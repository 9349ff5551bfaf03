// The register tile step of K4, K2, K3 and K5: a tile swept with every
// cell in a register of its lane.
//
// Replaces, for K4 (csrc/hetero.cu), K2 (csrc/wavefront.cu), K3
// (csrc/blocked.cu, its whole grid, per-tile form and chain mode) and K5
// (csrc/slab.cu, the slab sweep of alignment recovery), the body of
// trialign/kernels/blocked.py:_block_sweep and slab.py:_slab_sweep: one
// tile of tb x tc cells swept through its local planes q (cell (jl, kl) of
// plane q holds global i = q - jl - kl), with a one-cell halo taken from
// the faces its upper and left neighbours wrote.  K2, K3 and K5 sweep each
// tile as one sub-tile.
//
// Bound on the card: the shared-memory pillar this step replaced kept 25
// planes of the tile in shared memory, so each cell was 42 shared loads and
// a block-wide barrier ended every plane; one 33 x 33 tile-plane step took
// 2.26 us on an SM (PERF.md), about 12% of the SM's integer rate.  Here a
// cell costs its integer operations (about 70), four warp shuffles and no
// barrier.
//
// Sub-tiles.  The step sweeps at most 32 rows by kSubCols = 32 columns at a
// time.  A larger tile is swept as sub-tiles of that size, row after row of
// them, each a tile of its own whose halo is the face rows and columns the
// sub-tiles before it wrote in place into the tile's face slabs (the face
// slabs index a cell by i + kl and i + jl, so a sub-tile at (j0, k0) of its
// tile sees them shifted by k0 and j0).  Only the last sub-tile publishes
// the tile's progress, in the tile's planes; the first row of sub-tiles
// waits for the upper neighbour, the first column for the left one.  A
// sub-tile past the first column takes its halo corner from the column
// face's entry 0, where the sub-tile to its left staged it: the row-face
// slot of that corner holds the left sub-tile's bottom row by then.  The
// default 33 x 33 tile plane is one sub-tile.
//
// Layout.  Lane l of a warp owns sub-tile row jl = l + 1 (lanes past tb
// compute values nothing reads); warp w owns the strip of kStrip = 4 columns
// kl = 4w + 1 .. 4w + 4, so a block is ceil(tc / 4) warps, at most 8.
// Each cell's seven values are reduced where they are made into the seven
// partials their consumers take (kernels/hetero.py PARTIALS, the grouped
// max-plus of csrc/plane_step.cuh with each group's gap charge applied):
//   to (j, k) at q+1: Ix    to (j+1, k) at q+1: Iy    to (j, k+1) at q+1: Iz
//   to (j+1, k) at q+2: Ixy  to (j+1, k+1) at q+2: Iyz  to (j, k+1) at q+2: Ixz
//   to (j+1, k+1) at q+3: M (max7)
// so a cell is its predecessors' partials plus its substitution score.  A
// lane keeps its own row's partials (Ix, Iz, Ixz) in registers, with as
// many planes of history as their delay; the row above's (Iy, Ixy, Iyz, M)
// arrive by one rotating __shfl_sync a partial from lane l - 1.  Lane 31
// sends the halo row's partials in place of its own (the bottom row feeds
// no lane), so lane 0 receives the halo.
//
// Strips.  Column 0 of a strip is the previous strip's last column; its
// Iz, Ixz, Iyz and M partials (row 0's Iyz and M from the halo) pass through
// a ring in shared memory, 2 * chunk + 1 planes deep, which strip w reads a
// plane after strip w - 1 wrote it.  Strip 0's column 0 is the halo column,
// which each of its lanes loads a plane ahead.  Two strips meet at a named
// barrier (bar.sync on their 64 threads) once a chunk of planes: strip w
// starts chunk c when strip w - 1 has finished it, and strip w - 1 starts
// chunk c + 2 when strip w has finished chunk c, so the ring is read at
// most 2 * chunk planes after it was written.  No barrier spans the block
// inside a sub-tile.
//
// Halo and faces.  At the start of each chunk a warp waits (lane 0, acquire
// loads with back-off, as csrc/schedule.cuh PlaneWait) until the upper
// neighbour's progress word reaches min(q1 - 1 + tb, nq) and, for strip 0,
// the left one's min(q1 - 1 + tc, nq) (kernels/blocked.planes_needed; tb,
// tc and nq the tile's, q1 in the tile's planes), then loads the chunk's
// halo row over its columns (and the corner, strip 0) from the row face
// through L2 (__ldcg), in one round of loads for up to 32 cells, and
// reduces it to partials in a staging buffer.  The bottom row's values go
// to the row face at the end of each chunk, written by the whole warp; a
// cell of column tc writes its values to the column face (__stcg), each
// where 1 <= i <= |A|; the halo corners go to the faces too (the bottom
// row's column-0 entry, the right column's row-0 entry), so the state is
// that of K3's plain version (kernels/blocked.py blocked_ref).  The last strip publishes the tile's
// progress after each chunk of its last sub-tile (all strips have finished
// it by then): __syncwarp, __threadfence and a release store.  Rows a tile
// reads and writes in place follow PlaneWait's argument; inside the tile a
// face row is read by the warp that stages it before any warp writes it,
// and a sub-tile reads what the ones before it wrote after the block's
// barrier between them.
//
// Cells with i < 1 are zero (masked while q <= 32 + the strip's last
// column); cells with i > |A| compute values that only such cells read.
//
// Progress a strip (STRIP_WORDS, K2 and K3).  A tile's strips trail each
// other by a chunk, so a neighbour that waits for the last strip trails the
// first by W chunks more than its halo needs.  With a word a strip, strip
// w of a tile waits for word w of the upper tile (t.up + w), whose strip w
// has written the halo row over its columns (column k0 comes through the
// ring), and strip 0 for word W - 1 of the left tile (t.left + W - 1), its
// last strip; each strip publishes its own word after each chunk.  A
// single triplet's critical path crosses a tile diagonal per step, so this
// cuts its ramp; K4's many tiles keep one word a tile, and K3 and K5 take
// a word a strip only where the grid is bound by its ramp
// (kernels/blocked.py schedule), since each strip's word costs a fence a
// chunk.  K5 takes the choice at run time (WarpTile::strip_words), which
// halves its builds.
//
// Chain borders (CHAIN, K3's chain mode, kernels/blocked.py
// plan_dims_packed): npack problems of equal |A| stacked along i at pitch
// d, sharing B and C.  A cell with i = 0 (mod d) is a zero cell in all
// seven matrices, as a cell with i < 1 is: it is zeroed where it is made,
// so its partials are the zero cell's, and written into the faces like any
// cell (a neighbour's halo reads the zero there); slot m's final cell,
// i = m * d + d - 1 at (jl*, kl*), goes to out row m.  A lane keeps
// (q - jl - k0) mod d of the plane it sweeps, stepped with q; cell
// (jl, k0 + r) is a border where that less r is 0 mod d (one wrap where
// d > kStrip, a remainder otherwise).
//
// Register width (BITS, K2's and K3's score_bits).  A cell's seven values
// wrap to a score_bits-wide signed register where they are made, before
// they are reduced to partials or written to a face, so a partial is the
// grouped max-plus of stored, wrapped values: what the RTL's registers
// hold (kernels/ref.py wrap).  The instantiation without BITS is the one K4
// runs.
//
// The slab sweep (SLAB, K5; trialign/traceback/engine.py:77-119 and
// 238-273, kernels/slab.py slab_ref).  Every value a cell makes is clamped
// at kNeg, as the engine clamps.  A cell below the variant's first i holds
// its fill, t.fill: 0 in "free", kNeg in "free_jk" (whose j = 0 and k = 0
// faces are zero: the halo of the first tile row or column, and the tile
// corner at plane 0 there), kNeg under WALLS.  Every position of the tile
// plane, halo included, is captured into t.cap (7 x hb x wc) on the plane
// where its i is |A|: the cells where they are made, the halo row where it
// is staged, the halo column where it is read.  WALLS ("pin" and "bwd"):
// the sweep starts at plane 0, the origin's, where i = 0 holds a value and
// everything below is kNeg; a tile of the first tile row computes its halo
// row (the j = 0 face) and one of the first tile column its halo column
// (the k = 0 face) as DP cells that read kNeg outside the cuboid.  The face
// row is a DP along k and i only, so each chunk's staging computes it plane
// by plane, a lane a column (strip w's lane 0 reads column k0 from the ring,
// where strip w - 1's staging put its Iz and Ixz partials beside the Iyz
// and M ones), and the tile origin's lane holds the start vector t.ev there;
// the face column is one more cell a lane for strip 0, made after its
// plane's strip cells from its own row's Ix and the row above's Iy and Ixy
// (two more shuffles a plane).  "pin" (WALLS without BWD) makes a matrix
// kNeg where it would consume a symbol that does not exist: A at i = 0, B
// on the j = 0 face, C on the k = 0 face.  BWD, the backward step keyed by
// source state: a cell sends its raw value of state u where the forward
// step sends partial u (Ix, Iy, Iz a plane on, Ixy, Iyz, Ixz two, M three),
// and the consumer takes each target t's max over u of what it received
// (plus its substitution) + W[u][t], the transposed groups of
// slab_values.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_step.cuh"
#include "schedule.cuh"

namespace trialign {

constexpr int kRingRows = 33;  // row 0 (the halo row) and rows 1 .. 32
constexpr int kStrip = 4;      // columns a lane owns (R)
constexpr int kMaxStrips = 8;  // warps a block
constexpr int kSubRows = 32, kSubCols = kStrip * kMaxStrips;
// The longest chunk: the rings hold 2 * chunk + 1 planes (kernels/hetero.py
// MAX_CHUNK).
constexpr int kMaxChunk = 8;

// Gap charges as the partials add them: -2 go, -2 ge, -(go + ge), -go, -ge.
struct Charges {
  int o2, e2, oe, o, e;
};

// The seven partials of a cell with values v (kernels/hetero.py PARTIALS),
// the pair maxima that several groups share computed once.
__device__ __forceinline__ void cell_partials(const int v[kNumMatrices],
                                              const Charges& k,
                                              int p[kNumMatrices]) {
  const int m04 = max(v[0], v[4]), m34 = max(v[3], v[4]);
  const int m56 = max(v[5], v[6]);
  p[0] = max3(m04, max3(v[1], v[2], v[3]), m56);
  // Single-consume targets: max4 of the go + ge group, the one source that
  // pays 2 ge, the pair that pays 2 go.
  p[1] = max3(max(v[0], v[5]) + k.o2, v[1] + k.e2,
              max3(v[2], m34, v[6]) + k.oe);
  p[2] = max3(max(v[0], v[6]) + k.o2, v[2] + k.e2,
              max3(v[1], m34, v[5]) + k.oe);
  p[3] = max3(m04 + k.o2, v[3] + k.e2, max3(v[1], v[2], m56) + k.oe);
  // Double-consume targets: the go group and the ge group.
  p[4] = max(max3(v[0], v[3], m56) + k.o, max3(v[1], v[2], v[4]) + k.e);
  p[5] = max(max3(m04, v[1], v[6]) + k.o, max3(v[2], v[3], v[5]) + k.e);
  p[6] = max(max3(m04, v[2], v[5]) + k.o, max3(v[1], v[3], v[6]) + k.e);
}

// K5: minus infinity that survives additions (trialign/traceback/engine.py
// NEG).
constexpr int kNeg = -(1 << 26);

// What a cell with values v sends its consumers: the forward step's seven
// partials, or under BWD its seven values.
template <bool BWD>
__device__ __forceinline__ void cell_sends(const int v[kNumMatrices],
                                           const Charges& k,
                                           int p[kNumMatrices]) {
  if constexpr (BWD) {
#pragma unroll
    for (int m = 0; m < kNumMatrices; ++m) p[m] = v[m];
  } else {
    cell_partials(v, k, p);
  }
}

// K5's seven values of a cell from e (in v), what its predecessors sent plus
// the cell's substitution scores (M + S3, Ixy + S(a, b), Iyz + S(b, c),
// Ixz + S(a, c)), clamped at kNeg: forward the sums themselves; BWD each
// target t's max over source states u of e[u] + W[u][t], W's columns
// grouped by charge (Scoring.weight_matrix; engine.py backward_slab).
template <bool BWD>
__device__ __forceinline__ void slab_values(int v[kNumMatrices],
                                            const Charges& k) {
  if constexpr (BWD) {
    const int e0 = v[0], e1 = v[1], e2 = v[2], e3 = v[3], e4 = v[4],
              e5 = v[5], e6 = v[6];
    const int m12 = max(e1, e2), m13 = max(e1, e3), m23 = max(e2, e3);
    const int m45 = max(e4, e5), m46 = max(e4, e6), m56 = max(e5, e6);
    v[0] = max3(e0, max(m12, e3) + k.o2, max(m45, e6) + k.o);
    v[1] = max(max3(e0, e1 + k.e2, m23 + k.oe), max(m46 + k.e, e5 + k.o));
    v[2] = max(max3(e0, e2 + k.e2, m13 + k.oe), max(m45 + k.e, e6 + k.o));
    v[3] = max(max3(e0, e3 + k.e2, m12 + k.oe), max(e4 + k.o, m56 + k.e));
    v[4] = max(max3(e0, m12 + k.oe, e3 + k.o2), max(e4 + k.e, m56 + k.o));
    v[5] = max(max3(e0, e1 + k.o2, m23 + k.oe), max(m46 + k.o, e5 + k.e));
    v[6] = max(max3(e0, m13 + k.oe, e2 + k.o2), max(m45 + k.o, e6 + k.e));
  }
#pragma unroll
  for (int m = 0; m < kNumMatrices; ++m) v[m] = max(v[m], kNeg);
}

// "pin": a matrix is kNeg where it would consume a symbol that does not
// exist: A where no_a (i = 0), B where no_b (j = 0), C where no_c (k = 0).
__device__ __forceinline__ void pin_walls(int v[kNumMatrices], bool no_a,
                                          bool no_b, bool no_c) {
#pragma unroll
  for (int m = 0; m < kNumMatrices; ++m) {
    const int cb = consume_bits(m);
    if ((no_a && (cb & 1)) || (no_b && (cb & 2)) || (no_c && (cb & 4)))
      v[m] = kNeg;
  }
}

// The substitution scores of a cell with symbols a, b, c, as the step's
// plane loop computes them.
template <bool SUB, bool RTL>
__device__ __forceinline__ void cell_scores(int a, int b, int c,
                                            const int* sub,
                                            const StepScoring& s, int& s3,
                                            int& sab, int& sbc, int& sac) {
  if constexpr (SUB) {
    const int nsub = s.nsym + 1;
    const int ra = min(a, s.nsym) * nsub, cb = min(c, s.nsym);
    sab = sub[ra + min(b, s.nsym)];
    sac = sub[ra + cb];
    sbc = sub[min(b, s.nsym) * nsub + cb];
  } else {
    sab = a == b ? s.match : s.mismatch;
    sac = a == c ? s.match : s.mismatch;
    sbc = b == c ? s.match : s.mismatch;
  }
  if constexpr (RTL) {
    s3 = a == b ? (b == c ? 3 * s.match : 2 * (s.match + s.mismatch))
                : 3 * s.mismatch;
  } else {
    s3 = sab + sac + sbc;
  }
}

// Shared memory of one block of W strips: the W - 1 rings between them,
// the W halo-row buffers and the W bottom-row buffers (int4 each), then,
// under a submatrix (`sub`), its table.
inline size_t warp_pillar_shared_bytes(int strips, int chunk, bool sub) {
  return sizeof(int4) * ((size_t)(strips - 1) * (2 * chunk + 1) * kRingRows +
                         (size_t)strips * chunk * (3 * kStrip + 1)) +
         sizeof(int) * sub_table_ints(sub);
}

// Where a warp's cycles go, chunk by chunk: waiting (for strip w - 1 and
// the neighbours' progress), staging the halo, the planes, writing the
// bottom row, handing the chunk on (or publishing it); the last entry
// counts chunks.  Only the clocked build of the sweep (kernels/hetero.py
// step_phases) keeps it; in the others it is a no-op.
constexpr int kPhases = 6;
__device__ unsigned long long g_phase_cycles[kMaxStrips][kPhases];

template <bool ON>
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void add(int, int) {}
};

template <>
struct PhaseClock<true> {
  long long t = 0;
  unsigned long long acc[kPhases] = {};
  __device__ __forceinline__ void start() { t = clock64(); }
  __device__ __forceinline__ void mark(int k) {
    const long long now = clock64();
    acc[k] += now - t;
    t = now;
  }
  __device__ __forceinline__ void add(int w, int chunks) {
    acc[kPhases - 1] = chunks;
    if ((threadIdx.x & 31) == 0)
      for (int k = 0; k < kPhases; ++k)
        atomicAdd(&g_phase_cycles[w][k], acc[k]);
  }
};

// One sub-tile of one problem's tile, as the warp pillar takes it.
struct WarpTile {
  const int* a;  // A_i at index i, 1 <= i <= la (index 0: the pad)
  const int* b;  // B of sub-tile row jl at b[min(jl, bmax)]
  const int* c;  // C of sub-tile column kl at c[min(kl, cmax)]
  int bmax, cmax;  // the last row and column whose symbol b and c hold
  // The tile's row-face slab (nrows rows of 7 x wc) and column-face slab
  // (nrows rows of 7 x hb), shifted so that the sub-tile's halo row at its
  // plane q is rface[q * 7 wc + m * wc + kl] and its halo column
  // cface[q * 7 hb + m * hb + jl].
  int* rface;
  int* cface;
  int* out;   // the problem's 7 final values
  int* done;  // the tile's progress word, or nullptr before its last sub-tile
  int* up;    // (jb - 1, kb)'s, or nullptr but in the first sub-tile row
  int* left;  // (jb, kb - 1)'s, or nullptr but in the first sub-tile column
  int la, hb, wc;  // |A| and the tile plane (the faces' strides)
  int j0, k0;      // the sub-tile's corner in its tile
  int tb, tc;      // the sub-tile's rows and columns
  int jlstar, klstar;     // the final cell, in the sub-tile
  bool target;            // the sub-tile holds the final cell
  bool has_row, has_col;  // the halo row / column was written
  // K5 (SLAB) only.
  int* cap;        // the tile's capture plane, 7 x hb x wc ints
  const int* ev;   // the origin's seven values (WALLS)
  int fill;        // a cell's value below the first i: 0 or kNeg
  bool origin;     // the tile holds the cuboid's origin (WALLS)
  bool strip_words;  // a progress word a strip, else one a tile
};

// Sweeps one sub-tile with the block's first ceil(tc / 4) warps as strips.
// ring and stage: the shared buffers of warp_pillar_shared_bytes for the
// block's warps (stage: the halo-row buffers, then the bottom-row ones);
// sub: the submatrix table in shared memory (SUB); chunk: planes between
// handshakes.  CLOCK keeps the phase clock; BITS wraps each value to
// s.score_bits; STRIP_WORDS gives each strip a progress word of its own
// (t.done, t.up and t.left then point at kMaxStrips words a tile); CHAIN
// makes every cell with i = 0 (mod d) a zero border and captures slot m's
// final values into t.out row m (7 ints a row); SLAB, WALLS and BWD make
// it K5's tile (see the top of this file).
template <bool SUB, bool RTL, bool CLOCK, bool BITS = false,
          bool STRIP_WORDS = false, bool CHAIN = false, bool SLAB = false,
          bool WALLS = false, bool BWD = false>
__device__ __forceinline__ void warp_pillar(const WarpTile& t, int4* ring,
                                            int4* stage, const int* sub,
                                            const StepScoring& s,
                                            const Charges& K, int chunk,
                                            int d = 0) {
  constexpr int R = kStrip;
  // The first plane, and the least i a cell holds a value at: 0 under
  // WALLS (the origin), else 1.
  constexpr int FIRST = WALLS ? 0 : 1;
  // A progress word a strip: K5 picks it at run time (t.strip_words).
  const bool words = STRIP_WORDS || (SLAB && t.strip_words);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int tb = t.tb, tc = t.tc, la = t.la, nq = la + tb + tc;
  const int W = (tc + R - 1) / R;  // the sub-tile's strips
  if (w >= W) return;
  const int WB = blockDim.x >> 5;  // the strips the buffers hold
  const int jl = lane + 1, k0 = w * R;
  const int D = 2 * chunk + 1;
  const size_t rrow = (size_t)kNumMatrices * t.wc;
  const size_t crow = (size_t)kNumMatrices * t.hb;
  // Ring w - 1 runs from strip w - 1 to strip w.
  int4* ring_in = w > 0 ? ring + (size_t)(w - 1) * D * kRingRows : nullptr;
  int4* ring_out = w + 1 < W ? ring + (size_t)w * D * kRingRows : nullptr;
  // The halo row's partials of the chunk, R + 1 columns a plane (column 0:
  // the corner, for strip 0), and the bottom row's values, two int4 a cell,
  // which the whole warp writes to the row face at the chunk's end.
  int4* hrow = stage + (size_t)w * chunk * (R + 1);
  int4* brow =
      stage + (size_t)WB * chunk * (R + 1) + (size_t)w * chunk * R * 2;
  const bool has_row = t.has_row, has_col = t.has_col;

  // The partials of a zero cell: every cell with i < 1, every plane <= 0.
  // SLAB: of a cell holding the fill (every cell below the first i, every
  // plane before the first), which under WALLS is also every cell outside
  // the cuboid.
  int fill = 0;
  int Z[kNumMatrices];
  if constexpr (SLAB) {
    fill = WALLS ? kNeg : t.fill;
    int f[kNumMatrices];
#pragma unroll
    for (int m = 0; m < kNumMatrices; ++m) f[m] = fill;
    cell_sends<BWD>(f, K, Z);
  } else {
    const int zero[kNumMatrices] = {};
    cell_partials(zero, K, Z);
  }

  // Symbols: the lane's B_j, the strip's C_k, A_i shifted along the strip.
  const int bsym = t.b[min(jl, t.bmax)];
  const int nsub = SUB ? s.nsym + 1 : 0;
  int csym[R + 1], sbc[R + 1], a[R + 1];
#pragma unroll
  for (int r = 1; r <= R; ++r) {
    csym[r] = t.c[min(k0 + r, t.cmax)];
    if constexpr (SUB)
      sbc[r] = sub[min(bsym, s.nsym) * nsub + min(csym[r], s.nsym)];
    else
      sbc[r] = bsym == csym[r] ? s.match : s.mismatch;
    a[r] = t.a[0];
  }
  int a_next = t.a[0];  // every cell of plane 1 has i < 1
  // The register's range: a value v is stored as ((v + half) & low) - half
  // (BITS only; two's complement makes the mask exact for negatives).
  const int half = BITS ? 1 << (s.score_bits - 1) : 0;
  const int low = BITS ? (1 << s.score_bits) - 1 : 0;
  // Chain borders: (q - jl - k0) mod d at plane q, from plane 1.
  const bool wide = d > R;
  int imod = 0;
  if constexpr (CHAIN) imod = ((1 - jl - k0) % d + d) % d;

  // Partials by column (0: the boundary column) and age: own row's Ix (x),
  // Iz (z), Ixz (xz); the row above's Iy (y), Ixy (xy), Iyz (yz), M (m).
  int x1[R + 1], z1[R + 1], xz1[R + 1], xz2[R + 1];
  int y1[R + 1], xy1[R + 1], xy2[R + 1];
  int yz1[R + 1], yz2[R + 1], m1[R + 1], m2[R + 1], m3[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    x1[r] = Z[1];
    z1[r] = Z[3];
    xz1[r] = xz2[r] = Z[6];
    y1[r] = Z[2];
    xy1[r] = xy2[r] = Z[4];
    yz1[r] = yz2[r] = Z[5];
    m1[r] = m2[r] = m3[r] = Z[0];
  }
  // Strip 0's boundary column is the halo column, read a plane ahead: the
  // partials of plane q - 1 (nb*), of the corner (cb*, lane 31), and the
  // raw values of plane q while plane q runs.
  int nbz = Z[3], nbxz = Z[6], nbyz = Z[5], nbm = Z[0];
  int cbyz = Z[5], cbm = Z[0];
  int craw[kNumMatrices];
  if constexpr (SLAB && !WALLS) {
    // The tile corner at plane 0 (i = 0): zero on the j = 0 and k = 0
    // faces, else the fill.
    if (!has_row || !has_col) {
      const int zero[kNumMatrices] = {};
      int p[kNumMatrices];
      cell_partials(zero, K, p);
      cbyz = p[5];
      cbm = p[0];
    }
  }
  // WALLS: the computed face row's partials a lane keeps (its column's Ix,
  // Iz and Ixz, the last two also read by the lane to its right), and the
  // computed face column's (its own row's Ix, the row above's Iy and Ixy);
  // C of the face column.
  int hx = Z[1], hz = Z[3], hxz1 = Z[6], hxz2 = Z[6];
  int xc1 = Z[1], yc1 = Z[2], xyc1 = Z[4], xyc2 = Z[4];
  const int c0 = WALLS ? t.c[0] : 0;

  // The tile's planes: the sub-tile's plane q is the tile's q + plane0; a
  // chunk waits for the upper tile's plane q + tile tb and the left one's
  // q + tile tc, both at most the tile's last.
  const int plane0 = t.j0 + t.k0, last = la + t.hb + t.wc - 2;
  int seen_up = -1, seen_left = -1;
  PhaseClock<CLOCK> phases;
  phases.start();
  int chunks = 0;
  for (int q0 = FIRST; q0 <= nq; q0 += chunk, ++chunks) {
    const int q1 = min(q0 + chunk, nq + 1);
    // Strip w - 1 has finished this chunk, and the neighbours the planes
    // whose face rows it reads.
    if (w > 0) asm volatile("bar.sync %0, 64;" ::"r"(w) : "memory");
    if (lane == 0) {
      int* up = t.up;
      int* left = t.left;
      if (words) {
        // The upper tile's strip w has written the halo row over this
        // strip's columns (strip w - 1's before it); the left tile's last
        // strip, the halo column.
        up = up != nullptr ? up + w : nullptr;
        left = left != nullptr ? left + W - 1 : nullptr;
      }
      PlaneWait::await(up, min(q1 - 1 + plane0 + t.hb - 1, last), seen_up);
      if (w == 0)
        PlaneWait::await(left, min(q1 - 1 + plane0 + t.wc - 1, last),
                         seen_left);
    }
    __syncwarp();
    phases.mark(0);

    // The halo row over the strip's columns (and the corner, strip 0), as
    // partials; the right column's row-0 entry of the column face.  One
    // load round for up to 32 cells.
    bool staged = false;
    if constexpr (WALLS) {
      if (!has_row) {
        // The j = 0 face, computed plane by plane: lane r makes column
        // k0 + r (strip 0's lane 0 the corner line, read from the column
        // face past the first tile column); strip w's lane 0 reads column
        // k0 from the ring, where strip w - 1 put it.
        staged = true;
        const int k = k0 + lane, b0 = t.b[0];
        const int ck = t.c[min(k, t.cmax)];
        const bool makes = lane <= R && (lane > 0 || w == 0);
        for (int q = q0; q < q1; ++q) {
          const int lz = __shfl_up_sync(0xffffffffu, hz, 1);
          const int lxz = __shfl_up_sync(0xffffffffu, hxz2, 1);
          const int i = q - k;
          if (lane == 0 && w > 0) {
            const int4 e = ring_in[(q % D) * kRingRows];
            hz = e.x;
            hxz2 = hxz1;
            hxz1 = e.y;
          } else if (makes) {
            int v[kNumMatrices];
            if (lane == 0 && has_col) {
              const bool in = i >= 0 && i <= la;
#pragma unroll
              for (int m = 0; m < kNumMatrices; ++m)
                v[m] = in ? __ldcg(t.cface + q * crow + m * t.hb) : kNeg;
            } else {
              int s3, sab, sbc, sac;
              cell_scores<SUB, RTL>(t.a[min(max(i, 0), la)], b0, ck, sub,
                                    s, s3, sab, sbc, sac);
              v[0] = Z[0] + s3;
              v[1] = hx;
              v[2] = Z[2];
              v[3] = lane == 0 ? Z[3] : lz;
              v[4] = Z[4] + sab;
              v[5] = Z[5] + sbc;
              v[6] = (lane == 0 ? Z[6] : lxz) + sac;
              slab_values<BWD>(v, K);
              if constexpr (!BWD) pin_walls(v, i < 1, true, lane == 0);
              if (t.origin && lane == 0 && i == 0) {
#pragma unroll
                for (int m = 0; m < kNumMatrices; ++m) v[m] = t.ev[m];
              }
              if (i < 0) {
#pragma unroll
                for (int m = 0; m < kNumMatrices; ++m) v[m] = kNeg;
              }
            }
            int p[kNumMatrices];
            cell_sends<BWD>(v, K, p);
            hrow[(q - q0) * (R + 1) + lane] =
                make_int4(p[2], p[4], p[5], p[0]);
            if (lane == R && ring_out != nullptr)
              ring_out[(q % D) * kRingRows] =
                  make_int4(p[3], p[6], p[5], p[0]);
            if (k == tc && i >= 0 && i <= la) {
#pragma unroll
              for (int m = 0; m < kNumMatrices; ++m)
                __stcg(t.cface + (q - tc) * crow + m * t.hb, v[m]);
            }
            if (i == la && k <= tc) {
#pragma unroll
              for (int m = 0; m < kNumMatrices; ++m)
                t.cap[m * t.hb * t.wc + k] = v[m];
            }
            hx = p[1];
            hz = p[3];
            hxz2 = hxz1;
            hxz1 = p[6];
          }
        }
      }
    }
    if (!staged) {
      const int first = w == 0 ? 0 : 1, cols = R + 1 - first;
      for (int n = lane; n < (q1 - q0) * cols; n += 32) {
        const int q = q0 + n / cols, r = n % cols + first, k = k0 + r;
        const int i = q - k;
        const bool in = i >= FIRST && i <= la;
        const bool ok = has_row && k <= tc && in;
        const bool cc = k == 0 && t.k0 > 0;
        const int* f = cc ? t.cface + q * crow : t.rface + q * rrow + k;
        const int stride = cc ? t.hb : t.wc;
        int v[kNumMatrices], p[kNumMatrices];
#pragma unroll
        for (int m = 0; m < kNumMatrices; ++m)
          v[m] = ok ? __ldcg(f + m * stride) : (SLAB && has_row ? fill : 0);
        cell_sends<BWD>(v, K, p);
        hrow[(q - q0) * (R + 1) + r] = make_int4(p[2], p[4], p[5], p[0]);
        if (k == tc && in) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m)
            __stcg(t.cface + (q - tc) * crow + m * t.hb, v[m]);
        }
        if constexpr (SLAB) {
          if (i == la && k <= tc) {
#pragma unroll
            for (int m = 0; m < kNumMatrices; ++m)
              t.cap[m * t.hb * t.wc + k] = v[m];
          }
        }
      }
    }
    __syncwarp();

    phases.mark(1);
    int cur = q0 % D;  // ring slot of plane q
    for (int q = q0; q < q1; ++q) {
      const int prev = cur == 0 ? D - 1 : cur - 1;
      // The boundary column of plane q - 1 (zero partials for plane 0).
      int bz, bxz, byz, bm;
      if (w == 0) {
        bz = nbz;
        bxz = nbxz;
        byz = lane == 31 ? cbyz : nbyz;
        bm = lane == 31 ? cbm : nbm;
        // The halo column of plane q, used from plane q + 1: loaded
        // unmasked (a row of the slab in every case), masked at its use.
#pragma unroll
        for (int m = 0; m < kNumMatrices; ++m)
          craw[m] = __ldcg(t.cface + q * crow + m * t.hb + min(jl, tb));
        if (lane == 31) {
          const int4 h = hrow[(q - q0) * (R + 1)];
          cbyz = h.z;
          cbm = h.w;
        }
      } else if (q > FIRST) {
        const int4* slot = ring_in + prev * kRingRows;
        const int4 v = slot[jl];
        bz = v.x;
        bxz = v.y;
        byz = v.z;
        bm = v.w;
        if (lane == 31) {
          const int4 h = slot[0];
          byz = h.z;
          bm = h.w;
        }
      } else {
        bz = Z[3];
        bxz = Z[6];
        byz = Z[5];
        bm = Z[0];
      }
      z1[0] = bz;
      xz2[0] = xz1[0];
      xz1[0] = bxz;
#pragma unroll
      for (int r = R; r > 1; --r) a[r] = a[r - 1];
      a[1] = a_next;
      // A of cell (jl, k0 + 1) at plane q + 1.
      a_next = t.a[min(max(q - jl - k0, 0), la)];
      // The loads above are issued here, a plane before their use: the
      // compiler moves no memory access across the warp barrier.
      __syncwarp();
      const bool ramp = q <= 32 + k0 + R;
      // Whether plane q holds a final cell at (jl*, kl*): i = |A| there, or
      // in chain mode i = m * d + d - 1, slot m's, whose values go to out
      // row m.
      bool capture;
      int* out = t.out;
      if constexpr (CHAIN) {
        const int ifin = q - t.jlstar - t.klstar;
        capture = t.target && ifin >= 1 && ifin <= la && (ifin + 1) % d == 0;
        if (capture) out += ((ifin + 1) / d - 1) * kNumMatrices;
      } else {
        capture = t.target && q == la + t.jlstar + t.klstar;
      }

#pragma unroll
      for (int r = R; r >= 1; --r) {
        const int ai = a[r];
        int sab, sac;
        if constexpr (SUB) {
          const int row = min(ai, s.nsym) * nsub;
          sab = sub[row + min(bsym, s.nsym)];
          sac = sub[row + min(csym[r], s.nsym)];
        } else {
          sab = ai == bsym ? s.match : s.mismatch;
          sac = ai == csym[r] ? s.match : s.mismatch;
        }
        int s3;
        if constexpr (RTL) {
          // src/PE_1cyc.v:162 precedence quirk, as Scoring.triple_score.
          s3 = ai == bsym ? (bsym == csym[r] ? 3 * s.match
                                             : 2 * (s.match + s.mismatch))
                          : 3 * s.mismatch;
        } else {
          s3 = sab + sac + sbc[r];
        }
        int v[kNumMatrices];
        v[0] = m3[r - 1] + s3;
        v[1] = x1[r];
        v[2] = y1[r];
        v[3] = z1[r - 1];
        v[4] = xy2[r] + sab;
        v[5] = yz2[r - 1] + sbc[r];
        v[6] = xz2[r - 1] + sac;
        if constexpr (BITS) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m)
            v[m] = ((v[m] + half) & low) - half;
        }
        if constexpr (SLAB) slab_values<BWD>(v, K);
        const int k = k0 + r, i = q - jl - k;
        if constexpr (SLAB) {
          if (ramp) {
            if constexpr (WALLS && !BWD) {
              if (i == 0) pin_walls(v, true, false, false);
            }
            if (i < FIRST) {
#pragma unroll
              for (int m = 0; m < kNumMatrices; ++m) v[m] = fill;
            }
          }
        } else if (ramp && i < 1) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m) v[m] = 0;
        }
        if constexpr (CHAIN) {
          int im = imod - r;
          im = wide ? (im < 0 ? im + d : im) : (i % d + d) % d;
          if (im == 0) {
#pragma unroll
            for (int m = 0; m < kNumMatrices; ++m) v[m] = 0;
          }
        }
        if (jl == tb) {
          int4* b = brow + ((q - q0) * R + r - 1) * 2;
          b[0] = make_int4(v[0], v[1], v[2], v[3]);
          b[1] = make_int4(v[4], v[5], v[6], 0);
        }
        if (k == tc && jl <= tb && i >= FIRST && i <= la) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m)
            __stcg(t.cface + (q - tc) * crow + m * t.hb + jl, v[m]);
        }
        if (capture && jl == t.jlstar && k == t.klstar) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m) out[m] = v[m];
        }
        if constexpr (SLAB) {
          if (i == la && jl <= tb && k <= tc) {
#pragma unroll
            for (int m = 0; m < kNumMatrices; ++m)
              t.cap[(m * t.hb + jl) * t.wc + k] = v[m];
          }
        }
        int p[kNumMatrices];
        cell_sends<BWD>(v, K, p);
        x1[r] = p[1];
        z1[r] = p[3];
        xz2[r] = xz1[r];
        xz1[r] = p[6];
        int s2 = p[2], s4 = p[4], s5 = p[5], s0 = p[0];
        if (r == R && ring_out != nullptr)
          ring_out[cur * kRingRows + jl] = make_int4(p[3], p[6], p[5], p[0]);
        if (lane == 31) {
          const int4 h = hrow[(q - q0) * (R + 1) + r];
          s2 = h.x;
          s4 = h.y;
          s5 = h.z;
          s0 = h.w;
          // A computed face row's entry is the staging's (WALLS).
          if (r == R && ring_out != nullptr && (!WALLS || has_row))
            ring_out[cur * kRingRows] = make_int4(0, 0, s5, s0);
        }
        const int src = (lane + 31) & 31;
        y1[r] = __shfl_sync(0xffffffffu, s2, src);
        xy2[r] = xy1[r];
        xy1[r] = __shfl_sync(0xffffffffu, s4, src);
        if (r < R) {
          yz2[r] = yz1[r];
          yz1[r] = __shfl_sync(0xffffffffu, s5, src);
          m3[r] = m2[r];
          m2[r] = m1[r];
          m1[r] = __shfl_sync(0xffffffffu, s0, src);
        }
      }
      const int src = (lane + 31) & 31;
      yz2[0] = __shfl_sync(0xffffffffu, byz, src);
      m3[0] = m2[0];
      m2[0] = __shfl_sync(0xffffffffu, bm, src);
      if (w == 0) {
        // The halo column of plane q as partials; its bottom entry is the
        // row face's column-0 entry.
        const int i = q - jl;
        const bool ok = has_col && jl <= tb && i >= FIRST && i <= la;
        if (WALLS && !has_col) {
          // The k = 0 face: this row's cell of plane q from its own Ix and
          // the row above's Iy and Ixy; kNeg across the face.
          int s3, sab, sbc, sac;
          cell_scores<SUB, RTL>(a_next, bsym, c0, sub, s, s3, sab, sbc, sac);
          craw[0] = Z[0] + s3;
          craw[1] = xc1;
          craw[2] = yc1;
          craw[3] = Z[3];
          craw[4] = xyc2 + sab;
          craw[5] = Z[5] + sbc;
          craw[6] = Z[6] + sac;
          slab_values<BWD>(craw, K);
          if constexpr (!BWD) pin_walls(craw, i < 1, false, true);
          if (i < 0) {
#pragma unroll
            for (int m = 0; m < kNumMatrices; ++m) craw[m] = kNeg;
          }
        } else {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m)
            craw[m] = ok ? craw[m] : (SLAB && has_col ? fill : 0);
        }
        int p[kNumMatrices];
        cell_sends<BWD>(craw, K, p);
        nbz = p[3];
        nbxz = p[6];
        nbyz = p[5];
        nbm = p[0];
        if (jl == tb && q - tb >= FIRST && q - tb <= la) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m)
            __stcg(t.rface + (q - tb) * rrow + m * t.wc, craw[m]);
        }
        if constexpr (SLAB) {
          if (i == la && jl <= tb) {
#pragma unroll
            for (int m = 0; m < kNumMatrices; ++m)
              t.cap[(m * t.hb + jl) * t.wc] = craw[m];
          }
        }
        if (WALLS && !has_col) {
          // The row above's Iy and Ixy of the face column; lane 31 sends
          // the tile corner's.
          int sy = p[2], sxy = p[4];
          if (lane == 31) {
            const int4 h = hrow[(q - q0) * (R + 1)];
            sy = h.x;
            sxy = h.y;
          }
          xc1 = p[1];
          yc1 = __shfl_sync(0xffffffffu, sy, src);
          xyc2 = xyc1;
          xyc1 = __shfl_sync(0xffffffffu, sxy, src);
        }
      }
      cur = cur + 1 == D ? 0 : cur + 1;
      if constexpr (CHAIN) imod = imod + 1 == d ? 0 : imod + 1;
    }

    phases.mark(2);
    // The bottom row of the chunk to the row face, where 1 <= i <= |A|:
    // lane e writes matrix e / R of column e % R + 1 (consecutive columns
    // on consecutive lanes) for each plane of the chunk in that range.
    __syncwarp();
    for (int e = lane; e < kNumMatrices * R; e += 32) {
      const int m = e / R, r = e % R + 1, k = k0 + r;
      const int qa = max(q0, tb + k + FIRST), qb = min(q1, la + tb + k + 1);
      if (k > tc) continue;
      const int* src = reinterpret_cast<const int*>(brow) + (r - 1) * 8 + m;
      int* dst = t.rface + m * t.wc + k;
      for (int q = qa; q < qb; ++q)
        __stcg(dst + (q - tb) * rrow, src[(q - q0) * R * 8]);
    }

    phases.mark(3);
    // Publish the chunk, in tile planes, once the strips the word stands
    // for have finished it.
    auto publish = [&](int* word) {
      __syncwarp();
      if (lane == 0) {
        __threadfence();
        PlaneWait::Flag(*word).store(q1 - 1 + plane0,
                                     cuda::memory_order_release);
      }
    };
    if (w + 1 < W) {
      // Hand the chunk to strip w + 1.
      asm volatile("bar.sync %0, 64;" ::"r"(w + 1) : "memory");
      if (words && t.done != nullptr) publish(t.done + w);
    } else if (t.done != nullptr) {
      publish(t.done + (words ? w : 0));
    }
    phases.mark(4);
  }
  phases.add(w, chunks);
}

}  // namespace trialign
