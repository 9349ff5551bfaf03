// The register tile step of K4, K2 and K3: a tile swept with every cell in
// a register of its lane.
//
// Replaces, for K4 (csrc/hetero.cu), K2 (csrc/wavefront.cu) and K3
// (csrc/blocked.cu, its whole grid, per-tile form and chain mode), the body
// of trialign/kernels/blocked.py:_block_sweep: one tile of tb x tc cells
// swept through its local planes q (cell (jl, kl) of plane q holds global
// i = q - jl - kl), with a one-cell halo taken from the faces its upper and
// left neighbours wrote.  K2 and K3 sweep each tile as one sub-tile.
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
// cuts its ramp; K4's many tiles keep one word a tile, and K3 takes a word
// a strip only where its grid is bound by its ramp (kernels/blocked.py
// schedule), since each strip's word costs a fence a chunk.
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
// grouped max-plus of stored, wrapped values: what cell_step computes
// (csrc/plane_step.cuh wrap_bits).  The instantiation without BITS is the
// one K4 runs.
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
};

// Sweeps one sub-tile with the block's first ceil(tc / 4) warps as strips.
// ring and stage: the shared buffers of warp_pillar_shared_bytes for the
// block's warps (stage: the halo-row buffers, then the bottom-row ones);
// sub: the submatrix table in shared memory (SUB); chunk: planes between
// handshakes.  CLOCK keeps the phase clock; BITS wraps each value to
// s.score_bits; STRIP_WORDS gives each strip a progress word of its own
// (t.done, t.up and t.left then point at kMaxStrips words a tile); CHAIN
// makes every cell with i = 0 (mod d) a zero border and captures slot m's
// final values into t.out row m (7 ints a row).
template <bool SUB, bool RTL, bool CLOCK, bool BITS = false,
          bool STRIP_WORDS = false, bool CHAIN = false>
__device__ __forceinline__ void warp_pillar(const WarpTile& t, int4* ring,
                                            int4* stage, const int* sub,
                                            const StepScoring& s,
                                            const Charges& K, int chunk,
                                            int d = 0) {
  constexpr int R = kStrip;
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
  int Z[kNumMatrices];
  {
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
  // The register's range, as wrap_bits takes it (BITS only).
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

  // The tile's planes: the sub-tile's plane q is the tile's q + plane0; a
  // chunk waits for the upper tile's plane q + tile tb and the left one's
  // q + tile tc, both at most the tile's last.
  const int plane0 = t.j0 + t.k0, last = la + t.hb + t.wc - 2;
  int seen_up = -1, seen_left = -1;
  PhaseClock<CLOCK> phases;
  phases.start();
  int chunks = 0;
  for (int q0 = 1; q0 <= nq; q0 += chunk, ++chunks) {
    const int q1 = min(q0 + chunk, nq + 1);
    // Strip w - 1 has finished this chunk, and the neighbours the planes
    // whose face rows it reads.
    if (w > 0) asm volatile("bar.sync %0, 64;" ::"r"(w) : "memory");
    if (lane == 0) {
      int* up = t.up;
      int* left = t.left;
      if constexpr (STRIP_WORDS) {
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
    {
      const int first = w == 0 ? 0 : 1, cols = R + 1 - first;
      for (int n = lane; n < (q1 - q0) * cols; n += 32) {
        const int q = q0 + n / cols, r = n % cols + first, k = k0 + r;
        const int i = q - k;
        const bool in = i >= 1 && i <= la;
        const bool ok = has_row && k <= tc && in;
        const bool cc = k == 0 && t.k0 > 0;
        const int* f = cc ? t.cface + q * crow : t.rface + q * rrow + k;
        const int stride = cc ? t.hb : t.wc;
        int v[kNumMatrices], p[kNumMatrices];
#pragma unroll
        for (int m = 0; m < kNumMatrices; ++m)
          v[m] = ok ? __ldcg(f + m * stride) : 0;
        cell_partials(v, K, p);
        hrow[(q - q0) * (R + 1) + r] = make_int4(p[2], p[4], p[5], p[0]);
        if (k == tc && in) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m)
            __stcg(t.cface + (q - tc) * crow + m * t.hb, v[m]);
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
      } else if (q > 1) {
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
        const int k = k0 + r, i = q - jl - k;
        if (ramp && i < 1) {
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
        if (k == tc && jl <= tb && i >= 1 && i <= la) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m)
            __stcg(t.cface + (q - tc) * crow + m * t.hb + jl, v[m]);
        }
        if (capture && jl == t.jlstar && k == t.klstar) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m) out[m] = v[m];
        }
        int p[kNumMatrices];
        cell_partials(v, K, p);
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
          if (r == R && ring_out != nullptr)
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
        const bool ok = has_col && jl <= tb && i >= 1 && i <= la;
#pragma unroll
        for (int m = 0; m < kNumMatrices; ++m) craw[m] = ok ? craw[m] : 0;
        int p[kNumMatrices];
        cell_partials(craw, K, p);
        nbz = p[3];
        nbxz = p[6];
        nbyz = p[5];
        nbm = p[0];
        if (jl == tb && q - tb >= 1 && q - tb <= la) {
#pragma unroll
          for (int m = 0; m < kNumMatrices; ++m)
            __stcg(t.rface + (q - tb) * rrow + m * t.wc, craw[m]);
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
      const int qa = max(q0, tb + k + 1), qb = min(q1, la + tb + k + 1);
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
      if constexpr (STRIP_WORDS) {
        if (t.done != nullptr) publish(t.done + w);
      }
    } else if (t.done != nullptr) {
      publish(t.done + (STRIP_WORDS ? w : 0));
    }
    phases.mark(4);
  }
  phases.add(w, chunks);
}

}  // namespace trialign
