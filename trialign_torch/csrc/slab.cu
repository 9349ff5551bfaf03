// K5: the slab sweep of alignment recovery, with capture of the plane i = |A|.
//
// Replaces trialign/kernels/slab.py:_slab_sweep as launched by
// make_slab_grid_call and by make_slab_block_call.  It is K3's tiled sweep
// (csrc/blocked.cu: tiles of tb x tc cells with a one-cell halo, faces in
// skewed global slabs, the whole grid in one persistent launch) plus three
// things the Hirschberg split needs:
//
// * Capture.  Every position (jl, kl) of a tile, halo included, is written
//   once to cap[blk][t][jl][kl] on the plane where its global i equals |A|.
//   The forward variants also write the seven values of (|A|, |B|, |C|).
// * Per-variant borders (trialign/traceback/engine.py:77-119).  "free" has
//   zero borders, as K3.  "free_jk" has zero j = 0 / k = 0 faces and a NEG
//   wall at i = 0.  "pin" (the origin holds v0) and "bwd" (reversed inputs,
//   the origin holds the end vector) have NEG walls everywhere, and their
//   face cells are real DP cells: the tiles of the first tile row and column
//   compute their halo row or column with the step, reading NEG outside the
//   cuboid.
// * A backward step, keyed by source state: E_u is the u-shifted plane's row
//   u plus u's substitution at this cell, and value_t = max_u E_u + W[u][t]
//   (engine.py:238-273).  Every computed value is clamped at NEG, as the
//   engine clamps, so captured cells equal it bit for bit.
//
// Bound on the card: as K3, the integer add/max step (no tensor-core work)
// reads 43 values a cell from the plane ring in shared memory, and a barrier
// ends each plane; the capture adds one write of 7 ints for each cell of
// the i = |A| plane.  Its ~117 KB plane ring holds one block to an SM.
// Launched one tile anti-diagonal at a time, the grid was bound by the tiles
// of one diagonal (125 launches at the 2048^3 top split, 33 tiles each on
// average).
//
// Whole-grid sweep (slab_persistent): one launch for every tile, as K3's
// (csrc/schedule.cuh PlaneWait).  Blocks take tiles in table order from a
// global counter and sweep each pillar in chunks of planes; before a chunk a
// tile waits until its upper neighbour has finished plane q1 - 1 + tb and its
// left neighbour plane q1 - 1 + tc (capped at the last plane), the rule of
// kernels/blocked.py planes_needed.  The face slabs stay one a tile column
// and one a tile row, read and written in place: tile (jb, kb) reads row s
// at its step s, after (jb - 1, kb) wrote it at its step s + tb, and writes
// row s at its own step s + tb, before which (jb + 1, kb) does not read it
// and after which (jb - 1, kb), past its step s, never reads it again.
// "pin" and "bwd" start at plane 0, so progress starts at -1.
//
// Per-tile form (trialign/kernels/slab.py:make_slab_block_call, which the
// halo-sharded traceback runs one block a call): the same launch over a run
// of tiles the host lists as (jb, kb, up, left) entries, as K3's per-tile
// form (csrc/blocked.cu): any run of the tile table, or a band of rows of a
// stripe's columns.  A neighbour outside the run was swept by an earlier
// launch and reads as finished.  Tile indices are always global, so
// borders, the variant's fill, the target tile and the symbols are decided
// as in the whole sweep.  The wait rule needs a tile's faces to be those of
// its tile column and row, and so they are in every run: the scalar table
// (kernels/slab.py _scal_table, one for the whole grid in every state, a
// stripe's included) names tile (jb, kb)'s slabs kb and jb (columns 13, 14).
//
// The direct engine's choice-capture sweep (choices_persistent, entry
// trialign_slab_choices) replaces trialign/traceback/direct.py:_choices_seg,
// which is XLA in the JAX package (a jitted lax.scan a segment of planes),
// not a pallas_call.  It is this file's whole-grid sweep with the CHOICES
// flag: no capture plane; every cell with 0 <= i <= |A| on a plane q >= 1
// steps with cell_step_choices (csrc/plane_step.cuh), which also returns
// each target's argmax over its seven sources, and writes the 21 bits to
// the caller's packed buffers (3 bits a matrix: matrices 0-4 into an int16,
// 5-6 into a byte, row q - 1, (j, k) at j * (|C| + 1) + k, 64-bit
// offsets).  A target with no predecessor (j < dj or k < dk) chooses 0.  M's
// choice is the argmax of the seven stored values at (i-1, j-1, k-1), so a
// ring of 4 byte planes carries the argmax of max7 beside it, taken after
// the walls.  Cells whose value a wall fixes (the j = 0 / k = 0 faces and
// i = 0 of "free" and "free_jk") still step, for their choices, which is
// why the sweep visits i = 0 in every variant.  Bound: the step's 88 int32
// operations a cell (six targets by seven sources, ungrouped, since the
// argmax needs every source: 42 adds of a weight and 36 max-with-argmax
// steps; 3 pair-score adds; M's add and the 6 steps of max7 with its
// argmax), the count chip_smoke.py's bound uses, and the 3 B a cell it
// writes, 3.2 GB at 1024^3, in short rows of a tile's width.
//
// Kept for comparison only (chip_smoke.py; no entry point of the package
// reaches it): slab_kernel, the per-tile form as it was, one launch a run of
// one anti-diagonal with one block a tile (schedule NoWait).
//
// Design: the tile plane carries a guard row and column (index -1) that are
// set to the variant's fill and never written, so an edge cell's
// predecessor outside the cuboid reads NEG without a branch.  The ring (3
// generations of 7 planes and 4 generations of one plane: max7 forward, the
// M row backward) starts at the value every cell has below its first plane:
// 0 ("free"), 0 on the j = 0 / k = 0 faces and NEG elsewhere ("free_jk"),
// NEG ("pin", "bwd").  A position is written only on planes where its i is in
// [1, |A|] ("free", "free_jk") or [0, |A|] ("pin", "bwd", and every variant
// of the choice sweep); "pin" and "bwd"
// start at plane 0, where each tile's corner holds i = 0.  The faces carry
// every written position of the bottom row and right column, so a
// neighbour reads only face rows that were written, and no slab needs
// initialising.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_step.cuh"
#include "schedule.cuh"

namespace trialign {

// Geometry of one slab sweep; mirrors the ctypes structure in
// trialign_torch/_build.py field for field.
struct SlabGeom {
  int la;       // |A|: the capture plane, and the last i the sweep computes
  int hb;       // tile plane rows: halo row + tb cells
  int wc;       // tile plane columns: halo column + tc cells
  int n_jb;     // tile rows
  int n_kb;     // tile columns
  int nrows;    // rows of each face slab (local planes 0 .. la + tb + tc)
  int variant;  // kFree, kFreeJk, kPin or kBwd
};

namespace {

enum Variant { kFree = 0, kFreeJk = 1, kPin = 2, kBwd = 3 };

// trialign/traceback/engine.py NEG: minus infinity that survives additions.
constexpr int kNeg = -(1 << 26);
// Columns of a row of the per-block scalar table (trialign_torch/kernels/
// slab.py _scal_table): la, jb, kb, qstar, jlstar, klstar, ev[7], row-face
// slab, column-face slab, pad.
constexpr int kScalCols = 16;
constexpr int kRingPlanes = 3 * kNumMatrices + 4;
// Threads per tile, as K3 (csrc/blocked.cu).
constexpr int kThreads = 512;
// Largest submatrix K5 takes: every alphabet Scoring accepts (16 symbols),
// as the reference's slab kernel builds its select chains for any of them.
// K2 and K3 keep plane_step.cuh's kMaxSym.  The table has one more row and
// column for the clamped floor.
constexpr int kSlabMaxSym = 16;
constexpr int kSlabSubTable = (kSlabMaxSym + 1) * (kSlabMaxSym + 1);

// Where the choice-capture sweep writes: packed_lo and packed_hi of
// traceback/direct.py, (|A| + |B| + |C|, (|B| + 1)(|C| + 1)) each; row q - 1
// holds plane q, (j, k) at j * (|C| + 1) + k.
struct ChoiceOut {
  int16_t* lo;  // choices of matrices 0-4, 3 bits each
  uint8_t* hi;  // matrices 5 and 6
  int lb, lc;   // |B|, |C|
};

// The three pairwise scores and S3 of one cell, as cell_step computes them.
__device__ __forceinline__ void cell_subs(int a, int b, int cc,
                                          const StepScoring& s, const int* sub,
                                          int& s3, int& sab, int& sbc,
                                          int& sac) {
  sab = pair_score(a, b, s, sub);
  sac = pair_score(a, cc, s, sub);
  sbc = pair_score(b, cc, s, sub);
  if (s.rtl) {
    s3 = a == b ? (b == cc ? 3 * s.match : 2 * (s.match + s.mismatch))
                : 3 * s.mismatch;
  } else {
    s3 = sab + sac + sbc;
  }
}

// One cell of the backward sweep (engine.backward_slab): p1, p2 point at
// matrix 0 of planes q-1 and q-2 (matrices `ts` ints apart), m3 at the M row
// of plane q-3; c, up, left, upleft as in cell_step.
__device__ __forceinline__ void bwd_step(const int* p1, const int* p2,
                                         const int* m3, int ts, int c, int up,
                                         int left, int upleft, int a, int b,
                                         int cc, const StepScoring& s,
                                         const int* sub,
                                         int out[kNumMatrices]) {
  int s3, sab, sbc, sac;
  cell_subs(a, b, cc, s, sub, s3, sab, sbc, sac);
  int e[kNumMatrices];
  e[0] = m3[upleft] + s3;          // M: plane q-3 at (j-1, k-1)
  e[1] = p1[1 * ts + c];           // Ix: plane q-1 at (j, k)
  e[2] = p1[2 * ts + up];          // Iy: plane q-1 at (j-1, k)
  e[3] = p1[3 * ts + left];        // Iz: plane q-1 at (j, k-1)
  e[4] = p2[4 * ts + up] + sab;    // Ixy: plane q-2 at (j-1, k)
  e[5] = p2[5 * ts + upleft] + sbc;  // Iyz: plane q-2 at (j-1, k-1)
  e[6] = p2[6 * ts + left] + sac;  // Ixz: plane q-2 at (j, k-1)
  const int go = s.gap_open, ge = s.gap_extend;
#pragma unroll
  for (int t = 0; t < kNumMatrices; ++t) {
    int acc = e[0] + transition_weight(0, t, go, ge);
#pragma unroll
    for (int u = 1; u < kNumMatrices; ++u)
      acc = max(acc, e[u] + transition_weight(u, t, go, ge));
    out[t] = max(acc, kNeg);
  }
}

size_t shared_bytes(int hb, int wc) {
  return sizeof(int) * ((size_t)kRingPlanes * (hb + 1) * (wc + 1) + hb + wc +
                         kSlabSubTable);
}

// The choice-capture sweep's shared memory: K5's, and 4 generations of one
// byte plane, the argmax of max7.
size_t choices_shared_bytes(int hb, int wc) {
  return shared_bytes(hb, wc) + (size_t)4 * (hb + 1) * (wc + 1);
}

// Sweeps tile (jb, kb) under the schedule policy `sync` (csrc/schedule.cuh).
// CHOICES: the direct engine's choice-capture sweep (see the top of this
// file) instead of K5's capture; `co` is read only then.
template <bool CHOICES, class Sync>
__device__ __forceinline__ void slab_tile(
    int* smem, const int* __restrict__ a_ext, const int* __restrict__ b_ext,
    const int* __restrict__ c_ext, const SlabGeom& g, int jb, int kb,
    const int* __restrict__ scal, const int* __restrict__ sub,
    const StepScoring& s, int* rf, int* cf, int* __restrict__ out,
    int* __restrict__ cap, const ChoiceOut& co, Sync& sync) {
  const int hb = g.hb, wc = g.wc, tb = hb - 1, tc = wc - 1;
  // Guarded plane: position (jl, kl) at (jl + 1) * W1 + kl + 1, jl, kl >= -1.
  const int W1 = wc + 1, PG = (hb + 1) * W1;
  int* planes = smem;                         // [3 slots][7][PG]
  int* m4 = planes + 3 * kNumMatrices * PG;   // [4 slots][PG]
  int* bsym = m4 + 4 * PG;                    // [hb]
  int* csym = bsym + hb;                      // [wc]
  int* sub_s = csym + wc;                     // [kSlabSubTable]
  // CHOICES: [4 slots][PG], the argmax of each max7 in m4.
  uint8_t* a4 = reinterpret_cast<uint8_t*>(sub_s + kSlabSubTable);
  const int blk = jb * g.n_kb + kb;
  const int* row = scal + (size_t)blk * kScalCols;
  const int la = g.la, qstar = row[3], jlstar = row[4], klstar = row[5];
  const int variant = g.variant;
  const bool fwd = variant != kBwd;
  const bool walls = variant == kPin || variant == kBwd;

  for (int x = threadIdx.x; x < kRingPlanes * PG; x += kThreads) {
    const int pos = x % PG;
    const int jl = pos / W1 - 1, kl = pos % W1 - 1;
    const bool border = (jb == 0 && jl == 0) || (kb == 0 && kl == 0);
    planes[x] = variant == kFree || (variant == kFreeJk && border) ? 0 : kNeg;
  }
  if (CHOICES) {
    for (int x = threadIdx.x; x < 4 * PG; x += kThreads) a4[x] = 0;
  }
  for (int x = threadIdx.x; x < hb; x += kThreads)
    bsym[x] = b_ext[jb * tb + x];
  for (int x = threadIdx.x; x < wc; x += kThreads)
    csym[x] = c_ext[kb * tc + x];
  load_sub_table(sub, s.nsym, sub_s);
  __syncthreads();

  // Face slabs: row faces [n_kb][nrows][7][wc], column faces
  // [n_jb][nrows][7][hb].
  const size_t rrow = (size_t)kNumMatrices * wc, crow = (size_t)kNumMatrices * hb;
  int* rface = rf + (size_t)row[13] * g.nrows * rrow;
  int* cface = cf + (size_t)row[14] * g.nrows * crow;
  int* capb = cap + (size_t)blk * kNumMatrices * hb * wc;
  // The choice sweep also steps the cells with i = 0 of "free" and
  // "free_jk", whose choices the walk may read.
  const int ilo = walls || CHOICES ? 0 : 1;
  const int nq = la + tb + tc;
  const int npos = hb * wc;
  // CHOICES: one row of the packed buffers a global plane, 64-bit offsets.
  const size_t crow_len = (size_t)(co.lb + 1) * (co.lc + 1);

  for (int q = walls ? 0 : 1; q <= nq; ++q) {
    sync.before_plane(q);
    int* cur = planes + (q % 3) * kNumMatrices * PG;
    const int* p1 = planes + ((q + 2) % 3) * kNumMatrices * PG;
    const int* p2 = planes + ((q + 1) % 3) * kNumMatrices * PG;
    int* m4cur = m4 + (q & 3) * PG;
    const int* m4p3 = m4 + ((q + 1) & 3) * PG;  // slot of plane q - 3
    uint8_t* a4cur = a4 + (q & 3) * PG;
    const uint8_t* a4p3 = a4 + ((q + 1) & 3) * PG;

    for (int x = threadIdx.x; x < npos; x += kThreads) {
      const int jl = x / wc, kl = x - (x / wc) * wc;
      const int i = q - jl - kl;
      if (i < ilo || i > la) continue;
      const int c = (jl + 1) * W1 + kl + 1;
      const int gj = jb * tb + jl, gk = kb * tc + kl;
      int v[kNumMatrices];
      int word = -1;  // CHOICES: the cell's choices, where this tile owns it
      if (jl == 0 && jb > 0) {
        // Halo row from the row face; it wins at the corner.
        const int* src = rface + q * rrow + kl;
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = sync.load(src + t * wc);
      } else if (kl == 0 && kb > 0) {
        const int* src = cface + q * crow + jl;
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = sync.load(src + t * hb);
      } else if (CHOICES && i + gj + gk > 0) {
        // Every cell chooses from its stored predecessors; its value is then
        // walled as traceback/torch_engine.py _Grid.mask walls it.
        word = cell_step_choices(p1, p2, PG, c, c - W1, c - 1, c - W1 - 1,
                                 m4p3[c - W1 - 1], a4p3[c - W1 - 1], gj > 0,
                                 gk > 0, a_ext[i], bsym[jl], csym[kl], s,
                                 sub_s, v);
        if (!walls && (jl == 0 || kl == 0 || i == 0)) {
          // j = 0 and k = 0 faces are zero; i = 0 is zero in "free" and a
          // NEG wall in "free_jk".
          const int fill = variant == kFree || jl == 0 || kl == 0 ? 0 : kNeg;
#pragma unroll
          for (int t = 0; t < kNumMatrices; ++t) v[t] = fill;
        } else {
#pragma unroll
          for (int t = 0; t < kNumMatrices; ++t) {
            const int cb = consume_bits(t);
            v[t] = max(v[t], kNeg);
            if (walls && (i < (cb & 1) || gj < ((cb >> 1) & 1) ||
                          gk < ((cb >> 2) & 1)))
              v[t] = kNeg;
          }
        }
      } else if ((jl == 0 || kl == 0) && !walls) {
        // A j = 0 or k = 0 face cell of "free" / "free_jk": zero.
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = 0;
      } else if (i == 0 && jl == 0 && kl == 0) {
        // The origin of "pin" / "bwd" (only tile (0, 0) reaches here).
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = row[6 + t];
      } else if (fwd) {
        cell_step(p1, p2, PG, c, c - W1, c - 1, c - W1 - 1, m4p3[c - W1 - 1],
                  a_ext[i], bsym[jl], csym[kl], s, sub_s, v);
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = max(v[t], kNeg);
        if (variant == kPin) {
          // A matrix is a wall where it would consume a symbol that does
          // not exist: i < ca, global j < cb or k < cc.
#pragma unroll
          for (int t = 0; t < kNumMatrices; ++t) {
            const int cb = consume_bits(t);
            if (i < (cb & 1) || gj < ((cb >> 1) & 1) || gk < ((cb >> 2) & 1))
              v[t] = kNeg;
          }
        }
      } else {
        bwd_step(p1, p2, m4p3, PG, c, c - W1, c - 1, c - W1 - 1, a_ext[i],
                 bsym[jl], csym[kl], s, sub_s, v);
      }

      // max7 and, for CHOICES, its first argmax, of the stored values.
      int m = v[0], am = 0;
#pragma unroll
      for (int t = 0; t < kNumMatrices; ++t) {
        cur[t * PG + c] = v[t];
        if (v[t] > m) {
          m = v[t];
          am = t;
        }
      }
      m4cur[c] = fwd ? m : v[0];
      if (CHOICES) a4cur[c] = (uint8_t)am;
      if (jl == tb) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t)
          sync.store(&rface[(q - tb) * rrow + t * wc + kl], v[t]);
      }
      if (kl == tc) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t)
          sync.store(&cface[(q - tc) * crow + t * hb + jl], v[t]);
      }
      if (!CHOICES && i == la) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) capb[t * npos + x] = v[t];
      }
      if (fwd && q == qstar && jl == jlstar && kl == klstar) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) out[t] = v[t];
      }
      if (CHOICES && word >= 0 && gj <= co.lb && gk <= co.lc) {
        // Row i + j + k - 1 (q is the tile's local plane); matrices 0-4 in
        // the int16 buffer, 5-6 in the byte buffer.
        const size_t at = (size_t)(i + gj + gk - 1) * crow_len +
                          (size_t)gj * (co.lc + 1) + gk;
        co.lo[at] = (int16_t)(word & 0x7FFF);
        co.hi[at] = (uint8_t)(word >> 15);
      }
    }
    __syncthreads();
  }
  sync.finish();
}

// Tiles (jb_lo .. jb_lo + gridDim.x - 1, d - jb), one block each, after the
// launches of the earlier diagonals on the same stream (the earlier design).
__global__ void __launch_bounds__(kThreads)
    slab_kernel(const int* __restrict__ a_ext, const int* __restrict__ b_ext,
                const int* __restrict__ c_ext, SlabGeom g, int d, int jb_lo,
                const int* __restrict__ scal, const int* __restrict__ sub,
                StepScoring s, int* rf, int* cf, int* __restrict__ out,
                int* __restrict__ cap) {
  extern __shared__ int smem[];
  const int jb = jb_lo + blockIdx.x;
  NoWait sync;
  slab_tile<false>(smem, a_ext, b_ext, c_ext, g, jb, d - jb, scal, sub, s, rf,
                   cf, out, cap, ChoiceOut{}, sync);
}

// Entry of a run's table, as csrc/blocked.cu RunEntry: (jb, kb, up, left).
using RunEntry = int4;

// The tile table in one launch: the whole grid in table order (run ==
// nullptr, ntiles = n_jb * n_kb), or the ntiles entries of run, in which
// every neighbour of the run comes before its tile.  next_tile: the hand-out
// counter (0); done: one progress word a tile (-1), row jb * n_kb + kb of
// the whole grid or the entry of the run.
__global__ void __launch_bounds__(kThreads)
    slab_persistent(const int* __restrict__ a_ext,
                    const int* __restrict__ b_ext,
                    const int* __restrict__ c_ext, SlabGeom g,
                    const RunEntry* __restrict__ run, int ntiles, int chunk,
                    const int* __restrict__ scal, const int* __restrict__ sub,
                    StepScoring s, int* rf, int* cf, int* __restrict__ out,
                    int* __restrict__ cap, int* next_tile, int* done) {
  extern __shared__ int smem[];
  const int tb = g.hb - 1, tc = g.wc - 1, nq = g.la + tb + tc;
  const int first = g.variant == kPin || g.variant == kBwd ? 0 : 1;
  for (;;) {
    const int t = take_tile(next_tile);
    if (t >= ntiles) return;
    int jb, kb;
    int *me, *up, *left;
    if (run != nullptr) {
      const RunEntry e = run[t];
      jb = e.x;
      kb = e.y;
      me = done + t;
      up = e.z >= 0 ? done + e.z : nullptr;
      left = e.w >= 0 ? done + e.w : nullptr;
    } else {
      table_tile(t, g.n_jb, g.n_kb, jb, kb);
      me = done + jb * g.n_kb + kb;
      up = jb > 0 ? me - g.n_kb : nullptr;
      left = kb > 0 ? me - 1 : nullptr;
    }
    PlaneWait sync(me, up, left, tb, tc, nq, chunk, first);
    slab_tile<false>(smem, a_ext, b_ext, c_ext, g, jb, kb, scal, sub, s, rf,
                     cf, out, cap, ChoiceOut{}, sync);
  }
}

// The direct engine's choice-capture sweep over the whole tile table in one
// launch, as slab_persistent sweeps it (next_tile 0, done one -1 a tile).
__global__ void __launch_bounds__(kThreads)
    choices_persistent(const int* __restrict__ a_ext,
                       const int* __restrict__ b_ext,
                       const int* __restrict__ c_ext, SlabGeom g, int chunk,
                       const int* __restrict__ scal,
                       const int* __restrict__ sub, StepScoring s, int* rf,
                       int* cf, int* __restrict__ out, ChoiceOut co,
                       int* next_tile, int* done) {
  extern __shared__ int smem[];
  const int tb = g.hb - 1, tc = g.wc - 1, nq = g.la + tb + tc;
  const int first = g.variant == kPin ? 0 : 1;
  for (;;) {
    const int t = take_tile(next_tile);
    if (t >= g.n_jb * g.n_kb) return;
    int jb, kb;
    table_tile(t, g.n_jb, g.n_kb, jb, kb);
    int* me = done + jb * g.n_kb + kb;
    PlaneWait sync(me, jb > 0 ? me - g.n_kb : nullptr,
                   kb > 0 ? me - 1 : nullptr, tb, tc, nq, chunk, first);
    slab_tile<true>(smem, a_ext, b_ext, c_ext, g, jb, kb, scal, sub, s, rf,
                    cf, out, nullptr, co, sync);
  }
}

bool valid(const SlabGeom& g, const StepScoring& s) {
  return g.variant >= kFree && g.variant <= kBwd && s.nsym >= 0 &&
         s.nsym <= kSlabMaxSym && g.n_jb >= 1 && g.n_kb >= 1;
}

cudaError_t persistent_per_sm(int hb, int wc, int* per_sm) {
  const size_t smem = shared_bytes(hb, wc);
  cudaError_t err = cudaFuncSetAttribute(
      slab_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, slab_persistent,
                                                       kThreads, smem);
}

int launch_persistent(const int* a, const int* b, const int* c,
                      const SlabGeom& g, const RunEntry* run, int ntiles,
                      int chunk, int max_blocks, const int* scal,
                      const int* sub, StepScoring s, int* rf, int* cf,
                      int* out, int* cap, int* next_tile, int* done,
                      cudaStream_t stream) {
  if (!valid(g, s) || chunk < 1 || max_blocks < 0 || ntiles < 1 ||
      (run == nullptr && ntiles != g.n_jb * g.n_kb) ||
      ntiles > g.n_jb * g.n_kb || (uintptr_t)run % sizeof(int4) != 0)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, blocks = 0;
  cudaError_t err = persistent_per_sm(g.hb, g.wc, &per_sm);
  if (err == cudaSuccess)
    err = persistent_grid(per_sm, ntiles, max_blocks, &blocks);
  if (err != cudaSuccess) return (int)err;
  slab_persistent<<<blocks, kThreads, shared_bytes(g.hb, g.wc), stream>>>(
      a, b, c, g, run, ntiles, chunk, scal, sub, s, rf, cf, out, cap,
      next_tile, done);
  return (int)cudaGetLastError();
}

cudaError_t choices_per_sm(int hb, int wc, int* per_sm) {
  const size_t smem = choices_shared_bytes(hb, wc);
  cudaError_t err = cudaFuncSetAttribute(
      choices_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, choices_persistent, kThreads, smem);
}

int launch_choices(const int* a, const int* b, const int* c,
                   const SlabGeom& g, int chunk, const int* scal,
                   const int* sub, StepScoring s, int* rf, int* cf, int* out,
                   const ChoiceOut& co, int* next_tile, int* done,
                   cudaStream_t stream) {
  if (!valid(g, s) || g.variant == kBwd || chunk < 1 || co.lb < 0 ||
      co.lc < 0 || co.lb > g.n_jb * (g.hb - 1) ||
      co.lc > g.n_kb * (g.wc - 1) || g.la + co.lb + co.lc < 1)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, blocks = 0;
  cudaError_t err = choices_per_sm(g.hb, g.wc, &per_sm);
  if (err == cudaSuccess)
    err = persistent_grid(per_sm, g.n_jb * g.n_kb, 0, &blocks);
  if (err != cudaSuccess) return (int)err;
  choices_persistent<<<blocks, kThreads, choices_shared_bytes(g.hb, g.wc),
                       stream>>>(a, b, c, g, chunk, scal, sub, s, rf, cf, out,
                                 co, next_tile, done);
  return (int)cudaGetLastError();
}

int launch(const int* a, const int* b, const int* c, const SlabGeom& g, int d,
           int jb_lo, int ntiles, const int* scal, const int* sub,
           StepScoring s, int* rf, int* cf, int* out, int* cap,
           cudaStream_t stream) {
  const int lo = d - (g.n_kb - 1) > 0 ? d - (g.n_kb - 1) : 0;
  const int hi = d < g.n_jb - 1 ? d : g.n_jb - 1;
  if (d < 0 || ntiles < 1 || jb_lo < lo || jb_lo + ntiles - 1 > hi ||
      !valid(g, s))
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(g.hb, g.wc);
  cudaError_t err = cudaFuncSetAttribute(
      slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  slab_kernel<<<ntiles, kThreads, smem, stream>>>(
      a, b, c, g, d, jb_lo, scal, sub, s, rf, cf, out, cap);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace trialign

extern "C" {

// Shared memory one tile's thread block takes at tile plane hb x wc.
int trialign_slab_shared_bytes(int hb, int wc) {
  return (int)trialign::shared_bytes(hb, wc);
}

// K5's per-tile form as it was, for comparison: launch tiles (jb_lo ..
// jb_lo + ntiles - 1, d - jb) of tile anti-diagonal d on `stream`.  a: A_i
// at index i for 0 <= i <= |A| (index 0 a sentinel); b: n_jb * tb + 1 symbols (B_j at index j), c likewise with
// n_kb * tc + 1; scal: (n_jb * n_kb, 16) ints, one row per tile (row
// jb * n_kb + kb), whose columns 13 and 14 name the tile's row- and
// column-face slabs; rf: 7 * wc ints a row, nrows rows a slab; cf: 7 * hb
// ints a row, nrows rows a slab; out: 7 ints, written by the forward
// variants' target tile; cap: (n_jb * n_kb, 7, hb, wc) ints, each tile's
// entries written.  A tile runs after its upper and left neighbours on one
// stream, or after an event that orders them.  Returns cudaGetLastError()
// (or the error of cudaFuncSetAttribute).
int trialign_slab_tiles(const int* a, const int* b, const int* c,
                        trialign::SlabGeom g, int d, int jb_lo, int ntiles,
                        const int* scal, const int* sub,
                        trialign::StepScoring s, int* rf, int* cf, int* out,
                        int* cap, void* stream) {
  return trialign::launch(a, b, c, g, d, jb_lo, ntiles, scal, sub, s, rf, cf,
                          out, cap, (cudaStream_t)stream);
}

// Launch K5 as one persistent launch on `stream`: arrays as
// trialign_slab_tiles takes them, on a state whose scal names tile (jb,
// kb)'s faces by its column and row.  run == nullptr: the whole grid on a
// fresh state (ntiles = n_jb * n_kb).  Otherwise run holds ntiles entries of
// 4 ints (jb, kb, up, left), up and left the entries of the tile's
// neighbours within the run (earlier entries) or -1; a neighbour outside the
// run must have been swept by a launch ordered before this one (the same
// stream, or an event); run is 16-byte aligned.  chunk: local planes
// between two handshakes (>= 1); max_blocks: caps the grid (0: as many
// blocks as the SMs hold at once); next_tile: 1 int, 0; done: ntiles ints,
// -1.  A wait past the watchdog traps (csrc/schedule.cuh).  Returns
// cudaGetLastError() (or the error of the occupancy query).
int trialign_slab_sweep(const int* a, const int* b, const int* c,
                        trialign::SlabGeom g, const int* run, int ntiles,
                        const int* scal, const int* sub,
                        trialign::StepScoring s, int* rf, int* cf, int* out,
                        int* cap, int chunk, int max_blocks, int* next_tile,
                        int* done, void* stream) {
  return trialign::launch_persistent(
      a, b, c, g, reinterpret_cast<const trialign::RunEntry*>(run), ntiles,
      chunk, max_blocks, scal, sub, s, rf, cf, out, cap, next_tile, done,
      (cudaStream_t)stream);
}

// The direct engine's choice-capture sweep (traceback/direct.py choices) as
// one persistent launch on `stream`: arrays as trialign_slab_sweep takes them
// for the whole grid (variant "free", "free_jk" or "pin"; scal's final-cell
// target is (|B|, |C|), which may be 0), no capture.  lo and hi: the packed
// buffers, (la + lb + lc) rows of (lb + 1) * (lc + 1) entries, each cuboid
// slot (0 <= i <= la on plane q >= 1) written; the rest is left as it was.
// out: the 7 values at (la, lb, lc).  next_tile: 1 int, 0; done: n_jb * n_kb
// ints, -1.  Returns cudaGetLastError() (or the error of the occupancy
// query).
int trialign_slab_choices(const int* a, const int* b, const int* c,
                          trialign::SlabGeom g, const int* scal,
                          const int* sub, trialign::StepScoring s, int* rf,
                          int* cf, int* out, int16_t* lo, uint8_t* hi, int lb,
                          int lc, int chunk, int* next_tile, int* done,
                          void* stream) {
  return trialign::launch_choices(a, b, c, g, chunk, scal, sub, s, rf, cf,
                                  out, trialign::ChoiceOut{lo, hi, lb, lc},
                                  next_tile, done, (cudaStream_t)stream);
}

// Blocks of the persistent slab sweep one SM holds at tile plane hb x wc,
// into *per_sm.  Returns a CUDA error code.
int trialign_slab_blocks_per_sm(int hb, int wc, int* per_sm) {
  return (int)trialign::persistent_per_sm(hb, wc, per_sm);
}

}  // extern "C"
