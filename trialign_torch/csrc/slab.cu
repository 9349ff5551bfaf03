// K5: the slab sweep of alignment recovery, with capture of the plane
// i = |A|; and the direct engine's choice-capture sweep.
//
// Replaces trialign/kernels/slab.py:_slab_sweep as launched by
// make_slab_grid_call and by make_slab_block_call.  It is K3's tiled sweep
// (csrc/blocked.cu: tiles of tb x tc cells with a one-cell halo, faces in
// skewed global slabs, the whole grid in one persistent launch) on the same
// register step (csrc/pillar_warp.cuh, its SLAB, WALLS and BWD modes), plus
// three things the Hirschberg split needs:
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
//   cuboid, and start at plane 0, where the origin lies.
// * A backward step, keyed by source state: E_u is the u-shifted plane's
//   value of state u plus u's substitution at this cell, and value_t =
//   max_u E_u + W[u][t] (engine.py:238-273).  Every computed value is
//   clamped at NEG, as the engine clamps, so captured cells equal it bit for
//   bit.
//
// Bound on the card: the integer add/max step, as K3's (about 70 operations
// a cell forward, four shuffles; the backward cell takes each target's
// grouped max over seven sources, about 1.4 times the forward's); the
// capture adds one write of 7 ints for each position of the i = |A| plane.
// On the shared-memory plane ring this sweep ran before, a cell read 43
// values from shared memory, a barrier ended each plane and the ~117 KB
// ring held one block to an SM.
//
// Whole-grid sweep and per-tile form: one persistent launch
// (slab_persistent) for the whole tile table or for a run of it the host
// lists as (jb, kb, up, left) entries, as K3's (csrc/blocked.cu): any run
// of the tile table, or a band of rows of a stripe's columns
// (trialign/kernels/slab.py make_slab_block_call, which the halo-sharded
// traceback runs one block a call).  A neighbour outside the run was swept
// by an earlier launch and reads as finished.  Tile indices are always
// global, so borders, the variant's fill, the target tile and the symbols
// are decided as in the whole sweep; the scalar table (kernels/slab.py
// _scal_table) names tile (jb, kb)'s face slabs kb and jb (columns 13, 14),
// its final-cell target (3-5) and the origin vector (6-12).  A tile is one
// sub-tile of the register step (kernels/slab.py refuses a larger plane),
// and the progress words and chunks follow K3's schedule
// (kernels/blocked.py schedule): a word a strip where the launch is bound
// by its ramp, one a tile where the step rate binds.
//
// The direct engine's choice-capture sweep (choices_persistent, entry
// trialign_slab_choices) replaces trialign/traceback/direct.py:_choices_seg,
// which is XLA in the JAX package (a jitted lax.scan a segment of planes),
// not a pallas_call.  It sweeps the whole tile grid as K5 does, on a plane
// ring in shared memory (slab_tile): every cell with 0 <= i <= |A| on a
// plane q >= 1 steps with cell_step_choices (csrc/plane_step.cuh), which
// also returns each target's argmax over its seven sources, and writes the
// 21 bits to the caller's packed buffers (3 bits a matrix: matrices 0-4
// into an int16, 5-6 into a byte, row q - 1, (j, k) at j * (|C| + 1) + k,
// 64-bit offsets).  A target with no predecessor (j < dj or k < dk) chooses
// 0.  M's choice is the argmax of the seven stored values at
// (i-1, j-1, k-1), so a ring of 4 byte planes carries the argmax of max7
// beside it, taken after the walls.  Cells whose value a wall fixes (the
// j = 0 / k = 0 faces and i = 0 of "free" and "free_jk") still step, for
// their choices, which is why the sweep visits i = 0 in every variant.
// Bound: the step's 88 int32 operations a cell (six targets by seven
// sources, ungrouped, since the argmax needs every source: 42 adds of a
// weight and 36 max-with-argmax steps; 3 pair-score adds; M's add and the 6
// steps of max7 with its argmax), the count chip_smoke.py's bound uses, and
// the 3 B a cell it writes, 3.2 GB at 1024^3, in short rows of a tile's
// width.  Before each chunk of planes a tile waits until its upper
// neighbour has finished plane q1 - 1 + tb and its left neighbour plane
// q1 - 1 + tc (capped at the last plane, csrc/schedule.cuh PlaneWait), the
// rule of kernels/blocked.py planes_needed.
//
// The choice sweep's ring: the tile plane carries a guard row and column
// (index -1) that are set to the variant's fill and never written, so an
// edge cell's predecessor outside the cuboid reads NEG without a branch.
// The ring (3 generations of 7 planes and 4 generations of max7 and of its
// argmax) starts at the value every cell has below its first plane: 0
// ("free"), 0 on the j = 0 / k = 0 faces and NEG elsewhere ("free_jk"), NEG
// ("pin").  A position is written only on planes where its i is in
// [0, |A|]; "pin" starts at plane 0, where each tile's corner holds i = 0.
// The faces carry every written position of the bottom row and right
// column, so a neighbour reads only face rows that were written, and no
// slab needs initialising.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "warp_sweep.cuh"

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

// Columns of a row of the per-block scalar table (trialign_torch/kernels/
// slab.py _scal_table): la, jb, kb, qstar, jlstar, klstar, ev[7], row-face
// slab, column-face slab, pad.
constexpr int kScalCols = 16;
constexpr int kRingPlanes = 3 * kNumMatrices + 4;
// Threads of a choice sweep's tile.
constexpr int kThreads = 512;

// Entry of a run's table, as csrc/blocked.cu RunEntry: (jb, kb, up, left).
using RunEntry = int4;

// Tile t of a K5 launch as the register step takes it: the whole grid in
// table order (run == nullptr) or entry t of run; its symbols, face slabs,
// capture plane and progress words (kMaxStrips a tile, one a strip if
// strip_words, else the first alone), and the variant's target, fill and
// origin.
__device__ __forceinline__ WarpTile slab_warp_tile(
    const SlabGeom& g, const RunEntry* run, int t, const int* a,
    const int* b, const int* c, const int* scal, int* rf, int* cf, int* out,
    int* cap, int* done, bool strip_words) {
  int jb, kb, me, up, left;
  if (run != nullptr) {
    const RunEntry e = run[t];
    jb = e.x;
    kb = e.y;
    me = t;
    up = e.z;
    left = e.w;
  } else {
    table_tile(t, g.n_jb, g.n_kb, jb, kb);
    me = jb * g.n_kb + kb;
    up = jb > 0 ? me - g.n_kb : -1;
    left = kb > 0 ? me - 1 : -1;
  }
  const int tb = g.hb - 1, tc = g.wc - 1, blk = jb * g.n_kb + kb;
  const int* row = scal + (size_t)blk * kScalCols;
  WarpTile w;
  w.a = a;
  w.b = b + jb * tb;
  w.c = c + kb * tc;
  // Face slabs: row faces [n_kb][nrows][7][wc], column faces
  // [n_jb][nrows][7][hb].
  w.rface = rf + (size_t)row[13] * g.nrows * kNumMatrices * g.wc;
  w.cface = cf + (size_t)row[14] * g.nrows * kNumMatrices * g.hb;
  w.out = out;
  w.done = done + (size_t)me * kMaxStrips;
  w.up = up >= 0 ? done + (size_t)up * kMaxStrips : nullptr;
  w.left = left >= 0 ? done + (size_t)left * kMaxStrips : nullptr;
  w.la = g.la;
  w.hb = g.hb;
  w.wc = g.wc;
  w.j0 = 0;
  w.k0 = 0;
  w.tb = tb;
  w.tc = tc;
  w.bmax = tb;
  w.cmax = tc;
  w.jlstar = row[4];
  w.klstar = row[5];
  w.target = row[3] >= 0 && g.variant != kBwd;
  w.has_row = jb > 0;
  w.has_col = kb > 0;
  w.cap = cap + (size_t)blk * kNumMatrices * g.hb * g.wc;
  w.ev = row + 6;
  w.fill = g.variant == kFree ? 0 : kNeg;
  w.origin = jb == 0 && kb == 0;
  w.strip_words = strip_words;
  return w;
}

// The tile table in one launch: the whole grid in table order (run ==
// nullptr, ntiles = n_jb * n_kb), or the ntiles entries of run, in which
// every neighbour of the run comes before its tile.  next_tile: the hand-out
// counter (0); done: kMaxStrips progress words a tile (-1), at row
// jb * n_kb + kb of the whole grid or the entry of the run.  WALLS: "pin"
// and "bwd"; BWD: "bwd"; strip_words: a progress word a strip, else the
// tile's first word alone.  Two blocks an SM: 8 strips of 4 columns, 128
// registers a thread, as K3.
template <bool SUB, bool RTL, bool WALLS, bool BWD>
__global__ void __launch_bounds__(32 * kMaxStrips, 2)
    slab_persistent(const int* __restrict__ a_ext,
                    const int* __restrict__ b_ext,
                    const int* __restrict__ c_ext, SlabGeom g,
                    const RunEntry* __restrict__ run, int ntiles, int chunk,
                    bool strip_words, const int* __restrict__ scal,
                    const int* __restrict__ sub, StepScoring s, int* rf,
                    int* cf, int* out, int* __restrict__ cap, int* next_tile,
                    int* done) {
  extern __shared__ int4 smem4[];
  const int W = blockDim.x >> 5;
  int4* ring = smem4;
  int4* stage = ring + (size_t)(W - 1) * (2 * chunk + 1) * kRingRows;
  int* sub_s =
      reinterpret_cast<int*>(stage + (size_t)W * chunk * (3 * kStrip + 1));
  load_sub_table(sub, s.nsym, sub_s);
  const Charges K{-2 * s.gap_open, -2 * s.gap_extend,
                  -(s.gap_open + s.gap_extend), -s.gap_open, -s.gap_extend};
  __shared__ int tile;
  for (;;) {
    if (threadIdx.x == 0) tile = atomicAdd(next_tile, 1);
    __syncthreads();  // also orders sub_s
    if (tile >= ntiles) return;
    warp_pillar<SUB, RTL, false, false, false, false, true, WALLS, BWD>(
        slab_warp_tile(g, run, tile, a_ext, b_ext, c_ext, scal, rf, cf, out,
                       cap, done, strip_words),
        ring, stage, sub_s, s, K, chunk);
    // The rings and staging buffers serve the next tile; thread 0 takes it
    // after this barrier.
    __syncthreads();
  }
}

using SweepFn = void (*)(const int*, const int*, const int*, SlabGeom,
                         const RunEntry*, int, int, bool, const int*,
                         const int*, StepScoring, int*, int*, int*, int*,
                         int*, int*);

// The sweeps K5 is built in: a kind of variant (0 "free" and "free_jk", 1
// "pin", 2 "bwd") by a scoring mode (bit 0 rtl, bit 1 submatrix).
constexpr int kKinds = 3, kModes = 4;

int kind_of(int variant) {
  return variant == kBwd ? 2 : variant == kPin ? 1 : 0;
}

template <bool WALLS, bool BWD>
SweepFn pick_mode(int mode) {
  switch (mode) {
    case 0: return slab_persistent<false, false, WALLS, BWD>;
    case 1: return slab_persistent<false, true, WALLS, BWD>;
    case 2: return slab_persistent<true, false, WALLS, BWD>;
    case 3: return slab_persistent<true, true, WALLS, BWD>;
  }
  return nullptr;
}

// The sweep and its block for a variant and scoring mode at tile plane
// hb x wc and chunk (false for a variant K5 does not know or a plane past
// one sub-tile).
bool plan(int variant, int mode, int hb, int wc, int chunk, SweepFn* fn,
          int* threads, size_t* smem) {
  if (variant < kFree || variant > kBwd || mode < 0 || mode >= kModes ||
      hb - 1 > kSubRows || wc - 1 > kSubCols)
    return false;
  switch (kind_of(variant)) {
    case 0: *fn = pick_mode<false, false>(mode); break;
    case 1: *fn = pick_mode<true, false>(mode); break;
    default: *fn = pick_mode<true, true>(mode);
  }
  return *fn != nullptr &&
         sweep_block(hb, wc, chunk, (mode & 2) != 0, threads, smem);
}

int step_mode(const StepScoring& s) {
  return (s.rtl ? 1 : 0) | (s.nsym ? 2 : 0);
}

// Blocks an SM of each sweep at each chunk and strip count, on each of the
// first kCachedDevices devices (0: not asked yet), as csrc/blocked.cu
// keeps K3's: asked once, each sweep allowed the shared memory of the
// largest block (8 strips, the longest chunk) before the first query.
constexpr int kCachedDevices = 16;
std::atomic<int> g_per_sm[kCachedDevices][kKinds][kModes][kMaxChunk + 1]
                         [kMaxStrips + 1];

cudaError_t cached_per_sm(SweepFn fn, int variant, int mode, int chunk,
                          int threads, size_t smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* slot =
      dev < kCachedDevices
          ? &g_per_sm[dev][kind_of(variant)][mode][chunk][threads / 32]
          : nullptr;
  *blocks = slot != nullptr ? slot->load(std::memory_order_relaxed) : 0;
  if (*blocks > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)warp_pillar_shared_bytes(kMaxStrips, kMaxChunk, (mode & 2) != 0));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                        smem);
  if (err == cudaSuccess && slot != nullptr)
    slot->store(*blocks, std::memory_order_relaxed);
  return err;
}

int launch_persistent(const int* a, const int* b, const int* c,
                      const SlabGeom& g, const RunEntry* run, int ntiles,
                      int chunk, int max_blocks, const int* scal,
                      const int* sub, StepScoring s, int* rf, int* cf,
                      int* out, int* cap, int* next_tile, int* done,
                      bool strip_words, cudaStream_t stream) {
  SweepFn fn = nullptr;
  int threads = 0, per_sm = 0, blocks = 0;
  size_t smem = 0;
  const int mode = step_mode(s);
  if (s.nsym < 0 || s.nsym > kMaxSym || g.n_jb < 1 || g.n_kb < 1 ||
      max_blocks < 0 || ntiles < 1 ||
      (run == nullptr && ntiles != g.n_jb * g.n_kb) ||
      ntiles > g.n_jb * g.n_kb || (uintptr_t)run % sizeof(int4) != 0 ||
      !plan(g.variant, mode, g.hb, g.wc, chunk, &fn, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cached_per_sm(fn, g.variant, mode, chunk, threads, smem, &per_sm);
  if (err == cudaSuccess)
    err = persistent_grid(per_sm, ntiles, max_blocks, &blocks);
  if (err != cudaSuccess) return (int)err;
  fn<<<blocks, threads, smem, stream>>>(a, b, c, g, run, ntiles, chunk,
                                        strip_words, scal, sub, s, rf, cf,
                                        out, cap, next_tile, done);
  return (int)cudaGetLastError();
}

// Where the choice-capture sweep writes: packed_lo and packed_hi of
// traceback/direct.py, (|A| + |B| + |C|, (|B| + 1)(|C| + 1)) each; row q - 1
// holds plane q, (j, k) at j * (|C| + 1) + k.
struct ChoiceOut {
  int16_t* lo;  // choices of matrices 0-4, 3 bits each
  uint8_t* hi;  // matrices 5 and 6
  int lb, lc;   // |B|, |C|
};

// Shared memory of a tile's block: the guarded ring, the tile's B and C
// symbols and, under a submatrix (`sub`), its table.
size_t shared_bytes(int hb, int wc, bool sub) {
  return sizeof(int) * ((size_t)kRingPlanes * (hb + 1) * (wc + 1) + hb + wc +
                         sub_table_ints(sub));
}

// The choice-capture sweep's shared memory: the ring's, and 4 generations
// of one byte plane, the argmax of max7.
size_t choices_shared_bytes(int hb, int wc, bool sub) {
  return shared_bytes(hb, wc, sub) + (size_t)4 * (hb + 1) * (wc + 1);
}

// Sweeps tile (jb, kb) of the choice-capture sweep on the plane ring,
// waiting and publishing through `sync` (csrc/schedule.cuh).  The last
// branch of the cell, the forward step with "pin"'s walls that K5 took on
// this ring, is reached by no cell: every cell but the origin takes the
// choice step.  It stays because the sweep built without it took 90
// registers a thread instead of 97 and ran 6.5% slower on an H100 (PERF.md
// section 6); it goes with the ring (ROADMAP queue 2).
__device__ __forceinline__ void slab_tile(
    int* smem, const int* __restrict__ a_ext, const int* __restrict__ b_ext,
    const int* __restrict__ c_ext, const SlabGeom& g, int jb, int kb,
    const int* __restrict__ scal, const int* __restrict__ sub,
    const StepScoring& s, int* rf, int* cf, int* __restrict__ out,
    const ChoiceOut& co, PlaneWait& sync) {
  const int hb = g.hb, wc = g.wc, tb = hb - 1, tc = wc - 1;
  // Guarded plane: position (jl, kl) at (jl + 1) * W1 + kl + 1, jl, kl >= -1.
  const int W1 = wc + 1, PG = (hb + 1) * W1;
  int* planes = smem;                         // [3 slots][7][PG]
  int* m4 = planes + 3 * kNumMatrices * PG;   // [4 slots][PG]
  int* bsym = m4 + 4 * PG;                    // [hb]
  int* csym = bsym + hb;                      // [wc]
  // [4 slots][PG], the argmax of each max7 in m4.
  uint8_t* a4 = reinterpret_cast<uint8_t*>(csym + wc);
  int* sub_s = csym + wc + PG;  // [kSubTable], sub only
  const int blk = jb * g.n_kb + kb;
  const int* row = scal + (size_t)blk * kScalCols;
  const int la = g.la, qstar = row[3], jlstar = row[4], klstar = row[5];
  const int variant = g.variant;
  const bool walls = variant == kPin || variant == kBwd;

  for (int x = threadIdx.x; x < kRingPlanes * PG; x += kThreads) {
    const int pos = x % PG;
    const int jl = pos / W1 - 1, kl = pos % W1 - 1;
    const bool border = (jb == 0 && jl == 0) || (kb == 0 && kl == 0);
    planes[x] = variant == kFree || (variant == kFreeJk && border) ? 0 : kNeg;
  }
  for (int x = threadIdx.x; x < 4 * PG; x += kThreads) a4[x] = 0;
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
  const int nq = la + tb + tc;
  const int npos = hb * wc;
  // One row of the packed buffers a global plane, 64-bit offsets.
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
      // Cells with i = 0 step too, in every variant, for the choices the
      // walk may read.
      if (i < 0 || i > la) continue;
      const int c = (jl + 1) * W1 + kl + 1;
      const int gj = jb * tb + jl, gk = kb * tc + kl;
      int v[kNumMatrices];
      int word = -1;  // the cell's choices, where this tile owns it
      if (jl == 0 && jb > 0) {
        // Halo row from the row face; it wins at the corner.
        const int* src = rface + q * rrow + kl;
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = sync.load(src + t * wc);
      } else if (kl == 0 && kb > 0) {
        const int* src = cface + q * crow + jl;
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = sync.load(src + t * hb);
      } else if (i + gj + gk > 0) {
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
        // The origin of "pin" (only tile (0, 0) reaches here).
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = row[6 + t];
      } else {
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
      }

      // max7 and its first argmax, of the stored values.
      int m = v[0], am = 0;
#pragma unroll
      for (int t = 0; t < kNumMatrices; ++t) {
        cur[t * PG + c] = v[t];
        if (v[t] > m) {
          m = v[t];
          am = t;
        }
      }
      m4cur[c] = m;
      a4cur[c] = (uint8_t)am;
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
      if (q == qstar && jl == jlstar && kl == klstar) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) out[t] = v[t];
      }
      if (word >= 0 && gj <= co.lb && gk <= co.lc) {
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

// The direct engine's choice-capture sweep over the whole tile table in one
// launch: blocks take tiles in table order from next_tile (0); done holds
// one progress word a tile (-1).
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
    slab_tile(smem, a_ext, b_ext, c_ext, g, jb, kb, scal, sub, s, rf, cf,
              out, co, sync);
  }
}

cudaError_t choices_per_sm(int hb, int wc, bool sub, int* per_sm) {
  const size_t smem = choices_shared_bytes(hb, wc, sub);
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
  if (g.variant < kFree || g.variant > kPin || s.nsym < 0 ||
      s.nsym > kMaxSym || g.n_jb < 1 || g.n_kb < 1 || chunk < 1 ||
      co.lb < 0 || co.lc < 0 || co.lb > g.n_jb * (g.hb - 1) ||
      co.lc > g.n_kb * (g.wc - 1) || g.la + co.lb + co.lc < 1)
    return (int)cudaErrorInvalidValue;
  const bool table = s.nsym != 0;
  int per_sm = 0, blocks = 0;
  cudaError_t err = choices_per_sm(g.hb, g.wc, table, &per_sm);
  if (err == cudaSuccess)
    err = persistent_grid(per_sm, g.n_jb * g.n_kb, 0, &blocks);
  if (err != cudaSuccess) return (int)err;
  choices_persistent<<<blocks, kThreads,
                       choices_shared_bytes(g.hb, g.wc, table), stream>>>(
      a, b, c, g, chunk, scal, sub, s, rf, cf, out, co, next_tile, done);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace trialign

extern "C" {

// Shared memory one tile's thread block of the choice sweep takes at tile
// plane hb x wc under a submatrix of nsym symbols (0: match/mismatch).
int trialign_slab_shared_bytes(int hb, int wc, int nsym) {
  return (int)trialign::choices_shared_bytes(hb, wc, nsym != 0);
}

// Launch K5 as one persistent launch on `stream`.  a: A_i at index i for
// 0 <= i <= |A| (index 0 a sentinel); b: n_jb * tb + 1 symbols (B_j at
// index j), c likewise with n_kb * tc + 1; scal: (n_jb * n_kb, 16) ints, one
// row per tile (row jb * n_kb + kb), whose columns 13 and 14 name the
// tile's row- and column-face slabs, its column and row; rf: 7 * wc ints a
// row, nrows rows a slab; cf: 7 * hb ints a row, nrows rows a slab; out: 7
// ints, written by the forward variants' target tile; cap: (n_jb * n_kb, 7,
// hb, wc) ints, each tile's entries written.  run == nullptr: the whole
// grid on a fresh state (ntiles = n_jb * n_kb).  Otherwise run holds
// ntiles entries of 4 ints (jb, kb, up, left), up and left the entries of
// the tile's neighbours within the run (earlier entries) or -1; a neighbour
// outside the run must have been swept by a launch ordered before this one
// (the same stream, or an event); run is 16-byte aligned.  chunk: local
// planes between two handshakes (1 .. kMaxChunk); max_blocks: caps the grid
// (0: as many blocks as the SMs hold at once); next_tile: 1 int, 0; done:
// kMaxStrips ints a tile, -1; strip_words: a progress word a strip, else
// one a tile; the tile plane at most 33 x 33.  A wait past the watchdog
// traps (csrc/schedule.cuh).  Returns cudaGetLastError() (or the error of
// the occupancy query).
int trialign_slab_sweep(const int* a, const int* b, const int* c,
                        trialign::SlabGeom g, const int* run, int ntiles,
                        const int* scal, const int* sub,
                        trialign::StepScoring s, int* rf, int* cf, int* out,
                        int* cap, int chunk, int max_blocks, int* next_tile,
                        int* done, int strip_words, void* stream) {
  return trialign::launch_persistent(
      a, b, c, g, reinterpret_cast<const trialign::RunEntry*>(run), ntiles,
      chunk, max_blocks, scal, sub, s, rf, cf, out, cap, next_tile, done,
      strip_words != 0, (cudaStream_t)stream);
}

// What K5's sweep of variant `variant` under scoring mode `mode` (bit 0
// rtl, bit 1 a submatrix) takes at tile plane hb x wc and chunk: into
// out[0..4] its registers a thread, local (spill) bytes a thread, threads
// and shared bytes a block, and blocks an SM.  Returns a CUDA error code.
int trialign_slab_resources(int hb, int wc, int chunk, int mode, int variant,
                            int* out) {
  trialign::SweepFn fn = nullptr;
  int threads = 0;
  size_t smem = 0;
  if (!trialign::plan(variant, mode, hb, wc, chunk, &fn, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = trialign::cached_per_sm(fn, variant, mode, chunk, threads, smem,
                                  &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = threads;
  out[3] = (int)smem;
  out[4] = blocks;
  return 0;
}

// The direct engine's choice-capture sweep (traceback/direct.py choices) as
// one persistent launch on `stream`: arrays as trialign_slab_sweep takes them
// for the whole grid (variant "free", "free_jk" or "pin"; scal's final-cell
// target is (|B|, |C|), which may be 0), no capture.  lo and hi: the packed
// buffers, (la + lb + lc) rows of (lb + 1) * (lc + 1) entries, each cuboid
// slot (0 <= i <= la on plane q >= 1) written; the rest is left as it was.
// out: the 7 values at (la, lb, lc).  chunk: local planes between two
// handshakes (>= 1); next_tile: 1 int, 0; done: n_jb * n_kb ints, -1.
// Returns cudaGetLastError() (or the error of the occupancy query).
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

}  // extern "C"
