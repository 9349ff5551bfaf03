// K3: the blocked (sliced) sweep for triplets past the wavefront's caps, its
// per-tile form and its chain mode.
//
// Replaces trialign/kernels/blocked.py:_block_sweep as launched by
// make_grid_call (kernel _make_grid_kernel, chain mode included through the
// 13-tuple dims of plan_dims_packed) and by make_block_call (one block a
// call, for checkpoint.py and the halo's stripes).  The tile step is the
// register step of K4 and K2 (csrc/pillar_warp.cuh), chain borders included.
//
// Bound on the card: the int32 max/add rate of the SMs (about 70 operations
// a cell, four shuffles), as long as the tile table keeps every SM's blocks
// busy, and the grid by how many tiles run at once, since tile (jb, kb)
// needs the faces of (jb-1, kb) and (jb, kb-1).  On v5e the grid ran one
// tile after another on one core with the planes in VMEM.
//
// Design: a problem's tiles form a table in anti-diagonal order (diag
// ascending, then jb ascending).  The whole-grid sweep (and chain mode) is
// one persistent launch (blocked_persistent): as many blocks as the SMs hold
// at once, each taking the next tile of the table from a global counter and
// sweeping its pillar to the end before it takes another.  A tile is one
// sub-tile of the register step, at most 32 x 32 cells (the default 33 x 33
// tile plane; kernels/blocked.py refuses a larger one): a warp a strip of
// four tile columns, at most 8 warps, a lane a tile row, and no barrier
// spans the block inside it.  A tile advances chunk by chunk of planes as
// soon as its neighbours have finished the planes whose face rows the chunk
// reads (csrc/schedule.cuh PlaneWait, the rule kernels/blocked.py
// planes_needed states and the CPU tests model).  A tile has a progress
// word a strip (SW, K2's), so that strip w waits for strip w of the upper
// tile and strip 0 for the left tile's last strip, a lag of about a tile
// height and a chunk a tile diagonal, or one word, published by the last
// strip, which adds the W - 1 chunks by which a tile's strips trail each
// other but spares each strip's fence.  The host picks by the launch's
// waves, its tiles over the blocks the card holds at once
// (kernels/blocked.py schedule): a word a strip where the ramp binds, one a
// tile where the step rate does.  Chain mode, which runs in no cell of the
// benchmark, takes one word a tile, which keeps the build to 24 sweeps.
// The per-tile form is the same launch over a run of tiles that the host
// lists in a table of (jb, kb, up, left) entries, up and left being the
// entries of the tile's neighbours within the run or -1: any run of the
// tile table, which may end mid-diagonal (checkpoint.py), or a band of rows
// of a stripe's columns (the halo, dist/halo.py).  A neighbour outside the
// run was swept by an earlier launch, ordered before this one by the stream
// or an event, and reads as finished; the progress words are the launch's
// own.  The face slabs and the output stay in device memory between
// launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "warp_sweep.cuh"

namespace trialign {

// Geometry of one blocked sweep; mirrors the ctypes structure in
// trialign_torch/_build.py field for field.
struct BlockedGeom {
  int la;      // swept |A|: npack * d - 1 in chain mode
  int hb;      // tile plane rows: halo row + tb cells
  int wc;      // tile plane columns: halo column + tc cells
  int n_jb;    // tile rows
  int n_kb;    // tile columns
  int nrows;   // rows of each face slab (local planes 0 .. la + tb + tc)
  int jlstar;  // final cell (|B|, |C|) in the last tile, local coordinates
  int klstar;
  int d;       // slot pitch: |A| + 1 of one slot (la + 1 for one problem)
  int npack;   // slots: rows of out
};

namespace {

// Face slabs of tile (jb, kb): row faces [n_kb][nrows][7][wc], column faces
// [n_jb][nrows][7][hb].
__device__ __forceinline__ int* row_faces(int* rf, const BlockedGeom& g,
                                          int kb) {
  return rf + (size_t)kb * g.nrows * kNumMatrices * g.wc;
}
__device__ __forceinline__ int* col_faces(int* cf, const BlockedGeom& g,
                                          int jb) {
  return cf + (size_t)jb * g.nrows * kNumMatrices * g.hb;
}

// Entry of a run's table (kernels/blocked.py RUN_FIELDS): the tile (x, y) =
// (jb, kb) and the entries of its upper and left neighbours in the run
// (z, w), or -1 for a neighbour outside the run or the grid.
using RunEntry = int4;

// Tile t of the launch: the whole grid in table order (run == nullptr) or
// entry t of run; into jb, kb its tile and into me, up, left the rows of the
// progress words of it and its neighbours (-1: none).
__device__ __forceinline__ void launch_tile(const BlockedGeom& g,
                                            const RunEntry* run, int t,
                                            int& jb, int& kb, int& me,
                                            int& up, int& left) {
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
}

// Tile t of the launch as the register step takes it: its symbols, its
// face slabs, and the progress words it waits for and publishes,
// kMaxStrips a tile (one a strip, or the first alone).
__device__ __forceinline__ WarpTile blocked_tile(
    const BlockedGeom& g, const RunEntry* run, int t, const int* a,
    const int* b, const int* c, int* rf, int* cf, int* out, int* done) {
  int jb, kb, me, up, left;
  launch_tile(g, run, t, jb, kb, me, up, left);
  const int tb = g.hb - 1, tc = g.wc - 1;
  WarpTile w;
  w.a = a;
  w.b = b + jb * tb;
  w.c = c + kb * tc;
  w.rface = row_faces(rf, g, kb);
  w.cface = col_faces(cf, g, jb);
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
  w.jlstar = g.jlstar;
  w.klstar = g.klstar;
  w.target = jb == g.n_jb - 1 && kb == g.n_kb - 1;
  w.has_row = jb > 0;
  w.has_col = kb > 0;
  return w;
}

// The tile table in one launch: the whole grid in table order (run ==
// nullptr, ntiles = n_jb * n_kb), or the ntiles entries of run, in which
// every neighbour of the run comes before its tile.  next_tile: the hand-out
// counter (0); done: kMaxStrips progress words a tile (-1), at row
// jb * n_kb + kb of the whole grid or the entry of the run.  SW: a progress
// word a strip, else the tile's first word alone.  Two blocks an SM: 8
// strips of 4 columns, 128 registers a thread.
template <bool SUB, bool RTL, bool BITS, bool CHAIN, bool SW>
__global__ void __launch_bounds__(32 * kMaxStrips, 2)
    blocked_persistent(const int* __restrict__ a_ext,
                       const int* __restrict__ b_ext,
                       const int* __restrict__ c_ext, BlockedGeom g,
                       const RunEntry* __restrict__ run, int ntiles,
                       int chunk, const int* __restrict__ sub, StepScoring s,
                       int* rf, int* cf, int* out, int* next_tile,
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
    warp_pillar<SUB, RTL, false, BITS, SW, CHAIN>(
        blocked_tile(g, run, tile, a_ext, b_ext, c_ext, rf, cf, out, done),
        ring, stage, sub_s, s, K, chunk, g.d);
    // The rings and staging buffers serve the next tile; thread 0 takes it
    // after this barrier.
    __syncthreads();
  }
}

using SweepFn = void (*)(const int*, const int*, const int*, BlockedGeom,
                         const RunEntry*, int, int, const int*, StepScoring,
                         int*, int*, int*, int*, int*);

// The sweep of a scoring mode (bit 0 rtl, bit 1 submatrix, bit 2
// score_bits) of each variant, or nullptr.
template <bool CHAIN, bool SW>
SweepFn pick_mode(int mode) {
  switch (mode) {
    case 0: return blocked_persistent<false, false, false, CHAIN, SW>;
    case 1: return blocked_persistent<false, true, false, CHAIN, SW>;
    case 2: return blocked_persistent<true, false, false, CHAIN, SW>;
    case 3: return blocked_persistent<true, true, false, CHAIN, SW>;
    case 4: return blocked_persistent<false, false, true, CHAIN, SW>;
    case 5: return blocked_persistent<false, true, true, CHAIN, SW>;
    case 6: return blocked_persistent<true, false, true, CHAIN, SW>;
    case 7: return blocked_persistent<true, true, true, CHAIN, SW>;
  }
  return nullptr;
}

// The variants K3 is built in: 0 chain mode, with one word a tile; 1 and 2
// one problem, with a word a tile or a word a strip.
constexpr int kVariants = 3;

int variant(bool chain, bool strip_words) {
  if (chain) return 0;
  return strip_words ? 2 : 1;
}

SweepFn pick(int mode, int v) {
  switch (v) {
    case 0: return pick_mode<true, false>(mode);
    case 1: return pick_mode<false, false>(mode);
    case 2: return pick_mode<false, true>(mode);
  }
  return nullptr;
}

// Blocks an SM of each variant's and mode's sweep at each chunk and strip
// count, on each of the first kCachedDevices devices (0: not asked yet).
// A small sweep's launch costs little more than the occupancy query, so it
// is asked once.  Each sweep may take the shared memory of the largest
// block (8 strips, the longest chunk), set before the first query on a
// device and never lowered, so that a cached answer stays launchable.
constexpr int kCachedDevices = 16;
std::atomic<int> g_per_sm[kCachedDevices][kVariants][8][kMaxChunk + 1]
                         [kMaxStrips + 1];

cudaError_t cached_per_sm(SweepFn fn, int v, int mode, int chunk,
                          int threads, size_t smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* slot =
      dev < kCachedDevices ? &g_per_sm[dev][v][mode][chunk][threads / 32]
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

// The sweep and its block for a scoring mode at tile plane hb x wc and
// chunk, a word a strip or a tile (false for what K3 does not take: a
// plane past one sub-tile, or a word a strip in chain mode).
bool plan(int mode, bool chain, int hb, int wc, int chunk, bool strip_words,
          int* v, SweepFn* fn, int* threads, size_t* smem) {
  if (hb - 1 > kSubRows || wc - 1 > kSubCols || (chain && strip_words))
    return false;
  *v = variant(chain, strip_words);
  *fn = pick(mode, *v);
  return *fn != nullptr &&
         sweep_block(hb, wc, chunk, (mode & 2) != 0, threads, smem);
}

int step_mode(const StepScoring& s) {
  return (s.rtl ? 1 : 0) | (s.nsym ? 2 : 0) | (s.score_bits ? 4 : 0);
}

bool valid_geom(const BlockedGeom& g) {
  return g.d >= 1 && g.npack >= 1 && g.la == g.npack * g.d - 1 &&
         g.n_jb >= 1 && g.n_kb >= 1;
}

bool valid_run(const BlockedGeom& g, const int* run, int ntiles) {
  return valid_geom(g) && ntiles >= 1 &&
         (run != nullptr || ntiles == g.n_jb * g.n_kb) &&
         ntiles <= g.n_jb * g.n_kb && (uintptr_t)run % sizeof(int4) == 0;
}

}  // namespace
}  // namespace trialign

extern "C" {

// Launch K3 as one persistent launch on `stream`.  a: A_i at index i for
// 1 <= i <= la (slot borders i = m*d in chain mode); b: n_jb * tb + 1
// symbols (B_j at index j, sentinels past |B|); c likewise with
// n_kb * tc + 1; rf: n_kb * nrows * 7 * wc ints; cf: n_jb * nrows * 7 * hb
// ints; out: 7 ints a slot, written by the last tile.  run == nullptr: the
// whole grid on a fresh state (ntiles = n_jb * n_kb).  Otherwise run holds
// ntiles entries of 4 ints (jb, kb, up, left), up and left the entries of
// the tile's neighbours within the run (earlier entries) or -1; a neighbour
// outside the run must have been swept by a launch ordered before this one
// (the same stream, or an event); run is 16-byte aligned.  chunk: local
// planes between two handshakes (1 .. kMaxChunk); max_blocks: caps the grid
// (0: as many blocks as the SMs hold at once); next_tile: 1 int, 0; done:
// kMaxStrips ints a tile, -1; strip_words: a progress word a strip (only
// outside chain mode), else one a tile; the tile plane at most 33 x 33.  A
// wait past the watchdog traps (csrc/schedule.cuh).  Returns
// cudaGetLastError() (or the error of the occupancy query).
int trialign_blocked_sweep(const int* a, const int* b, const int* c,
                           trialign::BlockedGeom g, const int* run,
                           int ntiles, const int* sub,
                           trialign::StepScoring s, int* rf, int* cf, int* out,
                           int chunk, int max_blocks, int* next_tile,
                           int* done, int strip_words, void* stream) {
  const int mode = trialign::step_mode(s);
  const bool chain = g.d != g.la + 1;
  trialign::SweepFn fn = nullptr;
  int v = 0, threads = 0, sm_blocks = 0, blocks = 0;
  size_t smem = 0;
  if (!trialign::valid_run(g, run, ntiles) || max_blocks < 0 ||
      !trialign::plan(mode, chain, g.hb, g.wc, chunk, strip_words != 0, &v,
                      &fn, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = trialign::cached_per_sm(fn, v, mode, chunk, threads, smem,
                                            &sm_blocks);
  if (err == cudaSuccess)
    err = trialign::persistent_grid(sm_blocks, ntiles, max_blocks, &blocks);
  if (err != cudaSuccess) return (int)err;
  fn<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      a, b, c, g, reinterpret_cast<const trialign::RunEntry*>(run), ntiles,
      chunk, sub, s, rf, cf, out, next_tile, done);
  return (int)cudaGetLastError();
}

// What the sweep of scoring mode `mode` (chain mode: `chain` nonzero; a
// word a strip: `strip_words` nonzero) takes at tile plane hb x wc and
// chunk: into out[0..4] its registers a thread, local (spill) bytes a
// thread, threads and shared bytes a block, and blocks an SM.  Returns a
// CUDA error code.
int trialign_blocked_resources(int hb, int wc, int chunk, int mode,
                               int chain, int strip_words, int* out) {
  trialign::SweepFn fn = nullptr;
  int v = 0, threads = 0;
  size_t smem = 0;
  if (!trialign::plan(mode, chain != 0, hb, wc, chunk, strip_words != 0, &v,
                      &fn, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = trialign::cached_per_sm(fn, v, mode, chunk, threads, smem,
                                  &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = threads;
  out[3] = (int)smem;
  out[4] = blocks;
  return 0;
}

}  // extern "C"
