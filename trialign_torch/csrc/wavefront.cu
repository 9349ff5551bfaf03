// K2: the wavefront sweep of small triplets, |B|, |C| <= 255, |A| <= 4096.
//
// Replaces trialign/kernels/wavefront.py:_make_kernel (launched by _run /
// _run_compact), which sweeps every anti-diagonal plane q = i + j + k of one
// problem's (|A|+1, |B|+1, |C|+1) cuboid with the 16 carried (hb, wc)
// planes resident in VMEM, and returns the seven final-cell values.
//
// Bound on the card: that premise does not hold here, and one problem is
// far from filling the card.  One 256 x 256 int32 plane is 256 KB, above
// the 227 KB of shared memory a block can have, and the sweep carries 16 of
// them; and an SM swept one problem's plane after plane, so a single
// triplet ran on 1 SM of 132.  K2's bound is the int32 max/add rate of the
// SMs (about 70 operations a cell), which only a launch that spreads one
// problem over many SMs can approach; at 255^3 the ramp of its tile
// diagonals keeps it far from that bound.
//
// Design (wavefront_sweep): tiles, not problems, are the unit of work.  The
// host cuts each problem's (j, k) plane into tiles of tb x tc cells (one
// sub-tile of the register step, at most 32 x 32; the default tile plane
// 33 x 33 makes 255^2 eight by eight tiles) and lists every problem's
// tiles in one table in diagonal order, the longest |A| first within a
// diagonal (csrc/warp_sweep.cuh, kernels/wavefront.py plan_tiles).  One
// persistent launch a call runs the whole table: as many blocks as the SMs
// hold at once take entries from a global counter and sweep each tile's
// pillar through its own local planes on the register step
// (csrc/pillar_warp.cuh), starting each chunk of planes once the upper and
// left tiles' progress words show the planes it reads (csrc/schedule.cuh
// PlaneWait, kernels/blocked.planes_needed; each strip of a tile waits for
// and publishes a progress word of its own, csrc/pillar_warp.cuh
// STRIP_WORDS), with the faces in L2 as K4 keeps them.  So one 255^3
// triplet runs on 64 SMs, and a padded batch of small triplets fills the
// card; a tile sweeps only its own live planes, so no cell is visited off
// its i range and no barrier spans the block.  The symbols stay in the
// caller's (n, width) arrays, read by stride; a row or column past |B| or
// |C| in a ragged last tile reads the last symbol (its cells feed no cell
// inside the problem).  score_bits is a mode of the step (BITS): each
// value wraps where it is made.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "warp_sweep.cuh"

namespace trialign {
namespace {

// Ints of one problem's out row (the seven final values and a spare).
constexpr int kOutStride = 8;

// Two blocks an SM: 8 strips of 4 columns, 128 registers a thread.
template <bool SUB, bool RTL, bool BITS>
__global__ void __launch_bounds__(32 * kMaxStrips, 2)
    wavefront_sweep(const int* __restrict__ a, const int* __restrict__ b,
                    const int* __restrict__ c,
                    const long long* __restrict__ geom,
                    const int* __restrict__ table, int count, int hb, int wc,
                    const int* __restrict__ sub, StepScoring s, int* rf,
                    int* cf, int* out, int* done, int* next_entry,
                    int chunk) {
  extern __shared__ int4 smem4[];
  const int W = blockDim.x >> 5;
  int4* ring = smem4;
  int4* stage = ring + (size_t)(W - 1) * (2 * chunk + 1) * kRingRows;
  int* sub_s =
      reinterpret_cast<int*>(stage + (size_t)W * chunk * (3 * kStrip + 1));
  load_sub_table(sub, s.nsym, sub_s);
  const Charges K{-2 * s.gap_open, -2 * s.gap_extend,
                  -(s.gap_open + s.gap_extend), -s.gap_open, -s.gap_extend};
  __shared__ int entry;
  for (;;) {
    if (threadIdx.x == 0) entry = atomicAdd(next_entry, 1);
    __syncthreads();  // also orders sub_s
    if (entry >= count) return;
    const Entry t = table_entry(a, b, c, geom, table, entry, hb, wc, rf, cf,
                                out, kOutStride, done, kMaxStrips);
    // The tile is one sub-tile; the arrays end at |B| and |C|.
    WarpTile w = sub_tile(t, hb, wc, 0, 0);
    if (t.last_row) w.bmax = t.jlstar;
    if (t.last_col) w.cmax = t.klstar;
    warp_pillar<SUB, RTL, false, BITS, true>(w, ring, stage, sub_s, s, K,
                                             chunk);
    // The rings and staging buffers serve the next tile; thread 0 takes
    // the next entry after it.
    __syncthreads();
  }
}

using SweepFn = void (*)(const int*, const int*, const int*,
                         const long long*, const int*, int, int, int,
                         const int*, StepScoring, int*, int*, int*, int*,
                         int*, int);

// The sweep of a scoring mode (bit 0 rtl, bit 1 submatrix, bit 2
// score_bits), or nullptr.
SweepFn pick(int mode) {
  switch (mode) {
    case 0: return wavefront_sweep<false, false, false>;
    case 1: return wavefront_sweep<false, true, false>;
    case 2: return wavefront_sweep<true, false, false>;
    case 3: return wavefront_sweep<true, true, false>;
    case 4: return wavefront_sweep<false, false, true>;
    case 5: return wavefront_sweep<false, true, true>;
    case 6: return wavefront_sweep<true, false, true>;
    case 7: return wavefront_sweep<true, true, true>;
  }
  return nullptr;
}

// Threads and shared bytes of a block at tile plane hb x wc (`sub`: of a
// submatrix mode), or false for a plane past one sub-tile or a chunk the
// step does not take.
bool tile_block(int hb, int wc, int chunk, bool sub, int* threads,
                size_t* smem) {
  return hb - 1 <= kSubRows && wc - 1 <= kSubCols &&
         sweep_block(hb, wc, chunk, sub, threads, smem);
}

// Blocks an SM of each mode's sweep at each chunk and strip count, on each
// of the first kCachedDevices devices (0: not asked yet).  A small call's
// launch costs less than the occupancy query, so it is asked once.  Each
// sweep may take the shared memory of the largest block (8 strips, the
// longest chunk), set before the first query on a device and never
// lowered, so that a cached answer stays launchable.
constexpr int kCachedDevices = 16;
std::atomic<int> g_per_sm[kCachedDevices][8][kMaxChunk + 1][kMaxStrips + 1];

cudaError_t cached_per_sm(SweepFn fn, int mode, int chunk, int threads,
                          size_t smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* slot =
      dev < kCachedDevices ? &g_per_sm[dev][mode][chunk][threads / 32]
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

}  // namespace
}  // namespace trialign

extern "C" {

// Sweep the `count` entries of a call's table in one persistent launch on
// `stream`.  a, b, c: the problems' symbol arrays, A_i of problem p at
// a[a_off + i] for 1 <= i <= |A| (B and C likewise, up to |B| and |C|);
// geom: kGeomFields int64 a problem (offsets into a, b, c and into the
// faces); table: kTableFields ints an entry, in diagonal order; hb x wc:
// the tile plane, at most 33 x 33; rf, cf: the face slabs of every problem
// at their offsets (no entry needs a value before it is written); out: 8
// ints a problem, of which the first 7 get its final values (the caller
// zeroes them: a problem with an empty sequence has no tiles); done:
// kMaxStrips progress words an entry, one a strip (-1 fresh); next_entry:
// 1 int, 0.  chunk: planes
// between handshakes (1 .. kMaxChunk); max_blocks caps the grid (0: as many
// blocks as the SMs hold at once).  A wait past the watchdog traps
// (csrc/schedule.cuh).  Returns cudaGetLastError() (or the error of the
// occupancy query).
int trialign_wavefront(const int* a, const int* b, const int* c,
                       const long long* geom, const int* table, int count,
                       int hb, int wc, const int* sub,
                       trialign::StepScoring s, int* rf, int* cf, int* out,
                       int* done, int* next_entry, int chunk, int max_blocks,
                       void* stream) {
  const int mode =
      (s.rtl ? 1 : 0) | (s.nsym ? 2 : 0) | (s.score_bits ? 4 : 0);
  trialign::SweepFn fn = trialign::pick(mode);
  int threads = 0, sm_blocks = 0, blocks = 0;
  size_t smem = 0;
  if (fn == nullptr || count < 1 || max_blocks < 0 ||
      !trialign::tile_block(hb, wc, chunk, s.nsym != 0, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      trialign::cached_per_sm(fn, mode, chunk, threads, smem, &sm_blocks);
  if (err == cudaSuccess)
    err = trialign::persistent_grid(sm_blocks, count, max_blocks, &blocks);
  if (err != cudaSuccess) return (int)err;
  fn<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      a, b, c, geom, table, count, hb, wc, sub, s, rf, cf, out, done,
      next_entry, chunk);
  return (int)cudaGetLastError();
}

// What the sweep of scoring mode `mode` takes at tile plane hb x wc: into
// out[0..4] its registers a thread, local (spill) bytes a thread, threads
// and shared bytes a block, and blocks an SM.  Returns a CUDA error code.
int trialign_wavefront_resources(int hb, int wc, int chunk, int mode,
                                 int* out) {
  trialign::SweepFn fn = trialign::pick(mode);
  int threads = 0;
  size_t smem = 0;
  if (fn == nullptr ||
      !trialign::tile_block(hb, wc, chunk, (mode & 2) != 0, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = trialign::cached_per_sm(fn, mode, chunk, threads, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = threads;
  out[3] = (int)smem;
  out[4] = blocks;
  return 0;
}

}  // extern "C"
