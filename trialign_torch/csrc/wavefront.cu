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
//
// Kept for comparison only (chip_smoke.py and the cuda tests; no entry
// point of the package reaches it): wavefront_kernel, K2 as it was, one
// thread block a problem striding over the (j, k) cells of each whole
// plane with a block barrier between planes and the plane ring (3
// generations of the 7 matrices, 4 of max7: 25 planes, 6.5 MB at 255^2) in
// global scratch.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "plane_step.cuh"
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

// Threads and shared bytes of a block at tile plane hb x wc, or false for
// a plane past one sub-tile or a chunk the step does not take.
bool tile_block(int hb, int wc, int chunk, int* threads, size_t* smem) {
  return hb - 1 <= kSubRows && wc - 1 <= kSubCols &&
         sweep_block(hb, wc, chunk, threads, smem);
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
      (int)warp_pillar_shared_bytes(kMaxStrips, kMaxChunk));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                        smem);
  if (err == cudaSuccess && slot != nullptr)
    slot->store(*blocks, std::memory_order_relaxed);
  return err;
}

// K2 as it was: the plane ring of one problem in global scratch, and the
// threads of its block (the fastest of 256, 512 and 1024 at 255^3).
constexpr int kRingPlanes = 3 * kNumMatrices + 4;
constexpr int kEarlierThreads = 1024;

__global__ void __launch_bounds__(kEarlierThreads)
    wavefront_kernel(const int* __restrict__ a_ext, int a_stride,
                     const int* __restrict__ b_ext,
                     const int* __restrict__ c_ext,
                     const int* __restrict__ lens, int hb, int wc,
                     const int* __restrict__ sub, StepScoring s, int* scratch,
                     int* __restrict__ out) {
  __shared__ int sub_s[kSubTable];
  const int p = blockIdx.x;
  const int la = lens[3 * p], lb = lens[3 * p + 1], lc = lens[3 * p + 2];
  const int* a = a_ext + (size_t)p * a_stride;
  const int* bsym = b_ext + (size_t)p * hb;
  const int* csym = c_ext + (size_t)p * wc;
  const int P = hb * wc;
  // Ring: planes[slot][t][j * wc + k] for 3 slots, then max7[slot][...] for
  // 4 slots.  Not __restrict__: threads read what others wrote before the
  // barrier, so these loads must not take the non-coherent path.  The ring
  // is zeroed once, and a cell is written only on planes where it is
  // valid: a cell whose i is below 1 reads as the zero border; a cell past
  // |A| may hold a stale value, but no valid cell reads it.
  int* planes = scratch + (size_t)p * kRingPlanes * P;
  int* m7 = planes + 3 * kNumMatrices * P;
  for (int x = threadIdx.x; x < kRingPlanes * P; x += kEarlierThreads)
    planes[x] = 0;
  // An empty sequence scores 0 (its border face holds the final cell).
  if (threadIdx.x < kOutStride) out[kOutStride * p + threadIdx.x] = 0;
  load_sub_table(sub, s.nsym, sub_s);
  __syncthreads();

  const int qmax = la + lb + lc;
  const int ncell = lb * lc;
  for (int q = 1; q <= qmax; ++q) {
    int* cur = planes + (q % 3) * kNumMatrices * P;
    const int* p1 = planes + ((q + 2) % 3) * kNumMatrices * P;
    const int* p2 = planes + ((q + 1) % 3) * kNumMatrices * P;
    int* m7cur = m7 + (q & 3) * P;
    const int* m7p3 = m7 + ((q + 1) & 3) * P;  // slot of plane q - 3
    for (int x = threadIdx.x; x < ncell; x += kEarlierThreads) {
      const int j = x / lc + 1;
      const int k = x - (j - 1) * lc + 1;
      const int i = q - j - k;
      if (i < 1 || i > la) continue;
      const int c = j * wc + k;
      int v[kNumMatrices];
      const int mx = cell_step(p1, p2, P, c, c - wc, c - 1, c - wc - 1,
                               m7p3[c - wc - 1], a[i], bsym[j], csym[k], s,
                               sub_s, v);
#pragma unroll
      for (int t = 0; t < kNumMatrices; ++t) cur[t * P + c] = v[t];
      m7cur[c] = mx;
      if (q == qmax && j == lb && k == lc) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) out[kOutStride * p + t] = v[t];
      }
    }
    __syncthreads();
  }
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
      !trialign::tile_block(hb, wc, chunk, &threads, &smem))
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
  if (fn == nullptr || !trialign::tile_block(hb, wc, chunk, &threads, &smem))
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

// K2 as it was.  Ints of ring scratch one problem needs at plane extents
// hb x wc.
int trialign_wavefront_scratch_ints(int hb, int wc) {
  return trialign::kRingPlanes * hb * wc;
}

// K2 as it was: one thread block of 1024 threads for each of nprob
// problems on `stream`.  a: (nprob, a_stride) with a[p][i] = A_i for
// 1 <= i <= |A|; b: (nprob, hb), c: (nprob, wc) with the symbol of row j /
// column k at index j / k; lens: (nprob, 3) int32 (|A|, |B|, |C|) with
// |B| < hb, |C| < wc; scratch: nprob times
// trialign_wavefront_scratch_ints(hb, wc) ints; out: (nprob, 8), of which
// the first 7 get the final-cell values (all 0 when a sequence is empty).
// Returns cudaGetLastError().
int trialign_wavefront_earlier(const int* a, int a_stride, const int* b,
                               const int* c, const int* lens, int nprob,
                               int hb, int wc, const int* sub,
                               trialign::StepScoring s, int* scratch,
                               int* out, void* stream) {
  trialign::wavefront_kernel<<<nprob, trialign::kEarlierThreads, 0,
                               (cudaStream_t)stream>>>(
      a, a_stride, b, c, lens, hb, wc, sub, s, scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
