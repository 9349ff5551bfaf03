// The schedule of a persistent tile sweep: per-plane readiness.
//
// K5 (csrc/slab.cu) sweeps tiles of tb x tc cells through local planes q
// with PlaneWait; the register step of K2, K3 and K4 (csrc/pillar_warp.cuh)
// follows the same rule with PlaneWait's await and release store.  A tile
// reads row q of its row-face slab at plane q, which its upper neighbour
// (jb - 1, kb) wrote at its plane q + tb, and row q of its column-face
// slab, which its left neighbour (jb, kb - 1) wrote at its plane q + tc.
//
// One persistent launch runs the whole tile table, or a run of it (the
// per-tile forms).  A neighbour outside the run was swept by an earlier
// launch that the stream or an event orders before this one, and has no
// progress word here (nullptr): it reads as finished, and its faces are
// read through L2 like any other.  A tile sweeps its pillar in chunks of
// planes [q0, q1).  Before a chunk, thread 0 waits until the upper
// neighbour has finished plane min(q1 - 1 + tb, nq) and the left neighbour
// plane min(q1 - 1 + tc, nq) (kernels/blocked.py planes_needed, the rule
// the CPU tests model in any order it allows); after the chunk's last
// barrier it publishes q1 - 1.  The diagonal neighbour needs no flag: the
// corner comes through the upper neighbour's row face.
//
// Memory ordering.  A face row is written by one SM and read by another while
// the kernel runs, and adjacent rows share 128-byte lines (a row is 7 x wc
// ints), so a face must never be read through the SM's non-coherent L1:
// PlaneWait reads faces with ld.global.cg (__ldcg) and writes them with
// st.global.cg (__stcg).  Publishing is __syncthreads() (the block's face
// writes), then thread 0's __threadfence() and a release store of the
// progress word; waiting is thread 0's acquire loads, with __nanosleep
// back-off, then __syncthreads().
//
// A wait longer than kWatchdogNs (10 s of %globaltimer) traps, so a
// deadlock or a lost flag fails the launch with a CUDA error instead of
// hanging the card.
#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace trialign {

constexpr unsigned long long kWatchdogNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct PlaneWait {
  using Flag = cuda::atomic_ref<int, cuda::thread_scope_device>;

  int* done;   // this tile's progress word: the last local plane finished
  int* up;     // (jb - 1, kb)'s, or nullptr in the first tile row
  int* left;   // (jb, kb - 1)'s, or nullptr in the first tile column
  int tb, tc, nq, chunk;
  int first;   // the pillar's first local plane (0 or 1)
  int next;    // first plane of the next chunk
  int seen_up = -1, seen_left = -1;  // thread 0: progress last read

  __device__ PlaneWait(int* done, int* up, int* left, int tb, int tc, int nq,
                       int chunk, int first)
      : done(done), up(up), left(left), tb(tb), tc(tc), nq(nq), chunk(chunk),
        first(first), next(first) {}

  __device__ __forceinline__ int load(const int* p) const { return __ldcg(p); }
  __device__ __forceinline__ void store(int* p, int v) const { __stcg(p, v); }

  // Called by every thread at the top of plane q, after the barrier that
  // ended plane q - 1.
  __device__ __forceinline__ void before_plane(int q) {
    if (q != next) return;  // uniform over the block
    const int q1 = min(q + chunk, nq + 1);
    if (threadIdx.x == 0) {
      if (q > first) publish(q - 1);
      await(up, min(q1 - 1 + tb, nq), seen_up);
      await(left, min(q1 - 1 + tc, nq), seen_left);
    }
    next = q1;
    __syncthreads();
  }

  // Called by every thread after the barrier that ended plane nq.
  __device__ __forceinline__ void finish() {
    if (threadIdx.x == 0) publish(nq);
  }

  __device__ __forceinline__ void publish(int q) {
    __threadfence();
    Flag(*done).store(q, cuda::memory_order_release);
  }

  // Waits until *p (a progress word; none if nullptr) reaches need; seen
  // caches the last value read.  csrc/pillar_warp.cuh waits with it too.
  __device__ __forceinline__ static void await(int* p, int need, int& seen) {
    if (p == nullptr || seen >= need) return;
    Flag flag(*p);
    seen = flag.load(cuda::memory_order_acquire);
    if (seen >= need) return;
    const unsigned long long t0 = global_ns();
    unsigned ns = 32;
    while ((seen = flag.load(cuda::memory_order_acquire)) < need) {
      __nanosleep(ns);
      ns = ns < 256 ? 2 * ns : 256;
      if (global_ns() - t0 > kWatchdogNs) __trap();
    }
  }
};

// Tile t of the table in anti-diagonal order (diagonal d ascending, then jb;
// kernels/blocked.py tile_table).
__device__ __forceinline__ void table_tile(int t, int n_jb, int n_kb, int& jb,
                                           int& kb) {
  for (int d = 0;; ++d) {
    const int lo = max(0, d - (n_kb - 1)), hi = min(d, n_jb - 1);
    if (t <= hi - lo) {
      jb = lo + t;
      kb = d - jb;
      return;
    }
    t -= hi - lo + 1;
  }
}

// The hand-out of a persistent launch: thread 0 takes the next tile of the
// table from the global counter and the block shares it.  Every tile a block
// waits on was taken earlier by a block that is running, so the sweep
// cannot deadlock whatever the grid size and whatever else runs on the card.
__device__ __forceinline__ int take_tile(int* next_tile) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(next_tile, 1);
  __syncthreads();
  return tile;
}

// The grid of a persistent launch: the blocks the SMs hold at once (per_sm
// on each), capped by max_blocks (0: no cap) and by the tiles.
inline cudaError_t persistent_grid(int per_sm, int ntiles, int max_blocks,
                                   int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int n = per_sm * sms;
  if (max_blocks > 0 && max_blocks < n) n = max_blocks;
  *blocks = ntiles < n ? ntiles : n;
  return cudaSuccess;
}

}  // namespace trialign
