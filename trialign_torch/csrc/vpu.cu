// K6: the int32 elementwise rate probe.
//
// Replaces trialign/benchmarks.py:measure_vpu_rate, a Pallas micro-kernel
// that measures the v5e VPU's sustained int32 rate on register-resident
// vregs, the denominator of roofline().  Here each thread carries eight
// independent int32 chains in registers, seeded from its input element
// (x + r for chain r), and runs `iters` rounds of OPS operations on them in
// the reference's mix: for r < OPS / 2, pair j = r mod 4 does
// a[2j] = max(a[2j], a[2j+1]); a[2j+1] += a[2j] (a wrapping add).  The DPX
// mode does the same number of element operations as OPS / 2 Hopper
// __viaddmax_s32 instructions, max(a + b, c) in one instruction, which is
// the DP step's form: for r < OPS / 2, with h = (r / 4) mod 2,
// a[2j+h] = max(a[2j+1-h] + step, a[2j+h]), step < 0, so the values stay
// bounded.  Each thread writes the max of its chains, so nvcc cannot fold
// the loop.
//
// Bound on the card: operations alone (one load and one store a thread).
// Design: 256 threads a block and eight blocks an SM (32 registers a
// thread), every SM full, four independent dependency chains a thread.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_step.cuh"

namespace trialign {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <int OPS, bool DPX>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    vpu_kernel(const int* __restrict__ x, int n, int iters, int step,
               int* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  int a[8];
  const int x0 = x[t];
#pragma unroll
  for (int r = 0; r < 8; ++r) a[r] = x0 + r;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < OPS / 2; ++r) {
      const int j = r % 4;
      if (DPX) {
        const int h = (r / 4) % 2;
        a[2 * j + h] = __viaddmax_s32(a[2 * j + 1 - h], step, a[2 * j + h]);
      } else {
        a[2 * j] = max(a[2 * j], a[2 * j + 1]);
        a[2 * j + 1] = (int)((unsigned)a[2 * j + 1] + (unsigned)a[2 * j]);
      }
    }
  }
  int m = a[0];
#pragma unroll
  for (int r = 1; r < 8; ++r) m = max(m, a[r]);
  out[t] = m;
}

template <int OPS, bool DPX>
int launch(const int* x, int n, int iters, int step, int* out,
           cudaStream_t stream) {
  vpu_kernel<OPS, DPX><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(x, n, iters, step, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace trialign

extern "C" {

// Threads one block takes and blocks an SM holds at once: a launch over
// sms * blocks * threads elements fills every SM.
int trialign_vpu_threads() { return trialign::kThreads; }
int trialign_vpu_blocks_per_sm() { return trialign::kBlocksPerSm; }

// Run K6 over x[0 .. n-1] into out[0 .. n-1] on `stream`: `iters` rounds of
// ops_per_iter (64 or 512) element operations a thread, in the int32 mix or,
// with dpx, as __viaddmax_s32 with the given step.  Returns
// cudaGetLastError().
int trialign_vpu(const int* x, int n, int iters, int ops_per_iter, int dpx,
                 int step, int* out, void* stream) {
  if (n < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ops_per_iter == 64)
    return dpx ? trialign::launch<64, true>(x, n, iters, step, out, st)
               : trialign::launch<64, false>(x, n, iters, step, out, st);
  if (ops_per_iter == 512)
    return dpx ? trialign::launch<512, true>(x, n, iters, step, out, st)
               : trialign::launch<512, false>(x, n, iters, step, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
