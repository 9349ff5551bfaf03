// K2: the single-block wavefront sweep for one small triplet.
//
// Replaces trialign/kernels/wavefront.py:_make_kernel (launched by _run /
// _run_compact), which sweeps every anti-diagonal plane q = i + j + k of the
// (|A|+1, |B|+1, |C|+1) cuboid with the 16 carried (hb, wc) planes resident
// in VMEM, and returns the seven final-cell values.
//
// Bound on the card: that premise does not hold here.  One 256 x 256 int32
// plane is 256 KB, above the 227 KB of shared memory a block can have, and
// the sweep carries 16 of them.  So the plane ring (3 generations x 7
// matrices, and 4 generations of max7) lives in global scratch that the
// wrapper allocates: 25 planes, about 6.5 MB at 255^2, which stays in the
// 50 MB L2.  Each cell reads 43 values from that ring, so the kernel is bound
// by L2 latency and by having one SM per problem.
//
// Design: one thread block per problem (the grid is the problem count, so a
// batch of triplets is one launch).  Threads stride over the (j, k) cells of
// a plane and compute only the cells with 1 <= i <= |A|, j, k >= 1; one
// __syncthreads() separates planes.  The ring is zeroed once, and a cell is
// written only on planes where it is valid: in any ring slot, a cell whose i
// is below 1 has never been written (its i was smaller still on every
// earlier plane of that slot), so it reads as the zero border; a cell past
// |A| may hold a stale value, but no valid cell reads it.  Symbols are read
// as A[q - j - k] directly: the Hankel shear of the TPU kernel was a gather
// workaround.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_step.cuh"

namespace trialign {
namespace {

constexpr int kRingPlanes = 3 * kNumMatrices + 4;

template <int NT>
__global__ void __launch_bounds__(NT)
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
  // barrier, so these loads must not take the non-coherent path.
  int* planes = scratch + (size_t)p * kRingPlanes * P;
  int* m7 = planes + 3 * kNumMatrices * P;
  for (int x = threadIdx.x; x < kRingPlanes * P; x += NT) planes[x] = 0;
  // An empty sequence scores 0 (its border face holds the final cell).
  if (threadIdx.x < 8) out[8 * p + threadIdx.x] = 0;
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
    for (int x = threadIdx.x; x < ncell; x += NT) {
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
        for (int t = 0; t < kNumMatrices; ++t) out[8 * p + t] = v[t];
      }
    }
    __syncthreads();
  }
}

template <int NT>
int launch(const int* a, int a_stride, const int* b, const int* c,
           const int* lens, int nprob, int hb, int wc, const int* sub,
           StepScoring s, int* scratch, int* out, cudaStream_t stream) {
  wavefront_kernel<NT><<<nprob, NT, 0, stream>>>(a, a_stride, b, c, lens, hb,
                                                  wc, sub, s, scratch, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace trialign

extern "C" {

// Number of ints of ring scratch one problem needs at plane extents hb x wc.
int trialign_wavefront_scratch_ints(int hb, int wc) {
  return trialign::kRingPlanes * hb * wc;
}

// Launch K2 over nprob problems on `stream`.  a: (nprob, a_stride) with
// a[p][i] = A_i for 1 <= i <= |A|; b: (nprob, hb), c: (nprob, wc) with the
// symbol of row j / column k at index j / k; lens: (nprob, 3) int32
// (|A|, |B|, |C|) with |B| < hb, |C| < wc; scratch: nprob times
// trialign_wavefront_scratch_ints(hb, wc) ints; out: (nprob, 8), of which
// the first 7 get the final-cell values (all 0 when a sequence is empty).
// Returns cudaGetLastError().
int trialign_wavefront(const int* a, int a_stride, const int* b, const int* c,
                       const int* lens, int nprob, int hb, int wc,
                       const int* sub, trialign::StepScoring s, int* scratch,
                       int* out, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (threads) {
    case 256:
      return trialign::launch<256>(a, a_stride, b, c, lens, nprob, hb, wc, sub,
                                   s, scratch, out, st);
    case 512:
      return trialign::launch<512>(a, a_stride, b, c, lens, nprob, hb, wc, sub,
                                   s, scratch, out, st);
    case 1024:
      return trialign::launch<1024>(a, a_stride, b, c, lens, nprob, hb, wc,
                                    sub, s, scratch, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
