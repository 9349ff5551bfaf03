// The direct engine's walk: a pointer chase over the packed choices.
//
// Replaces trialign/traceback/direct.py:_walk_device, which is XLA in the
// JAX package (an on-device lax.while_loop), not a pallas_call.  From
// (|A|, |B|, |C|) in state t0 it reads the 3-bit choice of the current state
// at the current cell (matrices 0-4 in the int16 buffer, 5-6 in the byte
// buffer; row q - 1 of plane q = i + j + k, (j, k) at j * (|C| + 1) + k),
// records the state, steps back along the state's consume vector and takes
// the choice as the next state.  "free" and "free_jk" stop at the first
// border (i, j or k zero), "pin" at the origin.
//
// Bound on the card: one dependent load a step, at most |A| + |B| + |C|
// steps (3072 at 1024^3), each a trip to device memory; nothing to share
// between threads, so one thread walks and the result (the steps newest
// first, their count and the stop) is one small buffer that the host copies
// once, instead of one read a step from the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_step.cuh"

namespace trialign {
namespace {

// res: [0] the count of steps (-1 if a choice was not a state or the walk
// left the cuboid), [1..3] the (i, j, k) it stopped at, [4..] the states,
// newest first.
__global__ void walk_kernel(const int16_t* __restrict__ lo,
                            const uint8_t* __restrict__ hi, int la, int lb,
                            int lc, int t0, int pin, int* __restrict__ res) {
  const size_t plane = (size_t)(lb + 1) * (lc + 1);
  int i = la, j = lb, k = lc, t = t0, n = 0;
  while (pin ? (i > 0 || j > 0 || k > 0) : (i > 0 && j > 0 && k > 0)) {
    const size_t at = (size_t)(i + j + k - 1) * plane + (size_t)j * (lc + 1)
                      + k;
    const int s = t < 5 ? ((uint16_t)lo[at] >> (3 * t)) & 7
                        : (hi[at] >> (3 * t - 15)) & 7;
    res[4 + n++] = t;
    const int cb = consume_bits(t);
    i -= cb & 1;
    j -= (cb >> 1) & 1;
    k -= (cb >> 2) & 1;
    t = s;
    if (t >= kNumMatrices || i < 0 || j < 0 || k < 0) {
      n = -1;
      break;
    }
  }
  res[0] = n;
  res[1] = i;
  res[2] = j;
  res[3] = k;
}

}  // namespace
}  // namespace trialign

extern "C" {

// Walk the packed buffers lo, hi (la + lb + lc rows of (lb + 1) * (lc + 1)
// entries) from (la, lb, lc) in state t0 on `stream`, one thread; res: 4 +
// la + lb + lc ints.  pin: 1 for mode "pin", 0 for "free" / "free_jk".
// Returns cudaGetLastError().
int trialign_walk(const int16_t* lo, const uint8_t* hi, int la, int lb, int lc,
                  int t0, int pin, int* res, void* stream) {
  if (la < 0 || lb < 0 || lc < 0 || la + lb + lc < 1 || t0 < 0 ||
      t0 >= trialign::kNumMatrices)
    return (int)cudaErrorInvalidValue;
  trialign::walk_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(lo, hi, la, lb, lc,
                                                          t0, pin, res);
  return (int)cudaGetLastError();
}

}  // extern "C"
