// K4: the heterogeneous batch sweep, many distinct triplets in one launch.
//
// Replaces trialign/kernels/blocked.py:make_hetero_grid_call (_block_sweep in
// hetero mode) as chain._hetero_core_impl and mosaic._mosaic_core_impl
// launch it.  On v5e the grid ran one block after another on one core, so
// K4 chained distinct triplets along i at a pitch d to amortise each
// block's tb + tc plane ramp, picked every cell's B and C from a VMEM ring
// by band selects, and captured each slot's score in a capture plane.  None
// of that is a limit here.  What is: one problem's tile anti-diagonal is all
// the parallelism K3 has (16 tiles on average at 1024^3 with 33 x 33 tile
// planes, 12% of the 132 SMs).  So K4 keeps what K4 computes, the optimal
// score of each of many triplets with its own lengths, and not its layout.
//
// Design: K3's tile pillar (csrc/blocked.cu) with a problem axis.  Every
// problem of a dispatch is tiled by the same (hb, wc) plane and has its own
// |A|, tile counts, symbol arrays and face slabs, named by its row of a
// geometry table.  One launch runs global tile anti-diagonal d: one thread
// block per (problem, tile) with jb + kb = d, read from a host-built table
// that lists the longest problems first, so that the longest pillars start
// first.  Stream order makes the faces of diagonal d - 1 visible, as in K3;
// no two blocks of a launch share a face slab.  Each problem writes its
// seven final values into out[p] at its own q* = |A| + jl* + kl*.  A
// problem with an empty sequence has no tiles and keeps the zeros the
// wrapper put in out[p].
//
// Bound on the card: as K3, a pillar is bound by shared-memory loads (43 a
// cell) and one barrier a plane; with many problems a launch holds
// thousands of tiles, so the SMs stay busy and the batch is bound by those
// per-plane costs and by the longest pillar of each launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_step.cuh"

namespace trialign {

// Columns of the per-problem geometry table (int64), as
// trialign_torch/kernels/hetero.py GEOM_FIELDS lists them.
enum GeomField {
  kLa,      // |A|
  kNjb,     // tile rows
  kNkb,     // tile columns
  kNrows,   // rows of each face slab (local planes 0 .. |A| + tb + tc)
  kJlstar,  // final cell (|B|, |C|) in the last tile, local coordinates
  kKlstar,
  kAOff,    // offsets (ints) of the problem's A, B, C in the symbol buffer
  kBOff,
  kCOff,
  kRfOff,   // offsets (ints) of its row and column face slabs
  kCfOff,
  kGeomFields
};

namespace {

constexpr int kRingPlanes = 3 * kNumMatrices + 4;
constexpr int kThreads = 512;

size_t shared_bytes(int hb, int wc) {
  return sizeof(int) * ((size_t)kRingPlanes * hb * wc + hb + wc + kSubTable);
}

__global__ void __launch_bounds__(kThreads)
    hetero_kernel(const int* __restrict__ syms,
                  const long long* __restrict__ geom,
                  const int* __restrict__ tiles, int hb, int wc, int d,
                  const int* __restrict__ sub, StepScoring s, int* rf, int* cf,
                  int* __restrict__ out) {
  extern __shared__ int smem[];
  const int tb = hb - 1, tc = wc - 1, P = hb * wc;
  int* planes = smem;                            // [3 slots][7][P]
  int* m7 = planes + 3 * kNumMatrices * P;       // [4 slots][P]
  int* bsym = m7 + 4 * P;                        // [hb]
  int* csym = bsym + hb;                         // [wc]
  int* sub_s = csym + wc;                        // [kSubTable]

  const int p = tiles[2 * blockIdx.x], jb = tiles[2 * blockIdx.x + 1];
  const int kb = d - jb;
  const long long* g = geom + (size_t)p * kGeomFields;
  const int la = (int)g[kLa], nrows = (int)g[kNrows];
  const int jlstar = (int)g[kJlstar], klstar = (int)g[kKlstar];
  const int* a_ext = syms + g[kAOff];
  const int* b_ext = syms + g[kBOff];
  const int* c_ext = syms + g[kCOff];

  for (int x = threadIdx.x; x < kRingPlanes * P; x += kThreads) planes[x] = 0;
  for (int x = threadIdx.x; x < hb; x += kThreads) bsym[x] = b_ext[jb * tb + x];
  for (int x = threadIdx.x; x < wc; x += kThreads) csym[x] = c_ext[kb * tc + x];
  load_sub_table(sub, s.nsym, sub_s);
  __syncthreads();

  // The problem's face slabs: row faces [n_kb][nrows][7][wc], column faces
  // [n_jb][nrows][7][hb].  Written here, read by the next launch.
  const size_t rrow = (size_t)kNumMatrices * wc, crow = (size_t)kNumMatrices * hb;
  int* rface = rf + g[kRfOff] + (size_t)kb * nrows * rrow;
  int* cface = cf + g[kCfOff] + (size_t)jb * nrows * crow;
  const bool has_row = jb > 0, has_col = kb > 0;
  const bool target = jb == (int)g[kNjb] - 1 && kb == (int)g[kNkb] - 1;
  const int qstar = la + jlstar + klstar;
  const int nq = la + tb + tc;
  const int ncell = tb * tc, nhalo = tb + tc + 1;
  int* outp = out + (size_t)p * kNumMatrices;

  for (int q = 1; q <= nq; ++q) {
    int* cur = planes + (q % 3) * kNumMatrices * P;
    const int* p1 = planes + ((q + 2) % 3) * kNumMatrices * P;
    const int* p2 = planes + ((q + 1) % 3) * kNumMatrices * P;
    int* m7cur = m7 + (q & 3) * P;
    const int* m7p3 = m7 + ((q + 1) & 3) * P;  // slot of plane q - 3

    for (int x = threadIdx.x; x < ncell; x += kThreads) {
      const int jl = x / tc + 1;
      const int kl = x - (jl - 1) * tc + 1;
      const int i = q - jl - kl;
      if (i < 1 || i > la) continue;
      const int c = jl * wc + kl;
      int v[kNumMatrices];
      const int mx = cell_step(p1, p2, P, c, c - wc, c - 1, c - wc - 1,
                               m7p3[c - wc - 1], a_ext[i], bsym[jl], csym[kl],
                               s, sub_s, v);
#pragma unroll
      for (int t = 0; t < kNumMatrices; ++t) cur[t * P + c] = v[t];
      m7cur[c] = mx;
      if (jl == tb) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t)
          rface[(q - tb) * rrow + t * wc + kl] = v[t];
      }
      if (kl == tc) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t)
          cface[(q - tc) * crow + t * hb + jl] = v[t];
      }
      if (target && q == qstar && jl == jlstar && kl == klstar) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) outp[t] = v[t];
      }
    }

    // Halo, in K3's order: x <= tc is row-0 cell (0, x), the rest column-0
    // cell (x - tc, 0); the row face wins at the corner.
    for (int x = threadIdx.x; x < nhalo; x += kThreads) {
      const bool row = x <= tc;
      const int jl = row ? 0 : x - tc;
      const int kl = row ? x : 0;
      const int i = q - jl - kl;
      if (i < 1 || i > la) continue;
      int v[kNumMatrices];
      if (row ? has_row : has_col) {
        const int* src = row ? rface + q * rrow + kl : cface + q * crow + jl;
        const int stride = row ? wc : hb;
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = src[t * stride];
      } else {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = 0;
      }
      const int c = jl * wc + kl;
      int mx = v[0];
#pragma unroll
      for (int t = 0; t < kNumMatrices; ++t) {
        cur[t * P + c] = v[t];
        mx = max(mx, v[t]);
      }
      m7cur[c] = mx;
      if (!row && jl == tb) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) rface[(q - tb) * rrow + t * wc] = v[t];
      }
      if (row && kl == tc) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) cface[(q - tc) * crow + t * hb] = v[t];
      }
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace trialign

extern "C" {

// Launch K4 for the `ntiles` (problem, jb) pairs of global tile
// anti-diagonal d on `stream`.  syms: every problem's symbol arrays, laid
// out as K3's (A_i at a_off + i, B_j at b_off + j with sentinels past |B|,
// C likewise); geom: kGeomFields int64 per problem; tiles: 2 ints a tile;
// rf, cf: the face slabs of every problem at their offsets; out: 7 ints a
// problem.  Diagonals go in order 0, 1, ... on one stream.  Returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute).
int trialign_hetero_diag(const int* syms, const long long* geom,
                         const int* tiles, int ntiles, int hb, int wc, int d,
                         const int* sub, trialign::StepScoring s, int* rf,
                         int* cf, int* out, void* stream) {
  if (ntiles < 1 || d < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = trialign::shared_bytes(hb, wc);
  cudaError_t err = cudaFuncSetAttribute(
      trialign::hetero_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  trialign::hetero_kernel<<<ntiles, trialign::kThreads, smem,
                            (cudaStream_t)stream>>>(
      syms, geom, tiles, hb, wc, d, sub, s, rf, cf, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
