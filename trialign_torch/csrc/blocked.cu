// K3: the blocked (sliced) sweep for triplets past the wavefront's caps.
//
// Replaces trialign/kernels/blocked.py:_block_sweep as launched by
// make_grid_call (kernel _make_grid_kernel), without chain mode.  The (j, k)
// plane is cut into tiles of tb x tc cells; each tile is a pillar that sweeps
// every i, with a one-cell halo (row 0, column 0) that it takes from the
// faces its upper and left neighbours wrote.  Faces live in skewed slabs
// indexed by the tile's local plane q (cell (jl, kl) of local plane q holds
// global i = q - jl - kl): the bottom row of plane q goes to row
// s = q - tb of the row-face slab of its tile column, the right column to row
// s = q - tc of the column-face slab of its tile row, so the neighbour reads
// row s = q at its own step q.
//
// Bound on the card: on v5e the grid ran one tile after another on one core
// with the planes in VMEM.  Here a tile's plane ring (3 generations x 7
// matrices and 4 generations of max7, 25 planes of (tb+1)(tc+1) ints) sits
// in shared memory, so a tile is bound by shared-memory loads (43 a cell) and
// by the barrier that ends each plane; the grid is bound by how many tiles
// one anti-diagonal holds, since tile (jb, kb) needs the faces of (jb-1, kb)
// and (jb, kb-1).
//
// Design: one launch per tile anti-diagonal jb + kb = d, one thread block
// per tile, all tiles of a diagonal in parallel; stream order makes the
// previous diagonal's faces visible.  A row-face slab is read and written in
// place: a tile reads row s at step s and writes it at step s + tb, and no
// other tile of the same launch touches that slab.  The halo install order of
// blocked.py is kept: column 0 from the column face, then row 0 from the row
// face, so the row face wins at the corner [0, 0] (it carries the diagonal
// tile's value); tiles of the first tile row or column take the zero border
// instead.  A ring cell is written only on planes where its i is in
// [1, |A|], as in the wavefront kernel, and a face entry only where the
// neighbour will read it, so the slabs need no initialisation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_step.cuh"

namespace trialign {

// Geometry of one blocked sweep; mirrors the ctypes structure in
// trialign_torch/_build.py field for field.
struct BlockedGeom {
  int la;      // |A|
  int hb;      // tile plane rows: halo row + tb cells
  int wc;      // tile plane columns: halo column + tc cells
  int n_jb;    // tile rows
  int n_kb;    // tile columns
  int nrows;   // rows of each face slab (local planes 0 .. la + tb + tc)
  int jlstar;  // final cell (|B|, |C|) in the last tile, local coordinates
  int klstar;
};

namespace {

constexpr int kRingPlanes = 3 * kNumMatrices + 4;

size_t shared_bytes(int hb, int wc) {
  return sizeof(int) * ((size_t)kRingPlanes * hb * wc + hb + wc + kSubTable);
}

template <int NT>
__global__ void __launch_bounds__(NT)
    blocked_kernel(const int* __restrict__ a_ext, const int* __restrict__ b_ext,
                   const int* __restrict__ c_ext, BlockedGeom g, int d,
                   int jb_lo, const int* __restrict__ sub, StepScoring s,
                   int* rf, int* cf, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int hb = g.hb, wc = g.wc, tb = hb - 1, tc = wc - 1, P = hb * wc;
  const int la = g.la;
  int* planes = smem;                            // [3 slots][7][P]
  int* m7 = planes + 3 * kNumMatrices * P;       // [4 slots][P]
  int* bsym = m7 + 4 * P;                        // [hb]
  int* csym = bsym + hb;                         // [wc]
  int* sub_s = csym + wc;                        // [kSubTable]
  const int jb = jb_lo + blockIdx.x, kb = d - jb;

  for (int x = threadIdx.x; x < kRingPlanes * P; x += NT) planes[x] = 0;
  for (int x = threadIdx.x; x < hb; x += NT) bsym[x] = b_ext[jb * tb + x];
  for (int x = threadIdx.x; x < wc; x += NT) csym[x] = c_ext[kb * tc + x];
  load_sub_table(sub, s.nsym, sub_s);
  __syncthreads();

  // Face slabs: row faces [n_kb][nrows][7][wc], column faces
  // [n_jb][nrows][7][hb].  Written here, read by the next launch.
  const size_t rrow = (size_t)kNumMatrices * wc, crow = (size_t)kNumMatrices * hb;
  int* rface = rf + (size_t)kb * g.nrows * rrow;
  int* cface = cf + (size_t)jb * g.nrows * crow;
  const bool has_row = jb > 0, has_col = kb > 0;
  const bool target = jb == g.n_jb - 1 && kb == g.n_kb - 1;
  const int qstar = la + g.jlstar + g.klstar;
  const int nq = la + tb + tc;
  const int ncell = tb * tc, nhalo = tb + tc + 1;

  for (int q = 1; q <= nq; ++q) {
    int* cur = planes + (q % 3) * kNumMatrices * P;
    const int* p1 = planes + ((q + 2) % 3) * kNumMatrices * P;
    const int* p2 = planes + ((q + 1) % 3) * kNumMatrices * P;
    int* m7cur = m7 + (q & 3) * P;
    const int* m7p3 = m7 + ((q + 1) & 3) * P;  // slot of plane q - 3

    for (int x = threadIdx.x; x < ncell; x += NT) {
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
      if (target && q == qstar && jl == g.jlstar && kl == g.klstar) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) out[t] = v[t];
      }
    }

    // Halo: x <= tc is row-0 cell (0, x), the rest column-0 cell (x - tc, 0).
    for (int x = threadIdx.x; x < nhalo; x += NT) {
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
      // The faces include the halo corners: the bottom row's column-0 entry
      // and the right column's row-0 entry.
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

template <int NT>
int launch(const int* a, const int* b, const int* c, const BlockedGeom& g,
           int d, const int* sub, StepScoring s, int* rf, int* cf, int* out,
           cudaStream_t stream) {
  const int jb_lo = d - (g.n_kb - 1) > 0 ? d - (g.n_kb - 1) : 0;
  const int jb_hi = d < g.n_jb - 1 ? d : g.n_jb - 1;
  if (d < 0 || jb_hi < jb_lo) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(g.hb, g.wc);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  blocked_kernel<NT><<<jb_hi - jb_lo + 1, NT, smem, stream>>>(
      a, b, c, g, d, jb_lo, sub, s, rf, cf, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace trialign

extern "C" {

// Launch K3 for the tiles of anti-diagonal d on `stream`.  a: A_i at index i
// for 1 <= i <= |A|; b: n_jb * tb + 1 symbols (B_j at index j, sentinels
// past |B|); c likewise with n_kb * tc + 1; rf: n_kb * nrows * 7 * wc ints;
// cf: n_jb * nrows * 7 * hb ints; out: 7 ints, written by the last tile.
// Diagonals must be launched in order 0 .. n_jb + n_kb - 2 on one stream.
// Returns cudaGetLastError() (or the error of cudaFuncSetAttribute).
int trialign_blocked_diag(const int* a, const int* b, const int* c,
                          trialign::BlockedGeom g, int d, const int* sub,
                          trialign::StepScoring s, int* rf, int* cf, int* out,
                          int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (threads) {
    case 256:
      return trialign::launch<256>(a, b, c, g, d, sub, s, rf, cf, out, st);
    case 512:
      return trialign::launch<512>(a, b, c, g, d, sub, s, rf, cf, out, st);
    case 1024:
      return trialign::launch<1024>(a, b, c, g, d, sub, s, rf, cf, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
