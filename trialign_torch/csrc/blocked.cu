// K3: the blocked (sliced) sweep for triplets past the wavefront's caps, its
// per-tile form and its chain mode.
//
// Replaces trialign/kernels/blocked.py:_block_sweep as launched by
// make_grid_call (kernel _make_grid_kernel, chain mode included through the
// 13-tuple dims of plan_dims_packed) and by make_block_call (one block a
// call, for checkpoint.py).  The tile pillar itself is csrc/pillar.cuh,
// shared with K4.
//
// Bound on the card: on v5e the grid ran one tile after another on one core
// with the planes in VMEM.  Here a tile is bound by the pillar's
// shared-memory loads and per-plane barrier, and the grid by how many tiles
// one anti-diagonal holds, since tile (jb, kb) needs the faces of (jb-1, kb)
// and (jb, kb-1).
//
// Design: a problem's tiles form a table in anti-diagonal order (diag
// ascending, then jb ascending).  One launch runs a run of that table that
// lies on one anti-diagonal jb + kb = diag, one thread block per tile: all of a
// diagonal's tiles for the whole-grid sweep, any part of them for the
// per-tile form, which checkpoint.py uses to stop between any two tiles.
// The face slabs and the output stay in device memory between launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pillar.cuh"

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

template <int NT, bool CHAIN>
__global__ void __launch_bounds__(NT)
    blocked_kernel(const int* __restrict__ a_ext, const int* __restrict__ b_ext,
                   const int* __restrict__ c_ext, BlockedGeom g, int diag,
                   int jb_lo, const int* __restrict__ sub, StepScoring s,
                   int* rf, int* cf, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int jb = jb_lo + blockIdx.x, kb = diag - jb;
  // Face slabs: row faces [n_kb][nrows][7][wc], column faces
  // [n_jb][nrows][7][hb].
  int* rface = rf + (size_t)kb * g.nrows * kNumMatrices * g.wc;
  int* cface = cf + (size_t)jb * g.nrows * kNumMatrices * g.hb;
  const bool target = jb == g.n_jb - 1 && kb == g.n_kb - 1;
  tile_pillar<NT, CHAIN>(smem, a_ext, b_ext, c_ext, g.hb, g.wc, g.la, g.d,
                         jb, kb, target, g.jlstar, g.klstar, sub, s, rface,
                         cface, out);
}

template <int NT, bool CHAIN>
int launch(const int* a, const int* b, const int* c, const BlockedGeom& g,
           int diag, int jb_lo, int ntiles, const int* sub, StepScoring s,
           int* rf, int* cf, int* out, cudaStream_t stream) {
  const size_t smem = pillar_shared_bytes(g.hb, g.wc);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_kernel<NT, CHAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  blocked_kernel<NT, CHAIN><<<ntiles, NT, smem, stream>>>(
      a, b, c, g, diag, jb_lo, sub, s, rf, cf, out);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_mode(const int* a, const int* b, const int* c,
                const BlockedGeom& g, int diag, int jb_lo, int ntiles,
                const int* sub, StepScoring s, int* rf, int* cf, int* out,
                cudaStream_t stream) {
  if (g.d == g.la + 1)
    return launch<NT, false>(a, b, c, g, diag, jb_lo, ntiles, sub, s, rf, cf,
                             out, stream);
  return launch<NT, true>(a, b, c, g, diag, jb_lo, ntiles, sub, s, rf, cf, out,
                          stream);
}

}  // namespace
}  // namespace trialign

extern "C" {

// Launch K3 for tiles (jb_lo .. jb_lo + ntiles - 1, diag - jb) of tile
// anti-diagonal diag on `stream`.  a: A_i at index i for 1 <= i <= la (slot
// borders i = m*d in chain mode); b: n_jb * tb + 1 symbols (B_j at index j, sentinels past
// |B|); c likewise with n_kb * tc + 1; rf: n_kb * nrows * 7 * wc ints; cf:
// n_jb * nrows * 7 * hb ints; out: 7 ints a slot, written by the last tile.
// A tile runs after both of its upper and left neighbours on one stream.
// Returns cudaGetLastError() (or the error of cudaFuncSetAttribute).
int trialign_blocked_tiles(const int* a, const int* b, const int* c,
                           trialign::BlockedGeom g, int diag, int jb_lo,
                           int ntiles, const int* sub,
                           trialign::StepScoring s, int* rf, int* cf,
                           int* out, int threads, void* stream) {
  const int lo = diag - (g.n_kb - 1) > 0 ? diag - (g.n_kb - 1) : 0;
  const int hi = diag < g.n_jb - 1 ? diag : g.n_jb - 1;
  if (diag < 0 || ntiles < 1 || jb_lo < lo || jb_lo + ntiles - 1 > hi ||
      g.d < 1 || g.npack < 1 || g.la != g.npack * g.d - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (threads) {
    case 256:
      return trialign::launch_mode<256>(a, b, c, g, diag, jb_lo, ntiles, sub, s,
                                        rf, cf, out, st);
    case 512:
      return trialign::launch_mode<512>(a, b, c, g, diag, jb_lo, ntiles, sub, s,
                                        rf, cf, out, st);
    case 1024:
      return trialign::launch_mode<1024>(a, b, c, g, diag, jb_lo, ntiles, sub, s,
                                         rf, cf, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
