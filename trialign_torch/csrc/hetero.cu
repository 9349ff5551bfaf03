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
// Design: K3's tile pillar (csrc/pillar.cuh) with a problem axis.  Every
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
// Per-tile form (trialign/kernels/blocked.py:make_hetero_block_call, which
// the reference's interpret fallback runs one block a call): the host passes
// any run of one diagonal's table entries, so a sweep may stop and resume
// between two entries with its faces and outputs left in device memory.
//
// Bound on the card: as K3, a pillar is bound by shared-memory loads (43 a
// cell) and one barrier a plane (csrc/pillar.cuh); with many problems a
// launch holds thousands of tiles, so the SMs stay busy and the batch is
// bound by those per-plane costs and by the longest pillar of each launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pillar.cuh"

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

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    hetero_kernel(const int* __restrict__ syms,
                  const long long* __restrict__ geom,
                  const int* __restrict__ tiles, int hb, int wc, int d,
                  const int* __restrict__ sub, StepScoring s, int* rf, int* cf,
                  int* __restrict__ out) {
  extern __shared__ int smem[];
  const int p = tiles[2 * blockIdx.x], jb = tiles[2 * blockIdx.x + 1];
  const int kb = d - jb;
  const long long* g = geom + (size_t)p * kGeomFields;
  const int la = (int)g[kLa], nrows = (int)g[kNrows];
  // The problem's face slabs: row faces [n_kb][nrows][7][wc], column faces
  // [n_jb][nrows][7][hb].
  int* rface = rf + g[kRfOff] + (size_t)kb * nrows * kNumMatrices * wc;
  int* cface = cf + g[kCfOff] + (size_t)jb * nrows * kNumMatrices * hb;
  const bool target = jb == (int)g[kNjb] - 1 && kb == (int)g[kNkb] - 1;
  NoWait sync;  // one launch a diagonal: stream order carries the faces
  tile_pillar<kThreads, false>(
      smem, syms + g[kAOff], syms + g[kBOff], syms + g[kCOff], hb, wc, la,
      la + 1, jb, kb, target, (int)g[kJlstar], (int)g[kKlstar], sub, s, rface,
      cface, out + (size_t)p * kNumMatrices, sync);
}

}  // namespace
}  // namespace trialign

extern "C" {

// Launch K4 for `ntiles` (problem, jb) pairs of global tile anti-diagonal d
// (all of them, or any run of them) on `stream`.  syms: every problem's symbol arrays, laid
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
  const size_t smem = trialign::pillar_shared_bytes(hb, wc);
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
