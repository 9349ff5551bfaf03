// K4: the heterogeneous batch sweep, many distinct triplets in one launch.
//
// Replaces trialign/kernels/blocked.py:make_hetero_grid_call (_block_sweep in
// hetero mode) as chain._hetero_core_impl and mosaic._mosaic_core_impl
// launch it, and make_hetero_block_call, its per-block form.  On v5e the
// grid ran one block after another on one core, so K4 chained distinct
// triplets along i at a pitch d to amortise each block's tb + tc plane ramp,
// picked every cell's B and C from a VMEM ring by band selects, and captured
// each slot's score in a capture plane.  None of that is a limit here.
// What is: one problem's tile anti-diagonal is all the parallelism K3 has.
// So K4 keeps what K4 computes, the optimal score of each of many triplets
// with its own lengths, and not its layout.
//
// Design.  Every problem of a dispatch is tiled by the same (hb, wc) plane
// and has its own |A|, tile counts, symbol arrays and face slabs, named by
// its row of a geometry table.  The host lists the dispatch's tiles in a
// table (kernels/hetero.py TABLE_FIELDS): global tile anti-diagonal by
// diagonal, the longest problems first within one, each entry with the
// entries of its upper and left neighbours (the layout, and a tile's
// decoding, are csrc/warp_sweep.cuh's, which K2 shares).  One persistent
// launch (hetero_sweep) runs any run [idx0, idx0 + count) of the table: as
// many blocks as the SMs hold at once, each taking the next entry from a
// global counter in table order and sweeping its tile to the end before it
// takes another; a tile starts each chunk of planes once its neighbours'
// progress words (one a table entry, kept in the sweep state) show the
// planes whose face rows the chunk reads (kernels/blocked.planes_needed).
// A neighbour swept by an earlier run already reads as finished.  Every
// entry a block waits on was taken earlier by a running block
// (csrc/schedule.cuh), so the sweep cannot deadlock whatever the grid and
// whatever else runs on the card.  The whole dispatch is one launch
// (final_values), and so is every run of the per-tile form (sweep_tiles),
// which may stop and resume between any two entries with faces, outputs
// and progress words in device memory.
//
// The tile step is csrc/pillar_warp.cuh: each lane owns a tile row, each
// warp a strip of four columns, a cell's values stay in registers as the
// partials their consumers take, and no barrier spans the block inside a
// sub-tile of at most 32 x 32 cells; a larger tile plane is swept as
// sub-tiles, so every plane K3 takes runs.  Each problem writes its seven
// final values into out[p] at its own q* = |A| + jl* + kl*.  A problem with
// an empty sequence has no tiles and keeps the zeros the wrapper put in
// out[p].
//
// Bound on the card: the int32 max/add rate of the SMs (about 70 operations
// a cell, four shuffles), as long as the table keeps every SM's blocks busy;
// the batch's last diagonals leave SMs idle.
//
// Kept for comparison only (chip_smoke.py; no entry point of the package
// reaches it): hetero_diag, K4 as it was, one launch a run of one diagonal
// with one 512-thread block a tile on K3's shared-memory pillar
// (csrc/pillar.cuh, stream order carrying the faces).  The sweep's clocked
// build (CLOCK, default scoring only) serves kernels/hetero.py step_phases.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pillar.cuh"
#include "warp_sweep.cuh"

namespace trialign {
namespace {

constexpr int kSmemThreads = 512;

// Two blocks an SM: 8 strips of 4 columns, 128 registers a thread.
template <bool SUB, bool RTL, bool CLOCK>
__global__ void __launch_bounds__(32 * kMaxStrips, 2)
    hetero_sweep(const int* __restrict__ syms,
                 const long long* __restrict__ geom,
                 const int* __restrict__ table, int idx0, int count, int hb,
                 int wc, const int* __restrict__ sub, StepScoring s, int* rf,
                 int* cf, int* out, int* done, int* next_entry, int chunk) {
  extern __shared__ int4 smem4[];
  const int W = blockDim.x >> 5;
  int4* ring = smem4;
  int4* stage = ring + (size_t)(W - 1) * (2 * chunk + 1) * kRingRows;
  int* sub_s =
      reinterpret_cast<int*>(stage + (size_t)W * chunk * (3 * kStrip + 1));
  load_sub_table(sub, s.nsym, sub_s);
  const Charges K{-2 * s.gap_open, -2 * s.gap_extend,
                  -(s.gap_open + s.gap_extend), -s.gap_open, -s.gap_extend};
  __shared__ int entry;  // the block's entry, from idx0
  for (;;) {
    if (threadIdx.x == 0) entry = atomicAdd(next_entry, 1);
    __syncthreads();  // also orders sub_s
    if (entry >= count) return;
    for (int j0 = 0; j0 < hb - 1; j0 += kSubRows) {
      for (int k0 = 0; k0 < wc - 1; k0 += kSubCols) {
        // The entry is read again for each sub-tile, a load the compiler
        // cannot hoist, so that none of the tile's pointers stays in a
        // register while a sub-tile is swept (they would spill).
        const int e = idx0 + *reinterpret_cast<volatile int*>(&entry);
        warp_pillar<SUB, RTL, CLOCK>(
            sub_tile(table_entry(syms, syms, syms, geom, table, e, hb, wc,
                                 rf, cf, out, kNumMatrices, done, 1),
                     hb, wc, j0, k0),
            ring, stage, sub_s, s, K, chunk);
        // The rings and staging buffers serve the next sub-tile, which
        // reads the faces this one wrote; thread 0 takes the next entry
        // after it.
        __syncthreads();
      }
    }
  }
}

// K4 as it was: one block a tile of one diagonal, stream order carrying the
// faces; the tile's progress word is set once it is swept.
__global__ void __launch_bounds__(kSmemThreads)
    hetero_diag(const int* __restrict__ syms,
                const long long* __restrict__ geom,
                const int* __restrict__ table, int hb, int wc,
                const int* __restrict__ sub, StepScoring s, int* rf, int* cf,
                int* out, int* done) {
  extern __shared__ int smem[];
  const Entry t = table_entry(syms, syms, syms, geom, table, blockIdx.x, hb,
                              wc, rf, cf, out, kNumMatrices, done, 1);
  NoWait sync;
  tile_pillar<kSmemThreads, false>(
      smem, t.a, t.b, t.c, hb, wc, t.la, t.la + 1, t.jb, t.kb, t.target,
      t.jlstar, t.klstar, sub, s, t.rface, t.cface, t.out, sync);
  if (threadIdx.x == 0) *t.done = t.la + hb + wc - 2;
}

// Blocks of fn one SM holds with `threads` threads and `smem` bytes.
template <class Fn>
cudaError_t per_sm(Fn fn, int threads, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                       smem);
}

using SweepFn = void (*)(const int*, const long long*, const int*, int, int,
                         int, int, const int*, StepScoring, int*, int*, int*,
                         int*, int*, int);

// The sweep of a scoring mode (bit 0 rtl, bit 1 submatrix), or its clocked
// build (default scoring only), or nullptr.
SweepFn pick(int mode, bool clock) {
  if (clock) return mode == 0 ? hetero_sweep<false, false, true> : nullptr;
  switch (mode) {
    case 0: return hetero_sweep<false, false, false>;
    case 1: return hetero_sweep<false, true, false>;
    case 2: return hetero_sweep<true, false, false>;
    case 3: return hetero_sweep<true, true, false>;
  }
  return nullptr;
}

}  // namespace
}  // namespace trialign

extern "C" {

// Sweep entries idx0 .. idx0 + count - 1 of a dispatch's table in one
// persistent launch on `stream`.  syms: every problem's symbol arrays, laid
// out as K3's (A_i at a_off + i, B_j at b_off + j with sentinels past |B|,
// C likewise); geom: kGeomFields int64 a problem; table: kTableFields ints
// an entry; rf, cf: the face slabs of every problem at their offsets; out:
// 7 ints a problem; done: one progress word an entry (-1 fresh);
// next_entry: 1 int, 0.  chunk: planes between handshakes (1 ..
// kMaxChunk); max_blocks caps the grid (0: as many blocks as the SMs hold
// at once); clock: the build with the phase clock (default scoring only).
// Runs go in table order.  A wait past the watchdog traps
// (csrc/schedule.cuh).  score_bits is refused: the reference's hetero path
// has no register width.  Returns cudaGetLastError() (or the error of the
// occupancy query).
int trialign_hetero_sweep(const int* syms, const long long* geom,
                          const int* table, int idx0, int count, int hb,
                          int wc, const int* sub, trialign::StepScoring s,
                          int* rf, int* cf, int* out, int* done,
                          int* next_entry, int chunk, int max_blocks,
                          int clock, void* stream) {
  const int mode = (s.rtl ? 1 : 0) | (s.nsym ? 2 : 0);
  trialign::SweepFn fn = trialign::pick(mode, clock != 0);
  int threads = 0, sm_blocks = 0, blocks = 0;
  size_t smem = 0;
  if (fn == nullptr || idx0 < 0 || count < 1 || max_blocks < 0 ||
      s.score_bits ||
      !trialign::sweep_block(hb, wc, chunk, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = trialign::per_sm(fn, threads, smem, &sm_blocks);
  if (err == cudaSuccess)
    err = trialign::persistent_grid(sm_blocks, count, max_blocks, &blocks);
  if (err != cudaSuccess) return (int)err;
  fn<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      syms, geom, table, idx0, count, hb, wc, sub, s, rf, cf, out, done,
      next_entry, chunk);
  return (int)cudaGetLastError();
}

// K4 as it was: one block for each of the `ntiles` entries at `table` (a run
// of one global tile anti-diagonal), on `stream`, after the diagonals
// before it; done: those entries' progress words.  Returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute).
int trialign_hetero_diag(const int* syms, const long long* geom,
                         const int* table, int ntiles, int hb, int wc,
                         const int* sub, trialign::StepScoring s, int* rf,
                         int* cf, int* out, int* done, void* stream) {
  if (ntiles < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = trialign::pillar_shared_bytes(hb, wc);
  cudaError_t err = cudaFuncSetAttribute(
      trialign::hetero_diag, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  trialign::hetero_diag<<<ntiles, trialign::kSmemThreads, smem,
                          (cudaStream_t)stream>>>(syms, geom, table, hb, wc,
                                                  sub, s, rf, cf, out, done);
  return (int)cudaGetLastError();
}

// What the sweep takes at tile plane hb x wc: into out[0..4] its registers
// a thread, local (spill) bytes a thread, threads and shared bytes a block,
// and blocks an SM.  Returns a CUDA error code.
int trialign_hetero_resources(int hb, int wc, int chunk, int mode,
                              int* out) {
  trialign::SweepFn fn = trialign::pick(mode, false);
  int threads = 0;
  size_t smem = 0;
  if (fn == nullptr ||
      !trialign::sweep_block(hb, wc, chunk, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess) err = trialign::per_sm(fn, threads, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = threads;
  out[3] = (int)smem;
  out[4] = blocks;
  return 0;
}

// Copies the clocked sweep's cycle sums, kMaxStrips rows of kPhases, into
// out and zeroes them.  Returns a CUDA error code.
int trialign_hetero_phases(unsigned long long* out) {
  unsigned long long zero[trialign::kMaxStrips][trialign::kPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, trialign::g_phase_cycles,
                                         sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(trialign::g_phase_cycles, zero, sizeof(zero));
  return (int)err;
}

}  // extern "C"
