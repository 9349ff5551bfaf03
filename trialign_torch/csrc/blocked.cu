// K3: the blocked (sliced) sweep for triplets past the wavefront's caps, its
// per-tile form and its chain mode.
//
// Replaces trialign/kernels/blocked.py:_block_sweep as launched by
// make_grid_call (kernel _make_grid_kernel, chain mode included through the
// 13-tuple dims of plan_dims_packed) and by make_block_call (one block a
// call, for checkpoint.py and the halo's stripes).  The tile pillar itself
// is csrc/pillar.cuh (K4 has its own, csrc/pillar_warp.cuh).
//
// Bound on the card: on v5e the grid ran one tile after another on one core
// with the planes in VMEM.  Here a tile is bound by the pillar's
// shared-memory loads and per-plane barrier, and the grid by how many tiles
// run at once, since tile (jb, kb) needs the faces of (jb-1, kb) and
// (jb, kb-1).  Launched one tile anti-diagonal at a time, a diagonal starts
// only once every tile of the one before has swept its whole pillar of
// la + tb + tc planes: 63 launches at 1024^3 with 33 x 33 tile planes, 16
// tiles at once on average on 132 SMs.
//
// Design: a problem's tiles form a table in anti-diagonal order (diag
// ascending, then jb ascending).  The whole-grid sweep (and chain mode) is
// one persistent launch (blocked_persistent): as many blocks as the SMs hold
// at once, each taking the next tile of the table from a global counter and
// sweeping its pillar to the end before it takes another.  A tile advances
// chunk by chunk of planes as soon as its neighbours have finished the planes
// whose face rows the chunk reads, a lag of about one tile width, not a
// pillar (csrc/schedule.cuh PlaneWait, the rule kernels/blocked.py
// planes_needed states and the CPU tests model).  The per-tile form is the
// same launch over a run of tiles that the host lists in a table of
// (jb, kb, up, left) entries, up and left being the entries of the tile's
// neighbours within the run or -1: any run of the tile table, which may end
// mid-diagonal (checkpoint.py), or a band of rows of a stripe's columns (the
// halo, dist/halo.py).  A neighbour outside the run was swept by an earlier
// launch, ordered before this one by the stream or an event, and reads as
// finished; the progress words are the launch's own.  The face slabs and the
// output stay in device memory between launches.
//
// Kept for comparison only (chip_smoke.py; no entry point of the package
// reaches it): blocked_kernel, the per-tile form as it was, one launch a run
// of one anti-diagonal with one thread block a tile (schedule NoWait).
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

// Face slabs of tile (jb, kb): row faces [n_kb][nrows][7][wc], column faces
// [n_jb][nrows][7][hb].
__device__ __forceinline__ int* row_faces(int* rf, const BlockedGeom& g,
                                          int kb) {
  return rf + (size_t)kb * g.nrows * kNumMatrices * g.wc;
}
__device__ __forceinline__ int* col_faces(int* cf, const BlockedGeom& g,
                                          int jb) {
  return cf + (size_t)jb * g.nrows * kNumMatrices * g.hb;
}

template <int NT, bool CHAIN>
__global__ void __launch_bounds__(NT)
    blocked_kernel(const int* __restrict__ a_ext, const int* __restrict__ b_ext,
                   const int* __restrict__ c_ext, BlockedGeom g, int diag,
                   int jb_lo, const int* __restrict__ sub, StepScoring s,
                   int* rf, int* cf, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int jb = jb_lo + blockIdx.x, kb = diag - jb;
  const bool target = jb == g.n_jb - 1 && kb == g.n_kb - 1;
  NoWait sync;
  tile_pillar<NT, CHAIN>(smem, a_ext, b_ext, c_ext, g.hb, g.wc, g.la, g.d,
                         jb, kb, target, g.jlstar, g.klstar, sub, s,
                         row_faces(rf, g, kb), col_faces(cf, g, jb), out, sync);
}

// Entry of a run's table (kernels/blocked.py RUN_FIELDS): the tile (x, y) =
// (jb, kb) and the entries of its upper and left neighbours in the run
// (z, w), or -1 for a neighbour outside the run or the grid.
using RunEntry = int4;

// The tile table in one launch: the whole grid in table order (run ==
// nullptr, ntiles = n_jb * n_kb), or the ntiles entries of run, in which
// every neighbour of the run comes before its tile.  next_tile: the hand-out
// counter (0); done: one progress word a tile (-1), row jb * n_kb + kb of
// the whole grid or the entry of the run.
template <int NT, bool CHAIN>
__global__ void __launch_bounds__(NT)
    blocked_persistent(const int* __restrict__ a_ext,
                       const int* __restrict__ b_ext,
                       const int* __restrict__ c_ext, BlockedGeom g,
                       const RunEntry* __restrict__ run, int ntiles,
                       int chunk, const int* __restrict__ sub, StepScoring s,
                       int* rf, int* cf, int* __restrict__ out, int* next_tile,
                       int* done) {
  extern __shared__ int smem[];
  const int tb = g.hb - 1, tc = g.wc - 1, nq = g.la + tb + tc;
  for (;;) {
    const int t = take_tile(next_tile);
    if (t >= ntiles) return;
    int jb, kb;
    int *me, *up, *left;
    if (run != nullptr) {
      const RunEntry e = run[t];
      jb = e.x;
      kb = e.y;
      me = done + t;
      up = e.z >= 0 ? done + e.z : nullptr;
      left = e.w >= 0 ? done + e.w : nullptr;
    } else {
      table_tile(t, g.n_jb, g.n_kb, jb, kb);
      me = done + jb * g.n_kb + kb;
      up = jb > 0 ? me - g.n_kb : nullptr;
      left = kb > 0 ? me - 1 : nullptr;
    }
    PlaneWait sync(me, up, left, tb, tc, nq, chunk, 1);
    const bool target = jb == g.n_jb - 1 && kb == g.n_kb - 1;
    tile_pillar<NT, CHAIN>(smem, a_ext, b_ext, c_ext, g.hb, g.wc, g.la, g.d,
                           jb, kb, target, g.jlstar, g.klstar, sub, s,
                           row_faces(rf, g, kb), col_faces(cf, g, jb), out,
                           sync);
  }
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

// Blocks of blocked_persistent<NT, CHAIN> one SM holds at tile plane
// hb x wc, into *per_sm.
template <int NT, bool CHAIN>
cudaError_t persistent_per_sm(int hb, int wc, int* per_sm) {
  const size_t smem = pillar_shared_bytes(hb, wc);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_persistent<NT, CHAIN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, blocked_persistent<NT, CHAIN>, NT, smem);
}

template <int NT, bool CHAIN>
int launch_persistent(const int* a, const int* b, const int* c,
                      const BlockedGeom& g, const RunEntry* run, int ntiles,
                      int chunk, int max_blocks, const int* sub,
                      StepScoring s, int* rf, int* cf, int* out,
                      int* next_tile, int* done, cudaStream_t stream) {
  int per_sm = 0, blocks = 0;
  cudaError_t err = persistent_per_sm<NT, CHAIN>(g.hb, g.wc, &per_sm);
  if (err == cudaSuccess)
    err = persistent_grid(per_sm, ntiles, max_blocks, &blocks);
  if (err != cudaSuccess) return (int)err;
  blocked_persistent<NT, CHAIN>
      <<<blocks, NT, pillar_shared_bytes(g.hb, g.wc), stream>>>(
          a, b, c, g, run, ntiles, chunk, sub, s, rf, cf, out, next_tile,
          done);
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

template <int NT>
int launch_persistent_mode(const int* a, const int* b, const int* c,
                           const BlockedGeom& g, const RunEntry* run,
                           int ntiles, int chunk, int max_blocks,
                           const int* sub, StepScoring s, int* rf, int* cf,
                           int* out, int* next_tile, int* done,
                           cudaStream_t stream) {
  if (g.d == g.la + 1)
    return launch_persistent<NT, false>(a, b, c, g, run, ntiles, chunk,
                                        max_blocks, sub, s, rf, cf, out,
                                        next_tile, done, stream);
  return launch_persistent<NT, true>(a, b, c, g, run, ntiles, chunk,
                                     max_blocks, sub, s, rf, cf, out,
                                     next_tile, done, stream);
}

bool valid_geom(const BlockedGeom& g) {
  return g.d >= 1 && g.npack >= 1 && g.la == g.npack * g.d - 1 &&
         g.n_jb >= 1 && g.n_kb >= 1;
}

}  // namespace
}  // namespace trialign

extern "C" {

// K3's per-tile form as it was, for comparison: launch tiles (jb_lo ..
// jb_lo + ntiles - 1, diag - jb) of tile anti-diagonal diag on `stream`.  a: A_i at index i for 1 <= i <= la (slot
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
      !trialign::valid_geom(g))
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

// Launch K3 as one persistent launch on `stream`: arrays as
// trialign_blocked_tiles takes them.  run == nullptr: the whole grid on a
// fresh state (ntiles = n_jb * n_kb).  Otherwise run holds ntiles entries of
// 4 ints (jb, kb, up, left), up and left the entries of the tile's
// neighbours within the run (earlier entries) or -1; a neighbour outside the
// run must have been swept by a launch ordered before this one (the same
// stream, or an event); run is 16-byte aligned.  chunk: local planes
// between two handshakes (>= 1); max_blocks: caps the grid (0: as many
// blocks as the SMs hold at once); next_tile: 1 int, 0; done: ntiles ints,
// -1.  A wait past the watchdog
// traps (csrc/schedule.cuh).  Returns cudaGetLastError() (or the error of
// the occupancy query).
int trialign_blocked_sweep(const int* a, const int* b, const int* c,
                           trialign::BlockedGeom g, const int* run,
                           int ntiles, const int* sub,
                           trialign::StepScoring s, int* rf, int* cf, int* out,
                           int threads, int chunk, int max_blocks,
                           int* next_tile, int* done, void* stream) {
  if (!trialign::valid_geom(g) || chunk < 1 || max_blocks < 0 ||
      ntiles < 1 || (run == nullptr && ntiles != g.n_jb * g.n_kb) ||
      ntiles > g.n_jb * g.n_kb || (uintptr_t)run % sizeof(int4) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const trialign::RunEntry* r = reinterpret_cast<const trialign::RunEntry*>(run);
  switch (threads) {
    case 256:
      return trialign::launch_persistent_mode<256>(
          a, b, c, g, r, ntiles, chunk, max_blocks, sub, s, rf, cf, out,
          next_tile, done, st);
    case 512:
      return trialign::launch_persistent_mode<512>(
          a, b, c, g, r, ntiles, chunk, max_blocks, sub, s, rf, cf, out,
          next_tile, done, st);
    case 1024:
      return trialign::launch_persistent_mode<1024>(
          a, b, c, g, r, ntiles, chunk, max_blocks, sub, s, rf, cf, out,
          next_tile, done, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the persistent sweep one SM holds at tile plane hb x wc and
// `threads` threads a block, into *per_sm (chain mode: `chain` nonzero).
// Returns a CUDA error code.
int trialign_blocked_blocks_per_sm(int hb, int wc, int threads, int chain,
                                   int* per_sm) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (threads) {
    case 256:
      err = chain ? trialign::persistent_per_sm<256, true>(hb, wc, per_sm)
                  : trialign::persistent_per_sm<256, false>(hb, wc, per_sm);
      break;
    case 512:
      err = chain ? trialign::persistent_per_sm<512, true>(hb, wc, per_sm)
                  : trialign::persistent_per_sm<512, false>(hb, wc, per_sm);
      break;
    case 1024:
      err = chain ? trialign::persistent_per_sm<1024, true>(hb, wc, per_sm)
                  : trialign::persistent_per_sm<1024, false>(hb, wc, per_sm);
      break;
  }
  return (int)err;
}

}  // extern "C"
