// The 7-matrix affine-gap cell step on a plane ring in shared memory
// (cell_step, and the direct engine's cell_step_choices, which also returns
// each target's argmax; csrc/slab.cu's choice-capture sweep steps with it),
// and what every kernel shares: the scoring the kernels take, the
// substitution lookup, the matrices' axes and transition weights.  The
// register step of K2, K3, K4 and K5 (csrc/pillar_warp.cuh) takes the same
// groups pre-reduced.
//
// Replaces trialign/kernels/plane_math.py:fused_plane_update_m7 (K1), the
// plane-wide grouped max-plus update every Pallas kernel inlines.  On the TPU
// the step is written over whole (hb, wc) planes and reaches the predecessor
// at (j-dj, k-dk) by rolling the plane; here one thread computes one cell and
// reads its predecessors at the shifted positions directly.
//
// Bound on the card: the step is integer add/max only (no matrix product, so
// no tensor cores); on the ring it reads 42 predecessor values plus one
// carried max7 and writes 8 values per cell, so it is bound by the loads
// from shared memory.  The weight groups are fixed by which axes each
// matrix consumes and take the gap charges at run time; the integers equal
// the grouped update's: max is exact, and each group's charge is the one
// Scoring.weight_matrix() gives every source in it.
//
// Matrix order (trialign/config.py): 0 M, 1 Ix, 2 Iy, 3 Iz, 4 Ixy, 5 Iyz, 6 Ixz.
// Plane q holds cell (i = q - j - k, j, k).  The predecessor of target t is
// in plane q - PLANE_DELTA[t] at (j - dj, k - dk):
//   Ix  q-1 (j,   k  )   Iy  q-1 (j-1, k  )   Iz  q-1 (j,   k-1)
//   Ixy q-2 (j-1, k  )   Iyz q-2 (j-1, k-1)   Ixz q-2 (j,   k-1)
//   M   q-3 (j-1, k-1), carried as max7 of that plane (M's charges are 0).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace trialign {

constexpr int kNumMatrices = 7;
// Largest runtime substitution matrix every kernel takes: 24 symbols, the
// alphabet of NCBI's BLOSUM62 (20 residues, B, Z, X and *); the table has
// one more row and column for the clamped floor that out-of-alphabet codes
// score.
constexpr int kMaxSym = 24;
constexpr int kSubTable = (kMaxSym + 1) * (kMaxSym + 1);

// Ints of shared memory a block reserves for the table: all of it under a
// submatrix, none under match/mismatch, whose step never reads it.
constexpr int sub_table_ints(bool sub) { return sub ? kSubTable : 0; }

// Scoring as the kernels take it; mirrors the ctypes structure in
// trialign_torch/_build.py field for field.
struct StepScoring {
  int match;
  int mismatch;
  int gap_open;
  int gap_extend;
  int rtl;         // 1: s3_mode "rtl", 0: "sop"
  int nsym;        // 0: match/mismatch; else a (nsym+1)^2 submatrix table
  int score_bits;  // 0: plain int32; else stored values wrap to this width
};

// S(x, y).  With a submatrix, a code >= nsym (pads, sentinels, symbols
// outside the alphabet) indexes the floor row/column, which holds
// min(matrix minimum, -1) as Scoring.sub_lookup() does.
__device__ __forceinline__ int pair_score(int x, int y, const StepScoring& s,
                                          const int* sub) {
  if (s.nsym) {
    const int xx = min(x, s.nsym), yy = min(y, s.nsym);
    return sub[xx * (s.nsym + 1) + yy];
  }
  return x == y ? s.match : s.mismatch;
}

// A value stored into a score_bits-wide signed register (the RTL's
// unsaturated SCORE_BITS registers).  Two's complement makes the mask exact
// for negatives.
__device__ __forceinline__ int wrap_bits(int v, int score_bits) {
  if (!score_bits) return v;
  const int half = 1 << (score_bits - 1);
  const int low = (1 << score_bits) - 1;
  return ((v + half) & low) - half;
}

__device__ __forceinline__ int max3(int a, int b, int c) {
  return max(max(a, b), c);
}

__device__ __forceinline__ int max4(int a, int b, int c, int d) {
  return max(max(a, b), max(c, d));
}

// One cell of plane q.  p1 and p2 point at matrix 0 of planes q-1 and q-2,
// whose matrices lie `ts` ints apart; c, up, left and upleft are the offsets
// of (j, k), (j-1, k), (j, k-1) and (j-1, k-1); m7_ul is max7 of plane q-3 at
// (j-1, k-1); a, b, cc are the cell's symbols.  Writes the seven stored
// (wrapped) values to out and returns their max, the cell's max7.
__device__ __forceinline__ int cell_step(const int* p1, const int* p2, int ts,
                                         int c, int up, int left, int upleft,
                                         int m7_ul, int a, int b, int cc,
                                         const StepScoring& s, const int* sub,
                                         int out[kNumMatrices]) {
  const int sab = pair_score(a, b, s, sub);
  const int sac = pair_score(a, cc, s, sub);
  const int sbc = pair_score(b, cc, s, sub);
  int s3;
  if (s.rtl) {
    // src/PE_1cyc.v:162 precedence quirk, as Scoring.triple_score.
    s3 = a == b ? (b == cc ? 3 * s.match : 2 * (s.match + s.mismatch))
                : 3 * s.mismatch;
  } else {
    s3 = sab + sac + sbc;
  }
  const int go = s.gap_open, ge = s.gap_extend;

  int x[kNumMatrices], y[kNumMatrices], z[kNumMatrices];
  int xy[kNumMatrices], yz[kNumMatrices], xz[kNumMatrices];
#pragma unroll
  for (int t = 0; t < kNumMatrices; ++t) {
    x[t] = p1[t * ts + c];
    y[t] = p1[t * ts + up];
    z[t] = p1[t * ts + left];
    xy[t] = p2[t * ts + up];
    yz[t] = p2[t * ts + upleft];
    xz[t] = p2[t * ts + left];
  }

  // Single-consume targets: two gapped axes; a source pays gap_extend on an
  // axis it also gapped and gap_open on one it consumed.
  const int ix = max3(max(x[0], x[5]) - 2 * go, x[1] - 2 * ge,
                      max4(x[2], x[3], x[4], x[6]) - go - ge);
  const int iy = max3(max(y[0], y[6]) - 2 * go, y[2] - 2 * ge,
                      max4(y[1], y[3], y[4], y[5]) - go - ge);
  const int iz = max3(max(z[0], z[4]) - 2 * go, z[3] - 2 * ge,
                      max4(z[1], z[2], z[5], z[6]) - go - ge);
  // Double-consume targets: one gapped axis.
  const int ixy = max(max4(xy[0], xy[3], xy[5], xy[6]) - go,
                      max3(xy[1], xy[2], xy[4]) - ge) + sab;
  const int iyz = max(max4(yz[0], yz[1], yz[4], yz[6]) - go,
                      max3(yz[2], yz[3], yz[5]) - ge) + sbc;
  const int ixz = max(max4(xz[0], xz[2], xz[4], xz[5]) - go,
                      max3(xz[1], xz[3], xz[6]) - ge) + sac;
  const int m = m7_ul + s3;

  const int sb = s.score_bits;
  out[0] = wrap_bits(m, sb);
  out[1] = wrap_bits(ix, sb);
  out[2] = wrap_bits(iy, sb);
  out[3] = wrap_bits(iz, sb);
  out[4] = wrap_bits(ixy, sb);
  out[5] = wrap_bits(iyz, sb);
  out[6] = wrap_bits(ixz, sb);
  return max(max4(out[0], out[1], out[2], out[3]), max3(out[4], out[5], out[6]));
}

// Axes (bit 0 A, bit 1 B, bit 2 C) matrix t consumes, in the order of
// trialign_torch/config.py CONSUMES: M, Ix, Iy, Iz, Ixy, Iyz, Ixz.
__host__ __device__ constexpr int consume_bits(int t) {
  return t == 0 ? 7 : t == 1 ? 1 : t == 2 ? 2 : t == 3 ? 4 : t == 4 ? 3
       : t == 5 ? 6 : 5;
}

// Scoring.weight_matrix()[t][s]: each axis target t gaps costs gap_extend
// if source s gapped it too, else gap_open.  Unrolled, the indices are
// constants and this folds to a sum of the two charges.
__device__ __forceinline__ int transition_weight(int t, int s, int go,
                                                 int ge) {
  int charge = 0;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    if (!((consume_bits(t) >> axis) & 1))
      charge += ((consume_bits(s) >> axis) & 1) ? go : ge;
  }
  return -charge;
}

// The direct engine's cell step (trialign/traceback/direct.py _choices_seg):
// cell_step's seven values, unwrapped, and which source each target took.
// Each target's value is the max over its sources s = 0 .. 6, in that
// order, of pred[s] + W[t][s], and its choice the first s that reaches it
// (ties to the lowest source, as jnp.argmax and torch.max take them).
// Choice t sits in bits 3t .. 3t + 2 of the returned word.  M's sources
// all carry weight 0, so its value and choice are max7 and its argmax of
// plane q-3 at (j-1, k-1), m7_ul and a7_ul, carried by the caller.  A
// target whose predecessor lies outside the cuboid (j < dj: !has_up, or
// k < dk: !has_left) chooses 0; its value reads the caller's guard cells
// and the caller overwrites it.  Everything adds in full int32: NEG-valued
// sources, which do not fit 16 bits, are ranked by their charges.
__device__ __forceinline__ int cell_step_choices(
    const int* p1, const int* p2, int ts, int c, int up, int left,
    int upleft, int m7_ul, int a7_ul, bool has_up, bool has_left, int a,
    int b, int cc, const StepScoring& s, const int* sub,
    int out[kNumMatrices]) {
  const int sab = pair_score(a, b, s, sub);
  const int sac = pair_score(a, cc, s, sub);
  const int sbc = pair_score(b, cc, s, sub);
  int s3;
  if (s.rtl) {
    s3 = a == b ? (b == cc ? 3 * s.match : 2 * (s.match + s.mismatch))
                : 3 * s.mismatch;
  } else {
    s3 = sab + sac + sbc;
  }
  const int go = s.gap_open, ge = s.gap_extend;
  // Target t's predecessor offset within planes q-1 (Ix, Iy, Iz) and q-2
  // (Ixy, Iyz, Ixz), and the substitution it adds.
  const int* const src[kNumMatrices] = {nullptr, p1 + c, p1 + up, p1 + left,
                                        p2 + up, p2 + upleft, p2 + left};
  const int subs[kNumMatrices] = {s3, 0, 0, 0, sab, sbc, sac};
  const bool has[kNumMatrices] = {has_up && has_left, true, has_up, has_left,
                                  has_up, has_up && has_left, has_left};
  out[0] = m7_ul + s3;
  int word = has[0] ? a7_ul : 0;
#pragma unroll
  for (int t = 1; t < kNumMatrices; ++t) {
    int best = src[t][0] + transition_weight(t, 0, go, ge), arg = 0;
#pragma unroll
    for (int u = 1; u < kNumMatrices; ++u) {
      const int v = src[t][u * ts] + transition_weight(t, u, go, ge);
      if (v > best) {
        best = v;
        arg = u;
      }
    }
    out[t] = best + subs[t];
    if (has[t]) word |= arg << (3 * t);
  }
  return word;
}

// Copies the host-built submatrix table into shared memory (no-op for the
// match/mismatch scheme).  Caller synchronises before use.
__device__ __forceinline__ void load_sub_table(const int* sub, int nsym,
                                               int* dst) {
  const int n = nsym ? (nsym + 1) * (nsym + 1) : 0;
  for (int x = threadIdx.x; x < n; x += blockDim.x) dst[x] = sub[x];
}

}  // namespace trialign

// Every kernel source includes this header once and builds into a library
// of its own, so each library carries this message lookup for its wrapper.
extern "C" const char* trialign_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
