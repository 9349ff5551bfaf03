// The shared-memory tile pillar of the earlier designs, which only
// chip_smoke.py and the cuda tests run: K3's per-tile form as it was
// (blocked_kernel) and K3's persistent sweep as it was (pillar_sweep), both
// in csrc/blocked.cu, and K4's earlier design (csrc/hetero.cu).  K2, K3
// and K4 sweep their tiles on the register step (csrc/pillar_warp.cuh).
//
// Replaces the body of trialign/kernels/blocked.py:_block_sweep that both
// make_grid_call (K3, with its per-block form make_block_call and its chain
// mode) and make_hetero_grid_call (K4) run: one tile of tb x tc cells swept
// through every i, with a one-cell halo (row 0, column 0) taken from the
// faces its upper and left neighbours wrote.  Faces live in skewed slabs
// indexed by the tile's local plane q (cell (jl, kl) of local plane q holds
// global i = q - jl - kl): the bottom row of plane q goes to row s = q - tb
// of the row-face slab of its tile column, the right column to row
// s = q - tc of the column-face slab of its tile row, so the neighbour reads
// row s = q at its own step q.
//
// Bound on the card: the plane ring (3 generations x 7 matrices and 4
// generations of max7, 25 planes of (tb+1)(tc+1) ints) sits in shared
// memory, so a tile is bound by shared-memory loads (43 a cell) and by the
// barrier that ends each plane.
//
// Design: the caller names the tile and its problem's geometry, and a
// schedule policy (csrc/schedule.cuh): NoWait where stream order between
// launches makes the faces of the previous tile anti-diagonal visible and no
// two blocks of a launch share a face slab (K3's per-tile form as it was);
// PlaneWait where one persistent launch runs every tile and a tile waits, at
// the start of each chunk of planes, for the planes of its neighbours whose
// face rows the chunk reads (K3's persistent sweep as it was, chain mode
// included).  A row-face slab
// is read and written in place: a tile reads row s at step s and writes it
// at step s + tb.  Under PlaneWait that stays correct: tile (jb, kb) reads row
// s only once (jb - 1, kb) has written it (at its step s + tb), and writes
// row s itself at its step s + tb, which the next tile (jb + 1, kb) waits for
// before it reads it; (jb - 1, kb) has by then finished its step s, the
// last that reads the old row.  Rows that two tiles touch while both run
// are disjoint.  Column-face slabs likewise with tc.  The halo install order of
// blocked.py is kept: column 0 from the column face, then row 0 from the row
// face, so the row face wins at the corner [0, 0] (it carries the diagonal
// tile's value); tiles of the first tile row or column take the zero border
// instead.  A ring cell is written only on planes where its i is in
// [1, la], and a face entry only where the neighbour will read it, so the
// slabs need no initialisation.
//
// Chain mode (CHAIN, blocked.py plan_dims_packed): npack problems of equal
// |A| stacked along i at pitch d = |A| + 1, sharing B and C; the swept
// length is la = npack * d - 1.  A cell with i = 0 (mod d) is a zero border
// in all 7 matrices, written into the ring and the faces like any cell, so
// that no neighbour's halo keeps an older value; slot m's final cell is
// i = m * d + d - 1, captured into out row m.  Without chain mode d is
// la + 1 and out has one row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_step.cuh"
#include "schedule.cuh"

namespace trialign {

constexpr int kRingPlanes = 3 * kNumMatrices + 4;

// Shared memory of one tile's thread block: the ring, the tile's B and C
// symbols and, under a submatrix (`sub`), its table (kernels/blocked.py
// shared_bytes).
inline size_t pillar_shared_bytes(int hb, int wc, bool sub) {
  return sizeof(int) *
         ((size_t)kRingPlanes * hb * wc + hb + wc + sub_table_ints(sub));
}

// Sweeps tile (jb, kb) of one problem.  a_ext: A_i at index i, 1 <= i <= la;
// b_ext, c_ext: the problem's B and C arrays (B_j at index j, sentinels past
// |B|); rface, cface: this tile's row-face slab (its tile column's) and
// column-face slab (its tile row's), each nrows rows of 7 x wc (7 x hb)
// ints; target: the tile holds the final cell, at local (jlstar, klstar);
// out: 7 ints a slot; sync: the schedule policy (csrc/schedule.cuh), whose
// loads and stores carry the faces.
template <int NT, bool CHAIN, class Sync>
__device__ __forceinline__ void tile_pillar(
    int* smem, const int* __restrict__ a_ext, const int* __restrict__ b_ext,
    const int* __restrict__ c_ext, int hb, int wc, int la, int d, int jb,
    int kb, bool target, int jlstar, int klstar, const int* __restrict__ sub,
    const StepScoring& s, int* rface, int* cface, int* __restrict__ out,
    Sync& sync) {
  const int tb = hb - 1, tc = wc - 1, P = hb * wc;
  int* planes = smem;                            // [3 slots][7][P]
  int* m7 = planes + 3 * kNumMatrices * P;       // [4 slots][P]
  int* bsym = m7 + 4 * P;                        // [hb]
  int* csym = bsym + hb;                         // [wc]
  int* sub_s = csym + wc;                        // [kSubTable], sub only

  for (int x = threadIdx.x; x < kRingPlanes * P; x += NT) planes[x] = 0;
  for (int x = threadIdx.x; x < hb; x += NT) bsym[x] = b_ext[jb * tb + x];
  for (int x = threadIdx.x; x < wc; x += NT) csym[x] = c_ext[kb * tc + x];
  load_sub_table(sub, s.nsym, sub_s);
  __syncthreads();

  const size_t rrow = (size_t)kNumMatrices * wc, crow = (size_t)kNumMatrices * hb;
  const bool has_row = jb > 0, has_col = kb > 0;
  const int nq = la + tb + tc;
  const int ncell = tb * tc, nhalo = tb + tc + 1;
  // Chain borders: i mod d is (q mod d) - (jl + kl), wrapped once, where
  // d exceeds every jl + kl of the tile; a plain remainder otherwise.
  const bool wide_pitch = d > tb + tc;
  int qmod = 0;  // q mod d, stepped with q
  auto imod = [&](int i, int jk) {
    const int r = qmod - jk;
    return wide_pitch ? (r < 0 ? r + d : r) : i % d;
  };
  // A thread's cells are x = threadIdx.x + n * NT, (jl, kl) = (x / tc + 1,
  // x % tc + 1): the first one, and the step to the next, so that the plane
  // loop divides nothing.
  const int jl0 = threadIdx.x / tc + 1, kl0 = threadIdx.x % tc + 1;
  const int djl = NT / tc, dkl = NT % tc;

  for (int q = 1; q <= nq; ++q) {
    sync.before_plane(q);
    if (CHAIN) qmod = qmod + 1 == d ? 0 : qmod + 1;
    int* cur = planes + (q % 3) * kNumMatrices * P;
    const int* p1 = planes + ((q + 2) % 3) * kNumMatrices * P;
    const int* p2 = planes + ((q + 1) % 3) * kNumMatrices * P;
    int* m7cur = m7 + (q & 3) * P;
    const int* m7p3 = m7 + ((q + 1) & 3) * P;  // slot of plane q - 3
    // Whether plane q holds a slot's final cell at (jlstar, klstar): global
    // i = m * d + d - 1 there (i = la without chain mode).  Uniform over
    // the block, so the cells' test below is skipped on every other plane.
    const int ifin = q - jlstar - klstar;
    const bool capture =
        target && (CHAIN ? ifin >= 1 && ifin <= la && (ifin + 1) % d == 0
                         : ifin == la);

    int jl = jl0, kl = kl0;
    for (int x = threadIdx.x; x < ncell; x += NT) {
      const int i = q - jl - kl;
      const int c = jl * wc + kl;
      if (i >= 1 && i <= la) {
        int v[kNumMatrices];
        int mx = 0;
        if (CHAIN && imod(i, jl + kl) == 0) {
#pragma unroll
          for (int t = 0; t < kNumMatrices; ++t) v[t] = 0;
        } else {
          mx = cell_step(p1, p2, P, c, c - wc, c - 1, c - wc - 1,
                         m7p3[c - wc - 1], a_ext[i], bsym[jl], csym[kl],
                         s, sub_s, v);
        }
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) cur[t * P + c] = v[t];
        m7cur[c] = mx;
        if (jl == tb) {
#pragma unroll
          for (int t = 0; t < kNumMatrices; ++t)
            sync.store(&rface[(q - tb) * rrow + t * wc + kl], v[t]);
        }
        if (kl == tc) {
#pragma unroll
          for (int t = 0; t < kNumMatrices; ++t)
            sync.store(&cface[(q - tc) * crow + t * hb + jl], v[t]);
        }
        if (capture && jl == jlstar && kl == klstar) {
          int* o = out + (CHAIN ? (ifin + 1) / d - 1 : 0) * kNumMatrices;
#pragma unroll
          for (int t = 0; t < kNumMatrices; ++t) o[t] = v[t];
        }
      }
      kl += dkl;
      jl += djl;
      if (kl > tc) {
        kl -= tc;
        ++jl;
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
      if ((row ? has_row : has_col) && !(CHAIN && imod(i, jl + kl) == 0)) {
        const int* src = row ? rface + q * rrow + kl : cface + q * crow + jl;
        const int stride = row ? wc : hb;
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t) v[t] = sync.load(src + t * stride);
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
        for (int t = 0; t < kNumMatrices; ++t)
          sync.store(&rface[(q - tb) * rrow + t * wc], v[t]);
      }
      if (row && kl == tc) {
#pragma unroll
        for (int t = 0; t < kNumMatrices; ++t)
          sync.store(&cface[(q - tc) * crow + t * hb], v[t]);
      }
    }
    __syncthreads();
  }
  sync.finish();
}

}  // namespace trialign
