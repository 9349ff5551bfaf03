// What the table-driven sweeps on the register step share: K4
// (csrc/hetero.cu), many distinct triplets a dispatch, and K2
// (csrc/wavefront.cu), the small triplets of one call.
//
// A sweep's problems are all tiled by one tile plane (hb, wc); each has its
// own |A|, tile counts, symbol arrays and face slabs, named by its row of a
// geometry table, and the host lists every problem's tiles in one table of
// entries, global tile anti-diagonal by diagonal, each entry with the
// entries of its upper and left neighbours (kernels/hetero.py GEOM_FIELDS,
// TABLE_FIELDS).  A block of a persistent launch takes an entry, decodes it
// here into the tile it names, and sweeps that tile with warp_pillar
// (csrc/pillar_warp.cuh), sub-tile by sub-tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pillar_warp.cuh"
#include "schedule.cuh"

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
  kAOff,    // offsets (ints) of the problem's A, B, C in their buffers
  kBOff,
  kCOff,
  kRfOff,   // offsets (ints) of its row and column face slabs
  kCfOff,
  kGeomFields
};

// Columns of the table of tiles (int32), as kernels/hetero.py TABLE_FIELDS.
enum TableField { kProblem, kJb, kKb, kUp, kLeft, kTableFields };

// Table entry e of a sweep: the problem's arrays and faces, the tile and
// its neighbours' progress words.
struct Entry {
  const int *a, *b, *c;  // the problem's A, B, C arrays
  int *rface, *cface;    // the tile's face slabs
  int *out, *done, *up, *left;
  int la, jb, kb, jlstar, klstar;
  bool last_row, last_col;  // the tile is in the last tile row / column
  bool target;              // the tile holds the final cell
};

// Entry e: A, B and C at their offsets in a_syms, b_syms and c_syms (K4
// packs all three into one buffer), the problem's out row `out_stride`
// ints apart, `words` progress words an entry.
__device__ __forceinline__ Entry table_entry(
    const int* a_syms, const int* b_syms, const int* c_syms,
    const long long* geom, const int* table, int e, int hb, int wc, int* rf,
    int* cf, int* out, int out_stride, int* done, int words) {
  const int* row = table + (size_t)e * kTableFields;
  const int p = row[kProblem];
  const long long* g = geom + (size_t)p * kGeomFields;
  Entry t;
  t.jb = row[kJb];
  t.kb = row[kKb];
  t.la = (int)g[kLa];
  t.jlstar = (int)g[kJlstar];
  t.klstar = (int)g[kKlstar];
  t.last_row = t.jb == (int)g[kNjb] - 1;
  t.last_col = t.kb == (int)g[kNkb] - 1;
  t.target = t.last_row && t.last_col;
  const int nrows = (int)g[kNrows];
  // The problem's face slabs: row faces [n_kb][nrows][7][wc], column faces
  // [n_jb][nrows][7][hb].
  t.rface = rf + g[kRfOff] + (size_t)t.kb * nrows * kNumMatrices * wc;
  t.cface = cf + g[kCfOff] + (size_t)t.jb * nrows * kNumMatrices * hb;
  t.a = a_syms + g[kAOff];
  t.b = b_syms + g[kBOff];
  t.c = c_syms + g[kCOff];
  t.out = out + (size_t)p * out_stride;
  t.done = done + (size_t)e * words;
  t.up = row[kUp] >= 0 ? done + (size_t)row[kUp] * words : nullptr;
  t.left = row[kLeft] >= 0 ? done + (size_t)row[kLeft] * words : nullptr;
  return t;
}

// Sub-tile (j0, k0) of entry t's tile as the warp pillar takes it: its
// symbols and the tile's face slabs shifted to its corner; only the last
// sub-tile publishes the tile's progress, only the first row waits for the
// upper tile and the first column for the left one.  The symbols of every
// row and column of the sub-tile are read (K4's arrays hold sentinels up to
// the last tile's end).
__device__ __forceinline__ WarpTile sub_tile(const Entry& t, int hb, int wc,
                                             int j0, int k0) {
  const int tb = hb - 1, tc = wc - 1;
  WarpTile w;
  w.a = t.a;
  w.b = t.b + t.jb * tb + j0;
  w.c = t.c + t.kb * tc + k0;
  w.rface = t.rface + (size_t)k0 * kNumMatrices * wc + k0;
  w.cface = t.cface + (size_t)j0 * kNumMatrices * hb + j0;
  w.out = t.out;
  w.done = j0 + kSubRows >= tb && k0 + kSubCols >= tc ? t.done : nullptr;
  w.up = j0 == 0 ? t.up : nullptr;
  w.left = k0 == 0 ? t.left : nullptr;
  w.la = t.la;
  w.hb = hb;
  w.wc = wc;
  w.j0 = j0;
  w.k0 = k0;
  w.tb = min(kSubRows, tb - j0);
  w.tc = min(kSubCols, tc - k0);
  w.bmax = w.tb;
  w.cmax = w.tc;
  w.jlstar = t.jlstar - j0;
  w.klstar = t.klstar - k0;
  w.target = t.target && w.jlstar >= 1 && w.jlstar <= w.tb &&
             w.klstar >= 1 && w.klstar <= w.tc;
  w.has_row = t.jb > 0 || j0 > 0;
  w.has_col = t.kb > 0 || k0 > 0;
  return w;
}

// Threads and shared bytes of a block at tile plane hb x wc, or false for
// a plane or chunk the step does not take: a warp a strip of kStrip
// columns, at most kMaxStrips.
inline bool sweep_block(int hb, int wc, int chunk, int* threads,
                        size_t* smem) {
  const int tb = hb - 1, tc = wc - 1;
  if (tb < 1 || tc < 1 || chunk < 1 || chunk > kMaxChunk) return false;
  const int need = (tc + kStrip - 1) / kStrip;
  const int strips = need < kMaxStrips ? need : kMaxStrips;
  *threads = 32 * strips;
  *smem = warp_pillar_shared_bytes(strips, chunk);
  return true;
}

}  // namespace trialign
