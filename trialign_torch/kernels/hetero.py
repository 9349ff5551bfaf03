"""The heterogeneous batch sweep (K4): many distinct triplets in one launch.

Port of what ``trialign/kernels/blocked.py:make_hetero_grid_call`` computes
for ``chain._hetero_core_impl`` and ``mosaic._mosaic_core_impl``: the
optimal score of each of many triplets, each with its own lengths, in one
dispatch.  The TPU layout behind it (slots chained along i at a pitch, B and
C picked from a VMEM ring by band selects, a capture plane per block) is not
ported; ``csrc/hetero.cu`` explains why.

Every problem is tiled as K3 tiles one (``kernels/blocked.py``), at one
tile plane (hb, wc) shared by the dispatch, with its own symbol arrays and
face slabs.  The host side here packs a dispatch: one symbol buffer, a
per-problem geometry table (``GEOM_FIELDS``), and the dispatch's table of
tiles, global tile anti-diagonal by diagonal, the longest problems first
within one, each entry with the entries of its upper and left neighbours
(``TABLE_FIELDS``).  :func:`plan_dispatches` splits a batch into dispatches
whose face slabs fit a byte budget, the longest |A| first.

The sweep state (:class:`HeteroState`: every problem's face slabs, its final
values and one progress word a table entry) stays on the device from launch
to launch, so :func:`sweep_tiles` runs any run of the dispatch's table in
table order, K4's per-tile form (the port of ``make_hetero_block_call``);
:func:`final_values` is that over the whole table.  On a CUDA tensor each
is one persistent launch of K4 (``csrc/hetero.cu`` on the register tile step
``csrc/pillar_warp.cuh``, which sweeps a tile in sub-tiles of at most 32 x
32 cells): blocks take entries from a counter and start a tile's chunks of
planes as its neighbours' progress words allow (``blocked.planes_needed``).  On a CPU tensor they run :func:`hetero_ref`,
which sweeps each problem's tiles with K3's plain version ``blocked_ref``
at the dispatch's tile plane, on the same state.  :func:`step_layout_ref`
sweeps the same tiles in the register step's own order (lanes as tile
rows, strips of columns, pre-reduced partials, a ring of boundary columns
between strips); the tests hold it to both.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from trialign_torch import _build
from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels.ref import (
    PAD_A, PAD_B, PAD_C, pair_fn, substitution, wrap,
)
from trialign_torch.metrics import span

# Columns of the geometry table, in csrc/hetero.cu GeomField order.
GEOM_FIELDS = ("la", "n_jb", "n_kb", "nrows", "jlstar", "klstar",
               "a_off", "b_off", "c_off", "rf_off", "cf_off")
_G = {name: col for col, name in enumerate(GEOM_FIELDS)}
# Columns of the table of tiles (int32), in csrc/hetero.cu order: the
# problem, the tile (jb, kb), and the entries of its upper (jb - 1, kb) and
# left (jb, kb - 1) neighbours, -1 where it has none.
TABLE_FIELDS = ("problem", "jb", "kb", "up", "left")
# The register step (csrc/pillar_warp.cuh), which K3 shares: columns a lane
# owns (the strip, R; kStrip), rows and strips of a sub-tile (a lane a row,
# at most 8 warps a block; kSubRows, kMaxStrips), and the longest chunk its
# rings take (2 * chunk + 1 planes in shared memory; kMaxChunk; a longer one
# is refused).
STRIP, SUB_ROWS, MAX_STRIPS = bk.STRIP, bk.SUB_ROWS, bk.MAX_STRIPS
MAX_CHUNK = bk.MAX_CHUNK
# Planes between two handshakes of a tile with its neighbours and of a strip
# with the next (the chunk; the default from chip_smoke.py "tuning",
# PERF.md).
CHUNK = 8
# Share of the card's free memory that one dispatch's face slabs may take.
BUDGET_SHARE = 0.5


class HeteroBatch(NamedTuple):
    """One K4 dispatch, as :func:`prep_hetero` packs it."""

    syms: torch.Tensor     # int32: each problem's A, B, C arrays, K3's layout
    geom: np.ndarray       # (n, len(GEOM_FIELDS)) int64
    lens: np.ndarray       # (n, 3) |A|, |B|, |C|
    hb: int
    wc: int
    tiles: np.ndarray      # (ntiles, 2) int32 (problem, jb), by diagonal
    diag_start: np.ndarray  # tiles of diagonal d: diag_start[d]:[d + 1]
    rf_ints: int           # ints of all row face slabs
    cf_ints: int           # ints of all column face slabs
    geom_dev: torch.Tensor   # geom on the batch's device
    table: np.ndarray      # (ntiles, len(TABLE_FIELDS)) int32
    table_dev: torch.Tensor  # table on the batch's device


class HeteroState(NamedTuple):
    """What a dispatch's sweep carries from launch to launch, on its device:
    every problem's face slabs at its ``rf_off`` / ``cf_off`` and the final
    values.  Face entries no tile has written hold ``blocked.UNWRITTEN``;
    ``out`` starts at zero, which is also the score of a problem with an
    empty sequence."""

    rf: torch.Tensor   # (max(rf_ints, 1),) int32 row faces
    cf: torch.Tensor   # (max(cf_ints, 1),) int32 column faces
    out: torch.Tensor  # (n, 7) int32
    # (max(ntiles, 1),) int32 progress words, one a table entry: -1 fresh,
    # the tile's last local plane |A| + tb + tc once it is swept.
    done: torch.Tensor


def _grid(lens: np.ndarray, hb: int, wc: int):
    """:func:`blocked.grid_dims` over (n, 3) lengths: which problems have
    no empty sequence, and their n_jb, n_kb and nrows (0 for the others).
    Raises grid_dims' ValueError for a tile plane without a cell where a
    problem has tiles."""
    live = lens.min(axis=1) > 0
    if not live.any():
        zero = np.zeros(len(lens), np.int64)
        return live, zero, zero, zero
    bk.grid_dims(1, 1, 1, hb, wc)
    tb, tc = hb - 1, wc - 1
    n_jb = np.maximum(1, -(-lens[:, 1] // tb)) * live
    n_kb = np.maximum(1, -(-lens[:, 2] // tc)) * live
    nrows = (lens[:, 0] + tb + tc + 1) * live
    return live, n_jb, n_kb, nrows


def _face_bytes(lens: np.ndarray, hb: int, wc: int) -> np.ndarray:
    """Bytes of each problem's face slabs at tile plane (hb, wc), (n, 3)
    lengths in; 0 for a problem with an empty sequence."""
    _, n_jb, n_kb, nrows = _grid(lens, hb, wc)
    return 4 * NUM_MATRICES * nrows * (n_kb * wc + n_jb * hb)


def face_bytes(la: int, lb: int, lc: int, hb: int, wc: int) -> int:
    """Bytes of one problem's face slabs at tile plane (hb, wc)."""
    return int(_face_bytes(np.array([[la, lb, lc]], np.int64), hb, wc)[0])


def _starts(sizes: np.ndarray) -> np.ndarray:
    """Where each of consecutive runs of ``sizes`` starts."""
    return np.cumsum(sizes) - sizes


def plan_dispatches(lens, hb: int, wc: int, budget_bytes: Optional[int] = None,
                    max_problems: Optional[int] = None) -> List[List[int]]:
    """Indices of the non-empty problems of ``lens`` ((n, 3) lengths), the
    longest |A| first, cut into dispatches whose face slabs take at most
    ``budget_bytes`` (a problem above it runs alone) and that hold at most
    ``max_problems`` problems; None is no limit."""
    with span("k4.plan"):
        lens = np.asarray(lens, dtype=np.int64).reshape(-1, 3)
        order = np.flatnonzero(lens.min(axis=1) > 0)
        order = order[np.argsort(-lens[order, 0], kind="stable")]
        need = _face_bytes(lens, hb, wc)[order]
        out: List[List[int]] = []
        used = 0
        for i, b in zip(order.tolist(), need.tolist()):
            full = out and (
                (budget_bytes is not None and used + b > budget_bytes)
                or (max_problems is not None and len(out[-1]) >= max_problems))
            if not out or full:
                out.append([])
                used = 0
            out[-1].append(i)
            used += b
        return out


def prep_hetero(triplets: Sequence, hb: int, wc: int, device) -> HeteroBatch:
    """Pack triplets into one dispatch at tile plane (hb, wc); raises
    ValueError for a tile plane the card cannot hold.  Problems keep their
    order, which is the order of their tiles within each diagonal.

    Each part is computed over the whole dispatch at once and written into
    one int32 buffer: the geometry first (so that its int64 view is
    aligned), the symbols, the table.  On a CUDA device the buffer is
    pinned and reaches the card in one copy on the current stream, and
    ``syms``, ``geom_dev`` and ``table_dev`` are views of the one device
    buffer; torch does not hand the pinned block out again before that copy
    has run, so dispatches in flight on other streams are safe."""
    with span("k4.pack"):
        bk.grid_dims(1, 1, 1, hb, wc)
        tb, tc = hb - 1, wc - 1
        n = len(triplets)
        seqs = list(itertools.chain.from_iterable(triplets))
        lens = np.fromiter(map(len, seqs), np.int64, 3 * n).reshape(n, 3)
        live, n_jb, n_kb, nrows = _grid(lens, hb, wc)
        # Each problem's A, B and C arrays one after another, none where a
        # sequence is empty: a pad, the sequence, pads to the array's size.
        size = np.stack([lens[:, 0] + 1, n_jb * tb + 1, n_kb * tc + 1],
                        axis=1) * live[:, None]
        nsyms = int(size.sum())
        rf_size = n_kb * nrows * NUM_MATRICES * wc
        cf_size = n_jb * nrows * NUM_MATRICES * hb
        # The table in groups g = d * n + p, a problem's tiles on one
        # diagonal, jb rising: (p, jb) on d is entry base[g] + jb, and its
        # neighbours (p, jb, kb - 1) and (p, jb - 1, kb) are in group g - n.
        n_diag = int((n_jb + n_kb).max()) - 1 if live.any() else 0
        d_g, p_g = np.divmod(np.arange(n_diag * n), n)
        jb_min = np.maximum(0, d_g - n_kb[p_g] + 1)
        count = np.maximum(0, np.minimum(d_g, n_jb[p_g] - 1) - jb_min + 1)
        base = _starts(count) - jb_min
        ntiles = int(count.sum())
        g = np.repeat(np.arange(n_diag * n), count)
        jb = np.arange(ntiles) - base[g]
        kb = d_g[g] - jb
        left = np.concatenate([np.zeros(n, np.int64), base])[g] + jb

        ends = np.cumsum([0, 2 * n * len(GEOM_FIELDS), max(nsyms, 1),
                          ntiles * len(TABLE_FIELDS)])
        dev = torch.device(device)
        host = torch.empty(int(ends[-1]), dtype=torch.int32,
                           pin_memory=dev.type == "cuda")
        h = host.numpy()
        geom = h[:ends[1]].view(np.int64).reshape(n, len(GEOM_FIELDS))
        np.stack([  # GEOM_FIELDS, zeros for a problem without tiles
                  lens[:, 0] * live, n_jb, n_kb, nrows,
                  (lens[:, 1] - (n_jb - 1) * tb) * live,
                  (lens[:, 2] - (n_kb - 1) * tc) * live,
                  *(_starts(size.ravel()).reshape(n, 3) * live[:, None]).T,
                  _starts(rf_size) * live, _starts(cf_size) * live],
                 axis=1, out=geom)
        syms = h[ends[1]:ends[2]]
        if nsyms:
            keep = np.repeat(live, 3)
            seq_len, arr_len = lens.ravel()[keep], size.ravel()[keep]
            pads = np.tile(np.int32([PAD_A, PAD_B, PAD_C]), n)[keep]
            syms[:] = np.repeat(pads, arr_len)
            runs = np.stack([np.ones_like(seq_len), seq_len,
                             arr_len - 1 - seq_len], axis=1).ravel()
            at_seq = np.repeat(np.tile([False, True, False], len(seq_len)),
                               runs)
            syms[at_seq] = np.concatenate(list(itertools.compress(seqs,
                                                                  keep)))
        else:
            syms[:] = 0
        table = h[ends[2]:].reshape(ntiles, len(TABLE_FIELDS))
        np.stack([p_g[g], jb, kb, np.where(jb > 0, left - 1, -1),
                  np.where(kb > 0, left, -1)], axis=1, out=table)
        buf = host.to(dev, non_blocking=True)
        return HeteroBatch(
            buf[ends[1]:ends[2]], geom, lens, hb, wc,
            np.ascontiguousarray(table[:, :2]),
            np.concatenate([[0], np.cumsum(
                count.reshape(n_diag, n).sum(axis=1))]),
            int(rf_size.sum()), int(cf_size.sum()),
            buf[:ends[1]].view(torch.int64).view(n, len(GEOM_FIELDS)), table,
            buf[ends[2]:].view(ntiles, len(TABLE_FIELDS)))


def new_state(batch: HeteroBatch) -> HeteroState:
    """A fresh sweep state for ``batch``, on its device."""
    with span("k4.pack"):
        i32 = dict(dtype=torch.int32, device=batch.syms.device)
        return HeteroState(
            torch.full((max(batch.rf_ints, 1),), bk.UNWRITTEN, **i32),
            torch.full((max(batch.cf_ints, 1),), bk.UNWRITTEN, **i32),
            torch.zeros((len(batch.lens), NUM_MATRICES), **i32),
            torch.full((max(len(batch.tiles), 1),), -1, **i32),
        )


def _diag_runs(batch: HeteroBatch, idx0: int, count: int):
    """Entries idx0 .. idx0 + count - 1 of ``batch.tiles`` as runs of one
    global anti-diagonal each: (d, first entry, entries)."""
    _check_range(batch, idx0, count)
    lo, end = idx0, idx0 + count
    while lo < end:
        d = int(np.searchsorted(batch.diag_start, lo, side="right")) - 1
        hi = min(end, int(batch.diag_start[d + 1]))
        yield d, lo, hi - lo
        lo = hi


def _problem(batch: HeteroBatch, state: HeteroState, p: int):
    """Problem p's symbol arrays, dims and K3 state: views into the
    dispatch's buffers, so that K3's plain version updates them in place."""
    la, lb, lc = (int(x) for x in batch.lens[p])
    g = batch.geom[p]
    hb, wc = batch.hb, batch.wc
    n_jb, n_kb, nrows = (int(g[_G[k]]) for k in ("n_jb", "n_kb", "nrows"))
    dims = bk.Dims(hb, wc, n_jb, n_kb, la + hb - 1 + wc - 1, nrows)
    arrs = [batch.syms[int(g[_G[name]]):int(g[_G[name]]) + size]
            for name, size in (("a_off", la + 1),
                               ("b_off", n_jb * (hb - 1) + 1),
                               ("c_off", n_kb * (wc - 1) + 1))]
    rf0, cf0 = int(g[_G["rf_off"]]), int(g[_G["cf_off"]])
    rf = state.rf[rf0:rf0 + n_kb * nrows * NUM_MATRICES * wc]
    cf = state.cf[cf0:cf0 + n_jb * nrows * NUM_MATRICES * hb]
    return arrs, (la, lb, lc), dims, bk.BlockedState(
        rf.view(n_kb, nrows, NUM_MATRICES, wc),
        cf.view(n_jb, nrows, NUM_MATRICES, hb), state.out[p:p + 1])


def hetero_ref(batch: HeteroBatch, scoring: Scoring = Scoring(),
               state: Optional[HeteroState] = None, idx0: int = 0,
               count: Optional[int] = None,
               score_bits: int = 0) -> torch.Tensor:
    """Plain torch version of K4: sweeps entries idx0 .. idx0 + count - 1 of
    ``batch.tiles`` (all by default) from ``state`` (a fresh one by
    default), updating it in place, and returns its final values, an (n, 7)
    int32 tensor on the batch's device (zeros for a problem with an empty
    sequence).  Each problem's tiles of one diagonal run through K3's plain
    version ``blocked_ref`` at the batch's tile plane, on views of the
    dispatch's symbol and face buffers; each swept entry's progress word
    becomes its tile's last local plane, as the kernel leaves it.
    ``score_bits`` wraps stored values as K2's mode of the register step
    does (K4 itself refuses it); the tests hold :func:`step_layout_ref`
    to it."""
    if state is None:
        state = new_state(batch)
    if count is None:
        count = len(batch.tiles) - idx0
    for d, lo, n in _diag_runs(batch, idx0, count):
        rows = batch.tiles[lo:lo + n]
        # Within a diagonal each problem's tiles are contiguous, jb rising.
        starts = [0] + [r for r in range(1, n) if rows[r, 0] != rows[r - 1, 0]]
        for r0, r1 in zip(starts, starts[1:] + [n]):
            p, jb0 = int(rows[r0, 0]), int(rows[r0, 1])
            arrs, lens, dims, pstate = _problem(batch, state, p)
            bk.blocked_ref(*arrs, *lens, dims, scoring, score_bits, pstate,
                           bk.tile_index(dims, d, jb0), r1 - r0)
            state.done[lo + r0:lo + r1] = dims.nq
    return state.out


# ------------------------------------------------------- the register step

# The pre-reduced partials of the register step (csrc/pillar_warp.cuh): for
# each target matrix t (M, Ix, Iy, Iz, Ixy, Iyz, Ixz), the groups of source
# matrices with one gap charge each, as (sources, gap opens, gap extends),
# and where the partial max_s(v[s] + W[t, s]) of a cell's seven values v
# goes: (planes later, rows down, columns right).  The consumer adds its
# substitution score (S3, -, -, -, S(a,b), S(b,c), S(a,c)) and nothing else.
PARTIALS = (
    ((((0, 1, 2, 3, 4, 5, 6), 0, 0),), (3, 1, 1)),
    ((((0, 5), 2, 0), ((1,), 0, 2), ((2, 3, 4, 6), 1, 1)), (1, 0, 0)),
    ((((0, 6), 2, 0), ((2,), 0, 2), ((1, 3, 4, 5), 1, 1)), (1, 1, 0)),
    ((((0, 4), 2, 0), ((3,), 0, 2), ((1, 2, 5, 6), 1, 1)), (1, 0, 1)),
    ((((0, 3, 5, 6), 1, 0), ((1, 2, 4), 0, 1)), (2, 1, 0)),
    ((((0, 1, 4, 6), 1, 0), ((2, 3, 5), 0, 1)), (2, 1, 1)),
    ((((0, 2, 4, 5), 1, 0), ((1, 3, 6), 0, 1)), (2, 0, 1)),
)
# The partials that cross a lane (from the row above: Iy, Ixy, Iyz, M) and
# those a strip hands the next through the ring (its last column's Iz, Ixz,
# Iyz, M); the halo row carries the first kind, the halo column the second.
FROM_ABOVE = (2, 4, 5, 0)
ACROSS = (3, 6, 5, 0)
# A partial the step never carries: large, so that a read of one shows.
POISON = bk.UNWRITTEN


def partials(v: torch.Tensor, scoring: Scoring) -> torch.Tensor:
    """The seven partials (PARTIALS) of cells with values ``v`` (7, ...)."""
    go, ge = scoring.gap_open, scoring.gap_extend
    out = []
    for groups, _ in PARTIALS:
        best = None
        for srcs, opens, extends in groups:
            g = v[list(srcs)].amax(dim=0) - (opens * go + extends * ge)
            best = g if best is None else torch.maximum(best, g)
        out.append(best)
    return torch.stack(out)


def _only(p: torch.Tensor, keep) -> torch.Tensor:
    """``p`` with every partial outside ``keep`` poisoned."""
    out = torch.full_like(p, POISON)
    out[list(keep)] = p[list(keep)]
    return out


def _warp_tile(batch: HeteroBatch, state: HeteroState, entry: int,
               scoring: Scoring, strip: int, chunk: int,
               ring_depth: Optional[int], lanes: int, max_strips: int,
               score_bits: int) -> None:
    """One table entry's tile swept in the register step's order, in place:
    sub-tiles of at most ``lanes`` rows and ``max_strips`` strips of
    ``strip`` columns, row after row of them, each on the tile's face slabs
    shifted to its corner (:func:`_warp_sub_tile`)."""
    p, jb, kb = (int(x) for x in batch.table[entry, :3])
    (a_ext, b_ext, c_ext), (la, _, _), dims, pst = _problem(batch, state, p)
    tb, tc = dims.hb - 1, dims.wc - 1
    g = batch.geom[p]
    target = jb == dims.n_jb - 1 and kb == dims.n_kb - 1
    jlstar, klstar = int(g[_G["jlstar"]]), int(g[_G["klstar"]])
    cols = strip * max_strips
    for j0 in range(0, tb, lanes):
        for k0 in range(0, tc, cols):
            star = (jlstar - j0, klstar - k0)
            if not (target and 0 < star[0] <= lanes and 0 < star[1] <= cols):
                star = None
            _warp_sub_tile(
                a_ext, b_ext[jb * tb + j0:], c_ext[kb * tc + k0:], la,
                pst.rf[kb][k0:, :, k0:], pst.cf[jb][j0:, :, j0:],
                min(lanes, tb - j0), min(cols, tc - k0), jb > 0 or j0 > 0,
                kb > 0 or k0 > 0, k0 > 0, star, state.out[p], scoring,
                strip, chunk, ring_depth, score_bits)


def _warp_sub_tile(a_ext, b_sub, c_sub, la: int, rf, cf, tb: int, tc: int,
                   has_row: bool, has_col: bool, corner_col: bool, star, out,
                   scoring: Scoring, strip: int, chunk: int,
                   ring_depth: Optional[int], score_bits: int) -> None:
    """One sub-tile of tb x tc cells swept in the register step's order.

    ``b_sub[jl]`` and ``c_sub[kl]`` are its rows' and columns' symbols;
    ``rf`` and ``cf`` its tile's face slabs shifted so that its halo row of
    plane q is ``rf[q]`` and its halo column ``cf[q]``, written before
    where ``has_row`` / ``has_col``; ``star`` its final cell (jl, kl), whose
    values go to ``out``, or None.  With ``corner_col`` (a sub-tile past the
    tile's first column) the halo corner comes from the column face,
    entry 0, where the sub-tile to the left staged it: its row-face slot
    holds that sub-tile's bottom row by then.  Lanes are rows jl = 1 .. tb (one vector
    here); strip w owns columns w * R + 1 .. w * R + R.  A strip's plane q
    is P (7, tb + 1, R + 1): the partials of its cells, row 0 those of the
    halo row (from the row face, FROM_ABOVE only), column 0 those of the
    previous strip's last column (ACROSS only, from the ring, filled at
    plane q + 1) or of the halo column (strip 0).  Strips run chunk by
    chunk as the kernel's warps do at their most apart: strip w runs chunk
    c once strip w - 1 has run chunk c + 1, so the ring of ``ring_depth``
    planes (2 * chunk + 1) is read at its oldest.  With ``score_bits`` a
    cell's values wrap where they are made, before they become partials or
    face entries."""
    dev = a_ext.device
    nq = la + tb + tc
    R, W = strip, -(-tc // strip)
    D = ring_depth or 2 * chunk + 1
    pair = pair_fn(scoring, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    jl = torch.arange(1, tb + 1, device=dev).view(tb, 1)
    bsym = b_sub[jl]
    zero = partials(torch.zeros((NUM_MATRICES, tb + 1, R + 1), **i32),
                    scoring)
    hist = [{q: zero for q in (-2, -1, 0)} for _ in range(W)]
    ring = [torch.full((D, NUM_MATRICES, tb + 1), POISON, **i32)
            for _ in range(W)]
    chunks = [(q0, min(q0 + chunk, nq + 1)) for q0 in range(1, nq + 1, chunk)]
    staged_row, staged_col = {}, {}

    def halo(face, q, idx, n_ok):
        """Raw halo values (7, len(idx)) of face row q at entries idx, zero
        where the face has no writer or i is outside 1 .. |A|."""
        i = q - idx
        ok = n_ok & (i >= 1) & (i <= la)
        vals = face[q][:, idx.clamp(max=face.shape[-1] - 1)]
        return torch.where(ok.view(1, -1), vals, 0)

    def stage(w, q0, q1):
        k = torch.arange(w * R, w * R + R + 1, device=dev)
        for q in range(q0, q1):
            raw = halo(rf, q, k, torch.tensor(has_row) & (k <= tc))
            if corner_col and not w:
                raw[:, :1] = halo(cf, q, k[:1], torch.tensor(has_row))
            staged_row[w, q] = _only(partials(raw, scoring), FROM_ABOVE)
            if w:  # (0, w * R) comes through the ring
                staged_row[w, q][:, 0] = POISON
            if w * R < tc <= w * R + R and 1 <= q - tc <= la:
                cf[q - tc, :, 0] = raw[:, tc - w * R]
        if w:
            return
        rows = torch.arange(1, tb + 1, device=dev)
        for q in range(q0, q1):
            raw = halo(cf, q, rows, torch.tensor(has_col))
            staged_col[q] = _only(partials(raw, scoring), ACROSS)
            if 1 <= q - tb <= la:
                rf[q - tb, :, 0] = raw[:, tb - 1]

    def plane(w, q):
        k0 = w * R
        k = torch.arange(k0 + 1, k0 + R + 1, device=dev).view(1, R)
        h = hist[w]
        if q > 1:  # the boundary column of plane q - 1
            src = ring[w][(q - 1) % D] if w else None
            for t in ACROSS:
                h[q - 1][t, 1:, 0] = src[t, 1:] if w else staged_col[q - 1][t]
            if w:
                for t in (5, 0):
                    h[q - 1][t, 0, 0] = src[t, 0]
        v = torch.stack([h[q - dq][t, 1 - dj:tb + 1 - dj, 1 - dk:R + 1 - dk]
                         for t, (_, (dq, dj, dk)) in enumerate(PARTIALS)])
        i = q - jl - k
        csym = c_sub[k.clamp(max=len(c_sub) - 1)]
        subs = substitution(a_ext[i.clamp(0, la)], bsym, csym,
                            pair(bsym, csym), scoring, pair)
        v = wrap(v + torch.stack([torch.as_tensor(s, **i32).expand(tb, R)
                                  for s in subs]), score_bits)
        ok = (i >= 1) & (i <= la) & (k <= tc)
        v = torch.where(ok, v, 0)
        P = torch.full((NUM_MATRICES, tb + 1, R + 1), POISON, **i32)
        P[:, 0] = staged_row.pop((w, q))
        P[:, 1:, 1:] = partials(v, scoring)
        if q - tb >= 0:
            n = min(R, tc - k0)
            rf[q - tb, :, k0 + 1:k0 + n + 1] = torch.where(
                ok[tb - 1, :n], v[:, tb - 1, :n],
                rf[q - tb, :, k0 + 1:k0 + n + 1])
        if k0 < tc <= k0 + R and q - tc >= 0:
            r = tc - k0 - 1
            cf[q - tc, :, 1:tb + 1] = torch.where(
                ok[:, r], v[:, :, r], cf[q - tc, :, 1:tb + 1])
        if star and q == la + sum(star) and k0 < star[1] <= k0 + R:
            out[:] = v[:, star[0] - 1, star[1] - k0 - 1]
        if w + 1 < W:
            for t in ACROSS:
                ring[w + 1][q % D][t, 1:] = P[t, 1:, R]
            for t in (5, 0):
                ring[w + 1][q % D][t, 0] = P[t, 0, R]
        h[q] = P
        h.pop(q - 4, None)

    for s in range(len(chunks) + W - 1):
        for w in range(W):
            c = s - w
            if 0 <= c < len(chunks):
                stage(w, *chunks[c])
                for q in range(*chunks[c]):
                    plane(w, q)


def step_layout_ref(batch: HeteroBatch, scoring: Scoring = Scoring(),
                    state: Optional[HeteroState] = None, idx0: int = 0,
                    count: Optional[int] = None, strip: int = STRIP,
                    chunk: int = CHUNK, ring_depth: Optional[int] = None,
                    lanes: int = SUB_ROWS, max_strips: int = MAX_STRIPS,
                    score_bits: int = 0) -> torch.Tensor:
    """:func:`hetero_ref` computed in the register step's layout
    (``csrc/pillar_warp.cuh``), one table entry after another: sub-tiles of
    at most ``lanes`` rows and ``max_strips`` strips of ``strip`` columns
    (the kernel's are 32, 8 and 4), lanes as rows, the partials of
    :data:`PARTIALS` handed down and across, the ring between strips
    ``ring_depth`` planes deep (2 * chunk + 1 by default), each value
    wrapped to ``score_bits`` (K2's mode; 0 is K4's).  For the tests."""
    if state is None:
        state = new_state(batch)
    if count is None:
        count = len(batch.tiles) - idx0
    _check_range(batch, idx0, count)
    for e in range(idx0, idx0 + count):
        _warp_tile(batch, state, e, scoring, strip, chunk, ring_depth, lanes,
                   max_strips, score_bits)
        p = int(batch.table[e, 0])
        state.done[e] = int(batch.geom[p, _G["la"]]) + batch.hb + batch.wc - 2
    return state.out


# ------------------------------------------------------------ the wrappers

def _check_range(batch: HeteroBatch, idx0: int, count: int) -> None:
    if idx0 < 0 or count < 0 or idx0 + count > len(batch.tiles):
        raise ValueError(f"entries {idx0} .. {idx0 + count - 1} are not in a "
                         f"table of {len(batch.tiles)}")


def _check_state(batch: HeteroBatch, state: HeteroState) -> None:
    dev = batch.syms.device
    shapes = ((max(batch.rf_ints, 1),), (max(batch.cf_ints, 1),),
              (len(batch.lens), NUM_MATRICES), (max(len(batch.tiles), 1),))
    for t, shape in zip(state, shapes):
        if t.dtype != torch.int32 or t.shape != shape or \
                not t.is_contiguous() or t.device != dev:
            raise ValueError("the state must be new_state(batch)'s, on the "
                             "batch's device")


def _check_step(chunk: int, blocks: Optional[int]) -> None:
    """Raise ValueError for a schedule the register step does not take."""
    bk.check_schedule(chunk, blocks)
    if chunk > MAX_CHUNK:
        raise ValueError(f"K4 takes chunks of at most {MAX_CHUNK} planes, "
                         f"not {chunk}")


def _mode(scoring: Scoring) -> int:
    """csrc/hetero.cu's step mode: bit 0 rtl, bit 1 a submatrix."""
    return int(scoring.s3_mode == "rtl") | 2 * int(scoring.submatrix
                                                    is not None)


def _run(counter, batch: HeteroBatch, state: HeteroState, idx0: int,
         count: int, scoring: Scoring, chunk: int,
         blocks: Optional[int]) -> HeteroState:
    """Entries idx0 .. idx0 + count - 1 on ``state``: hetero_ref on a CPU
    tensor; on a CUDA tensor one persistent launch of K4 (counted on
    ``counter``) that raises if refused and never falls back."""
    _build.check_submatrix(scoring)
    _check_state(batch, state)
    _check_range(batch, idx0, count)
    _check_step(chunk, blocks)
    dev = batch.syms.device
    if dev.type == "cpu":
        hetero_ref(batch, scoring, state, idx0, count)
        return state
    if dev.type != "cuda":
        raise ValueError(f"no hetero kernel for device {dev}")
    if count == 0:
        return state
    _launch(batch, state, idx0, count, scoring, chunk, blocks, False)
    counter.launches += 1
    return state


def _launch(batch: HeteroBatch, state: HeteroState, idx0: int, count: int,
            scoring: Scoring, chunk: int, blocks: Optional[int],
            clock: bool) -> None:
    """One persistent launch of K4 (its clocked build if ``clock``) on the
    current stream."""
    dev = batch.syms.device
    with torch.cuda.device(dev):
        with span("k4.pack"):
            lib = _build.load("hetero")
            step, table = _build.kernel_scoring(scoring, 0, dev)
            # The hand-out counter, on the stream.
            next_entry = torch.zeros(1, dtype=torch.int32, device=dev)
        with span("k4.launch"):
            code = lib.trialign_hetero_sweep(
                batch.syms.data_ptr(), batch.geom_dev.data_ptr(),
                batch.table_dev.data_ptr(), idx0, count, batch.hb,
                batch.wc, table.data_ptr(), step, state.rf.data_ptr(),
                state.cf.data_ptr(), state.out.data_ptr(),
                state.done.data_ptr(), next_entry.data_ptr(), chunk,
                blocks or 0, int(clock),
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(lib, code, "hetero kernel launch (persistent sweep)")


# The phases of step_phases, in csrc/pillar_warp.cuh PhaseClock order.
PHASES = ("wait", "halo", "planes", "bottom_row", "hand_on")


def step_phases(batch: HeteroBatch, chunk: int = CHUNK) -> List[dict]:
    """Where K4's warps spend their cycles on ``batch`` (a CUDA dispatch,
    default scoring): the whole table once on the sweep's build with the
    phase clock, which is not the one the package runs and counts no
    launch.  For each strip, the cycles of its warps in each of
    :data:`PHASES`, summed over tiles, and its chunks."""
    _check_step(chunk, None)
    if not batch.syms.is_cuda:
        raise ValueError("step_phases runs on a CUDA device")
    lib = _build.load("hetero")
    n = len(PHASES) + 1
    sums = (ctypes.c_ulonglong * (MAX_STRIPS * n))()
    _build.check(lib, lib.trialign_hetero_phases(sums), "phase clock reset")
    _launch(batch, new_state(batch), 0, len(batch.tiles), Scoring(), chunk,
            None, True)
    torch.cuda.synchronize(batch.syms.device)
    _build.check(lib, lib.trialign_hetero_phases(sums), "phase clock read")
    strips = min(-(-(batch.wc - 1) // STRIP), MAX_STRIPS)
    return [{**{name: int(sums[w * n + k]) for k, name in enumerate(PHASES)},
             "chunks": int(sums[w * n + len(PHASES)])}
            for w in range(strips)]


def sweep_tiles(batch: HeteroBatch, state: HeteroState, idx0: int,
                count: int, scoring: Scoring = Scoring(), chunk: int = CHUNK,
                blocks: Optional[int] = None) -> HeteroState:
    """K4's per-tile form (blocked.py make_hetero_block_call): runs entries
    idx0 .. idx0 + count - 1 of ``batch.tiles`` on ``state`` (from
    :func:`new_state`) in place and returns it; ``state.out[p]`` holds
    problem p's final values once its last tile has run.  Runs go in table
    order and may end in the middle of a diagonal.  On a CPU tensor this is
    :func:`hetero_ref`; on a CUDA tensor it is one persistent launch of K4
    (``chunk`` planes between handshakes, at most ``MAX_CHUNK``; ``blocks``
    caps the grid, the SMs' occupancy by default), which never falls back.
    Nothing waits for the card."""
    return _run(sweep_tiles, batch, state, idx0, count, scoring, chunk,
                blocks)


def final_values(batch: HeteroBatch, scoring: Scoring = Scoring(),
                 chunk: int = CHUNK,
                 blocks: Optional[int] = None) -> torch.Tensor:
    """The seven final-cell values of each problem of a dispatch, an (n, 7)
    int32 tensor (zeros for a problem with an empty sequence):
    :func:`sweep_tiles` over the whole table on a fresh state, one launch on
    a CUDA tensor, :func:`hetero_ref` on a CPU tensor.  Nothing waits for
    the card."""
    return _run(final_values, batch, new_state(batch), 0, len(batch.tiles),
                scoring, chunk, blocks).out


def step_resources(hb: int, wc: int, scoring: Scoring = Scoring(),
                   chunk: int = CHUNK) -> dict:
    """What K4's persistent kernel takes on the current card at tile plane
    (hb, wc): registers a thread, local-memory (spill) bytes a thread,
    threads and shared bytes a block, and blocks an SM."""
    _check_step(chunk, None)
    lib = _build.load("hetero")
    vals = (ctypes.c_int * 5)()
    _build.check(lib, lib.trialign_hetero_resources(
        hb, wc, chunk, _mode(scoring), vals), "hetero resource query")
    return dict(zip(("registers", "local_bytes", "threads", "shared_bytes",
                     "blocks_per_sm"), list(vals)))


# Launches of the CUDA kernel since the count was last set to 0, for each
# entry point: the whole dispatch (final_values) and the per-tile form
# (sweep_tiles).
final_values.launches = 0
sweep_tiles.launches = 0


def default_budget(device, sharing: int = 1) -> Optional[int]:
    """Face-slab bytes one dispatch may take: ``BUDGET_SHARE`` of the card's
    free memory over the ``sharing`` dispatches that run on it at once (the
    data slots of a mesh that name one card), or no limit on the CPU (the
    plain version allocates each problem's faces on its own).  Memory that
    torch's caching allocator holds but no tensor uses counts as free: the
    faces are allocated from that cache first."""
    with span("k4.plan"):
        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(dev)
        cached = torch.cuda.memory_reserved(dev) - \
            torch.cuda.memory_allocated(dev)
        return int((free + cached) * BUDGET_SHARE / max(1, sharing))


def align_hetero(triplets: Sequence, scoring: Scoring = Scoring(),
                 device="cuda", block_shape: Optional[Tuple[int, int]] = None,
                 max_problems: Optional[int] = None,
                 budget_bytes: Optional[int] = None,
                 on_scores: Optional[Callable[[int, int], None]] = None,
                 ) -> List[int]:
    """Optimal scores of a batch of triplets through K4 (its plain version
    on ``device="cpu"``), in input order; an empty sequence scores 0.

    ``block_shape`` is the shared tile plane (hb, wc), K3's default if None.
    :func:`plan_dispatches` cuts the batch at ``max_problems`` problems and
    at ``budget_bytes`` of face slabs (:func:`default_budget` if None).
    Every dispatch is queued before any score is read; ``on_scores(i,
    score)`` fires for each problem as its dispatch drains (for an empty
    one, at once).  When a dispatch fails as it is packed or launched, the
    dispatches queued before it drain before the failure is raised, so that
    a retry (``align_batch_resilient``) runs none of them again."""
    triplets = [tuple(np.asarray(s) for s in t) for t in triplets]
    hb, wc = block_shape or bk.choose_block_shape(0, 0, 0)
    if budget_bytes is None:
        budget_bytes = default_budget(device)
    lens = [[len(x) for x in t] for t in triplets]
    out = [0] * len(triplets)
    for i, t in enumerate(lens):
        if min(t) == 0 and on_scores is not None:
            on_scores(i, 0)
    pending = []

    def drain() -> None:
        for idx, scores in pending:
            with span("wait"):
                scores = scores.tolist()
            for i, s in zip(idx, scores):
                out[i] = int(s)
                if on_scores is not None:
                    on_scores(i, out[i])

    try:
        for idx in plan_dispatches(lens, hb, wc, budget_bytes, max_problems):
            batch = prep_hetero([triplets[i] for i in idx], hb, wc, device)
            pending.append((idx,
                            final_values(batch, scoring).max(dim=1).values))
    except Exception:
        drain()
        raise
    drain()
    return out
