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
per-problem geometry table (``GEOM_FIELDS``), and a table of (problem, tile
row) pairs for each global tile anti-diagonal.  :func:`plan_dispatches`
splits a batch into dispatches whose face slabs fit a byte budget, the
longest |A| first.

The sweep state (:class:`HeteroState`: every problem's face slabs and final
values) stays on the device from launch to launch, so :func:`sweep_tiles`
runs any run of the dispatch's table, K4's per-tile form (the port of
``make_hetero_block_call``); :func:`final_values` is that over the whole
table.  On a CUDA tensor they launch K4 once per run of one anti-diagonal.
On a CPU tensor they run :func:`hetero_ref`, which sweeps each problem's
tiles with K3's plain version ``blocked_ref`` at the dispatch's tile plane,
on the same state.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from trialign_torch import _build
from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels.ref import PAD_A, PAD_B, PAD_C

# Columns of the geometry table, in csrc/hetero.cu GeomField order.
GEOM_FIELDS = ("la", "n_jb", "n_kb", "nrows", "jlstar", "klstar",
               "a_off", "b_off", "c_off", "rf_off", "cf_off")
_G = {name: col for col, name in enumerate(GEOM_FIELDS)}
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
    tiles_dev: torch.Tensor  # tiles on the batch's device


class HeteroState(NamedTuple):
    """What a dispatch's sweep carries from launch to launch, on its device:
    every problem's face slabs at its ``rf_off`` / ``cf_off`` and the final
    values.  Face entries no tile has written hold ``blocked.UNWRITTEN``;
    ``out`` starts at zero, which is also the score of a problem with an
    empty sequence."""

    rf: torch.Tensor   # (max(rf_ints, 1),) int32 row faces
    cf: torch.Tensor   # (max(cf_ints, 1),) int32 column faces
    out: torch.Tensor  # (n, 7) int32


def face_bytes(la: int, lb: int, lc: int, hb: int, wc: int) -> int:
    """Bytes of one problem's face slabs at tile plane (hb, wc)."""
    if min(la, lb, lc) == 0:
        return 0
    d = bk.plan_dims(la, lb, lc, hb, wc)
    return 4 * NUM_MATRICES * d.nrows * (d.n_kb * wc + d.n_jb * hb)


def plan_dispatches(lens, hb: int, wc: int, budget_bytes: Optional[int] = None,
                    max_problems: Optional[int] = None) -> List[List[int]]:
    """Indices of the non-empty problems of ``lens`` ((n, 3) lengths), the
    longest |A| first, cut into dispatches whose face slabs take at most
    ``budget_bytes`` (a problem above it runs alone) and that hold at most
    ``max_problems`` problems; None is no limit."""
    lens = [tuple(int(x) for x in t) for t in lens]
    order = sorted((i for i, t in enumerate(lens) if min(t) > 0),
                   key=lambda i: -lens[i][0])
    out: List[List[int]] = []
    used = 0
    for i in order:
        need = face_bytes(*lens[i], hb, wc)
        full = out and (
            (budget_bytes is not None and used + need > budget_bytes)
            or (max_problems is not None and len(out[-1]) >= max_problems))
        if not out or full:
            out.append([])
            used = 0
        out[-1].append(i)
        used += need
    return out


def prep_hetero(triplets: Sequence, hb: int, wc: int, device) -> HeteroBatch:
    """Pack triplets into one dispatch at tile plane (hb, wc); raises
    ValueError for a tile plane the card cannot hold.  Problems keep their
    order, which is the order of their tiles within each diagonal."""
    bk.plan_dims(1, 1, 1, hb, wc)
    tb, tc = hb - 1, wc - 1
    n = len(triplets)
    geom = np.zeros((n, len(GEOM_FIELDS)), np.int64)
    lens = np.zeros((n, 3), np.int64)
    parts, off, rf, cf = [], 0, 0, 0
    tiles = []  # (diagonal, problem, jb)
    for p, t in enumerate(triplets):
        la, lb, lc = (len(x) for x in t)
        lens[p] = la, lb, lc
        if min(la, lb, lc) == 0:
            continue
        d = bk.plan_dims(la, lb, lc, hb, wc)
        g = geom[p]
        g[_G["la"]], g[_G["n_jb"]], g[_G["n_kb"]] = la, d.n_jb, d.n_kb
        g[_G["nrows"]] = d.nrows
        g[_G["jlstar"]] = lb - (d.n_jb - 1) * tb
        g[_G["klstar"]] = lc - (d.n_kb - 1) * tc
        for name, seq, size, pad in (
                ("a_off", t[0], la + 1, PAD_A),
                ("b_off", t[1], d.n_jb * tb + 1, PAD_B),
                ("c_off", t[2], d.n_kb * tc + 1, PAD_C)):
            arr = np.full(size, pad, np.int32)
            arr[1:len(seq) + 1] = np.asarray(seq, dtype=np.int32)
            parts.append(arr)
            g[_G[name]] = off
            off += size
        g[_G["rf_off"]], g[_G["cf_off"]] = rf, cf
        rf += d.n_kb * d.nrows * NUM_MATRICES * wc
        cf += d.n_jb * d.nrows * NUM_MATRICES * hb
        jb, kb = np.meshgrid(np.arange(d.n_jb), np.arange(d.n_kb),
                             indexing="ij")
        tiles.append(np.stack([(jb + kb).ravel(), np.full(jb.size, p),
                               jb.ravel()], axis=1))
    tiles = np.concatenate(tiles) if tiles else np.zeros((0, 3), np.int64)
    tiles = tiles[np.lexsort((tiles[:, 1], tiles[:, 0]))]
    n_diag = int(tiles[:, 0].max()) + 1 if len(tiles) else 0
    diag_start = np.searchsorted(tiles[:, 0], np.arange(n_diag + 1))
    syms = np.concatenate(parts) if parts else np.zeros(1, np.int32)
    tiles = np.ascontiguousarray(tiles[:, 1:].astype(np.int32))
    return HeteroBatch(torch.from_numpy(syms).to(device), geom, lens, hb, wc,
                       tiles, diag_start, rf, cf,
                       torch.from_numpy(geom).to(device),
                       torch.from_numpy(tiles).to(device))


def new_state(batch: HeteroBatch) -> HeteroState:
    """A fresh sweep state for ``batch``, on its device."""
    i32 = dict(dtype=torch.int32, device=batch.syms.device)
    return HeteroState(
        torch.full((max(batch.rf_ints, 1),), bk.UNWRITTEN, **i32),
        torch.full((max(batch.cf_ints, 1),), bk.UNWRITTEN, **i32),
        torch.zeros((len(batch.lens), NUM_MATRICES), **i32),
    )


def _diag_runs(batch: HeteroBatch, idx0: int, count: int):
    """Entries idx0 .. idx0 + count - 1 of ``batch.tiles`` as runs of one
    global anti-diagonal each: (d, first entry, entries)."""
    if idx0 < 0 or count < 0 or idx0 + count > len(batch.tiles):
        raise ValueError(f"entries {idx0} .. {idx0 + count - 1} are not in a "
                         f"table of {len(batch.tiles)}")
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
               count: Optional[int] = None) -> torch.Tensor:
    """Plain torch version of K4: sweeps entries idx0 .. idx0 + count - 1 of
    ``batch.tiles`` (all by default) from ``state`` (a fresh one by
    default), updating it in place, and returns its final values, an (n, 7)
    int32 tensor on the batch's device (zeros for a problem with an empty
    sequence).  Each problem's tiles of one diagonal run through K3's plain
    version ``blocked_ref`` at the batch's tile plane, on views of the
    dispatch's symbol and face buffers."""
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
            bk.blocked_ref(*arrs, *lens, dims, scoring, 0, pstate,
                           bk.tile_index(dims, d, jb0), r1 - r0)
    return state.out


def _check_state(batch: HeteroBatch, state: HeteroState) -> None:
    dev = batch.syms.device
    shapes = ((max(batch.rf_ints, 1),), (max(batch.cf_ints, 1),),
              (len(batch.lens), NUM_MATRICES))
    for t, shape in zip(state, shapes):
        if t.dtype != torch.int32 or t.shape != shape or \
                not t.is_contiguous() or t.device != dev:
            raise ValueError("the state must be new_state(batch)'s, on the "
                             "batch's device")


def _run(counter, batch: HeteroBatch, state: HeteroState, idx0: int,
         count: int, scoring: Scoring) -> HeteroState:
    """Entries idx0 .. idx0 + count - 1 on ``state``: hetero_ref on a CPU
    tensor, K4 (one launch a run of one diagonal, counted on ``counter``) on
    a CUDA tensor, never a fallback."""
    _build.check_submatrix(scoring)
    _check_state(batch, state)
    dev = batch.syms.device
    if dev.type == "cpu":
        hetero_ref(batch, scoring, state, idx0, count)
        return state
    if dev.type != "cuda":
        raise ValueError(f"no hetero kernel for device {dev}")
    lib = _build.load("hetero")
    step, table = _build.kernel_scoring(scoring, 0, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for d, lo, n in _diag_runs(batch, idx0, count):
            code = lib.trialign_hetero_diag(
                batch.syms.data_ptr(), batch.geom_dev.data_ptr(),
                batch.tiles_dev.data_ptr() + 8 * lo, n, batch.hb, batch.wc,
                d, table.data_ptr(), step, state.rf.data_ptr(),
                state.cf.data_ptr(), state.out.data_ptr(), stream,
            )
            _build.check(lib, code, f"hetero kernel launch (diagonal {d})")
            counter.launches += 1
    return state


def sweep_tiles(batch: HeteroBatch, state: HeteroState, idx0: int,
                count: int, scoring: Scoring = Scoring()) -> HeteroState:
    """K4's per-tile form (blocked.py make_hetero_block_call): runs entries
    idx0 .. idx0 + count - 1 of ``batch.tiles`` on ``state`` (from
    :func:`new_state`) in place and returns it; ``state.out[p]`` holds
    problem p's final values once its last tile has run.  A run may end in
    the middle of a diagonal.  On a CPU tensor this is :func:`hetero_ref`;
    on a CUDA tensor it launches K4 once per run of one diagonal and never
    falls back.  Nothing waits for the card."""
    return _run(sweep_tiles, batch, state, idx0, count, scoring)


def final_values(batch: HeteroBatch,
                 scoring: Scoring = Scoring()) -> torch.Tensor:
    """The seven final-cell values of each problem of a dispatch, an (n, 7)
    int32 tensor (zeros for a problem with an empty sequence):
    :func:`sweep_tiles` over the whole table on a fresh state.  On a CPU
    tensor this is :func:`hetero_ref`; on a CUDA tensor it launches K4 once
    per global tile anti-diagonal and never falls back.  Nothing waits for
    the card."""
    return _run(final_values, batch, new_state(batch), 0, len(batch.tiles),
                scoring).out


# Launches of the CUDA kernel since the count was last set to 0, for each
# entry point: the whole dispatch (final_values) and the per-tile form
# (sweep_tiles).
final_values.launches = 0
sweep_tiles.launches = 0


def default_budget(device, sharing: int = 1) -> Optional[int]:
    """Face-slab bytes one dispatch may take: ``BUDGET_SHARE`` of the card's
    free memory over the ``sharing`` dispatches that run on it at once (the
    data slots of a mesh that name one card), or no limit on the CPU (the
    plain version allocates each problem's faces on its own)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free * BUDGET_SHARE / max(1, sharing))


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
            for i, s in zip(idx, scores.tolist()):
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
