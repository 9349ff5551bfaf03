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

On a CUDA tensor :func:`final_values` launches K4 once per anti-diagonal.
On a CPU tensor it runs :func:`hetero_ref`, which sweeps each problem with
K3's plain version ``blocked_ref`` at the dispatch's tile plane.
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
    return HeteroBatch(torch.from_numpy(syms).to(device), geom, lens, hb, wc,
                       tiles[:, 1:].astype(np.int32), diag_start, rf, cf)


def hetero_ref(batch: HeteroBatch, scoring: Scoring = Scoring()) -> torch.Tensor:
    """Plain torch version of K4: the seven final-cell values of each
    problem, an (n, 7) int32 tensor on the batch's device (zeros for a
    problem with an empty sequence).  Each problem runs K3's plain version
    ``blocked_ref`` at the batch's tile plane, from its slice of the symbol
    buffer."""
    dev = batch.syms.device
    out = torch.zeros((len(batch.lens), NUM_MATRICES), dtype=torch.int32,
                      device=dev)
    tb, tc = batch.hb - 1, batch.wc - 1
    for p, (la, lb, lc) in enumerate(batch.lens.tolist()):
        if min(la, lb, lc) == 0:
            continue
        g = batch.geom[p]
        n_jb, n_kb = int(g[_G["n_jb"]]), int(g[_G["n_kb"]])
        dims = bk.Dims(batch.hb, batch.wc, n_jb, n_kb, la + tb + tc,
                       int(g[_G["nrows"]]))
        arrs = [batch.syms[int(g[_G[name]]):int(g[_G[name]]) + size]
                for name, size in (("a_off", la + 1), ("b_off", n_jb * tb + 1),
                                   ("c_off", n_kb * tc + 1))]
        out[p] = bk.blocked_ref(*arrs, la, lb, lc, dims, scoring)
    return out


def final_values(batch: HeteroBatch,
                 scoring: Scoring = Scoring()) -> torch.Tensor:
    """The seven final-cell values of each problem of a dispatch, an (n, 7)
    int32 tensor (zeros for a problem with an empty sequence).  On a CPU
    tensor this is :func:`hetero_ref`; on a CUDA tensor it launches K4 once
    per global tile anti-diagonal and never falls back.  Nothing waits for
    the card."""
    _build.check_submatrix(scoring)
    dev = batch.syms.device
    if dev.type == "cpu":
        return hetero_ref(batch, scoring)
    if dev.type != "cuda":
        raise ValueError(f"no hetero kernel for device {dev}")
    lib = _build.load("hetero")
    step, table = _build.kernel_scoring(scoring, 0, dev)
    geom = torch.from_numpy(batch.geom).to(dev)
    tiles = torch.from_numpy(batch.tiles).to(dev)
    rf = torch.empty(max(batch.rf_ints, 1), dtype=torch.int32, device=dev)
    cf = torch.empty(max(batch.cf_ints, 1), dtype=torch.int32, device=dev)
    out = torch.zeros((len(batch.lens), NUM_MATRICES), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for d in range(len(batch.diag_start) - 1):
            lo, hi = int(batch.diag_start[d]), int(batch.diag_start[d + 1])
            code = lib.trialign_hetero_diag(
                batch.syms.data_ptr(), geom.data_ptr(),
                tiles.data_ptr() + 8 * lo, hi - lo, batch.hb, batch.wc, d,
                table.data_ptr(), step, rf.data_ptr(), cf.data_ptr(),
                out.data_ptr(), stream,
            )
            _build.check(lib, code, f"hetero kernel launch (diagonal {d})")
            final_values.launches += 1
    return out


# Launches of the CUDA kernel since the count was last set to 0.
final_values.launches = 0


def default_budget(device) -> Optional[int]:
    """Face-slab bytes one dispatch may take: ``BUDGET_SHARE`` of the card's
    free memory, or no limit on the CPU (the plain version allocates each
    problem's faces on its own)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free * BUDGET_SHARE)


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
    one, at once)."""
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
    for idx in plan_dispatches(lens, hb, wc, budget_bytes, max_problems):
        batch = prep_hetero([triplets[i] for i in idx], hb, wc, device)
        pending.append((idx, final_values(batch, scoring).max(dim=1).values))
    for idx, scores in pending:
        for i, s in zip(idx, scores.tolist()):
            out[i] = int(s)
            if on_scores is not None:
                on_scores(i, out[i])
    return out
