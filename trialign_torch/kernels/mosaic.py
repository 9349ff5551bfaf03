"""Batch scoring for large batches: the port of ``align_batch_mosaic``.

Port of ``trialign/kernels/mosaic.py:align_batch_mosaic``, ``_rotate``
(which here leaves a triplet alone under an asymmetric submatrix) and
``_snake_perm``.  On the TPU the mosaic packs many problems into one
VMEM-sized canvas and sweeps it with K4, with tall classes and a residue of
near-cubic problems beside it, all to amortise a sequential grid's
per-block ramp.  On the H100 K4 (``kernels/hetero.py``) takes every problem
with its own tiles, so the whole batch is one residue: ``residue_route``
"auto" and "chain" send it through K4, "blocked" through K3 one problem at
a time.

With a ``mesh`` the problems spread over its 'data' slots, each slot's
share contiguous and balanced by cells (:func:`_snake_chunks`).  Each slot
runs its dispatches on its own device and CUDA stream through K4's
per-tile form (``hetero.sweep_tiles``), one launch a dispatch, the slots in
turn, so that slots which share a card run at once.

Not ported, as TPU layout: the canvas packer (``CanvasGeometry``,
``pack_mosaic``, ``plan_mosaic``, ``prep_mosaic``), the one-hot einsum
plane assembly of ``_mosaic_core_impl``, ``TALL_SHAPES`` and the v5e cost
model of ``_route_residue``.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from trialign_torch.config import Scoring
from trialign_torch.dist import mesh as dmesh
from trialign_torch.dist.batch import _blocked_group
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import hetero
from trialign_torch.kernels.chain import check_scoring
from trialign_torch.metrics import span

RESIDUE_ROUTES = ("auto", "chain", "blocked")


def _rotate(t, scoring: Scoring):
    """Axis assignment: A = longest, then B = longer of the rest, as far as
    the score allows.  sop scoring is fully permutation-symmetric; rtl-mode
    s3 is only A<->B symmetric, so rtl may only put the longer of (a, b) on
    A.  A submatrix with S(x, y) != S(y, x) allows no swap, so such a
    triplet keeps its axes (the reference's ``_rotate`` swaps it all the
    same, which changes its score)."""
    sub = scoring.submatrix
    if sub is not None and any(sub[x][y] != sub[y][x]
                               for x in range(len(sub))
                               for y in range(len(sub))):
        return t
    a, b, c = t
    if scoring.s3_mode == "sop":
        seqs = sorted((a, b, c), key=len, reverse=True)
        return seqs[0], seqs[1], seqs[2]
    if len(b) > len(a):
        return b, a, c
    return t


def _snake_chunks(costs: Sequence[int], ndata: int) -> List[List[int]]:
    """Job indices in ``ndata`` contiguous chunks of snake-balanced cost
    (the reference's _snake_perm, as chunks): jobs by falling cost dealt
    0, 1, ..., ndata - 1, ndata - 1, ..., 0, and so on."""
    order = sorted(range(len(costs)), key=lambda i: -costs[i])
    chunks: List[List[int]] = [[] for _ in range(ndata)]
    for r, i in enumerate(order):
        dev = r % ndata if (r // ndata) % 2 == 0 else ndata - 1 - r % ndata
        chunks[dev].append(i)
    return chunks


def data_devices(mesh) -> List:
    """The devices of a mesh's data slots (its model axis's first column),
    which must all be this process's: a batch over processes goes through
    ``dist.batch.align_batch_multihost``."""
    slots = [row[0] for row in mesh.slots]
    if any(s.rank != dmesh.rank() for s in slots):
        raise ValueError("the mesh's data axis spans processes: use "
                         "align_batch_multihost")
    return [dmesh.normalize(s.device) for s in slots]


def _slot_work(idx, triplets, lens, scoring, device, budget, pending):
    """One slot's dispatches, one K4 run of a whole dispatch a step (a
    generator).  A finished dispatch goes on ``pending`` as (problems,
    scores, event on the slot's stream after its run, None on the CPU)."""
    hb, wc = bk.choose_block_shape(0, 0, 0)
    for cut in hetero.plan_dispatches([lens[i] for i in idx], hb, wc,
                                      budget):
        part = [idx[c] for c in cut]
        batch = hetero.prep_hetero([triplets[i] for i in part], hb, wc,
                                   device)
        state = hetero.new_state(batch)
        hetero.sweep_tiles(batch, state, 0, len(batch.tiles), scoring)
        scores = state.out.max(dim=1).values
        done = None
        if scores.is_cuda:
            done = torch.cuda.Event()
            done.record()
        pending.append((part, scores, done))
        yield


def _hetero_on_slots(triplets, scoring, devices, on_scores) -> List[int]:
    """K4 over the data slots ``devices``: each slot's share (snake-balanced
    by cells) in dispatches under its share of the card's memory, the slots
    taking turns one dispatch at a time on their own streams, so that slots
    which share a card run at once.  After each turn the dispatches that
    have finished on the device drain; when a dispatch fails, every one
    already swept drains before the failure is raised, so that a retry
    runs none of them again."""
    lens = [[len(x) for x in t] for t in triplets]
    out = [0] * len(triplets)
    for i, t in enumerate(lens):
        if min(t) == 0 and on_scores is not None:
            on_scores(i, 0)
    cells = [la * lb * lc for la, lb, lc in lens]
    chunks = _snake_chunks(cells, len(devices))
    streams = dmesh.SlotStreams(devices)
    sharing = Counter(streams.devices)
    pending: list = []

    def drain(everything: bool) -> None:
        for item in list(pending):
            idx, scores, done = item
            if not (everything or done is None or done.query()):
                continue
            pending.remove(item)
            with span("wait"):
                scores = scores.tolist()
            for i, s in zip(idx, scores):
                out[i] = int(s)
                if on_scores is not None:
                    on_scores(i, out[i])

    work = []
    for k, (dev, idx) in enumerate(zip(streams.devices, chunks)):
        idx = [i for i in idx if min(lens[i]) > 0]
        budget = hetero.default_budget(dev, sharing[dev])
        work.append((k, _slot_work(idx, triplets, lens, scoring, dev,
                                   budget, pending)))
    try:
        while work:
            try:
                for k, gen in list(work):
                    with streams.on(k):
                        if next(gen, StopIteration) is StopIteration:
                            work.remove((k, gen))
            except Exception:
                # A dispatch failed: those that finished still drain.
                streams.join()
                drain(True)
                raise
            drain(False)
    finally:
        streams.join()
    drain(True)
    return out


def align_batch_mosaic(
    triplets: Sequence,
    scoring: Scoring = Scoring(),
    mesh=None,
    residue_route: str = "auto",
    on_scores: Optional[Callable[[int, int], None]] = None,
    device="cuda",
) -> List[int]:
    """Batch scoring, scores in input order; an empty sequence scores 0
    without a dispatch.

    Each triplet is rotated (:func:`_rotate`) so that the longest sequence
    lies along A, then ``residue_route`` "auto" or "chain" sends the batch
    through K4 (largest |A| first, dispatches cut by the card's memory) and
    "blocked" through K3 one problem at a time.  ``mesh`` (``dist.mesh``)
    spreads the batch over its data slots, each on its device (``device``
    is then not read); without one the batch runs on ``device``.
    ``on_scores(i, score)`` fires for each problem as its dispatch
    drains."""
    check_scoring(scoring)
    if residue_route not in RESIDUE_ROUTES:
        raise ValueError(f"residue_route must be one of {RESIDUE_ROUTES}, "
                         f"not {residue_route!r}")
    with span("route"):
        rotated = [_rotate(tuple(np.asarray(s) for s in t), scoring)
                   for t in triplets]
    devices = data_devices(mesh) if mesh is not None else None
    if residue_route != "blocked":
        if devices is not None:
            return _hetero_on_slots(rotated, scoring, devices, on_scores)
        return hetero.align_hetero(rotated, scoring, device,
                                   on_scores=on_scores)
    if devices is None:
        out = _blocked_group(rotated, scoring, device)
    else:
        out = [0] * len(rotated)
        cells = [len(a) * len(b) * len(c) for a, b, c in rotated]
        for idx, dev in zip(_snake_chunks(cells, len(devices)), devices):
            for i, s in zip(idx, _blocked_group([rotated[i] for i in idx],
                                                scoring, dev)):
                out[i] = s
    if on_scores is not None:
        for i, s in enumerate(out):
            on_scores(i, s)
    return out
