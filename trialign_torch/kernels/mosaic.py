"""Batch scoring for large batches: the port of ``align_batch_mosaic``.

Port of ``trialign/kernels/mosaic.py:align_batch_mosaic`` and ``_rotate``
(which here leaves a triplet alone under an asymmetric submatrix).
On the TPU the mosaic packs many problems into one VMEM-sized canvas and
sweeps it with K4, with tall classes and a residue of near-cubic problems
beside it, all to amortise a sequential grid's per-block ramp.  On the H100
K4 (``kernels/hetero.py``) takes every problem with its own tiles, so the
whole batch is one residue: ``residue_route`` "auto" and "chain" send it
through K4, "blocked" through K3 one problem at a time.

Not ported, as TPU layout: the canvas packer (``CanvasGeometry``,
``pack_mosaic``, ``plan_mosaic``, ``prep_mosaic``), the one-hot einsum
plane assembly of ``_mosaic_core_impl``, ``TALL_SHAPES`` and the v5e cost
model of ``_route_residue``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from trialign_torch.config import Scoring
from trialign_torch.dist.batch import _blocked_group
from trialign_torch.kernels import hetero
from trialign_torch.kernels.chain import check_scoring

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
    "blocked" through K3 one problem at a time.  ``on_scores(i, score)``
    fires for each problem as its dispatch drains.  ``mesh`` must be None
    until the multi-device slice of the port."""
    check_scoring(scoring)
    if mesh is not None:
        raise NotImplementedError("align_batch_mosaic runs on one device")
    if residue_route not in RESIDUE_ROUTES:
        raise ValueError(f"residue_route must be one of {RESIDUE_ROUTES}, "
                         f"not {residue_route!r}")
    rotated = [_rotate(tuple(np.asarray(s) for s in t), scoring)
               for t in triplets]
    if residue_route != "blocked":
        return hetero.align_hetero(rotated, scoring, device,
                                   on_scores=on_scores)
    out = _blocked_group(rotated, scoring, device)
    if on_scores is not None:
        for i, s in enumerate(out):
            on_scores(i, s)
    return out
