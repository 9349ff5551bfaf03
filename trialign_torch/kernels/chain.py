"""Heterogeneous chains: many distinct triplets in one dispatch, on K4.

Port of ``trialign/kernels/chain.py`` (``align_chain``,
``align_batch_chained``).  On the TPU a chain packs its triplets along the i
axis at a pitch and picks each cell's B and C from a ring by band selects;
the packer keeps the final cells of one chain distinct, since one capture
plane per block holds every slot's score.  K4 (``kernels/hetero.py``) gives
every triplet its own tiles, face slabs and output row instead, so here a
"chain" is one K4 dispatch and the distinct-final-cell constraint is gone.

Not ported, as TPU layout: ``chain_pitch``, ``plan_hetero``,
``choose_chain_shape``, ``prep_hetero``, ``pack_chains`` and
``pack_sub_tables`` (the i-axis chain layout, its v5e VMEM budget and the
ring's byte packing).  ``align_batch_chained`` also drops the reference's
blocked fallback past |B| > 519 or |C| > 639: that was the largest
single-dispatch chain geometry in VMEM, and K4 keeps its faces in device
memory, so it takes every size.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from trialign_torch.config import Scoring
from trialign_torch.kernels import hetero
from trialign_torch.kernels.plane_math import hetero_sub_ok


def check_scoring(scoring: Scoring) -> None:
    """Raise ValueError for a submatrix the reference's hetero route
    refuses (``hetero_sub_ok``)."""
    if scoring.submatrix is not None and not hetero_sub_ok(scoring.submatrix):
        raise ValueError(
            "hetero submatrix needs <= 4 symbols with byte-range entries: "
            "use api.align_batch (it routes such batches through the "
            "padded/bucketed path)")


def align_chain(
    triplets: Sequence,
    scoring: Scoring = Scoring(),
    block_shape: Optional[Tuple[int, int]] = None,
    device="cuda",
) -> List[int]:
    """Score distinct triplets in one K4 dispatch (more only if their face
    slabs pass the card's budget), in input order; an empty sequence
    scores 0.  ``block_shape`` is the shared tile plane (hb, wc).  Unlike
    the reference, the triplets' final cells need not be distinct, and
    there is no ``interpret``: ``device="cpu"`` runs the plain version."""
    check_scoring(scoring)
    return hetero.align_hetero(triplets, scoring, device, block_shape)


def align_batch_chained(
    triplets: Sequence,
    scoring: Scoring = Scoring(),
    max_p: int = 32,
    device="cuda",
) -> List[int]:
    """Batch scoring through K4, ``max_p`` problems a dispatch (the
    reference's slots a chain), the longest |A| first; scores in input
    order, 0 for an empty sequence."""
    check_scoring(scoring)
    return hetero.align_hetero(triplets, scoring, device, max_problems=max_p)
