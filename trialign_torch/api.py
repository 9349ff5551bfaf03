"""Public API of the port: align(), align_batch(), and alignment recovery.

Port of ``trialign/api.py`` (``AlignResult``, ``BACKENDS``, ``_pick_backend``,
``align``, ``align_batch`` and ``_align_batch_traceback``).  The backends map onto the reference's: "torch" is the plain
sweep (the reference's "xla"), "wavefront" and "blocked" are the CUDA
kernels K2 and K3 (the reference's "pallas" and "blocked"), and "golden" and
"native" are the host oracles (the port's copies).  Sizes route to the same
kernel as in the reference.  ``return_alignment=True`` runs the
Hirschberg/direct engine (traceback/hirschberg.py), whose biggest splits
sweep on the slab kernel K5; backend "native" recovers one on the host.
``align_batch`` routes a batch as the reference does (:func:`batch_routes`):
a large batch on the card through K4 (kernels/mosaic.py), the rest through
one K2 launch and K3 (dist/batch.py).

Devices are explicit: ``device`` defaults to "cuda", and without a card
align() raises unless the caller passes ``device="cpu"``, where the kernel
backends run their kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from trialign_torch.config import Scoring, encode
from trialign_torch.kernels.plane_math import hetero_sub_ok
from trialign_torch.kernels.wavefront import SUBMATRIX_NSYM_CAP, fits
from trialign_torch.metrics import span


@dataclasses.dataclass
class AlignResult:
    """Result of one three-sequence alignment."""

    score: int
    alignment: Optional[List[List[int]]] = None  # 3 rows of codes, -1 = gap
    backend: str = ""
    cells: int = 0  # DP cell-updates performed (|A|*|B|*|C|)
    seconds: float = 0.0

    @property
    def gcups(self) -> float:
        """Giga cell-updates per second (1 cell = all 7 matrices)."""
        return self.cells / self.seconds / 1e9 if self.seconds > 0 else 0.0


def _prep(seq) -> np.ndarray:
    if isinstance(seq, str):
        return encode(seq)
    return np.asarray(seq, dtype=np.uint8)


BACKENDS = ("auto", "golden", "torch", "wavefront", "blocked", "native")

# The reference's gate for the mosaic route (trialign/api.py:49, :340): a
# batch of at least MOSAIC_MIN triplets whose rotated |A| is at most
# LA_MOSAIC_CAP.  Kept so that every batch takes the reference's route.
LA_MOSAIC_CAP = 1024
MOSAIC_MIN = 64
# Per-problem cell cap for routing batch traceback to the C++ engine: its
# choice buffer is 4 B a cell per problem in flight (~256 MB at the cap).
NATIVE_TB_CELLS = 64 * 2**20


def _pick_backend(la: int, lb: int, lc: int) -> str:
    # The reference's routing (trialign/api.py:59-62): the wavefront kernel
    # (K2) up to its caps, the blocked sweep beyond.
    return "wavefront" if fits(la, lb, lc) else "blocked"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "align() runs on a CUDA device and none is available; pass "
            "device='cpu' for the plain CPU versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    return dev


def align(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    backend: str = "auto",
    return_alignment: bool = False,
    score_bits: int = 0,
    device="cuda",
) -> AlignResult:
    """Optimal alignment score of three sequences.

    ``backend``: "auto" (by size, as the reference routes), "golden"
    (NumPy), "torch" (plain sweep on ``device``), "wavefront" (K2, |B|,|C|
    <= 255 and |A| <= 4096), "blocked" (K3, any size) or "native" (C++
    oracle on the host).  ``return_alignment`` recovers one optimal
    alignment through the Hirschberg/direct engine on ``device`` (backend
    "hirschberg" in the result; ``backend`` is ignored except "native",
    which recovers it with the C++ oracle).  ``score_bits`` nonzero wraps
    stored scores as signed registers of that width (the RTL's
    SCORE_BITS); "golden", "torch", "wavefront" and "blocked" implement it.
    """
    with span("align"):
        with span("route"):
            a, b, c = _prep(a), _prep(b), _prep(c)
            if backend not in BACKENDS:
                raise ValueError(
                    f"unknown backend {backend!r}; choose from {BACKENDS}")
            dev = _device(device)
            backend = _route(len(a), len(b), len(c), scoring, backend,
                             return_alignment, score_bits)
        cells = len(a) * len(b) * len(c)
        t0 = time.perf_counter()
        if return_alignment:
            if backend == "native":
                from trialign_torch.native import align_native

                score, alignment = align_native(a, b, c, scoring)
            else:
                from trialign_torch.traceback import hirschberg_align

                score, alignment = hirschberg_align(a, b, c, scoring,
                                                    device=dev)
            return AlignResult(score=score, alignment=alignment,
                               backend=backend, cells=cells,
                               seconds=time.perf_counter() - t0)
        if backend == "golden":
            from trialign_torch.golden import align_planes_numpy

            score = align_planes_numpy(a, b, c, scoring,
                                       score_bits=score_bits)
        elif backend == "torch":
            from trialign_torch.kernels.ref import align_ref

            score = align_ref(a, b, c, scoring, score_bits, dev)
        elif backend == "wavefront":
            from trialign_torch.kernels.wavefront import align_wavefront

            score = align_wavefront(a, b, c, scoring, score_bits, dev)
        elif backend == "blocked":
            from trialign_torch.kernels.blocked import align_blocked

            score = align_blocked(a, b, c, scoring, score_bits=score_bits,
                                  device=dev)
        else:  # native
            from trialign_torch.native import score_native

            score = score_native(a, b, c, scoring)
        return AlignResult(
            score=int(score),
            backend=backend,
            cells=cells,
            seconds=time.perf_counter() - t0,
        )


def _route(la: int, lb: int, lc: int, scoring: Scoring, backend: str,
           return_alignment: bool, score_bits: int) -> str:
    """The backend :func:`align` runs for a call, by size as the reference
    routes ("hirschberg" for alignment recovery unless "native"); raises
    ValueError for a combination no backend implements."""
    if score_bits:
        if return_alignment:
            raise ValueError("score_bits mode is score-only (no traceback)")
        if backend == "auto":
            backend = _pick_backend(la, lb, lc)
            if scoring.submatrix is not None and \
                    len(scoring.submatrix) > SUBMATRIX_NSYM_CAP:
                backend = "torch"
        if backend not in ("golden", "torch", "wavefront", "blocked"):
            raise ValueError(
                f"score_bits wraparound is implemented by the 'golden', "
                f"'torch', 'wavefront' and 'blocked' backends, not {backend!r}"
            )
    if return_alignment:
        return "native" if backend == "native" else "hirschberg"
    if scoring.submatrix is not None:
        small_alpha = len(scoring.submatrix) <= SUBMATRIX_NSYM_CAP
        if backend == "auto":
            backend = _pick_backend(la, lb, lc) if small_alpha else "torch"
        allowed = ("golden", "torch", "native") + (
            ("wavefront", "blocked") if small_alpha else ()
        )
        if backend not in allowed:
            raise ValueError(
                f"submatrix scoring is implemented by the {allowed} "
                f"backends, not {backend!r}"
            )
    if backend == "auto":
        backend = _pick_backend(la, lb, lc)
    return backend


def _align_batch_traceback(arrs: Sequence, scoring: Scoring,
                           dev: torch.device) -> List[AlignResult]:
    """Batch alignment recovery: C++ engine threads for problems up to
    NATIVE_TB_CELLS cells, the Hirschberg/direct engine on ``dev`` for the
    rest."""
    from concurrent.futures import ThreadPoolExecutor

    from trialign_torch.native import align_native, is_available

    t0 = time.perf_counter()
    out: List[Optional[AlignResult]] = [None] * len(arrs)
    cells = [len(a) * len(b) * len(c) for a, b, c in arrs]
    small = [i for i in range(len(arrs)) if cells[i] <= NATIVE_TB_CELLS] \
        if is_available() else []
    if small:
        # ctypes releases the GIL, so the threads run the C++ DP at once.
        with ThreadPoolExecutor(min(8, len(small))) as ex:
            for i, (score, rows) in zip(small, ex.map(
                    lambda i: align_native(*arrs[i], scoring), small)):
                out[i] = AlignResult(score=score, alignment=rows,
                                     backend="native", cells=cells[i])
    from trialign_torch.traceback import hirschberg_align

    for i, (a, b, c) in enumerate(arrs):
        if out[i] is None:
            score, rows = hirschberg_align(a, b, c, scoring, device=dev)
            out[i] = AlignResult(score=score, alignment=rows,
                                 backend="hirschberg", cells=cells[i])
    dt = time.perf_counter() - t0
    total = sum(cells) or 1
    for r in out:
        r.seconds = dt * r.cells / total
    return out


def batch_routes(lens: Sequence, scoring: Scoring, mosaic: bool) -> List[str]:
    """The route of each triplet of a batch with lengths ``lens`` ((n, 3)),
    by the reference's rules (trialign/api.py:294-363): "mosaic" (K4,
    kernels/mosaic.py), "padded" (one K2 launch, K3 past K2's caps,
    dist/batch.py) or "torch" (the plain sweep, for submatrices past the
    kernels' 8 symbols).  ``mosaic`` says whether the mosaic route is open:
    on the card, or where TRIALIGN_FORCE_MOSAIC=1 forces it."""
    n = len(lens)
    if scoring.submatrix is not None and not hetero_sub_ok(scoring.submatrix):
        small = len(scoring.submatrix) <= SUBMATRIX_NSYM_CAP
        return ["padded" if small else "torch"] * n
    routes = ["padded"] * n
    if mosaic and n >= MOSAIC_MIN:
        sop = scoring.s3_mode == "sop"
        idx = [i for i, (la, lb, lc) in enumerate(lens)
               if (max(la, lb, lc) if sop else max(la, lb)) <= LA_MOSAIC_CAP]
        if len(idx) >= MOSAIC_MIN:
            for i in idx:
                routes[i] = "mosaic"
    return routes


def align_batch(
    triplets: Sequence,
    scoring: Scoring = Scoring(),
    return_alignment: bool = False,
    device="cuda",
) -> List[AlignResult]:
    """Align a batch of independent (a, b, c) triplets; results in input
    order, score 0 for a triplet with an empty sequence.

    Scores follow :func:`batch_routes`: on the card a batch of at least 64
    triplets with rotated |A| <= LA_MOSAIC_CAP runs through K4, the rest
    through one K2 launch for the triplets inside its caps and K3 for the
    longer ones.  On ``device="cpu"`` the same routes run the kernels'
    plain versions, with the mosaic route closed unless
    TRIALIGN_FORCE_MOSAIC=1.  ``return_alignment`` recovers every
    alignment: small problems on C++ engine threads, the rest through the
    Hirschberg/direct engine on ``device``.  The reference's ``backend``
    argument, which it ignores, is not taken."""
    with span("align_batch"):
        with span("route"):
            dev = _device(device)
            arrs = [(_prep(a), _prep(b), _prep(c)) for a, b, c in triplets]
        if return_alignment:
            return _align_batch_traceback(arrs, scoring, dev)
        return _score_batch(arrs, scoring, dev)


def _score_batch(arrs: Sequence, scoring: Scoring,
                 dev: torch.device) -> List[AlignResult]:
    """Scores of encoded triplets by :func:`batch_routes`, as
    :func:`align_batch` returns them."""
    t0 = time.perf_counter()
    with span("route"):
        mosaic = dev.type == "cuda" or \
            os.environ.get("TRIALIGN_FORCE_MOSAIC") == "1"
        routes = batch_routes([[len(x) for x in t] for t in arrs], scoring,
                              mosaic)
    scores = [0] * len(arrs)
    for route in ("mosaic", "padded", "torch"):
        idx = [i for i, r in enumerate(routes) if r == route]
        if not idx:
            continue
        group = [arrs[i] for i in idx]
        if route == "mosaic":
            from trialign_torch.kernels.mosaic import align_batch_mosaic

            got = align_batch_mosaic(group, scoring, device=dev)
        elif route == "padded":
            from trialign_torch.dist.batch import align_batch_padded

            got = align_batch_padded(group, scoring, dev)
        else:
            from trialign_torch.kernels.ref import align_ref

            got = [align_ref(*t, scoring, 0, dev) for t in group]
        for i, s in zip(idx, got):
            scores[i] = s
    dt = time.perf_counter() - t0
    # Items share dispatches, so each item's time is apportioned by cells:
    # every item's .gcups is then the batch's.
    cells = [len(a) * len(b) * len(c) for a, b, c in arrs]
    total = sum(cells) or 1
    # As the reference: a batch the submatrix gate sends past K4 is named
    # by its one route, any other "batch".
    gated = scoring.submatrix is not None and \
        not hetero_sub_ok(scoring.submatrix)
    name = routes[0] if gated and routes else "batch"
    return [AlignResult(score=int(s), backend=name, cells=n,
                        seconds=dt * n / total)
            for s, n in zip(scores, cells)]
