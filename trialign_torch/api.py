"""Public API of the port: align(), the score path.

Port of ``trialign/api.py`` (``AlignResult``, ``BACKENDS``, ``_pick_backend``
and ``align``).  The backends map onto the reference's: "torch" is the plain
sweep (the reference's "xla"), "wavefront" and "blocked" are the CUDA
kernels K2 and K3 (the reference's "pallas" and "blocked"), and "golden" and
"native" are the reference's own host oracles.  Sizes route to the same
kernel as in the reference.

Devices are explicit: ``device`` defaults to "cuda", and without a card
align() raises unless the caller passes ``device="cpu"``, where the
"wavefront" and "blocked" backends run their kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from trialign.config import Scoring, encode
from trialign_torch.kernels.wavefront import SUBMATRIX_NSYM_CAP


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

# The alignment-recovery item of the port's plan.
_TRACEBACK_ITEM = "ROADMAP.md queue 1 item 5 (Traceback)"


def _pick_backend(la: int, lb: int, lc: int) -> str:
    # The reference's routing (trialign/api.py:59-62): the single-block
    # kernel up to its caps, the blocked sweep beyond.
    small = lb <= 255 and lc <= 255 and la <= 4096
    return "wavefront" if small else "blocked"


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
    oracle on the host; with ``return_alignment`` it also recovers one
    alignment).  ``score_bits`` nonzero wraps stored scores as signed
    registers of that width (the RTL's SCORE_BITS); "golden", "torch",
    "wavefront" and "blocked" implement it.
    """
    a, b, c = _prep(a), _prep(b), _prep(c)
    la, lb, lc = len(a), len(b), len(c)
    cells = la * lb * lc
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    dev = _device(device)
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
        if backend != "native":
            raise NotImplementedError(
                f"alignment recovery is not ported yet ({_TRACEBACK_ITEM}); "
                "backend='native' recovers one on the host"
            )
        from trialign.native import align_native

        t0 = time.perf_counter()
        score, alignment = align_native(a, b, c, scoring)
        return AlignResult(score=score, alignment=alignment, backend="native",
                           cells=cells, seconds=time.perf_counter() - t0)

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

    t0 = time.perf_counter()
    if backend == "golden":
        from trialign.golden import align_planes_numpy

        score = align_planes_numpy(a, b, c, scoring, score_bits=score_bits)
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
        from trialign.native import score_native

        score = score_native(a, b, c, scoring)

    return AlignResult(
        score=int(score),
        backend=backend,
        cells=cells,
        seconds=time.perf_counter() - t0,
    )
