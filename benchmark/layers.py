"""What the per-layer readers read from inside the program: its spans on the
profiler's clock (``trialign.*``, host events of a traced window) and its
cell counters (``.cells`` on the slab kernel's entry points).

A program without them, as one from before they existed, gives nothing to
read: every function here then returns None and raises nothing.
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Sequence, Tuple

from benchmark import stats

WAIT = "trialign.wait"
SLAB = "trialign_torch.kernels.slab"


def _inside(outer: List[Tuple[float, float]],
            inner: List[Tuple[float, float]]) -> float:
    """Seconds of the sorted disjoint intervals ``inner`` that lie inside
    the sorted disjoint intervals ``outer``."""
    total, k = 0.0, 0
    for lo, hi in outer:
        while k < len(inner) and inner[k][1] <= lo:
            k += 1
        j = k
        while j < len(inner) and inner[j][0] < hi:
            total += min(hi, inner[j][1]) - max(lo, inner[j][0])
            j += 1
    return total


def host_ms(window, root: str) -> Optional[float]:
    """Host milliseconds a completed request spends in the program outside
    waiting for the device: the outermost ``root`` spans of the traced
    window, less the ``trialign.wait`` spans inside them, summed over the
    window and divided by its completed requests."""
    tr = window.trace
    if tr is None or not window.done:
        return None
    outer = stats.merged((s, e) for n, s, e in tr.host if n == root)
    if not outer:
        return None
    waits = stats.merged((s, e) for n, s, e in tr.host if n == WAIT)
    busy = sum(hi - lo for lo, hi in outer) - _inside(outer, waits)
    return 1e3 * busy / len(window.done)


class Cells:
    """The cells that the slab kernel's counters ``names`` (entry points of
    ``kernels/slab.py`` with a ``.cells`` count) swept between
    :meth:`install`, which a reader calls from its ``install`` just before
    the window, and :meth:`moved`."""

    def __init__(self, names: Sequence[str]):
        self.names = tuple(names)
        self.start: Optional[int] = None

    def now(self) -> Optional[int]:
        try:
            slab = importlib.import_module(SLAB)
        except ImportError:
            return None
        counts = [getattr(getattr(slab, n, None), "cells", None)
                  for n in self.names]
        return None if None in counts else sum(counts)

    def install(self) -> None:
        self.start = self.now()

    def moved(self) -> Optional[int]:
        now = self.now()
        if self.start is None or now is None:
            return None
        return now - self.start
