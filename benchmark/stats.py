"""The metric arithmetic the readers share: window rates, tails, the union of
device intervals, and roofline shares against the frozen peak table."""

from __future__ import annotations

import json
import math
import os
from typing import Iterable, List, Optional, Sequence, Tuple

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")
Interval = Tuple[float, float]


def rate(work: float, seconds: float) -> Optional[float]:
    """Work a second over the whole window."""
    return work / seconds if seconds > 0 else None


def per_request(seconds: float, completed: int) -> Optional[float]:
    """The window's seconds over the requests completed in it."""
    return seconds / completed if completed else None


def percentile(values: Sequence[float], pct: float) -> Optional[float]:
    """The nearest-rank percentile of all ``values``: the smallest value
    with at least ``pct``% of them at or below it."""
    if not values:
        return None
    ranked = sorted(values)
    return ranked[max(0, math.ceil(pct / 100 * len(ranked)) - 1)]


def merged(intervals: Iterable[Interval],
           within: Optional[Interval] = None) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals, clipped to
    ``within``."""
    out: List[Interval] = []
    for lo, hi in sorted(intervals):
        if within is not None:
            lo, hi = max(lo, within[0]), min(hi, within[1])
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def covered(intervals: Iterable[Interval],
            within: Optional[Interval] = None) -> float:
    """Seconds that at least one of ``intervals`` covers."""
    return sum(hi - lo for lo, hi in merged(intervals, within))


def gaps(intervals: Iterable[Interval], within: Interval) -> List[Interval]:
    """The stretches of ``within`` that no interval covers."""
    out, at = [], within[0]
    for lo, hi in merged(intervals, within):
        if lo > at:
            out.append((at, lo))
        at = hi
    if within[1] > at:
        out.append((at, within[1]))
    return out


def peak(kind: str, key: str) -> Optional[float]:
    """The frozen peak ``key`` of the device ``kind`` (``peaks.json``), or
    None for a device the table does not hold."""
    with open(PEAKS) as f:
        entry = json.load(f)["devices"].get(kind)
    return None if entry is None else float(entry[key])


def roofline_pct(ops: float, peak_ops: Optional[float],
                 seconds: float) -> Optional[float]:
    """The least time ``ops`` take at ``peak_ops`` a second, as a share of
    ``seconds``, in percent; None when there is nothing to read."""
    if not peak_ops or seconds <= 0 or ops <= 0:
        return None
    return 100.0 * ops / peak_ops / seconds
