"""The device trace of a traced window, from ``torch.profiler``.

The profiler records the CUDA activity of the process (kernels the program
launches through ctypes included) and its host events: torch operators,
CUDA runtime calls, and the benchmark's own spans (``bm.*``).  This module
turns it into device intervals by name, the device's busy seconds inside
the window, its top operations, and its idle gaps labelled by what the host
was doing.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark import stats

WINDOW = "bm.window"
# The names the profiler gives device operations that are not kernels.
COPIES = ("Memcpy", "Memset")
# Idle gaps labelled one by one, longest first; the rest are summed.
LABELLED_GAPS = 4000


@dataclasses.dataclass
class Trace:
    """Device operations as (name, start, end) in seconds on the profiler's
    clock, host events likewise, and the window's span on that clock."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return stats.covered(((s, e) for _, s, e in self.device), self.window)

    def kernel_s(self, *names: str) -> float:
        """Seconds in the window of the kernels whose name holds any of
        ``names``, or of every kernel (not copies or fills) without
        ``names``, summed: each runs alone on the one stream."""
        return sum(min(e, self.window[1]) - max(s, self.window[0])
                   for n, s, e in self.device
                   if (any(x in n for x in names) if names
                       else not n.startswith(COPIES))
                   and e > self.window[0] and s < self.window[1])

    def top_ops(self, count: int = 10) -> List[List]:
        by = collections.Counter()
        for n, s, e in self.device:
            by[n] += max(0.0, min(e, self.window[1]) - max(s, self.window[0]))
        return [[n, v] for n, v in by.most_common(count)]

    def idle_gaps(self, count: int = 10) -> List[List]:
        """Idle seconds of the device, summed by the innermost host event
        at each gap's middle, the largest ``count``."""
        gaps = stats.gaps(((s, e) for _, s, e in self.device), self.window)
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [(n, s, e) for n, s, e in self.host if n != WINDOW]
        starts = np.array([s for _, s, _ in host])
        ends = np.array([e for _, _, e in host])
        by = collections.Counter()
        for k, (lo, hi) in enumerate(gaps):
            label = "gaps past the longest %d" % LABELLED_GAPS
            if k < LABELLED_GAPS:
                mid = (lo + hi) / 2
                inside = np.flatnonzero((starts <= mid) & (ends >= mid)) \
                    if len(host) else []
                label = "host outside any recorded event"
                if len(inside):
                    best = min(inside, key=lambda i: ends[i] - starts[i])
                    label = host[best][0]
            by[label] += hi - lo
        return [[n, v] for n, v in by.most_common(count)]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.endswith(")"):
        depth = 0
        for at in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[at], 0)
            if depth == 0:
                name = name[:at]
                break
    return name[5:] if name.startswith("void ") else name


def read(prof) -> Optional[Trace]:
    """The trace of a ``torch.profiler.profile`` run whose window is a
    ``bm.window`` span; None if it has no such span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == cuda:
            # The benchmark's spans show on the device's timeline too.
            if not e.name.startswith("bm.") and \
                    not getattr(e, "is_user_annotation", False):
                device.append((short_name(e.name), start, end))
        else:
            host.append((e.name, start, end))
            if e.name == WINDOW:
                window = (start, end)
    if window is None:
        return None
    return Trace(device, host, window)


def summary(trace: Trace) -> Dict:
    return {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
