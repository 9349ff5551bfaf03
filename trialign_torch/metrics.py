"""Structured run metrics and profiling hooks.

Port of ``trialign/metrics.py``.  Every run can emit a structured record
(score, cell count, GCUPS, backend, device) and wrap itself in a
``torch.profiler`` trace for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Iterator, Optional

import torch


@dataclasses.dataclass
class RunMetrics:
    """One alignment run's record.  1 cell-update = one (i,j,k) lattice site
    across all 7 matrices, the reference's headline unit (pic/Result.png)."""

    score: int = 0
    cells: int = 0
    seconds: float = 0.0
    backend: str = ""
    device: str = ""
    shape: tuple = ()
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds > 0 else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["gcups"] = round(self.gcups, 4)
        return d

    def emit(self, stream=None) -> None:
        print(json.dumps(self.to_dict()), file=stream or sys.stderr, flush=True)


@contextlib.contextmanager
def timed(metrics: RunMetrics) -> Iterator[RunMetrics]:
    t0 = time.perf_counter()
    try:
        yield metrics
    finally:
        metrics.seconds = time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device="cuda") -> Iterator[None]:
    """``torch.profiler`` trace of the block, written into ``log_dir`` as a
    Chrome trace (``trace.json``, for chrome://tracing or Perfetto); CUDA
    activity is recorded when ``device`` is a CUDA device.  No-op when
    ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_summary(device="cuda") -> str:
    """``cudax<count>:<name of card 0>`` for a CUDA device (for example
    ``cudax1:NVIDIA H100 80GB HBM3``), ``cpu`` for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return f"cudax{torch.cuda.device_count()}:{torch.cuda.get_device_name(0)}"
