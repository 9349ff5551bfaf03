"""One run of one cell: its pool, the warm-up, the measured window, the
metrics and the check against the plain reference.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<traffic>.json`` and each metric's reader in
``metrics/<metric>.py``.  A reader is a module with ``read(window)``, which
returns the metric's value or None where it finds nothing to read, and,
for a per-layer metric, optionally ``install(probe)``, which asks the
traced run for the spans, counters and memory readings it needs.

The client is one closed loop: it sends the pool's requests in turn, each
when the previous one has returned, until ``seconds`` have passed; the
request under way then finishes, and the window ends with it.  A request
ends in host integers (scores, alignment rows), so the host clock around
it covers the device's work.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import traffic
from benchmark import trace as btrace
from benchmark.reference import dp, rescore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# Top-level modules the run must not hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "trialign")
# Every number compared is exact: scores are integers.
LIMIT = 0


def load(bench_dir: str, *parts: str) -> dict:
    with open(os.path.join(bench_dir, *parts)) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(man: dict, name: str, section: str) -> List[dict]:
    """The metrics of ``section`` that cell ``name`` reports."""
    return [m for m in man[section] if name in m.get("workloads", [name])]


def reader(name: str, metrics_dir: Optional[str] = None):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    path = os.path.join(metrics_dir or os.path.join(HERE, "metrics"),
                        name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def scoring_of(config: dict):
    """The program's ``Scoring`` for a configuration's scoring."""
    from trialign_torch.config import Scoring

    sc = config["scoring"]
    sub = sc.get("submatrix")
    return Scoring(match=sc["match"], mismatch=sc["mismatch"],
                   gap_open=sc["gap_open"], gap_extend=sc["gap_extend"],
                   s3_mode=sc.get("s3", "sop"),
                   submatrix=tuple(map(tuple, sub)) if sub else None)


def program(config: dict, mix: dict, device,
            score_bits: int = 0) -> Callable:
    """The request the mix sends, through the program's public entry: a
    function of one request that returns [(score, rows or None)], one pair
    a triplet."""
    from trialign_torch import api

    scoring = scoring_of(config)
    alignment = bool(mix.get("alignment"))
    if mix["entry"] == "align_batch":
        def call(req):
            return [(r.score, r.alignment) for r in api.align_batch(
                req, scoring, return_alignment=alignment, device=device)]
    elif mix["entry"] == "align":
        def call(req):
            r = api.align(*req, scoring, return_alignment=alignment,
                          score_bits=score_bits, device=device)
            return [(r.score, r.alignment)]
    else:
        raise ValueError(f"unknown entry {mix['entry']!r}")
    return call


@dataclasses.dataclass
class Record:
    item: int            # index into the pool
    start: float         # host clock
    end: float
    cells: int
    answer: Optional[list]
    error: Optional[str]
    counters: Dict[str, int]
    peak_bytes: Optional[int]

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Probe:
    """What a traced run records besides the profiler's trace, as the
    per-layer readers ask for it: spans around the program's functions,
    the program's launch counters by request, and the peak memory of each
    request."""

    def __init__(self):
        self.spans: List[tuple] = []   # (name, start, end, record index)
        self.counters: Dict[str, object] = {}
        self.per_request_peak = False
        self._patches: List[tuple] = []
        self._index = 0
        self._start: Dict[str, int] = {}
        self._peak = 0

    def span(self, name: str, module: str, attr: str) -> None:
        """Time every call of ``module.attr`` as span ``name``."""
        mod = importlib.import_module(module)
        real = getattr(mod, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function("bm." + name):
                out = real(*args, **kwargs)
            self.spans.append((name, t0, time.perf_counter(), self._index))
            return out

        setattr(mod, attr, timed)
        self._patches.append((mod, attr, real))

    def counter(self, name: str, module: str, attr: str) -> None:
        """Read ``module.attr.launches`` before and after each request."""
        self.counters[name] = getattr(importlib.import_module(module), attr)

    def peak_per_request(self) -> None:
        self.per_request_peak = True

    def before(self, index: int) -> None:
        self._index = index
        if self.per_request_peak and torch.cuda.is_available():
            self._peak = max(self._peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        self._start = {k: f.launches for k, f in self.counters.items()}

    def after(self):
        counts = {k: f.launches - self._start[k]
                  for k, f in self.counters.items()}
        peak = None
        if self.per_request_peak and torch.cuda.is_available():
            peak = torch.cuda.max_memory_allocated()
        return counts, peak

    def memory_peak(self) -> int:
        if not torch.cuda.is_available():
            return 0
        return max(self._peak, torch.cuda.max_memory_allocated())

    def restore(self) -> None:
        for mod, attr, real in reversed(self._patches):
            setattr(mod, attr, real)
        self._patches.clear()


@dataclasses.dataclass
class Window:
    """What the readers read: the window's requests and its length on the
    host clock, the probe's spans, the device trace of a traced run, and
    the device's kind (for the peak table)."""

    records: List[Record]
    seconds: float
    spans: List[tuple]
    trace: Optional[btrace.Trace]
    kind: str

    @property
    def done(self) -> List[Record]:
        return [r for r in self.records if r.error is None]


def run_window(call: Callable, pool: list, seconds: float, probe: Probe,
               log=sys.stderr):
    """Closed loop over the pool for ``seconds``: (records, start, end)."""
    cells = [traffic.cells(r) for r in pool]
    records: List[Record] = []
    start = time.perf_counter()
    deadline = start + seconds
    while not records or time.perf_counter() < deadline:
        item = len(records) % len(pool)
        probe.before(len(records))
        answer, error = None, None
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("bm.request"):
                answer = call(pool[item])
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            error = f"{type(e).__name__}: {e}"
            if not any(r.error for r in records):
                traceback.print_exc(file=log)
        t1 = time.perf_counter()
        counts, peak = probe.after()
        records.append(Record(item, t0, t1, cells[item], answer, error,
                              counts, peak))
    return records, start, records[-1].end


def check_sample(mix: dict, pool: list, seed: int) -> List[tuple]:
    """(request, triplet) pairs whose answers are checked: every triplet of
    the pool, or for a batch mix ``check_sample`` of them drawn from the
    seed with the largest of each batch."""
    sizes = [[len(a) * len(b) * len(c) for a, b, c in traffic.triplets(r)]
             for r in pool]
    every = [(p, t) for p, s in enumerate(sizes) for t in range(len(s))]
    want = mix.get("check_sample")
    if not want or want >= len(every):
        return every
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    picked = {every[i] for i in rng.choice(len(every), size=want,
                                           replace=False)}
    picked |= {(p, int(np.argmax(s))) for p, s in enumerate(sizes)}
    return sorted(picked)


def check(config: dict, mix: dict, pool: list, records: List[Record],
          seed: int, device):
    """The numbers compared, each with its limit, the answers compared and
    the plain reference's seconds on ``device``."""
    scoring = config["scoring"]
    sample = check_sample(mix, pool, seed)
    trips = [traffic.triplets(pool[p])[t] for p, t in sample]
    t0 = time.perf_counter()
    want = dp.scores(trips, scoring, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    by_item: Dict[int, List[tuple]] = {}
    for (p, t), trip, score in zip(sample, trips, want):
        by_item.setdefault(p, []).append((t, trip, score))
    failed = sum(r.error is not None for r in records)
    wrong_scores, wrong_rows, compared = failed, failed, 0
    for r in records:
        if r.error is not None:
            continue
        for t, trip, score in by_item.get(r.item, []):
            compared += 1
            got, rows = r.answer[t] if t < len(r.answer) else (None, None)
            wrong_scores += got != score
            if mix.get("alignment"):
                wrong_rows += rows is None or \
                    rescore.rescore(rows, trip, scoring) != score
    checks = {"wrong_scores": {"value": int(wrong_scores), "limit": LIMIT}}
    if mix.get("alignment"):
        checks["wrong_alignments"] = {"value": int(wrong_rows),
                                      "limit": LIMIT}
    return checks, compared, ref_s


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", started: Optional[float] = None,
             root: str = ROOT, bench_dir: str = HERE, log=sys.stderr,
             call: Optional[Callable] = None) -> dict:
    """One run of cell ``name``: the result line's object.  ``started`` is
    the host clock at process start (``setup_s`` counts from it); ``call``
    stands in for the program's entry (the control, the fault tests);
    ``root`` holds ``BENCHMARK.json`` and ``bench_dir`` the cell's files."""
    started = time.perf_counter() if started is None else started
    man = manifest(root)
    cell = workload(man, name)
    config = load(bench_dir, "configs", cell["config"] + ".json")
    mix = load(bench_dir, "traffic", cell["traffic"] + ".json")
    section = "per_layer" if trace else "end_to_end"
    metrics = [m for m in cell_metrics(man, name, section)
               if m["name"] != "setup_s"]
    readers = {m["name"]: reader(m["name"], os.path.join(bench_dir, "metrics"))
               for m in metrics}
    t_pool = time.perf_counter()
    pool = traffic.pool(config, mix, seed)
    call = call or program(config, mix, device)
    cuda = torch.device(device).type == "cuda"
    t_warm = time.perf_counter()
    for req in pool:  # warm-up: every shape the window sends, once
        call(req)
    if cuda:
        torch.cuda.synchronize()
    print(f"setup: {t_pool - started:.3f} s to the pool, "
          f"{t_warm - t_pool:.3f} s making it, "
          f"{time.perf_counter() - t_warm:.3f} s warming up", file=log)
    probe = Probe()
    if trace:
        for mod in readers.values():
            if hasattr(mod, "install"):
                mod.install(probe)
    prof = None
    try:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(btrace.WINDOW):
                    records, t0, t1 = run_window(call, pool, seconds, probe,
                                                 log)
                if cuda:
                    torch.cuda.synchronize()
        else:
            records, t0, t1 = run_window(call, pool, seconds, probe, log)
    finally:
        probe.restore()
    memory_peak = probe.memory_peak()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded JAX or the JAX package: {found}")
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    tr = btrace.read(prof) if prof is not None else None
    window = Window(records, t1 - t0, probe.spans, tr, kind)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(window)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if not trace:
        values["setup_s"] = {"value": t0 - started, "unit": "s"}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        breakdown = btrace.summary(tr)
    del prof, tr, window, call
    if cuda:
        torch.cuda.empty_cache()
    checks, compared, ref_s = check(config, mix, pool, records, seed,
                                    device)
    print(f"reference: {ref_s:.3f} s for {compared} answers compared",
          file=log)
    failed = sum(r.error is not None for r in records)
    correct = bool(records) and failed == 0 and compared > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": values, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
