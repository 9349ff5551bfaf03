"""Where the time of ``align(..., return_alignment=True)`` goes, on the card.

Run on a machine with a CUDA device::

    python3 -m trialign_torch.profile_traceback [--sizes 512 1024 2048] \
        [--seed 0] [--sharded STRIPES [--single-cells CELLS]]

For each size n it prints one JSON line with, for a random n^3 triplet:

* ``seconds`` of one alignment under ``torch.profiler`` (CPU and CUDA
  activity), ending in a ``torch.cuda.synchronize()``, and ``nodes``: every
  node of its Hirschberg recursion, from the engine's ``trialign.tb.*``
  spans in that run, in the order they opened, each with its route
  (``walk``, ``direct``, ``split``, or ``restart`` around the re-solve of a
  split whose guard won), its depth (0 at the top), its seconds and the
  device's kernel seconds inside it, on the profiler's clock;
* ``direct`` (where the top node is direct): for each route of the direct
  engine, ``kernels`` (``direct.choices`` and ``direct.walk``, the CUDA
  kernels) and ``plain`` (their plain versions ``direct._choices`` and
  ``direct.walk_ref`` on the card), the choice-capture sweep and the walk,
  each in host seconds ending in a ``torch.cuda.synchronize()``, the walk's
  steps, and the device's busy share over the sweep: the kernel seconds of
  a profiled run of the sweep (CUDA activity only) over that run's seconds;
* ``sharded`` (with ``--sharded``): ``dist.halo_tb.hirschberg_align_sharded``
  on the same triplet in STRIPES stripes sharing the card, nodes above
  ``--single-cells`` split on the stripes: its seconds, the seconds of its
  sweeps on the stripes (every sharded split and ``free_jk`` guard, each
  ending in a ``torch.cuda.synchronize()``), the rest (the single-device
  leaves and the host) and the leaves' nodes, from their spans as above
  (its profiled run is the one timed).

Then the card's name and power limit.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_ops(events) -> list:
    """The device's operations among a profiler's ``events``: CUDA activity
    other than the package's spans, which show on the device's timeline
    too."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_seconds(fn) -> dict:
    """The device's kernel seconds in one run of ``fn``, from torch.profiler
    recording CUDA activity only, and that run's (profiled) wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_ops(prof.events())
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    return {"kernel_s": busy, "kernels": len(kernels),
            "profiled_wall_s": wall}


NODE = "trialign.tb."


def span_nodes(events) -> list:
    """The Hirschberg nodes among a profiler's ``events``: each
    ``trialign.tb.<route>`` span, in the order they opened, as its route,
    its depth among the nodes around it, its seconds and the seconds of the
    device's operations inside it (clipped to it; the profiler puts both on
    one clock)."""
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.name.startswith(NODE)
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda s: (s[0], -s[1]))
    ops = [(e.time_range.start, e.time_range.end)
           for e in _device_ops(events)]
    nodes, open_ends = [], []
    for start, end, name in spans:
        while open_ends and open_ends[-1] <= start:
            open_ends.pop()
        inside = sum(max(0.0, min(e, end) - max(s, start)) for s, e in ops)
        nodes.append({"route": name[len(NODE):], "depth": len(open_ends),
                      "seconds": (end - start) / 1e6,
                      "kernel_s": inside / 1e6})
        open_ends.append(end)
    return nodes


def traced(fn):
    """(``fn()``, its seconds, its nodes) from one run under torch.profiler
    recording CPU and CUDA activity, ending in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return out, seconds, span_nodes(prof.events())


def direct_seconds(a, b, c, cuda, sweep, walk) -> dict:
    """One route of the direct engine on a triplet in mode "free": ``sweep``
    (``direct.choices`` or ``direct._choices``) and ``walk``
    (``direct.walk`` or ``direct.walk_ref``), timed, and the busy share over
    the sweep."""
    from trialign_torch.config import Scoring

    lens = len(a), len(b), len(c)

    def run_sweep():
        return sweep(a, b, c, Scoring(), "free", None, cuda)

    (final, lo, hi), sweep_s = _seconds(run_sweep)
    t0 = int(np.argmax(final.cpu().numpy()))
    res, walk_s = _seconds(lambda: walk(lo, hi, t0, *lens, "free"))
    del final, lo, hi
    prof = kernel_seconds(run_sweep)
    return {"sweep_s": sweep_s, "walk_s": walk_s, "walk_steps": int(res[0]),
            **prof, "busy_share": prof["kernel_s"] / prof["profiled_wall_s"]}


def sharded_seconds(a, b, c, cuda, stripes: int, single_cells: int) -> dict:
    """One run of the sharded traceback on ``stripes`` stripes sharing the
    card, its seconds split into the sweeps on the stripes and the rest."""
    from trialign_torch.dist import halo_tb, mesh

    striped = []

    def timed(fn):
        def run(*args, **kwargs):
            out, seconds = _seconds(lambda: fn(*args, **kwargs))
            striped.append(seconds)
            return out
        return run

    real = halo_tb.sharded_split_point, halo_tb._sharded_final_vector
    halo_tb.sharded_split_point, halo_tb._sharded_final_vector = map(timed,
                                                                     real)
    try:
        (score, _), total, nodes = traced(
            lambda: halo_tb.hirschberg_align_sharded(
                a, b, c, mesh=mesh.make_mesh(1, stripes,
                                             devices=[cuda] * stripes),
                single_cells=single_cells))
    finally:
        halo_tb.sharded_split_point, halo_tb._sharded_final_vector = real
    return {"stripes": stripes, "single_cells": single_cells,
            "score": score, "seconds": total, "striped_s": sum(striped),
            "striped_calls": len(striped), "rest_s": total - sum(striped),
            "nodes": nodes}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[512, 1024, 2048])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sharded", type=int, default=0, metavar="STRIPES",
                        help="also run the sharded traceback in STRIPES "
                             "stripes sharing the card")
    parser.add_argument("--single-cells", type=int, default=64 << 20,
                        help="the sharded traceback's single-device gate")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_traceback: no CUDA device", file=sys.stderr)
        return 1
    from trialign_torch import _build
    from trialign_torch.traceback import direct, hirschberg

    _build.build()  # outside the timed runs

    cuda = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    for n in args.sizes:
        a, b, c = (rng.integers(0, 4, n).astype(np.int32) for _ in range(3))
        (score, _), total, nodes = traced(
            lambda: hirschberg.hirschberg_align(a, b, c, device=cuda))
        rec = {"n": n, "score": score, "seconds": total, "nodes": nodes}
        if hirschberg.DIRECT_CELLS >= (n + 1) ** 3:
            rec["direct"] = {
                "kernels": direct_seconds(a, b, c, cuda, direct.choices,
                                          direct.walk),
                "plain": direct_seconds(a, b, c, cuda, direct._choices,
                                        direct.walk_ref)}
        if args.sharded:
            rec["sharded"] = sharded_seconds(a, b, c, cuda, args.sharded,
                                             args.single_cells)
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
