"""Where the time of ``align(..., return_alignment=True)`` goes, on the card.

Run on a machine with a CUDA device::

    python3 -m trialign_torch.profile_traceback [--sizes 512 1024 2048] \
        [--seed 0]

For each size n it prints one JSON line with, for a random n^3 triplet:

* ``nodes``: every node of the Hirschberg recursion with its shape, mode,
  route and seconds (the engine's ``TRIALIGN_TB_TRACE`` lines);
* ``direct`` (where the top node is direct): the direct engine's
  choice-capture sweep and its walk, each in host seconds ending in a
  ``torch.cuda.synchronize()``, the walk's steps, and the device's busy
  share over the sweep: the kernel seconds ``torch.profiler`` records (CUDA
  activity only) in a second run of the same sweep, over the first,
  unprofiled run's seconds.

Then the card's name and power limit.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import io
import json
import os
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    return {"kernel_s": busy, "kernels": len(kernels),
            "profiled_wall_s": wall}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[512, 1024, 2048])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_traceback: no CUDA device", file=sys.stderr)
        return 1
    from trialign_torch import _build
    from trialign_torch.config import Scoring
    from trialign_torch.traceback import direct, hirschberg

    _build.build()  # outside the timed runs

    cuda = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    os.environ["TRIALIGN_TB_TRACE"] = "1"
    for n in args.sizes:
        a, b, c = (rng.integers(0, 4, n).astype(np.int32) for _ in range(3))
        log, saved = io.StringIO(), sys.stderr
        sys.stderr = log
        try:
            (score, _), total = _seconds(
                lambda: hirschberg.hirschberg_align(a, b, c, device=cuda))
        finally:
            sys.stderr = saved
        rec = {"n": n, "score": score, "seconds": total,
               "nodes": log.getvalue().splitlines()}
        if hirschberg.DIRECT_CELLS >= (n + 1) ** 3:
            def sweep():
                return direct._choices(a, b, c, Scoring(), "free", None, cuda)

            (final, lo, hi), sweep_s = _seconds(sweep)
            t0 = int(np.argmax(final.cpu().numpy()))
            (acts, _), walk_s = _seconds(
                lambda: direct._walk(lo, hi, t0, n, n, n, n + 1, "free"))
            del final, lo, hi
            prof = kernel_seconds(sweep)
            rec["direct"] = {"sweep_s": sweep_s, "walk_s": walk_s,
                             "walk_steps": len(acts), **prof,
                             "busy_share": prof["kernel_s"] / sweep_s}
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
