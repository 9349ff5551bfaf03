"""Run one cell of the benchmark on the GPU and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy seconds and a breakdown of the trace.  The result is the last
line of standard output; the numbers compared with the plain reference,
each beside its limit, are the last lines of standard error.  Without a
CUDA device, or with fewer than the cell asks for, the run prints no
result and exits 2.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def query_power_limit():
    """Start ``nvidia-smi`` reading the card's name and power limit; it runs
    while the cell sets up."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
    except OSError as e:
        return f"unknown ({type(e).__name__})"


def power_limit(query) -> str:
    """What :func:`query_power_limit` read, once it has ended."""
    if isinstance(query, str):
        return query
    try:
        out, _ = query.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        query.kill()
        query.communicate()
        return "unknown (nvidia-smi timed out)"
    lines = out.strip().splitlines()
    return lines[0] if query.returncode == 0 and lines else "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    query = query_power_limit()
    try:
        return _run(args, query)
    finally:
        if not isinstance(query, str) and query.poll() is None:
            query.kill()
            query.wait()


def _run(args, query) -> int:
    import torch

    from benchmark import harness

    chips = int(harness.workload(harness.manifest(), args.workload)["chips"])
    if not torch.cuda.is_available():
        print(f"benchmark: no CUDA device ({power_limit(query)}); the "
              "benchmark measures a GPU and has no CPU fallback",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell asks for {chips} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import trialign_torch
    except ImportError as e:
        print(f"benchmark: the program is missing: {e}", file=sys.stderr)
        return 2
    if not os.path.abspath(trialign_torch.__file__).startswith(
            harness.ROOT + os.sep):
        print(f"benchmark: trialign_torch comes from "
              f"{trialign_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", STARTED)
    except Exception:  # noqa: BLE001 - the run fails with its traceback
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)} x{chips} of "
          f"{torch.cuda.device_count()}; name, power.limit: "
          f"{power_limit(query)}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
