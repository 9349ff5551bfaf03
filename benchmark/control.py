"""The readings the comparison's limits are set from, on the GPU.

    python3 -m benchmark.control --workload <cell> --program-seeds S.. \
        --control-seeds S.. --seconds <s> [--wrap BITS ..]

For each program seed, one run of the cell as the benchmark makes it (its
pool, warm-up, window and check) gives the sound program's readings.  For
each control seed, the cell's control (``controls/<cell>.json``) takes the
program's place and is checked the same way: ``program`` runs the
program's own path with a stated guarantee switched off (``scoring``
changes, ``score_bits``), ``reference`` puts the plain reference in
``wrap_bits``-bit registers in its place.  ``--wrap`` adds the reference in
each of those register widths on the control seeds, to show which widths
change an answer at this cell's sizes.  One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness, traffic
from benchmark.reference import dp


def control_call(config: dict, mix: dict, spec: dict, device):
    """The program with the control's guarantee switched off."""
    changed = dict(config, scoring=dict(config["scoring"],
                                        **spec.get("scoring", {})))
    return harness.program(changed, mix, device, spec.get("score_bits", 0))


def reference_checks(config: dict, mix: dict, seed: int, bits: int,
                     device) -> dict:
    """The checks of the reference in ``bits``-bit registers put in the
    program's place: one answer for every checked triplet of the pool."""
    pool = traffic.pool(config, mix, seed)
    sample = harness.check_sample(mix, pool, seed)
    got = dp.scores([traffic.triplets(pool[p])[t] for p, t in sample],
                    config["scoring"], device, wrap_bits=bits)
    records = []
    for p, req in enumerate(pool):
        answer = [(None, None)] * len(traffic.triplets(req))
        for (q, t), score in zip(sample, got):
            if q == p:
                answer[t] = (score, None)
        records.append(harness.Record(p, 0.0, 0.0, traffic.cells(req),
                                      answer, None, {}, None))
    checks, compared, _ = harness.check(config, mix, pool, records, seed,
                                        device)
    return {"checks": checks, "compared": compared}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--wrap", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.workload(harness.manifest(), args.workload)
    config = harness.load(harness.HERE, "configs", cell["config"] + ".json")
    mix = harness.load(harness.HERE, "traffic", cell["traffic"] + ".json")
    spec = harness.load(harness.HERE, "controls", args.workload + ".json")

    def emit(side, seed, t0, **fields):
        print(json.dumps({"workload": args.workload, "side": side,
                          "seed": seed, "seconds": time.perf_counter() - t0,
                          **fields}), flush=True)

    for seed in args.program_seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False)
        emit("program", seed, t0, correct=out["correct"],
             attempted=out["attempted"], checks=out["checks"])
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        if spec["kind"] == "program":
            out = harness.run_cell(
                args.workload, seed, args.seconds, False,
                call=control_call(config, mix, spec, "cuda"))
            emit("control", seed, t0, correct=out["correct"],
                 attempted=out["attempted"], checks=out["checks"])
        else:
            emit("control", seed, t0, **reference_checks(
                config, mix, seed, spec["wrap_bits"], "cuda"))
        for bits in args.wrap:
            t0 = time.perf_counter()
            emit(f"reference_int{bits}", seed, t0,
                 **reference_checks(config, mix, seed, bits, "cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
