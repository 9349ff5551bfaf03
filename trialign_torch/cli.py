"""Command-line interface of the port.

Port of ``trialign/cli.py``: the commands ``align``, ``batch``, ``bench`` and
``selftest`` with the reference's flags and output formats.  Everything runs
on the CUDA device; ``--cpu`` (or ``TRIALIGN_FORCE_CPU=1``) runs the
kernels' plain versions on the CPU instead.  Without a card and without
``--cpu`` the CLI exits with status 2 and says so.

``--backend`` takes the port's names (``api.BACKENDS``) and the
reference's: "xla" is "torch", "pallas" is "wavefront", "pallas_interpret"
is "wavefront" on the CPU.

Examples:
  python -m trialign_torch.cli align --a ACGTACGT --b ACGACGT --c ACTTACG --alignment
  python -m trialign_torch.cli align --a-file dat/A_seq.dat --b-file dat/B_seq.dat \\
      --c-file dat/C_seq.dat --backend golden
  python -m trialign_torch.cli batch --tsv triplets.tsv [--sharded]
  python -m trialign_torch.cli --cpu selftest
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from trialign_torch.config import Scoring, decode, encode

# The reference's backend names and the port's counterparts.
BACKEND_ALIASES = {"xla": "torch", "pallas": "wavefront",
                   "pallas_interpret": "wavefront"}


def _load_seq(inline, path):
    if inline is not None:
        return encode(inline)
    if path is None:
        raise SystemExit("provide either an inline sequence or a file")
    if path.endswith(".dat"):
        from trialign_torch.io import load_dat_sequence

        return load_dat_sequence(path)
    from trialign_torch.io import read_fasta

    seqs = read_fasta(path)
    if len(seqs) != 1:
        raise SystemExit(f"{path}: expected exactly one FASTA record, got {len(seqs)}")
    return encode(next(iter(seqs.values())))


def _load_triplet(args):
    """Three sequences from inline flags, per-sequence files, or one
    3-record FASTA (--fasta)."""
    if getattr(args, "fasta", None):
        from trialign_torch.io import read_fasta

        seqs = read_fasta(args.fasta)
        if len(seqs) != 3:
            raise SystemExit(
                f"{args.fasta}: expected exactly 3 FASTA records, got {len(seqs)}"
            )
        return tuple(encode(s) for s in seqs.values())
    return (
        _load_seq(args.a, args.a_file),
        _load_seq(args.b, args.b_file),
        _load_seq(args.c, args.c_file),
    )


def _parse_submatrix(spec):
    """'1,-1,-1,-1,-1,1,...' (n*n comma values, row-major) -> nested tuple."""
    if not spec:
        return None
    vals = [int(v) for v in spec.replace(" ", "").split(",") if v != ""]
    n = int(len(vals) ** 0.5)
    if n * n != len(vals):
        raise SystemExit(
            f"--submatrix needs a square count of values (got {len(vals)})"
        )
    return tuple(tuple(vals[i * n : (i + 1) * n]) for i in range(n))


def _scoring(args) -> Scoring:
    return Scoring(
        match=args.match,
        mismatch=args.mismatch,
        gap_open=args.gap_open,
        gap_extend=args.gap_extend,
        s3_mode=args.s3_mode,
        submatrix=_parse_submatrix(getattr(args, "submatrix", None)),
    )


def _add_scoring_args(p):
    p.add_argument("--match", type=int, default=1)
    p.add_argument("--mismatch", type=int, default=-1)
    p.add_argument("--gap-open", type=int, default=2)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--s3-mode", choices=["sop", "rtl"], default="sop")
    p.add_argument(
        "--submatrix", default=None, metavar="V1,V2,...",
        help="runtime substitution matrix: n*n comma-separated ints, "
        "row-major (symbol codes 0..n-1); requires --s3-mode sop "
        "(the reference testbench's planned 4x4 score-matrix ports)",
    )


def _rows(alignment):
    return [decode([v if v != -1 else 255 for v in row]) for row in alignment]


def cmd_align(args) -> int:
    from trialign_torch.api import align
    from trialign_torch.metrics import (
        RunMetrics, device_summary, profile_trace,
    )

    a, b, c = _load_triplet(args)
    with profile_trace(args.profile, args.device):
        res = align(
            a, b, c, scoring=_scoring(args), backend=args.backend,
            return_alignment=args.alignment,
            score_bits=getattr(args, "score_bits", 0), device=args.device,
        )
    if args.profile:
        print(f"profiler trace written to {args.profile}", file=sys.stderr)
    if args.metrics:
        RunMetrics(
            score=res.score,
            cells=res.cells,
            seconds=res.seconds,
            backend=res.backend,
            device=device_summary(args.device),
            shape=(len(a), len(b), len(c)),
        ).emit()
    if args.json:
        out = {
            "score": res.score,
            "backend": res.backend,
            "cells": res.cells,
            "seconds": round(res.seconds, 6),
            "gcups": round(res.gcups, 4),
            "device": device_summary(args.device),
        }
        if res.alignment:
            out["alignment"] = _rows(res.alignment)
        print(json.dumps(out))
    else:
        print(f"score: {res.score}")
        print(f"backend: {res.backend}  cells: {res.cells}  "
              f"time: {res.seconds*1e3:.2f} ms  gcups: {res.gcups:.3f}")
        if res.alignment:
            for name, row in zip("ABC", _rows(res.alignment)):
                print(f"{name}: {row}")
    return 0


def cmd_batch(args) -> int:
    from trialign_torch.api import align_batch

    trips = []
    with open(args.tsv) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            parts = line.split()
            if len(parts) != 3:
                raise SystemExit(
                    f"{args.tsv}:{lineno}: expected 3 whitespace-separated "
                    f"sequences, got {len(parts)}"
                )
            trips.append(tuple(encode(p) for p in parts))
    if args.sharded and args.alignment:
        raise SystemExit("--alignment is score+path recovery on the host "
                         "path; run it without --sharded")
    if args.sharded:
        import torch

        from trialign_torch.dist.batch import align_batch_sharded
        from trialign_torch.dist.mesh import default_mesh, make_mesh

        mesh = (default_mesh() if args.device == "cuda"
                else make_mesh(devices=[torch.device("cpu")]))
        for i, s in enumerate(align_batch_sharded(trips, _scoring(args),
                                                  mesh)):
            print(f"{i}\t{s}")
        return 0
    results = align_batch(trips, scoring=_scoring(args),
                          return_alignment=args.alignment,
                          device=args.device)
    for i, r in enumerate(results):
        print(f"{i}\t{r.score}")
        if r.alignment:
            for name, row in zip("ABC", _rows(r.alignment)):
                print(f"  {name}: {row}")
    return 0


def cmd_bench(args) -> int:
    """Single-device benchmark at --size^3 (see trialign_torch.benchmarks
    for the measurement discipline)."""
    from trialign_torch.benchmarks import (
        BASELINE_ASIC_GCUPS,
        bench_blocked,
        bench_single_stream,
        parity_check,
    )
    from trialign_torch.metrics import device_summary, profile_trace

    sc = _scoring(args)
    n = args.size
    if args.mode == "wavefront" and n > 255:
        # Honor the explicit mode request instead of silently switching.
        raise SystemExit(
            f"--mode wavefront requires --size <= 255 (the wavefront "
            f"kernel's |B|, |C| cap); got {n}. Use --mode blocked or auto."
        )
    parity_check(sc, device=args.device)
    with profile_trace(args.profile, args.device):
        if n <= 255 and args.mode in ("auto", "wavefront"):
            gcups, dt = bench_single_stream(n, args.repeats, sc,
                                            device=args.device)
            mode = "wavefront"
        else:
            gcups, dt = bench_blocked(n, args.repeats, sc, device=args.device)
            mode = "blocked"
    if args.profile:
        print(f"profiler trace written to {args.profile}", file=sys.stderr)
    out = {
        "size": n,
        "mode": mode,
        "ms_per_alignment": round(dt * 1e3, 3),
        "gcups": round(gcups, 3),
        "vs_reference_asic": round(gcups / BASELINE_ASIC_GCUPS, 3),
        "backend": args.device,
        "device": device_summary(args.device),
        "parity": "exact",
    }
    print(json.dumps(out) if args.json else
          f"{mode} {n}^3: {dt*1e3:.2f} ms/alignment -> {gcups:.2f} GCUPS "
          f"({out['vs_reference_asic']}x reference ASIC)")
    return 0


def cmd_selftest(args) -> int:
    """Cross-backend parity on the canonical triplet."""
    from trialign_torch.golden import align_planes_numpy, rescore_alignment
    from trialign_torch.io import load_reference_triplet
    from trialign_torch.kernels.blocked import align_blocked
    from trialign_torch.kernels.ref import align_ref
    from trialign_torch.kernels.wavefront import align_wavefront
    from trialign_torch.traceback import hirschberg_align

    dev = args.device
    a, b, c = load_reference_triplet()
    sc = _scoring(args)
    want = align_planes_numpy(a, b, c, sc)
    rows = [("golden", want)]
    rows.append(("torch", align_ref(a, b, c, sc, device=dev)))
    rows.append(("wavefront", align_wavefront(a, b, c, sc, device=dev)))
    rows.append(("blocked", align_blocked(a, b, c, sc, device=dev)))
    try:
        from trialign_torch.native import align_native, score_native

        rows.append(("native-c++", score_native(a, b, c, sc)))
        nscore, nrows = align_native(a, b, c, sc)
        # A traceback whose rescore disagrees is a mismatch even if the
        # score itself is right; surface it as one.
        ok_tb = rescore_alignment(nrows, sc) == nscore
        rows.append(("native-tb", nscore if ok_tb else 10**9))
    except Exception as e:  # the host toolchain may be missing
        print(f"native-c++: skipped ({e})", file=sys.stderr)
    hscore, _ = hirschberg_align(a, b, c, sc, device=dev)
    rows.append(("hirschberg", hscore))

    ok = True
    for name, got in rows:
        good = got == want
        ok &= good
        print(f"{name:12s} {got:6d}  {'OK' if good else 'MISMATCH'}")
    print(f"backend: {dev}  ->  {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    from trialign_torch.api import BACKENDS

    ap = argparse.ArgumentParser(prog="trialign-torch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU, through the kernels' plain versions (also "
        "via TRIALIGN_FORCE_CPU=1); the default is the CUDA device",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("align", help="align one triplet")
    p.add_argument("--a")
    p.add_argument("--b")
    p.add_argument("--c")
    p.add_argument("--a-file")
    p.add_argument("--b-file")
    p.add_argument("--c-file")
    p.add_argument("--fasta", help="one FASTA file with exactly 3 records")
    p.add_argument("--backend", default="auto",
                   choices=[*BACKENDS, *BACKEND_ALIASES])
    p.add_argument("--alignment", action="store_true", help="recover the alignment")
    p.add_argument("--score-bits", type=int, default=0, dest="score_bits",
                   help="RTL bit-parity mode: wrap stored scores as signed "
                   "N-bit registers (the hardware's SCORE_BITS=12)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace into DIR")
    p.add_argument("--metrics", action="store_true",
                   help="emit a structured RunMetrics JSON line to stderr")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("batch", help="align triplets from a TSV (a b c per line)")
    p.add_argument("--tsv", required=True)
    p.add_argument("--sharded", action="store_true",
                   help="data-parallel across this process's devices "
                        "(align_batch_sharded; with --cpu one CPU slot)")
    p.add_argument("--alignment", action="store_true",
                   help="recover every alignment (threaded C++ engine / "
                        "Hirschberg engine; incompatible with --sharded)")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("bench", help="single-device benchmark at --size^3")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--repeats", type=int, default=4)
    p.add_argument("--mode", choices=["auto", "wavefront", "blocked"], default="auto")
    p.add_argument("--json", action="store_true")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace into DIR")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("selftest", help="cross-backend parity check")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_selftest)

    args = ap.parse_args(argv)
    args.device = "cuda"
    if args.cpu or os.environ.get("TRIALIGN_FORCE_CPU") == "1" or \
            getattr(args, "backend", None) == "pallas_interpret":
        args.device = "cpu"
    if hasattr(args, "backend"):
        args.backend = BACKEND_ALIASES.get(args.backend, args.backend)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("trialign-torch: no CUDA device; the port runs on a GPU. "
                  "Pass --cpu (or set TRIALIGN_FORCE_CPU=1) for the CPU "
                  "versions of its kernels", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
