#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's score path on one GPU and check it.

Run from the root of the repository, on a machine with an NVIDIA H100 and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``trialign_torch/csrc`` and prints one
JSON line per phase:

1. ``device``: the card, the toolkit, the build time and ptxas statistics;
2. ``wavefront``: K2 against its plain version (the torch sweep), exactly;
3. ``blocked``: K3 against its plain versions (the tiled ``blocked_ref`` and
   the torch sweep), exactly;
4. ``main_path``: ``trialign_torch.align`` with backend "auto" against the
   golden model and the C++ oracle, with the kernels' launch counts;
5. ``tuning``: K2's thread count and K3's tile shape candidates;
6. ``timings``: each kernel beside the plain sweep at the main path's sizes.

Then a summary of the kernels, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any mismatch or error exits
non-zero before that line; without a CUDA device it exits 1 at once.  It
imports no JAX: the oracles are the reference's JAX-free modules.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from trialign.config import Scoring
from trialign.golden import align_planes_numpy
from trialign.io import load_reference_triplet
from trialign.native import score_native
import trialign_torch
from trialign_torch import _build
from trialign_torch.benchmarks import gcups, time_cuda_ms
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import ref
from trialign_torch.kernels import wavefront as wf

DEFAULT = Scoring()
RTL = Scoring(s3_mode="rtl")
NONDEFAULT = Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2)
# Asymmetric, so that a swapped lookup shows.
SUB4 = Scoring(submatrix=((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1),
                          (-1, -2, -1, 1)))
SUB8 = Scoring(submatrix=tuple(
    tuple(int(v) for v in row)
    for row in np.random.default_rng(7).integers(-4, 6, (8, 8))))
# Large enough that a 64-long near-identical triplet passes 2047.
WIDE = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)

# (name, scoring, score_bits, alphabet the sequences draw from).  The
# submatrix cases draw past the matrix, so codes outside it score the floor.
VARIANTS = {
    "default": (DEFAULT, 0, 4),
    "rtl": (RTL, 0, 4),
    "nondefault": (NONDEFAULT, 0, 4),
    "sub4": (SUB4, 0, 6),
    "sub8": (SUB8, 0, 10),
}

CUDA = torch.device("cuda")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def triplet(rng, shape, nsym=4):
    return tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in shape)


def near_identical(rng, n, every=(7, 5), nsym=4):
    """A triplet of one random sequence with B changed at every every[0]-th
    and C at every every[1]-th position: its score grows nearly 3 * match a
    position."""
    a = rng.integers(0, nsym, n).astype(np.uint8)
    b, c = a.copy(), a.copy()
    b[::every[0]] = (b[::every[0]] + 1) % nsym
    c[::every[1]] = (c[::every[1]] + 2) % nsym
    return a, b, c


def cpu_ints(t: torch.Tensor) -> list:
    return [int(v) for v in t.cpu().reshape(-1)]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------- phases


def phase_device() -> str:
    smi = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         torch_cuda=torch.version.cuda,
         nvcc=[ln for ln in nvcc.splitlines() if "release" in ln][0],
         build_s=build_s, ptxas=ptxas)
    return smi


def wavefront_pair(a, b, c, scoring, bits):
    """(kernel, plain) final-cell values of one triplet on the card."""
    args = wf.prep(a, b, c, CUDA)
    got = wf.final_values(*args, scoring, bits)[0]
    want = ref.sweep(args[0][0], args[1][0], args[2][0], len(a), len(b),
                     len(c), scoring, bits)
    return cpu_ints(got), cpu_ints(want)


def phase_wavefront(rng) -> int:
    cases = [(s, "default") for s in
             ((1, 1, 1), (6, 5, 7), (40, 4, 6), (64, 64, 64), (255, 255, 255),
              (4096, 16, 16))]
    cases += [((64, 64, 64), v) for v in ("rtl", "nondefault", "sub4", "sub8")]
    cases += [((255, 255, 255), "rtl")]
    err = 0
    checked = []
    for shape, name in cases:
        scoring, bits, nsym = VARIANTS[name]
        got, want = wavefront_pair(*triplet(rng, shape, nsym), scoring, bits)
        err = max(err, max(abs(g - w) for g, w in zip(got, want)))
        require(got == want, f"K2 {shape} {name}: kernel {got} != plain {want}")
        checked.append(f"{shape}/{name}")

    # score_bits=12 where the wrap changes the answer (golden on the host).
    a, b, c = near_identical(rng, 64)
    got, want = wavefront_pair(a, b, c, WIDE, 12)
    g12 = align_planes_numpy(a, b, c, WIDE, score_bits=12)
    g0 = align_planes_numpy(a, b, c, WIDE)
    require(g12 != g0, f"no wrap at 64^3: {g12} == {g0}")
    require(got == want and max(got) == g12,
            f"K2 score_bits=12: kernel {got} plain {want} golden {g12}")
    checked.append("(64, 64, 64)/wide/score_bits=12")

    # One launch over a batch of problems of mixed lengths.
    trips = [triplet(rng, s) for s in ((30, 20, 25), (5, 40, 3), (50, 1, 60))]
    la, lb, lc = (max(len(t[x]) for t in trips) + 1 for x in range(3))
    pads = (ref.PAD_A, ref.PAD_B, ref.PAD_C)
    arrs = [torch.stack([ref.extend(t[x], width, pads[x], CUDA)
                         for t in trips]) for x, width in enumerate((la, lb, lc))]
    lens = [[len(x) for x in t] for t in trips]
    got = wf.final_values(*arrs, lens)
    for p, t in enumerate(trips):
        want = ref.sweep(arrs[0][p], arrs[1][p], arrs[2][p], *lens[p])
        require(cpu_ints(got[p]) == cpu_ints(want), f"K2 batch item {p}")
    checked.append("batch of 3")
    emit(phase="wavefront", cases=checked, max_abs_err=err)
    return err


def blocked_case(a, b, c, scoring, bits, block_shape, tiled_ref):
    """Kernel against the torch sweep and, if asked, against blocked_ref,
    all on the card; returns the kernel's values."""
    la, lb, lc = len(a), len(b), len(c)
    dims = bk.plan_dims(la, lb, lc, *block_shape)
    arrs = bk.prep_blocked(a, b, c, dims, CUDA)
    got = cpu_ints(bk.final_values(*arrs, la, lb, lc, dims, scoring, bits))
    plains = [cpu_ints(ref.sweep(*arrs, la, lb, lc, scoring, bits))]
    if tiled_ref:
        plains.append(cpu_ints(
            bk.blocked_ref(*arrs, la, lb, lc, dims, scoring, bits)))
    err = max(abs(g - w) for want in plains for g, w in zip(got, want))
    for name, want in zip(("sweep", "blocked_ref"), plains):
        require(got == want, f"K3 {la, lb, lc} {block_shape}: kernel {got} "
                f"!= {name} {want}")
    return got, err


def phase_blocked(rng) -> int:
    checked = []
    err = 0
    default_shape = bk.choose_block_shape(0, 0, 0)
    small = [((10, 40, 50), (16, 128), "default"),
             ((10, 40, 50), (17, 17), "default")]
    small += [((37, 70, 45), (9, 17), v) for v in VARIANTS]
    for shape, block, name in small:
        scoring, bits, nsym = VARIANTS[name]
        _, e = blocked_case(*triplet(rng, shape, nsym), scoring, bits, block,
                            True)
        err = max(err, e)
        checked.append(f"{shape}/{block}/{name}/tiled")
    for shape in ((300, 300, 300), (100, 257, 700)):
        _, e = blocked_case(*triplet(rng, shape), DEFAULT, 0, default_shape,
                            False)
        err = max(err, e)
        checked.append(f"{shape}/{default_shape}/default")

    # score_bits=12 with default scoring: a near-identical 768^3 triplet
    # scores past 2047, so the wrap is real.
    trip = near_identical(rng, 768, every=(97, 89))
    got, e = blocked_case(*trip, DEFAULT, 12, default_shape, False)
    err = max(err, e)
    arrs = bk.prep_blocked(*trip, bk.plan_dims(768, 768, 768), CUDA)
    unwrapped = max(cpu_ints(ref.sweep(*arrs, 768, 768, 768)))
    require(unwrapped > 2047 and max(got) != unwrapped,
            f"no wrap at 768^3: unwrapped {unwrapped}, wrapped {max(got)}")
    checked.append(f"(768, 768, 768)/{default_shape}/default/score_bits=12 "
                   f"(unwrapped {unwrapped}, wrapped {max(got)})")
    emit(phase="blocked", cases=checked, max_abs_err=err)
    return err


def phase_main_path(rng) -> dict:
    wf.final_values.launches = 0
    bk.final_values.launches = 0
    runs = []
    a, b, c = load_reference_triplet()
    r = trialign_torch.align(a, b, c)
    want = align_planes_numpy(a, b, c)
    require(r.backend == "wavefront" and r.score == want,
            f"dat triplet: {r.backend} {r.score} != golden {want}")
    runs.append({"input": "dat", "backend": r.backend, "score": r.score,
                 "oracle": "golden"})
    for n, backend in ((64, "wavefront"), (1024, "blocked")):
        a, b, c = triplet(rng, (n, n, n))
        r = trialign_torch.align(a, b, c)
        t0 = time.perf_counter()
        want = score_native(a, b, c)
        native_s = time.perf_counter() - t0
        require(r.backend == backend and r.score == want,
                f"{n}^3: {r.backend} {r.score} != native {want}")
        runs.append({"input": f"random {n}^3", "backend": r.backend,
                     "score": r.score, "oracle": "native",
                     "oracle_s": native_s, "align_s": r.seconds})
    launches = {"wavefront": wf.final_values.launches,
                "blocked": bk.final_values.launches}
    require(all(launches.values()), f"a kernel did not launch: {launches}")
    emit(phase="main_path", runs=runs, launches=launches)
    return launches


def _inputs(rng, shape, count=4):
    return [triplet(rng, shape) for _ in range(count)]


def time_wavefront(trips, threads=wf.THREADS):
    args = [(*wf.prep(*t, CUDA), DEFAULT, 0, threads) for t in trips]
    return time_cuda_ms(wf.final_values, args)


def time_blocked(trips, block_shape, threads=bk.THREADS):
    args = []
    for a, b, c in trips:
        dims = bk.plan_dims(len(a), len(b), len(c), *block_shape)
        args.append((*bk.prep_blocked(a, b, c, dims, CUDA), len(a), len(b),
                     len(c), dims, DEFAULT, 0, threads))
    return time_cuda_ms(bk.final_values, args)


def time_plain(trips):
    args = []
    for a, b, c in trips:
        la, lb, lc = len(a), len(b), len(c)
        args.append((ref.extend(a, la + 1, ref.PAD_A, CUDA),
                     ref.extend(b, lb + 1, ref.PAD_B, CUDA),
                     ref.extend(c, lc + 1, ref.PAD_C, CUDA), la, lb, lc))
    return time_cuda_ms(ref.sweep, args)


def phase_tuning(rng) -> None:
    trips = _inputs(rng, (255, 255, 255))
    k2 = {t: time_wavefront(trips, t) for t in (256, 512, 1024)}
    trips = _inputs(rng, (1024, 1024, 1024))
    k3 = {}
    for shape in ((17, 17), (33, 33), (17, 65), (33, 65), (65, 33)):
        for threads in (256, 512, 1024):
            k3[f"{shape[0]}x{shape[1]}/{threads}"] = time_blocked(
                trips, shape, threads)
    emit(phase="tuning", wavefront_255_ms_by_threads=k2,
         blocked_1024_ms_by_tile_threads=k3,
         chosen={"wavefront_threads": wf.THREADS,
                 "blocked_tile": bk.choose_block_shape(0, 0, 0),
                 "blocked_threads": bk.THREADS})


def phase_timings(rng) -> dict:
    rows = {}
    for name, n in (("wavefront", 255), ("blocked", 512), ("blocked", 1024)):
        trips = _inputs(rng, (n, n, n))
        if name == "wavefront":
            ms = time_wavefront(trips)
        else:
            ms = time_blocked(trips, bk.choose_block_shape(n, n, n))
        plain_ms = time_plain(trips[:3])
        cells = n ** 3
        rows[f"{name}_{n}"] = {"ms": ms, "gcups": gcups(cells, ms),
                               "plain_ms": plain_ms,
                               "plain_gcups": gcups(cells, plain_ms)}
    emit(phase="timings", **rows)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of every generated sequence")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on a GPU",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    smi = phase_device()
    k2_err = phase_wavefront(rng)
    k3_err = phase_blocked(rng)
    launches = phase_main_path(rng)
    phase_tuning(rng)
    rows = phase_timings(rng)
    require("jax" not in sys.modules, "JAX was imported")
    emit(kernels=[
        {"name": "wavefront", "route": "cuda",
         "source": "trialign_torch/csrc/wavefront.cu",
         "replaces": "trialign/kernels/wavefront.py:112",
         "launches": launches["wavefront"], "max_abs_err": k2_err,
         "ms": rows["wavefront_255"]["ms"],
         "plain_ms": rows["wavefront_255"]["plain_ms"]},
        {"name": "blocked", "route": "cuda",
         "source": "trialign_torch/csrc/blocked.cu",
         "replaces": "trialign/kernels/blocked.py:225",
         "launches": launches["blocked"], "max_abs_err": k3_err,
         "ms": rows["blocked_1024"]["ms"],
         "plain_ms": rows["blocked_1024"]["plain_ms"]},
    ])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
