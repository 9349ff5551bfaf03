#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

Run from the root of the repository, on a machine with an NVIDIA H100 and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``trialign_torch/csrc`` (one ``nvcc``
per source, all at once) and prints one JSON line per phase:

1. ``device``: the card, its SM clock, the toolkit, the build time and
   ptxas statistics;
2. ``wavefront``: K2 against its plain version (the torch sweep), exactly;
3. ``blocked``: K3 against its plain versions (the tiled ``blocked_ref`` and
   the torch sweep), exactly;
4. ``slab``: K5 against its plain versions (the tiled ``slab_ref`` and the
   torch engine), exactly: the captured plane and the final vector of every
   variant, on multi-tile and ragged shapes, under five scorings (one a
   16-symbol submatrix, which only K5 takes);
5. ``hetero``: K4 against its plain version ``hetero_ref``, exactly: the
   final vector of every problem of ragged batches (a 1 x 1-tile problem,
   an empty sequence, one batch cut into several dispatches) under four
   scorings;
6. ``main_path``: ``trialign_torch.align`` with backend "auto" against the
   golden model and the C++ oracle, with the kernels' launch counts;
7. ``traceback``: ``trialign_torch.align(..., return_alignment=True)`` at
   512^3 and 1024^3 (the direct engine), 2048^3 (K5 for the top split) and
   768^3 with lowered caps (K5 on pin nodes); each alignment rescores to the
   score path's score and holds the inputs; seconds, peak memory, the top
   node's route and K5's launches (those of the 2048^3 run go to the
   summary);
8. ``batch``: ``trialign_torch.align_batch`` on 1024 triplets with every
   length uniform in [128, 512] (K4, by its launches; seconds, GCUPS and
   triplets/s, best of 3 after a warm-up; the card's busy share under
   ``torch.profiler``), 64 of its scores against
   ``align()`` and 8 against the C++ oracle; a 48-triplet batch (one K2
   launch and K3) against ``align()``; 16 alignments that rescore exactly;
9. ``tuning``: K2's thread count and K3's tile shape candidates;
10. ``timings``: each kernel beside its plain version at the main path's
    sizes, and beside its bound; K5 against the torch engine, exactly, at
    the shape the 2048^3 traceback gives it; K4 against hetero_ref,
    exactly and timed, on a dispatch of three of the 1024-triplet batch's
    problems (its largest, its smallest, one at random), and K4 at the
    whole batch.

Then a summary of the kernels, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any mismatch or error exits
non-zero before that line; without a CUDA device it exits 1 at once.  It
imports neither JAX nor the JAX package: the oracles are the port's copies.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import trialign_torch
from trialign_torch import _build
from trialign_torch.benchmarks import gcups, time_cuda_ms
from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.golden import align_planes_numpy, rescore_alignment
from trialign_torch.io import load_reference_triplet
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import hetero as hk
from trialign_torch.kernels import mosaic
from trialign_torch.kernels import ref
from trialign_torch.kernels import slab as sk
from trialign_torch.kernels import wavefront as wf
from trialign_torch.kernels.plane_math import op_count
from trialign_torch.native import score_native
from trialign_torch.profile_traceback import kernel_seconds
from trialign_torch.traceback import direct
from trialign_torch.traceback import hirschberg as hb
from trialign_torch.traceback import torch_engine
from trialign_torch.traceback.engine import NEG

DEFAULT = Scoring()
RTL = Scoring(s3_mode="rtl")
NONDEFAULT = Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2)
# Asymmetric, so that a swapped lookup shows.
SUB4 = Scoring(submatrix=((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1),
                          (-1, -2, -1, 1)))
SUB8 = Scoring(submatrix=tuple(
    tuple(int(v) for v in row)
    for row in np.random.default_rng(7).integers(-4, 6, (8, 8))))
# K5 alone takes alphabets past 8 symbols: up to the 16 Scoring accepts.
SUB16 = Scoring(submatrix=tuple(
    tuple(int(v) for v in row)
    for row in np.random.default_rng(16).integers(-4, 6, (16, 16))))
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
SLAB_VARIANTS = {**VARIANTS, "sub16": (SUB16, 0, 18)}

# The shape of K5's sweeps at the 2048^3 traceback's top split.
SPLIT_SHAPE = (1024, 2048, 2048)
# The repo's throughput workload (trialign/benchmarks.py bench_batch_mixed,
# BASELINE config 3): 1024 triplets, each length uniform in [128, 512].
BATCH_N, BATCH_LENS = 1024, (128, 512)
# HBM bytes a second of one H100 SXM (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
# INT32 lanes of one SM of Hopper (the CUDA programming guide's throughput
# table: 64 results a clock for 32-bit integer add and min/max).
INT32_LANES_PER_SM = 64

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


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def reset_launches() -> None:
    wf.final_values.launches = 0
    bk.final_values.launches = 0
    hk.final_values.launches = 0
    sk.slab_sweep.launches = 0


def read_launches() -> dict:
    return {"wavefront": wf.final_values.launches,
            "blocked": bk.final_values.launches,
            "hetero": hk.final_values.launches,
            "slab": sk.slab_sweep.launches}


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    name_power = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    t0 = time.perf_counter()
    _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit(phase="device", nvidia_smi=name_power, sm_clock_max_mhz=clock_mhz,
         sms=sms, torch=torch.__version__, torch_cuda=torch.version.cuda,
         nvcc=[ln for ln in nvcc.splitlines() if "release" in ln][0],
         build_s=build_s, ptxas=ptxas)
    return {"smi": name_power, "int32_ops_per_s":
            sms * INT32_LANES_PER_SM * clock_mhz * 1e6}


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


def onehot(state: int) -> np.ndarray:
    v = np.full(NUM_MATRICES, NEG, np.int32)
    v[state] = 0
    return v


def _diff(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.long() - want.long()).abs().max())


def slab_case(rng, shape, block_shape, name, variant, tiled_ref=True):
    """K5 against the torch engine (the assembled slab, and the final vector
    of a forward variant) and, if asked, against slab_ref (every capture
    entry, halo included, and the final vector) on one input; returns the
    largest difference."""
    scoring, _, nsym = SLAB_VARIANTS[name]
    a, b, c = (x.astype(np.int32) for x in triplet(rng, shape, nsym))
    la, lb, lc = shape
    ev = onehot(int(rng.integers(0, NUM_MATRICES)))
    if variant == "bwd":
        # The kernel sweeps reversed inputs; the engine reverses itself.
        a, b, c = (x[::-1].copy() for x in (a, b, c))
    dims = sk._plan(la, lb, lc, block_shape)
    arrs = sk.prep_blocked(a, b, c, dims, CUDA)
    f_k, cap_k = sk.slab_sweep(*arrs, la, lb, lc, dims, variant, ev, scoring)
    slab_k = sk._assemble(cap_k, dims, lb, lc)
    what = f"K5 {shape} {block_shape} {name} {variant}"
    pairs = []
    if tiled_ref:
        f_r, cap_r = sk.slab_ref(*arrs, la, lb, lc, dims, variant, ev, scoring)
        pairs.append((cap_k, cap_r, "slab_ref capture"))
        if variant != "bwd":
            pairs.append((f_k, f_r, "slab_ref final"))
    if variant == "bwd":
        g = torch_engine.backward_slab_torch_async(
            a[::-1].copy(), b[::-1].copy(), c[::-1].copy(), scoring,
            end_v=ev, device=CUDA)()
        pairs.append((slab_k, torch.from_numpy(g).to(CUDA).flip(1, 2),
                      "engine slab"))
    else:
        f_e, s_e = torch_engine.forward_sweep_torch_async(
            a, b, c, scoring, mode=variant,
            v0=ev if variant == "pin" else None, capture_m=la, device=CUDA)()
        pairs += [(slab_k, torch.from_numpy(s_e).to(CUDA), "engine slab"),
                  (f_k, torch.from_numpy(f_e).to(CUDA), "engine final")]
    err = 0
    for got, want, against in pairs:
        require(got.shape == want.shape and torch.equal(got, want),
                f"{what}: kernel != {against}")
        err = max(err, _diff(got, want))
    return err


def phase_slab(rng) -> int:
    # Multi-tile and ragged (9 x 17 and 17 x 9 tiles over lengths that are
    # no multiple of the tile), a single tile, and the default tile plane.
    shapes = [((12, 20, 30), (9, 17)), ((7, 8, 9), (9, 17)),
              ((15, 40, 33), (17, 9)), ((40, 100, 70), None)]
    checked, err = [], 0
    for name in ("default", "rtl", "nondefault", "sub4", "sub16"):
        for shape, block in shapes:
            for variant in sk.VARIANTS:
                err = max(err, slab_case(rng, shape, block, name, variant))
            checked.append(f"{shape}/{block}/{name}")
    emit(phase="slab", cases=checked, variants=list(sk.VARIANTS),
         max_abs_err=err)
    return err


def hetero_case(trips, scoring, block):
    """K4 against hetero_ref on one dispatch, exactly; the largest
    difference."""
    batch = hk.prep_hetero(trips, *block, CUDA)
    got = hk.final_values(batch, scoring)
    want = hk.hetero_ref(batch, scoring)
    require(torch.equal(got, want), f"K4 {[list(map(len, t)) for t in trips]}"
            f" {block}: kernel {cpu_ints(got)} != hetero_ref {cpu_ints(want)}")
    return _diff(got, want)


def phase_hetero(rng) -> int:
    # Different |A|, tile counts and final cells, ragged against the tile,
    # a 1 x 1-tile problem and an empty sequence.
    lens = [(20, 30, 12), (3, 5, 4), (0, 4, 3), (7, 17, 40), (25, 9, 9),
            (1, 1, 1), (60, 70, 50), (33, 32, 33)]
    checked, err = [], 0
    for name in ("default", "rtl", "nondefault", "sub4"):
        scoring, _, nsym = VARIANTS[name]
        trips = [triplet(rng, n, nsym) for n in lens]
        for block in ((9, 17), bk.choose_block_shape(0, 0, 0)):
            err = max(err, hetero_case(trips, scoring, block))
            checked.append(f"{len(trips)} problems/{block}/{name}")
        # One batch cut into dispatches by a small face budget: each
        # dispatch against hetero_ref, and the scores of align_hetero.
        block = (9, 17)
        budget = 2 * hk.face_bytes(60, 70, 50, *block)
        plan = hk.plan_dispatches(lens, *block, budget)
        require(len(plan) >= 2, f"one dispatch under budget {budget}")
        want = [0] * len(trips)
        for idx in plan:
            err = max(err, hetero_case([trips[i] for i in idx], scoring,
                                       block))
            batch = hk.prep_hetero([trips[i] for i in idx], *block, CUDA)
            for i, v in zip(idx, hk.hetero_ref(batch, scoring).max(dim=1)
                            .values.tolist()):
                want[i] = v
        got = hk.align_hetero(trips, scoring, CUDA, block,
                              budget_bytes=budget)
        require(got == want, f"K4 {name} in {len(plan)} dispatches: {got} "
                f"!= {want}")
        checked.append(f"{len(plan)} dispatches/{block}/{name}")
    emit(phase="hetero", cases=checked, max_abs_err=err)
    return err


def phase_main_path(rng) -> dict:
    reset_launches()
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
    launches = read_launches()
    require(launches["wavefront"] and launches["blocked"],
            f"a kernel did not launch: {launches}")
    emit(phase="main_path", runs=runs, launches=launches)
    return launches


class _Spy:
    """Counts the calls of a module function (by ``mode`` where given) while
    installed; the function itself runs unchanged."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = {}

    def __enter__(self):
        def spy(*args, **kwargs):
            mode = kwargs.get("mode", "free")
            self.calls[mode] = self.calls.get(mode, 0) + 1
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def traceback_case(a, b, c, label, native):
    """One align(return_alignment=True) on the card, checked; its record."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = read_launches()
    with _Spy(direct, "direct_traceback") as dspy, \
            _Spy(sk, "split_point_blocked_async") as sspy:
        r = trialign_torch.align(a, b, c, return_alignment=True)
        torch.cuda.synchronize()
    after = read_launches()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: after[k] - before[k] for k in after}
    score_path = trialign_torch.align(a, b, c)
    require(r.backend == "hirschberg", f"{label}: backend {r.backend}")
    require(r.score == score_path.score,
            f"{label}: traceback {r.score} != score path "
            f"({score_path.backend}) {score_path.score}")
    rescored = rescore_alignment(r.alignment)
    require(rescored == r.score, f"{label}: rescored {rescored} != {r.score}")
    for row, seq in zip(r.alignment, (a, b, c)):
        require([v for v in row if v != -1] == [int(x) for x in seq],
                f"{label}: a row without its gaps is not its input")
    rec = {"case": label, "score": r.score,
           "score_path": [score_path.backend, score_path.score],
           "columns": len(r.alignment[0]), "seconds": r.seconds,
           "max_memory_allocated": peak,
           "top_route": "split" if sspy.calls else "direct",
           "slab_split_nodes": sspy.calls,
           "direct_leaves": sum(dspy.calls.values()),
           "launches": launches}
    if native:
        t0 = time.perf_counter()
        want = score_native(a, b, c)
        rec["native"] = [want, time.perf_counter() - t0]
        require(r.score == want, f"{label}: {r.score} != native {want}")
    return rec


def phase_traceback(rng) -> int:
    """The slice's path; returns K5's launches in the run of the 2048^3 case,
    the one size whose default route reaches K5."""
    recs = []
    for n in (512, 1024, 2048):
        trip = triplet(rng, (n, n, n))
        reset_launches()
        rec = traceback_case(*trip, f"random {n}^3", native=n == 512)
        require(rec["top_route"] == ("split" if n == 2048 else "direct"),
                f"{n}^3 took route {rec['top_route']}")
        require(n < 2048 or rec["launches"]["slab"] > 0,
                f"K5 did not launch at 2048^3: {rec['launches']}")
        recs.append(rec)
    slab_launches = rec["launches"]["slab"]
    # Pin nodes on K5: the direct cap lowered to 16 Mi cells and the slab
    # kernel's to 8 Mi, so that the right half of the 768^3 split (a pin
    # node) splits again through K5.
    saved = hb.DIRECT_CELLS, hb.SLAB_KERNEL_CELLS
    hb.DIRECT_CELLS, hb.SLAB_KERNEL_CELLS = 16 << 20, 8 << 20
    try:
        rec = traceback_case(*triplet(rng, (768, 768, 768)),
                             "random 768^3, pin splits", native=False)
    finally:
        hb.DIRECT_CELLS, hb.SLAB_KERNEL_CELLS = saved
    require(rec["slab_split_nodes"].get("pin", 0) > 0,
            f"no pin node ran K5: {rec['slab_split_nodes']}")
    recs.append(rec)
    emit(phase="traceback", runs=recs, slab_launches_2048=slab_launches,
         slab_launches_pin_splits=rec["launches"]["slab"])
    return slab_launches


def batch_triplets(rng, n=BATCH_N, lens=BATCH_LENS):
    lo, hi = lens
    return [triplet(rng, rng.integers(lo, hi + 1, 3)) for _ in range(n)]


def batch_cells(trips) -> int:
    return sum(len(a) * len(b) * len(c) for a, b, c in trips)


def timed_batch(trips, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trialign_torch.align_batch(trips, **kwargs)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_batch(rng) -> tuple:
    """The slice's path: the 1024-triplet batch on K4.  Returns K4's
    launches in its first run and the batch, for the timings."""
    trips = batch_triplets(rng)
    cells = batch_cells(trips)
    reset_launches()
    res, first_s = timed_batch(trips)
    launches = read_launches()
    require(launches["hetero"] > 0 and not launches["wavefront"]
            and not launches["blocked"],
            f"the 1024-triplet batch did not take K4 alone: {launches}")
    scores = [r.score for r in res]
    runs_s = []
    for _ in range(3):
        again, sec = timed_batch(trips)
        require([r.score for r in again] == scores, "a rerun disagrees")
        runs_s.append(sec)
    best = min(runs_s)
    # The card's busy share: kernel seconds of one more call under
    # torch.profiler (CUDA activity only) over the best unprofiled call.
    prof = kernel_seconds(lambda: trialign_torch.align_batch(trips))

    sample = [int(i) for i in rng.choice(len(trips), 64, replace=False)]
    single = {}
    for i in sample:
        r = trialign_torch.align(*trips[i])
        require(r.score == scores[i], f"triplet {i} "
                f"{list(map(len, trips[i]))}: batch {scores[i]} != align() "
                f"({r.backend}) {r.score}")
        single[r.backend] = single.get(r.backend, 0) + 1
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        native = list(ex.map(lambda i: score_native(*trips[i]), sample[:8]))
    native_s = time.perf_counter() - t0
    require(native == [scores[i] for i in sample[:8]],
            f"batch {[scores[i] for i in sample[:8]]} != native {native}")

    # The padded route: fewer than 64 triplets, some past K2's caps.
    small = batch_triplets(rng, 48, (16, 320))
    reset_launches()
    res48, s48 = timed_batch(small)
    l48 = read_launches()
    n_long = sum(not wf.fits(*map(len, t)) for t in small)
    require(l48["wavefront"] == 1 and l48["blocked"] > 0
            and not l48["hetero"], f"48-triplet batch launches {l48}")
    want48 = [trialign_torch.align(*t).score for t in small]
    require([r.score for r in res48] == want48, "48-triplet batch != align()")

    tb = batch_triplets(rng, 16, (64, 200))
    res16, s16 = timed_batch(tb, return_alignment=True)
    for r, t in zip(res16, tb):
        require(rescore_alignment(r.alignment) == r.score,
                "a batch alignment does not rescore")
        for row, seq in zip(r.alignment, t):
            require([v for v in row if v != -1] == [int(x) for x in seq],
                    "a batch alignment row without gaps is not its input")
    want16 = [trialign_torch.align(*t).score for t in tb]
    require([r.score for r in res16] == want16, "batch alignments != align()")

    emit(phase="batch", triplets=len(trips), lengths=list(BATCH_LENS),
         cells=cells, first_s=first_s, runs_s=runs_s, best_s=best,
         gcups=cells / best / 1e9, triplets_per_s=len(trips) / best,
         launches=launches, **prof, busy_share=prof["kernel_s"] / best,
         checked_against_align=len(sample),
         align_backends=single, checked_against_native=len(native),
         native_s=native_s,
         padded={"triplets": len(small), "past_k2_caps": n_long,
                 "seconds": s48, "launches": l48},
         alignments={"triplets": len(tb), "seconds": s16,
                     "backends": sorted({r.backend for r in res16})})
    return launches["hetero"], trips


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


def time_slab(trips, variant):
    ev = np.zeros(NUM_MATRICES, np.int32)
    args = []
    for a, b, c in trips:
        la, lb, lc = len(a), len(b), len(c)
        dims = sk._plan(la, lb, lc)
        args.append((*sk.prep_blocked(a, b, c, dims, CUDA), la, lb, lc, dims,
                     variant, ev))
    return time_cuda_ms(sk.slab_sweep, args)


def time_engine(trips, variant):
    """The torch engine's sweep of the same work as K5 ``variant``."""
    if variant == "bwd":
        fn = lambda a, b, c: torch_engine.backward_slab_torch_async(  # noqa
            a, b, c, end_v=np.zeros(NUM_MATRICES, np.int32), device=CUDA)
    else:
        fn = lambda a, b, c: torch_engine.forward_sweep_torch_async(  # noqa
            a, b, c, capture_m=len(a), device=CUDA)
    return time_cuda_ms(fn, trips)


def hetero_dispatch(trips):
    """The K4 dispatch that align_batch gives a batch (rotated, the longest
    |A| first); the batch must fit one."""
    rot = [mosaic._rotate(t, DEFAULT) for t in trips]
    hb_, wc_ = bk.choose_block_shape(0, 0, 0)
    plan = hk.plan_dispatches([list(map(len, t)) for t in rot], hb_, wc_,
                              hk.default_budget(CUDA))
    require(len(plan) == 1, f"the batch took {len(plan)} dispatches")
    return hk.prep_hetero([rot[i] for i in plan[0]], hb_, wc_, CUDA)


def hetero_bound(trips, dev) -> tuple:
    """bound() of one K4 dispatch of ``trips``: each problem's three symbol
    vectors read once, its 7 final values written once."""
    nbytes = 4 * sum(len(a) + len(b) + len(c) + NUM_MATRICES
                     for a, b, c in trips)
    return bound(batch_cells(trips), nbytes, dev)


def time_hetero(rng, trips, dev) -> dict:
    """K4 and hetero_ref on one sample dispatch of the batch's problems (the
    one with the most cells, the one with the fewest and one at random), held
    equal and timed on that same dispatch; then K4 at the whole 1024-triplet
    batch (that batch and two more like it), the host's packing of its
    dispatch and its bound."""
    sizes = [len(a) * len(b) * len(c) for a, b, c in trips]
    pick = [int(np.argmax(sizes)), int(np.argmin(sizes))]
    pick.append(int(rng.choice([i for i in range(len(trips))
                                if i not in pick])))
    rot = [mosaic._rotate(trips[i], DEFAULT) for i in pick]
    sample = hk.prep_hetero(rot, *bk.choose_block_shape(0, 0, 0), CUDA)
    # The kernel is deterministic, so three trials of one dispatch.
    ms = time_cuda_ms(hk.final_values, [(sample,)] * 3)
    got = hk.final_values(sample)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = hk.hetero_ref(sample)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    require(torch.equal(got, want), f"K4 on the batch's problems "
            f"{[list(map(len, t)) for t in rot]}: kernel {cpu_ints(got)} != "
            f"hetero_ref {cpu_ints(want)}")
    cells = batch_cells(rot)
    bms, by = hetero_bound(rot, dev)

    batches = [trips] + [batch_triplets(rng) for _ in range(2)]
    t0 = time.perf_counter()
    inputs = [(hetero_dispatch(trips),)]
    prep_s = time.perf_counter() - t0
    inputs += [(hetero_dispatch(t),) for t in batches[1:]]
    batch_ms = time_cuda_ms(hk.final_values, inputs)
    batch_bms, batch_by = hetero_bound(trips, dev)
    return {"ms": ms, "gcups": gcups(cells, ms),
            "lengths": [list(map(len, t)) for t in rot], "cells": cells,
            "plain": "hetero_ref on the same dispatch, one run",
            "plain_ms": plain_ms, "plain_gcups": gcups(cells, plain_ms),
            "bound_ms": bms, "bound_by": by, "max_abs_err": _diff(got, want),
            "batch": {"ms": batch_ms, "gcups": gcups(batch_cells(trips),
                                                     batch_ms),
                      "triplets": len(trips), "cells": batch_cells(trips),
                      "host_prep_s": prep_s, "bound_ms": batch_bms,
                      "bound_by": batch_by}}


def phase_tuning(rng) -> None:
    trips = _inputs(rng, (255, 255, 255))
    k2 = {t: time_wavefront(trips, t) for t in (256, 512, 1024)}
    trips = _inputs(rng, (1024, 1024, 1024))
    k3 = {}
    for shape in ((17, 17), (33, 33), (33, 65)):
        for threads in (256, 512, 1024):
            k3[f"{shape[0]}x{shape[1]}/{threads}"] = time_blocked(
                trips, shape, threads)
    emit(phase="tuning", wavefront_255_ms_by_threads=k2,
         blocked_1024_ms_by_tile_threads=k3,
         chosen={"wavefront_threads": wf.THREADS,
                 "blocked_tile": bk.choose_block_shape(0, 0, 0),
                 "blocked_threads": bk.THREADS})


def bound(cells, nbytes, dev) -> tuple:
    """(least ms the card could take, "bytes" or "operations") for a sweep
    of ``cells`` cells at op_count(Scoring()) int32 operations a cell,
    moving ``nbytes``."""
    ops_ms = cells * op_count(DEFAULT) / dev["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_timings(rng, dev, batch) -> tuple:
    """The timing rows, and K5's largest difference from the torch engine at
    the split's shape; ``batch`` is the batch phase's 1024 triplets."""
    rows = {}
    for name, n in (("wavefront", 255), ("blocked", 512), ("blocked", 1024)):
        trips = _inputs(rng, (n, n, n))
        if name == "wavefront":
            ms = time_wavefront(trips)
        else:
            ms = time_blocked(trips, bk.choose_block_shape(n, n, n))
        plain_ms = time_plain(trips[:3])
        cells = n ** 3
        # Inputs read once (3 symbol vectors), the final vector written.
        bms, by = bound(cells, 4 * (3 * n + NUM_MATRICES + 1), dev)
        rows[f"{name}_{n}"] = {"ms": ms, "gcups": gcups(cells, ms),
                               "plain_ms": plain_ms,
                               "plain_gcups": gcups(cells, plain_ms),
                               "bound_ms": bms, "bound_by": by}
    la, lb, lc = SPLIT_SHAPE
    trips = _inputs(rng, SPLIT_SHAPE)
    dims = sk._plan(la, lb, lc)
    # Inputs read once; the capture (every tile's plane) and final written.
    nbytes = 4 * (la + lb + lc + dims.n_jb * dims.n_kb * NUM_MATRICES
                  * dims.hb * dims.wc + NUM_MATRICES)
    bms, by = bound(la * lb * lc, nbytes, dev)
    # K5 against the torch engine at the shape the 2048^3 traceback gives
    # it (slab_ref would take too long there): the slab and final vector of
    # "free", the slab of "bwd" with a pinned end state.
    split_err = max(slab_case(rng, SPLIT_SHAPE, None, "default", variant,
                              tiled_ref=False) for variant in ("free", "bwd"))
    for variant in ("free", "bwd"):
        ms = time_slab(trips, variant)
        plain_ms = time_engine(trips[:3], variant)
        rows[f"slab_{variant}_{la}x{lb}x{lc}"] = {
            "ms": ms, "gcups": gcups(la * lb * lc, ms),
            "plain": "torch engine", "plain_ms": plain_ms,
            "plain_gcups": gcups(la * lb * lc, plain_ms),
            "bound_ms": bms, "bound_by": by}
    rows["hetero_sample"] = time_hetero(rng, batch, dev)
    emit(phase="timings", **rows, slab_split_max_abs_err=split_err)
    return rows, split_err


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
    dev = phase_device()
    k2_err = phase_wavefront(rng)
    k3_err = phase_blocked(rng)
    k5_err = phase_slab(rng)
    k4_err = phase_hetero(rng)
    launches = phase_main_path(rng)
    launches["slab"] = phase_traceback(rng)
    launches["hetero"], batch = phase_batch(rng)
    phase_tuning(rng)
    rows, split_err = phase_timings(rng, dev, batch)
    k5_err = max(k5_err, split_err)
    k4 = rows["hetero_sample"]
    k4_err = max(k4_err, k4["max_abs_err"])
    require("jax" not in sys.modules and "trialign" not in sys.modules,
            "JAX or the JAX package was imported")
    split = "x".join(map(str, SPLIT_SHAPE))
    # K4's ms, plain_ms and bound_ms are of the sample dispatch (the plain
    # version would take hours on the whole batch); the whole batch's
    # kernel ms and bound stand beside them.
    kernels = [
        ("wavefront", "trialign/kernels/wavefront.py:112", k2_err,
         rows["wavefront_255"], {}),
        ("blocked", "trialign/kernels/blocked.py:225", k3_err,
         rows["blocked_1024"], {}),
        ("hetero", "trialign/kernels/blocked.py:963", k4_err, k4,
         {"cells": k4["cells"], "batch_ms": k4["batch"]["ms"],
          "batch_bound_ms": k4["batch"]["bound_ms"],
          "batch_cells": k4["batch"]["cells"]}),
        ("slab", "trialign/kernels/slab.py:74", k5_err,
         rows[f"slab_free_{split}"], {}),
    ]
    emit(kernels=[
        {"name": name, "route": "cuda",
         "source": f"trialign_torch/csrc/{name}.cu", "replaces": replaces,
         "launches": launches[name], "max_abs_err": err, "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": None, **extra}
        for name, replaces, err, row, extra in kernels
    ])
    print(dev["smi"], flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
