#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

Run from the root of the repository, on a machine with an NVIDIA H100 and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``trialign_torch/csrc`` (one ``nvcc``
per source, all at once) and prints one JSON line per phase:

1. ``device``: the card, its SM clock, the toolkit, the build time (and
   each source's nvcc, all started together), the registers and spills of
   every build of the register step (K2 to K5) and ptxas statistics;
2. ``wavefront``: K2 (one persistent launch over every problem's tiles on
   the register step) against its plain version (the torch sweep),
   exactly, all seven values: tiny, ragged and |A|-long shapes under five
   scorings and ``score_bits=12``, one launch over a batch of 3; then
   4096 x 255 x 255 and a padded batch of 40 triplets, one launch each;
   every table up to BLOSUM62's 24 symbols, sequences drawing codes past
   the table;
3. ``blocked``: K3 against its plain versions (the tiled ``blocked_ref`` and
   the torch sweep), exactly, a 16S-length triplet in ``rrna16s.score``'s
   regime (a word a tile, chunks of 6) among them;
4. ``slab``: K5 against its plain versions (the tiled ``slab_ref`` and the
   torch engine), exactly: the captured plane and the final vector of every
   variant, on multi-tile and ragged shapes and the default tile plane,
   under six scorings (a 16-symbol submatrix and BLOSUM62's 24 symbols
   among them);
5. ``schedule``: the persistent sweeps (one launch a sweep, tiles started
   by per-plane readiness) against their plain versions on the card,
   exactly, at the occupancy's grid and capped at 1 and 3 blocks: K3 at
   512^3 on 10 inputs and at 1024^3 and every slot of the 16 x 512^3 chain
   (all seven values against the torch sweep); K5 "free" and "bwd" on a
   multi-tile shape under seven scorings (capture and final vector against
   ``slab_ref``) and at the 2048^3 top split's shape (the assembled slab
   and final vector against the torch engine); K4 (one launch a dispatch)
   against ``hetero_ref``, the whole state, on ragged dispatches under two
   scorings at one sub-tile and at tiles cut into sub-tiles, and on 16 of
   the batch's kind (every problem's seven values against the torch sweep,
   every entry's progress word); the per-tile forms of K3 and K5 (one
   persistent launch a run): K3 at 1024^3 in quarters of the table and in
   the bands of 2 stripes against the torch sweep, K5 at the sharded
   1024^3 traceback's top split ("free" in quarters, "bwd" in bands)
   against the torch engine, and the whole state against ``blocked_ref``
   and ``slab_ref`` over the whole table on a small multi-tile shape (K3 in
   quarters and bands, K5 every variant under seven scorings in the bands
   of 3 stripes); K4's registers, spills and blocks an SM;
6. ``hetero``: K4 against its plain version ``hetero_ref``, exactly: the
   final vector of every problem of ragged batches (a 1 x 1-tile problem,
   an empty sequence, one batch cut into several dispatches) at 9 x 17
   tiles, the default tile plane and the planes K4 sweeps as sub-tiles
   (34 x 33, 34 x 65, 16 x 128), under five scorings (BLOSUM62 among
   them, codes 24 and 25 past it on the floor row);
7. ``direct``: the direct engine's two kernels (``traceback/direct.py``)
   against their plain versions, exactly: the choice-capture kernel against
   the torch sweep ``_choices`` (the final vector and every cuboid slot of
   the packed buffers, compared a chunk of planes at a time) and the walk
   kernel against ``walk_ref`` (steps and stop, from the best end state), on
   7 ragged shapes (a length of 1, an empty B or C, several tiles) under
   seven scorings (a 16- and a 24-symbol submatrix among them) in the modes
   "free", "free_jk" and "pin", then at 512^3 in every mode, at 1024^3 and on a "pin" leaf
   of the 2048^3 route, 512 x 1024 x 1024 (packed offsets past 2^31);
8. ``main_path``: ``trialign_torch.align`` with backend "auto" against the
   golden model (the ``dat`` triplet), the C++ oracle (64^3 and 512^3) and
   the torch sweep (1024^3, all seven values), with the kernels' launch
   counts (K3 once a sweep: 2);
9. ``traceback``: ``trialign_torch.align(..., return_alignment=True)`` at
   512^3 and 1024^3 (the direct engine), 2048^3 (K5 for the top split) and
   768^3 with lowered caps (K5 on pin nodes); each alignment rescores to the
   score path's score and holds the inputs; seconds, peak memory, the top
   node's route, K5's launches and the direct kernels' (one choice and one
   walk launch a direct node; those of the 2048^3 run go to the summary);
   a spy holds that the torch choice sweep never ran;
10. ``batch``: ``trialign_torch.align_batch`` on 1024 triplets with every
    length uniform in [128, 512] (K4, one launch; seconds, GCUPS and
    triplets/s, best of 3 after a warm-up; the card's busy share under
    ``torch.profiler``), 64 of its
    scores against ``align()`` and 8 against the C++ oracle; a 48-triplet
    batch (one K2 launch and K3) against ``align()``; 16 alignments that
    rescore exactly; then ``protfam_batch``: one batch of the benchmark's
    ``protfam.fambatch`` cell (512 family triplets of 200-600 residues
    under BLOSUM62) on K4 alone, one launch, every triplet routed there;
    64 of its scores against ``align()`` and 16, its largest triplet
    among them, against the C++ oracle;
11. ``vpu``: ``benchmarks.roofline()`` (K6's main path): the int32 and
    DPX rates beside the rate ``int32_peak_ops()`` assumes, with the SM
    clock read during the run.  The faster measured rate is the peak that
    every later bound divides by.  Then K6 against its plain version,
    exactly, in both op mixes, on a sample that must take at least its
    bound;
12. ``checkpoint``: K3's per-tile form against ``blocked_ref`` (the whole
    state, in runs of tiles that end mid-diagonal, under five scorings);
    the main path's 1024^3 triplet checkpointed a quarter of its grid at a
    time, stopped after two segments and resumed by a new aligner from the
    file, equal to ``main_path``'s score and, all seven final values, to
    the torch sweep, in 4 launches; ``align_resilient`` with one injected
    failure;
    ``align_batch_resilient`` on 256 of the batch's triplets in dispatches
    of 64 with a failure after the second drain (only the unscored 128
    dispatched again, scores equal to the batch's); the per-tile form's
    time on a 192^3 sample beside ``blocked_ref``'s;
13. ``chain``: K3's chain mode against ``blocked_ref`` on multi-tile shapes
    (9 x 17 and 33 x 33 tiles, 1 to 5 slots, five scorings, and
    ``score_bits=12``); then the bench's chains, 16 slots of 512^3 and 8 of
    1024^3 (ms per alignment, GCUPS, bound, launches): every slot's seven
    values equal the torch sweep of its triplet, two slots' scores equal
    ``align()`` and one the C++ oracle;
14. ``halo``: the halo (``dist/halo.py``) on stripes that share the card,
    each on its own CUDA stream, each in bands of tile rows, one launch a
    band: K3's per-tile form in 2 and 3 stripes with uneven columns, in the
    model's bands and in bands of 1 and 2 rows, against ``blocked_ref``
    (the whole state); the main path's 1024^3 triplet in 1, 2 and 4
    stripes under both schedules, all seven values equal to the torch
    sweep's, launches one a band a stripe; ms beside K3's whole-grid sweep;
    the measured face-copy rate and the model's time on separate cards;
15. ``halo_tb``: K5's per-tile form against ``slab_ref`` (capture and final
    vector) in runs that end mid-diagonal and in 2 and 3 stripes, every
    variant, default and 16-symbol scoring; ``hirschberg_align_sharded`` on
    the traceback phase's 1024^3 triplet in 2 stripes with two levels of
    splits on them, rescoring to the score path's score, one launch a band
    a stripe (seconds, split into the sweeps on the stripes and the rest);
    that run's top split (512 x 1024 x 1024, 2 stripes) against the torch
    engine, capture and final vector exactly, and timed beside it;
16. ``sharded_batch``: K4's per-tile form against ``hetero_ref`` in runs
    that end mid-diagonal under two scorings; ``align_batch_sharded`` on
    the 1024-triplet batch over 2 data slots sharing the card (one launch a
    slot), equal to the batch phase's scores;
    ``align_batch_resilient(mesh=...)`` in dispatches
    of 64 with a failure as a slot packs its second (the dispatches swept
    by then drain; only the rest is dispatched again);
17. ``cli``: ``python -m trialign_torch.cli`` in four subprocesses at once:
    ``selftest`` (every row OK), ``align --json`` on the bundled ``dat``
    files (equal to golden), ``bench --size 1024 --json`` (parity
    ``exact``; its time shares the card), ``batch --sharded`` on 70
    triplets (equal to ``align_batch``);
18. ``multihost``: two processes (``python -m trialign_torch.dist.worker``,
    ``gloo``) on the card, started with the cli phase's:
    ``align_batch_multihost``, a halo whose model axis spans both processes
    and the sharded traceback across them, each equal to this process's
    run of the same functions;
19. ``tuning``: K2 at 64^3, 255^3 and 4096 x 255 x 255 over two tile
    planes and three chunks (each held to the default), its registers and
    spills; the persistent K3 at 1024^3 over
    three tile planes of one sub-tile and three chunks; K5 "free" at the
    2048^3 top split's shape over the chunks; K4 on the batch over its
    chunks, and where its warps spend their cycles;
20. ``timings``: each kernel (minimum over distinct inputs after a
    warm-up) beside its plain version (one run) at the main path's
    sizes, and beside its bound; K2 at 64^3, 255^3 and 4096 x 255 x 255,
    beside K3 on the same triplets; K3 at 512^3, 1024^3 and 1536^3 (all
    seven values against the torch sweep), both bench chains; K5 against
    the torch engine, exactly, and timed: "free" and "bwd" at the shape
    the 2048^3 traceback gives it, "free", "free_jk" and "bwd" at a 16S
    triplet's top split (750 x 1500 x 1500); K4 and its per-tile form
    (one run, one diagonal a run, and runs of a quarter of the table)
    against hetero_ref, exactly and timed, on a dispatch of two of the
    1024-triplet batch's problems (its largest and its smallest), and both
    at the whole batch (16 of its problems' seven values against the torch
    sweep); K3's per-tile form at 1024^3 in quarters; the 1024^3 halo in
    2 stripes in bands of 1 to 32 rows, and in 4 stripes in bands of 16
    and 32 rows in turns; K3's whole grid, its
    quarters and the 2-stripe halo at 1024^3 with the grid capped at one
    block an SM, in turns with the occupancy's grid; the direct engine's
    choice kernel at 1024^3 beside its torch sweep, its walk kernel beside
    ``walk_ref``, and ``direct_traceback`` at 1024^3 in turns with the plain
    engine (kernels, plain, plain, kernels);
21. ``bench``: the port's bench parent (``python -m trialign_torch.bench``)
    under a budget of ``BENCH_BUDGET_S`` seconds, which leaves it the probe
    and the headline: it must exit 0 with ``blocked_1k`` exact against the
    C++ oracle on the measured 1024^3 triplet, K3 launched, and the card's
    name and power limit in its line; then the bench's own runner in this
    process: the probe, ``traceback_4k`` cut by a cap of ``BENCH_CUT_S``
    seconds (named in the next line) and the child stages
    ``parity_fixtures`` and ``single_stream_255``, whose lines still come,
    each exact and with its kernels launched.

Then a summary of the kernels, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any mismatch or error exits
non-zero before that line; without a CUDA device it exits 1 at once.  It
imports neither JAX nor the JAX package: the oracles are the port's copies.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

import trialign_torch
from benchmark import traffic
from trialign_torch import _build, api, bench, benchmarks, resilience
from trialign_torch.benchmarks import gcups, time_cuda_ms
from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.dist import halo as dh
from trialign_torch.dist import halo_tb
from trialign_torch.dist import mesh as dmesh
from trialign_torch.golden import align_planes_numpy, rescore_alignment
from trialign_torch.io import load_reference_triplet
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import hetero as hk
from trialign_torch.kernels import mosaic
from trialign_torch.kernels import ref
from trialign_torch.kernels import slab as sk
from trialign_torch.kernels import vpu
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
# The reference's largest table, which K5's phases hold besides.
SUB16 = Scoring(submatrix=tuple(
    tuple(int(v) for v in row)
    for row in np.random.default_rng(16).integers(-4, 6, (16, 16))))
ROOT = os.path.dirname(os.path.abspath(__file__))


def bench_file(*parts) -> dict:
    """A JSON file of the benchmark (``benchmark/<parts>``)."""
    with open(os.path.join(ROOT, "benchmark", *parts)) as f:
        return json.load(f)


# The benchmark's protein configuration: NCBI BLOSUM62, 24 symbols, the
# largest table every kernel takes, with BLASTP's gaps.
PROTFAM = bench_file("configs", "protfam.json")
BLOSUM62 = Scoring(
    gap_open=PROTFAM["scoring"]["gap_open"],
    gap_extend=PROTFAM["scoring"]["gap_extend"],
    submatrix=tuple(map(tuple, PROTFAM["scoring"]["submatrix"])))
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
    "blosum62": (BLOSUM62, 0, 26),
}
SLAB_VARIANTS = {**VARIANTS, "sub16": (SUB16, 0, 18)}

# The shape of K5's sweeps at the 2048^3 traceback's top split, and of its
# per-tile form's at the sharded 1024^3 traceback's.
SPLIT_SHAPE = (1024, 2048, 2048)
TOP_SPLIT = (512, 1024, 1024)
# The shape of K5's sweeps at a 16S rRNA triplet's top split (the
# benchmark's rrna16s.align: ~1500^3, split at |A| / 2).
SPLIT_16S = (750, 1500, 1500)
# The repo's throughput workload (trialign/benchmarks.py bench_batch_mixed,
# BASELINE config 3): 1024 triplets, each length uniform in [128, 512].
BATCH_N, BATCH_LENS = 1024, (128, 512)
# Samples on which the plain versions of K3's per-tile form and chain mode
# finish in seconds: an n^3 problem, and npack slots of n^3.
TILES_SAMPLE = 192
CHAIN_SAMPLE = (128, 4)
# The bench's chains (bench.py stages chain_512 and chain_1k): (n, slots).
CHAIN_BENCH = ((512, 16), (1024, 8))
# The sizes at which K3's whole grid is timed.
K3_TIMED = (512, 1024, 1536)
# HBM bytes a second of one H100 SXM (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
# The bench phase: the parent's budget (the probe and the headline take
# about 40 s on an H100, after which less than the 75 s the bench needs
# to start a stage is left), and the cap that cuts traceback_4k (18 s on an
# H100: about 7 s to start, then a first run, two timed runs and the score
# path).
BENCH_BUDGET_S, BENCH_CUT_S = 100, 10.0

CUDA = torch.device("cuda")
ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def emit(**fields) -> None:
    """One JSON line; a phase's line also gives the seconds since start."""
    if "phase" in fields:
        fields["t_s"] = time.perf_counter() - T0
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


def plain_sweep(a, b, c) -> torch.Tensor:
    """The seven final values of one triplet from the plain torch sweep
    (ref.sweep), on the card."""
    la, lb, lc = len(a), len(b), len(c)
    return ref.sweep(ref.extend(a, la + 1, ref.PAD_A, CUDA),
                     ref.extend(b, lb + 1, ref.PAD_B, CUDA),
                     ref.extend(c, lc + 1, ref.PAD_C, CUDA), la, lb, lc)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


# Each kernel entry point's launch counter, by the name the summary gives it.
COUNTERS = {"wavefront": wf.final_values,
            "blocked": bk.final_values,
            "blocked_tiles": bk.sweep_tiles, "blocked_chain": bk.chain_values,
            "hetero": hk.final_values, "hetero_tiles": hk.sweep_tiles,
            "slab": sk.slab_sweep, "slab_tiles": sk.sweep_tiles,
            "vpu": vpu.vpu_chains,
            "direct_choices": sk.choice_sweep, "direct_walk": direct.walk}


def reset_launches() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
        if hasattr(fn, "cells"):
            fn.cells = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


# ---------------------------------------------------------------- phases


def step_signatures() -> dict:
    """Registers, spill bytes, threads, shared bytes and blocks an SM of
    every build of the register step: K2 and K3 by scoring mode (and K3's
    progress words and chain mode), K4 by scoring, K5 by scoring and
    variant."""
    modes = {"default": DEFAULT, "rtl": RTL, "sub": SUB4}
    d3, dchain = bk.plan_dims(64, 64, 64), bk.plan_dims_packed(8, 64, 64, 2)
    d5 = sk._plan(64, 64, 64)
    out = {}
    for name, sc in modes.items():
        for bits in (0, 12):
            out[f"k2/{name}/bits{bits}"] = wf.step_resources(
                scoring=sc, score_bits=bits)
            for sw in (False, True):
                out[f"k3/{name}/bits{bits}/sw{int(sw)}"] = bk.step_resources(
                    d3, sc, bits, strip_words=sw)
            out[f"k3chain/{name}/bits{bits}"] = bk.step_resources(
                dchain, sc, bits)
        out[f"k4/{name}"] = hk.step_resources(33, 33, sc)
        for variant in sk.VARIANTS:
            out[f"k5/{name}/{variant}"] = sk.step_resources(d5, sc, variant)
    return out


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
         build_s=build_s, nvcc_s=_build.nvcc_seconds,
         step_signatures=step_signatures(),
         ptxas=ptxas)
    # The vpu phase adds "int32_ops_per_s", the rate every bound uses.
    return {"smi": name_power}


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
    cases += [((64, 64, 64), v)
              for v in ("rtl", "nondefault", "sub4", "sub8", "blosum62")]
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
    before = wf.final_values.launches
    got = wf.final_values(*arrs, lens)
    require(wf.final_values.launches == before + 1, "K2 batch: not 1 launch")
    for p, t in enumerate(trips):
        want = ref.sweep(arrs[0][p], arrs[1][p], arrs[2][p], *lens[p])
        require(cpu_ints(got[p]) == cpu_ints(want), f"K2 batch item {p}")
    checked.append("batch of 3")

    # The longest |A| at the widest plane, and a padded batch of 40, each
    # in one launch: every problem's seven values against the torch sweep
    # on the card.
    for what, (a, b, c, lens) in (
            ("(4096, 255, 255)", wf.prep(*triplet(rng, (4096, 255, 255)),
                                         CUDA)),
            ("padded batch of 40", padded_args(padded_triplets(rng, 40)))):
        before = wf.final_values.launches
        got = wf.final_values(a, b, c, lens)
        require(wf.final_values.launches == before + 1, f"K2 {what}: not 1 "
                "launch")
        for p, dims in enumerate(np.asarray(lens).tolist()):
            want = ref.sweep(a[p], b[p], c[p], *dims) if min(dims) else \
                torch.zeros(NUM_MATRICES, dtype=torch.int32, device=CUDA)
            err = max(err, _diff(got[p], want))
            require(torch.equal(got[p], want), f"K2 {what} item {p}: "
                    f"{cpu_ints(got[p])} != torch sweep {cpu_ints(want)}")
        checked.append(f"{what}/torch sweep")
    emit(phase="wavefront", cases=checked, max_abs_err=err)
    return err


def padded_triplets(rng, n):
    """n triplets for one K2 launch: |A| uniform in [1, 600], |B| and |C|
    in [1, 255]."""
    return [triplet(rng, (rng.integers(1, 601), *rng.integers(1, 256, 2)))
            for _ in range(n)]


def padded_args(trips):
    """K2's inputs for a padded batch, as align_batch makes them."""
    from trialign_torch.dist.batch import prep_padded

    return prep_padded(trips, CUDA)


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
    small = [((10, 40, 50), (17, 33), "default"),
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
    # rrna16s.score's regime: a 16S-length triplet at the default plane,
    # past RAMP_WAVES waves (a word a tile, chunks of 6), all seven values
    # against the torch sweep (about 15 s).
    shape = (1531, 1547, 1462)
    dims = bk.plan_dims(*shape)
    plan = bk.schedule(dims, bk.n_tiles(dims), bk.resident_blocks(dims))
    require(plan == bk.Schedule(False, 6),
            f"K3 at {shape}: schedule {plan}, not rrna16s.score's")
    _, e = blocked_case(*triplet(rng, shape), DEFAULT, 0, default_shape,
                        False)
    err = max(err, e)
    checked.append(f"{shape}/{default_shape}/default/{plan}")

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


def engine_k5(a, b, c, variant, ev, scoring):
    """The torch engine's (final vector, or None for "bwd"; slab; device
    ms) of K5's sweep of (a, b, c) as the kernel takes them (reversed for
    "bwd"), on the card, in the kernel's orientation."""
    if variant == "bwd":
        ms, fin = event_ms(functools.partial(
            torch_engine.backward_slab_torch_async, a[::-1].copy(),
            b[::-1].copy(), c[::-1].copy(), scoring, end_v=ev, device=CUDA))
        return None, torch.from_numpy(fin()).to(CUDA).flip(1, 2), ms
    ms, fin = event_ms(functools.partial(
        torch_engine.forward_sweep_torch_async, a, b, c, scoring,
        mode=variant, v0=ev if variant == "pin" else None,
        capture_m=len(a), device=CUDA))
    f_e, s_e = fin()
    return torch.from_numpy(f_e).to(CUDA), torch.from_numpy(s_e).to(CUDA), ms


def slab_case(rng, shape, block_shape, name, variant, tiled_ref=True):
    """K5 against the torch engine (the assembled slab, and the final vector
    of a forward variant) and, if asked, against slab_ref (every capture
    entry, halo included, and the final vector) on one input; returns the
    largest difference and the engine's device milliseconds."""
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
    f_e, slab_e, engine_ms = engine_k5(a, b, c, variant, ev, scoring)
    pairs.append((slab_k, slab_e, "engine slab"))
    if f_e is not None:
        pairs.append((f_k, f_e, "engine final"))
    err = 0
    for got, want, against in pairs:
        require(got.shape == want.shape and torch.equal(got, want),
                f"{what}: kernel != {against}")
        err = max(err, _diff(got, want))
    return err, engine_ms


def phase_slab(rng) -> int:
    # Multi-tile and ragged (9 x 17 and 17 x 9 tiles over lengths that are
    # no multiple of the tile), a single tile, and the default tile plane.
    shapes = [((12, 20, 30), (9, 17)), ((7, 8, 9), (9, 17)),
              ((15, 40, 33), (17, 9)), ((40, 100, 70), None)]
    checked, err = [], 0
    for name in ("default", "rtl", "nondefault", "sub4", "sub16", "blosum62"):
        for shape, block in shapes:
            for variant in sk.VARIANTS:
                err = max(err, slab_case(rng, shape, block, name, variant)[0])
            checked.append(f"{shape}/{block}/{name}")
    emit(phase="slab", cases=checked, variants=list(sk.VARIANTS),
         max_abs_err=err)
    return err


# The grid caps the schedule phase runs beside the occupancy's grid: one
# block sweeps the table alone, three interleave few tiles.
GRID_CAPS = (None, 1, 3)


def schedule_k3(what, arrs, lens, dims, want, **kwargs) -> int:
    """The persistent K3 (final_values, or chain_values for chain dims) at
    every grid cap against ``want``, the torch sweep's values; the largest
    difference."""
    fn = bk.chain_values if dims.d else bk.final_values
    err = 0
    for blocks in GRID_CAPS:
        got = fn(*arrs, *lens, dims, blocks=blocks, **kwargs)
        require(torch.equal(got, want), f"K3 persistent {what} blocks="
                f"{blocks}: {cpu_ints(got)} != torch sweep {cpu_ints(want)}")
        err = max(err, _diff(got, want))
    return err


def table_quarters(dims):
    """The tile table in four runs (most end mid-diagonal)."""
    n = bk.n_tiles(dims)
    q = -(-n // 4)
    return [bk.table_run(dims, i, min(q, n - i)) for i in range(0, n, q)]


def stripe_bands(dims, band, ndev):
    """Each stripe's bands of ``band`` tile rows, band by band, as
    dist/halo.py run_stripes launches them (here on one state)."""
    runs = [bk.rect_tiles(rows, cols) for rows in dh.bands(dims.n_jb, band)
            for cols in dh.stripe_columns(dims.n_kb, ndev)]
    return [r for r in runs if r]


def schedule_runs(what, form, sweep, fresh, check, runs) -> int:
    """A per-tile form (``form``: bk or sk) over ``runs`` (lists of tiles),
    one launch a run, at every grid cap: ``sweep(state, tiles, blocks)`` on
    ``fresh()``, then each (got, want, name) of ``check(state)`` equal; the
    largest difference."""
    err = 0
    for blocks in GRID_CAPS:
        state = fresh()
        before = form.sweep_tiles.launches
        for tiles in runs:
            sweep(state, tiles, blocks)
        require(form.sweep_tiles.launches == before + len(runs),
                f"{what}: {form.sweep_tiles.launches - before} launches for "
                f"{len(runs)} runs")
        for g, w, field in check(state):
            require(g.shape == w.shape and torch.equal(g, w),
                    f"{what} blocks={blocks}: {field} != the plain version's")
            err = max(err, _diff(g, w))
    return err


def schedule_tiles_k3(what, trip, runs, tiled_ref=True) -> int:
    """K3's per-tile form in each of ``runs`` (name -> the runs of a dims),
    at every grid cap: with ``tiled_ref`` the whole state (faces and output)
    against one blocked_ref over the whole table, else (where blocked_ref
    would take minutes) the seven values against the torch sweep."""
    lens = tuple(map(len, trip))
    dims = bk.plan_dims(*lens)
    arrs = bk.prep_blocked(*trip, dims, CUDA)
    if tiled_ref:
        want = bk.new_state(dims, CUDA)
        bk.blocked_ref(*arrs, *lens, dims, state=want)

        def check(state):
            return zip(state, want, want._fields)
    else:
        out = ref.sweep(*arrs, *lens).view(1, -1)

        def check(state):
            return [(state.out, out, "out (torch sweep)")]
    return max(schedule_runs(f"K3 per tile {what} in {name}", bk,
                             lambda st, tiles, blocks: bk.sweep_run(
                                 *arrs, *lens, dims, st, tiles,
                                 blocks=blocks),
                             lambda: bk.new_state(dims, CUDA), check,
                             runs_of(dims))
               for name, runs_of in runs.items())


def schedule_k5(rng, shape, name, variant, runs, tiled_ref=True) -> tuple:
    """K5 at every grid cap, the persistent whole-grid sweep and its
    per-tile form in each of ``runs`` (name -> the runs of a dims): with
    ``tiled_ref`` the whole state (capture, faces, final vector) against one
    slab_ref over the whole table, else (where slab_ref would take a minute
    or more) the assembled slab and a forward variant's final vector
    against the torch engine.  The largest difference of each."""
    scoring, _, nsym = SLAB_VARIANTS[name]
    seqs = tuple(x.astype(np.int32) for x in triplet(rng, shape, nsym))
    ev = onehot(int(rng.integers(0, NUM_MATRICES)))
    dims = sk._plan(*shape)
    arrs = sk.prep_blocked(*seqs, dims, CUDA)
    def fresh():
        return sk.new_state(*shape, dims, ev, CUDA)

    if tiled_ref:
        want = fresh()
        sk.slab_ref(*arrs, *shape, dims, variant, None, scoring, state=want)

        def values(out, cap):
            return [(cap, want.cap, "capture"), (out, want.out, "final")]

        def check(state):
            return zip(state, want, want._fields)
    else:
        f_w, slab_w, _ = engine_k5(*seqs, variant, ev, scoring)

        def values(out, cap):
            pairs = [(sk._assemble(cap, dims, *shape[1:]), slab_w, "slab")]
            return pairs + ([(out, f_w, "final")] if f_w is not None else [])

        def check(state):
            return values(state.out, state.cap)
    what = f"K5 {shape} {name} {variant}"
    whole = 0
    for blocks in GRID_CAPS:
        out, cap = sk.slab_sweep(*arrs, *shape, dims, variant, ev, scoring,
                                 blocks=blocks)
        for g, w, field in values(out, cap):
            require(g.shape == w.shape and torch.equal(g, w),
                    f"{what} persistent blocks={blocks}: {field} != the "
                    "plain version's")
            whole = max(whole, _diff(g, w))
    tiles = max([schedule_runs(
        f"{what} per tile in {how}", sk,
        lambda st, tiles, blocks: sk.sweep_run(*arrs, *shape, dims, variant,
                                               st, tiles, scoring,
                                               blocks=blocks),
        fresh, check, runs_of(dims)) for how, runs_of in runs.items()],
                default=0)
    return whole, tiles


def schedule_k4(what, trips, block, scoring=DEFAULT) -> int:
    """The persistent K4 (one launch a dispatch) at every grid cap against
    hetero_ref: faces, final values and progress words bit for bit; the
    largest difference."""
    batch = hk.prep_hetero(trips, *block, CUDA)
    n = len(batch.tiles)
    want = hk.new_state(batch)
    hk.hetero_ref(batch, scoring, want)
    err = 0
    for blocks in GRID_CAPS:
        got = hk.sweep_tiles(batch, hk.new_state(batch), 0, n, scoring,
                             blocks=blocks)
        for g, w, field in zip(got, want, want._fields):
            require(torch.equal(g, w), f"K4 persistent {what} {block} "
                    f"blocks={blocks}: {field} != hetero_ref's")
            err = max(err, _diff(g, w))
    return err


def schedule_k4_sweep(what, trips, block) -> int:
    """schedule_k4 where hetero_ref would take minutes: every problem's
    seven values against the torch sweep, and every entry's progress word
    its tile's last local plane, as hetero_ref leaves it; the largest
    difference."""
    batch = hk.prep_hetero(trips, *block, CUDA)
    n = len(batch.tiles)
    want = torch.stack([plain_sweep(*t) for t in trips])
    # A tile's last local plane: |A| + tb + tc of its problem.
    last = np.asarray(batch.lens)[:, 0] + batch.hb + batch.wc - 2
    done = torch.from_numpy(last[np.asarray(batch.tiles)[:, 0]].astype(
        np.int32)).to(CUDA)
    err = 0
    for blocks in GRID_CAPS:
        got = hk.sweep_tiles(batch, hk.new_state(batch), 0, n, blocks=blocks)
        for g, w, field in ((got.out, want, "out"), (got.done[:n], done,
                                                      "done")):
            require(torch.equal(g, w), f"K4 persistent {what} {block} "
                    f"blocks={blocks}: {field} != the torch sweep's")
            err = max(err, _diff(g, w))
    return err


def chain_sweep(a_list, b, c) -> torch.Tensor:
    """The torch sweep of every slot of a chain of equal-length triplets
    (a, b, c) for a in a_list, (npack, 7), on the card."""
    n = len(a_list[0])
    return ref.sweep(torch.stack([ref.extend(a, n + 1, ref.PAD_A, CUDA)
                                  for a in a_list]),
                     ref.extend(b, len(b) + 1, ref.PAD_B, CUDA),
                     ref.extend(c, len(c) + 1, ref.PAD_C, CUDA), n, len(b),
                     len(c))


def phase_schedule(rng) -> dict:
    """The persistent sweeps (one launch a sweep, tiles started by per-plane
    readiness) against their plain versions on the card, at the occupancy's
    grid and capped at 1 and 3 blocks: K3 at 512^3 on 10 inputs (races are
    intermittent) and at 1024^3 and every slot of the 16 x 512^3 chain
    against the torch sweep; K5 "free" and "bwd" at the 2048^3 top split's
    shape against the torch engine, and every variant under seven scorings
    on a small multi-tile shape against slab_ref; the per-tile forms of K3
    and K5 in runs, at the main path's shapes against the torch sweep and
    engine and on a small shape the whole state against blocked_ref and
    slab_ref; K4 against hetero_ref, and on 16 of the batch's kind against
    the torch sweep.  Returns the largest difference of each."""
    checked, err = [], {"blocked": 0, "blocked_chain": 0, "slab": 0,
                        "hetero": 0, "blocked_tiles": 0, "slab_tiles": 0}
    for n, count in ((512, 10), (1024, 1)):
        dims = bk.plan_dims(n, n, n)
        for _ in range(count):
            arrs = bk.prep_blocked(*triplet(rng, (n, n, n)), dims, CUDA)
            want = ref.sweep(*arrs, n, n, n)
            err["blocked"] = max(err["blocked"], schedule_k3(
                f"{n}^3", arrs, (n, n, n), dims, want))
        checked.append(f"K3 {n}^3 x{count}")
    n, npack = CHAIN_BENCH[0]
    a_list = [triplet(rng, (n,))[0] for _ in range(npack)]
    b, c = triplet(rng, (n, n))
    chain_dims = bk.plan_dims_packed(n, n, n, npack)
    arrs = bk.prep_chain(a_list, b, c, chain_dims, CUDA)
    err["blocked_chain"] = schedule_k3(
        f"chain {n}^3 x{npack}", arrs, (n, n, n), chain_dims,
        chain_sweep(a_list, b, c))
    checked.append(f"K3 chain {n}^3 x{npack}, every slot")
    for variant in ("free", "bwd"):
        err["slab"] = max(err["slab"], schedule_k5(
            rng, SPLIT_SHAPE, "default", variant, {}, tiled_ref=False)[0])
    checked.append(f"K5 {SPLIT_SHAPE} free, bwd/default/torch engine")
    # The per-tile forms, one persistent launch a run, in quarters of the
    # table and in the bands of stripes: at the main path's shapes against
    # the torch sweep and engine (blocked_ref takes about 110 s at 1024^3,
    # slab_ref about 60 s at the top split), and the whole state against
    # blocked_ref and slab_ref on a small multi-tile shape.
    quarters_and_bands = {"quarters": table_quarters,
                          "bands of 8, 2 stripes":
                              lambda d: stripe_bands(d, 8, 2)}
    n = 1024
    err["blocked_tiles"] = schedule_tiles_k3(
        f"{n}^3", triplet(rng, (n, n, n)), quarters_and_bands,
        tiled_ref=False)
    checked.append(f"K3 per tile {n}^3 in quarters and bands of 8, 2 "
                   "stripes/torch sweep")
    small = {"quarters": table_quarters,
             "bands of 2, 3 stripes": lambda d: stripe_bands(d, 2, 3)}
    err["blocked_tiles"] = max(err["blocked_tiles"], schedule_tiles_k3(
        "(60, 200, 170)", triplet(rng, (60, 200, 170)), small))
    checked.append("K3 per tile (60, 200, 170) in quarters and bands of 2, "
                   "3 stripes/blocked_ref")
    for variant, runs in (("free", "quarters"),
                          ("bwd", "bands of 8, 2 stripes")):
        e_whole, e_tiles = schedule_k5(rng, TOP_SPLIT, "default", variant,
                                       {runs: quarters_and_bands[runs]},
                                       tiled_ref=False)
        err["slab"] = max(err["slab"], e_whole)
        err["slab_tiles"] = max(err["slab_tiles"], e_tiles)
        checked.append(f"K5 {TOP_SPLIT} {variant}, per tile in {runs}/"
                       "torch engine")
    for name in SLAB_VARIANTS:
        for variant in sk.VARIANTS:
            e_whole, e_tiles = schedule_k5(
                rng, (60, 200, 170), name, variant,
                {"bands of 2, 3 stripes": small["bands of 2, 3 stripes"]})
            err["slab"] = max(err["slab"], e_whole)
            err["slab_tiles"] = max(err["slab_tiles"], e_tiles)
        checked.append(f"K5 (60, 200, 170) every variant/{name}, per tile "
                       "in bands of 2, 3 stripes")
    for name in ("default", "sub4"):
        scoring, _, nsym = VARIANTS[name]
        trips = [triplet(rng, n, nsym) for n in HETERO_LENS]
        for block in ((9, 17), bk.choose_block_shape(0, 0, 0), (34, 65)):
            err["hetero"] = max(err["hetero"], schedule_k4(
                name, trips, block, scoring))
            checked.append(f"K4 {len(trips)} problems/{block}/{name}")
    trips = [mosaic._rotate(t, DEFAULT) for t in batch_triplets(rng, 16)]
    err["hetero"] = max(err["hetero"], schedule_k4_sweep(
        "16 of the batch's kind", trips, bk.choose_block_shape(0, 0, 0)))
    checked.append("K4 16 triplets in [128, 512]/default plane/torch sweep")
    hb_, wc_ = bk.choose_block_shape(0, 0, 0)
    emit(phase="schedule", cases=checked, grid_caps=GRID_CAPS,
         blocks_per_sm={
             "blocked": bk.blocks_per_sm(bk.plan_dims(1024, 1024, 1024)),
             "blocked_chain": bk.blocks_per_sm(chain_dims),
             "slab": sk.blocks_per_sm(sk._plan(*SPLIT_SHAPE)),
             "hetero": hk.step_resources(hb_, wc_)["blocks_per_sm"]},
         hetero_resources=hk.step_resources(hb_, wc_),
         sms=torch.cuda.get_device_properties(0).multi_processor_count,
         chunk=bk.CHUNK, max_abs_err=err)
    return err


def hetero_case(trips, scoring, block):
    """K4 against hetero_ref on one dispatch, exactly; the largest
    difference and hetero_ref's scores."""
    batch = hk.prep_hetero(trips, *block, CUDA)
    got = hk.final_values(batch, scoring)
    want = hk.hetero_ref(batch, scoring)
    require(torch.equal(got, want), f"K4 {[list(map(len, t)) for t in trips]}"
            f" {block}: kernel {cpu_ints(got)} != hetero_ref {cpu_ints(want)}")
    return _diff(got, want), want.max(dim=1).values.tolist()


# K4's ragged dispatch: different |A|, tile counts and final cells, ragged
# against the tile, a 1 x 1-tile problem and an empty sequence.  Its tile
# planes past one sub-tile of the register step: two rows of sub-tiles (the
# second one row), 2 x 2, and four ragged columns of them.
HETERO_SUB_TILE_PLANES = ((34, 33), (34, 65), (16, 128))
HETERO_LENS = [(20, 30, 12), (3, 5, 4), (0, 4, 3), (7, 17, 40), (25, 9, 9),
               (1, 1, 1), (60, 70, 50), (33, 32, 33)]


def phase_hetero(rng) -> int:
    lens = HETERO_LENS
    checked, err = [], 0
    for name in ("default", "rtl", "nondefault", "sub4", "blosum62"):
        scoring, _, nsym = VARIANTS[name]
        trips = [triplet(rng, n, nsym) for n in lens]
        for block in ((9, 17), bk.choose_block_shape(0, 0, 0),
                      *HETERO_SUB_TILE_PLANES):
            err = max(err, hetero_case(trips, scoring, block)[0])
            checked.append(f"{len(trips)} problems/{block}/{name}")
        # One batch cut into dispatches by a small face budget: each
        # dispatch against hetero_ref, and the scores of align_hetero.
        block = (9, 17)
        budget = 2 * hk.face_bytes(60, 70, 50, *block)
        plan = hk.plan_dispatches(lens, *block, budget)
        require(len(plan) >= 2, f"one dispatch under budget {budget}")
        want = [0] * len(trips)
        for idx in plan:
            e, scores = hetero_case([trips[i] for i in idx], scoring, block)
            err = max(err, e)
            for i, v in zip(idx, scores):
                want[i] = v
        got = hk.align_hetero(trips, scoring, CUDA, block,
                              budget_bytes=budget)
        require(got == want, f"K4 {name} in {len(plan)} dispatches: {got} "
                f"!= {want}")
        checked.append(f"{len(plan)} dispatches/{block}/{name}")
    emit(phase="hetero", cases=checked, max_abs_err=err)
    return err


# The direct engine's kernels (traceback/direct.py) against their plain
# versions: ragged shapes (a length of 1, an empty B or C, several 33 x 33
# tiles) under every scoring K5 takes, in every mode, then the main path's
# direct sizes: 512^3 and 1024^3 whole, and a leaf of the 2048^3 route
# (DIRECT_LEAF, "pin"), whose packed offsets pass 2^31.  The packed buffers
# at scale are compared a chunk of DIRECT_ROWS planes at a time, so that
# the comparison adds little to the two buffers' 9.7 GB each at 1024^3.
DIRECT_SHAPES = ((1, 1, 1), (1, 40, 3), (30, 1, 45), (12, 0, 40), (3, 50, 0),
                 (9, 70, 40), (40, 34, 66))
DIRECT_MODES = ("free", "free_jk", "pin")
DIRECT_LEAF = (512, 1024, 1024)
DIRECT_ROWS = 64


def direct_v0(rng, mode):
    """The start vector of "pin" (small values, NEG walls), else None."""
    if mode != "pin":
        return None
    v0 = rng.integers(-9, 10, NUM_MATRICES).astype(np.int32)
    v0[rng.random(NUM_MATRICES) < 0.5] = NEG
    v0[rng.integers(NUM_MATRICES)] = 0
    return v0


def packed_diff(got, want, lens) -> tuple:
    """(largest difference of the final vectors and of the packed entries on
    the cuboid's slots, count of differing entries) of two results of the
    choice-capture sweep, DIRECT_ROWS planes at a time."""
    err, bad, qmax = _diff(got[0], want[0]), 0, sum(lens)
    for q0 in range(0, qmax, DIRECT_ROWS):
        q1 = min(q0 + DIRECT_ROWS, qmax)
        on = direct.cuboid_slots(*lens, q0, q1, CUDA)
        for g, w in zip(got[1:], want[1:]):
            d = (g[q0:q1].int() - w[q0:q1].int()).abs() * on
            err, bad = max(err, int(d.max())), bad + int((d != 0).sum())
    return err, bad


def direct_case(trip, scoring, mode, v0) -> tuple:
    """The choice kernel (one launch) against direct._choices, and the walk
    kernel against direct.walk_ref from the best end state on the kernel's
    buffers, exactly; (largest differences of both, the walk's steps)."""
    lens = tuple(len(x) for x in trip)
    what = f"direct {lens} {mode}"
    before = sk.choice_sweep.launches
    got = direct.choices(*trip, scoring, mode, v0, CUDA)
    require(sk.choice_sweep.launches == before + 1,
            f"{what}: not one launch of the choice kernel")
    err, bad = packed_diff(got, direct._choices(*trip, scoring, mode, v0,
                                                CUDA), lens)
    require(err == 0, f"{what}: {bad} packed entries or the final vector "
            f"differ from the torch sweep's (largest difference {err})")
    t0 = int(torch.argmax(got[0]))
    res = direct.walk(got[1], got[2], t0, *lens, mode)
    want = direct.walk_ref(got[1], got[2], t0, *lens, mode)
    n = int(want[0])
    walk_err = _diff(res[:4 + n], want[:4 + n])
    require(walk_err == 0, f"{what}: the walk kernel's steps or stop differ "
            "from walk_ref's")
    return err, walk_err, n


def phase_direct(rng) -> dict:
    """The direct engine's two kernels against their plain versions; returns
    each one's largest difference."""
    errs, walk_errs, runs = [], [], []
    for name, (scoring, _, nsym) in SLAB_VARIANTS.items():
        for mode in DIRECT_MODES:
            for shape in DIRECT_SHAPES:
                err, walk_err, _ = direct_case(triplet(rng, shape, nsym),
                                               scoring, mode,
                                               direct_v0(rng, mode))
                errs.append(err)
                walk_errs.append(walk_err)
    for shape, modes in (((512,) * 3, DIRECT_MODES), ((1024,) * 3, ("free",)),
                         (DIRECT_LEAF, ("pin",))):
        trip = triplet(rng, shape)
        for mode in modes:
            t0 = time.perf_counter()
            err, walk_err, steps = direct_case(trip, DEFAULT, mode,
                                               direct_v0(rng, mode))
            errs.append(err)
            walk_errs.append(walk_err)
            runs.append({"shape": list(shape), "mode": mode,
                         "walk_steps": steps,
                         "seconds": time.perf_counter() - t0})
    emit(phase="direct", small_cases=len(SLAB_VARIANTS) * len(DIRECT_MODES)
         * len(DIRECT_SHAPES), scorings=list(SLAB_VARIANTS), runs=runs,
         max_abs_err=max(errs), walk_max_abs_err=max(walk_errs))
    return {"direct_choices": max(errs), "direct_walk": max(walk_errs)}


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
    # The C++ oracle up to 512^3; the 1024^3 headline against the torch
    # sweep, all seven values (the oracle would take ~26 s there).
    for n, backend in ((64, "wavefront"), (512, "blocked"), (1024, "blocked")):
        a, b, c = triplet(rng, (n, n, n))
        r = trialign_torch.align(a, b, c)
        t0 = time.perf_counter()
        if n < 1024:
            oracle, want = "native", score_native(a, b, c)
        else:
            plain = plain_sweep(a, b, c)
            oracle, want = "torch sweep", max(cpu_ints(plain))
            headline = (a, b, c), r.score, plain
        oracle_s = time.perf_counter() - t0
        require(r.backend == backend and r.score == want,
                f"{n}^3: {r.backend} {r.score} != {oracle} {want}")
        runs.append({"input": f"random {n}^3", "backend": r.backend,
                     "score": r.score, "oracle": oracle,
                     "oracle_s": oracle_s, "align_s": r.seconds})
    launches = read_launches()
    require(launches["wavefront"] == 2 and launches["blocked"] == 2,
            f"K2 not once a call, or K3 not once a sweep: {launches}")
    emit(phase="main_path", runs=runs, launches=launches)
    return launches, headline


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
            _Spy(direct, "_choices") as pspy, \
            _Spy(sk, "split_point_blocked_async") as sspy:
        r = trialign_torch.align(a, b, c, return_alignment=True)
        torch.cuda.synchronize()
    require(not pspy.calls, f"{label}: the torch choice sweep ran on the "
            f"card path: {pspy.calls}")
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
           "torch_sweeps": sum(pspy.calls.values()),
           "launches": launches}
    require(launches["direct_choices"] == launches["direct_walk"]
            == rec["direct_leaves"] > 0,
            f"{label}: the direct kernels did not launch once a direct "
            f"node: {launches}, {rec['direct_leaves']} direct nodes")
    if native:
        t0 = time.perf_counter()
        want = score_native(a, b, c)
        rec["native"] = [want, time.perf_counter() - t0]
        require(r.score == want, f"{label}: {r.score} != native {want}")
    return rec


def phase_traceback(rng) -> tuple:
    """The slice's path; returns the launches of K5 and of the direct
    engine's kernels in the run of the 2048^3 case (the one size whose
    default route reaches K5; the direct kernels run in its leaves, and on
    the whole triplet at 512^3 and 1024^3), and the 1024^3 triplet with its
    record.  Every case holds that the torch choice sweep never ran."""
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
        if n == 1024:
            case_1024 = trip, rec
    launches_2048 = {k: rec["launches"][k]
                     for k in ("slab", "direct_choices", "direct_walk")}
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
    emit(phase="traceback", runs=recs, launches_2048=launches_2048,
         slab_launches_pin_splits=rec["launches"]["slab"])
    return launches_2048, case_1024


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
    launches in its first run, the batch and its scores."""
    trips = batch_triplets(rng)
    cells = batch_cells(trips)
    reset_launches()
    res, first_s = timed_batch(trips)
    launches = read_launches()
    require(launches["hetero"] == 1 and not launches["wavefront"]
            and not launches["blocked"],
            f"the 1024-triplet batch did not take K4 alone, one launch: "
            f"{launches}")
    scores = [r.score for r in res]
    runs_s = []
    for _ in range(3):
        again, sec = timed_batch(trips)
        runs_s.append(sec)
        require([r.score for r in again] == scores, "a rerun disagrees")
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
    # Its K2 launch alone, on the triplets inside K2's caps of that batch
    # and two more like it.
    k2_inputs = [padded_args([t for t in b if wf.fits(*map(len, t))])
                 for b in [small] + [batch_triplets(rng, 48, (16, 320))
                                     for _ in range(2)]]
    k2_ms = time_cuda_ms(wf.final_values, k2_inputs)

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
                 "seconds": s48, "launches": l48, "k2_ms": k2_ms},
         alignments={"triplets": len(tb), "seconds": s16,
                     "backends": sorted({r.backend for r in res16})})
    return launches["hetero"], trips, scores


# Of the protein batch: scores held to align() and to the C++ oracle.
PROTFAM_ALIGN_SAMPLE, PROTFAM_NATIVE_SAMPLE = 64, 16


def phase_protfam_batch(seed: int) -> None:
    """The ``protfam.fambatch`` cell's path: one of its batches (512
    family triplets, three ~31%-identical copies of a 200-600-residue root
    each) under BLOSUM62, all on K4 in one launch, none to the padded route
    or the plain sweep; scores of a sample against ``align()`` (K2 or K3)
    and, the batch's largest triplet among them, against the C++ oracle."""
    trips = traffic.pool(PROTFAM, bench_file("traffic", "fambatch.json"),
                         seed)[0]
    cells = batch_cells(trips)
    before = {r: getattr(api.batch_routes, r) for r in api.ROUTES}
    reset_launches()
    res, first_s = timed_batch(trips, scoring=BLOSUM62)
    launches = read_launches()
    routed = {r: getattr(api.batch_routes, r) - before[r] for r in api.ROUTES}
    require(launches["hetero"] == 1 and not launches["wavefront"]
            and not launches["blocked"]
            and routed == {"mosaic": len(trips), "padded": 0, "torch": 0},
            f"the protein batch did not take K4 alone, one launch: "
            f"{launches}, routed {routed}")
    scores = [r.score for r in res]
    runs_s = []
    for _ in range(3):
        again, sec = timed_batch(trips, scoring=BLOSUM62)
        require([r.score for r in again] == scores, "a rerun disagrees")
        runs_s.append(sec)

    rng = np.random.default_rng(seed)
    largest = max(range(len(trips)),
                  key=lambda i: np.prod([len(x) for x in trips[i]]))
    sample = [largest] + [int(i) for i in rng.choice(
        [i for i in range(len(trips)) if i != largest],
        PROTFAM_ALIGN_SAMPLE - 1, replace=False)]
    single = {}
    for i in sample:
        r = trialign_torch.align(*trips[i], BLOSUM62)
        require(r.score == scores[i], f"protein triplet {i} "
                f"{list(map(len, trips[i]))}: batch {scores[i]} != align() "
                f"({r.backend}) {r.score}")
        single[r.backend] = single.get(r.backend, 0) + 1
    require("torch" not in single, f"align() took the plain sweep: {single}")
    native_idx = sample[:PROTFAM_NATIVE_SAMPLE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        native = list(ex.map(lambda i: score_native(*trips[i], BLOSUM62),
                             native_idx))
    native_s = time.perf_counter() - t0
    require(native == [scores[i] for i in native_idx],
            f"protein batch {[scores[i] for i in native_idx]} != native "
            f"{native}")
    best = min(runs_s)
    emit(phase="protfam_batch", triplets=len(trips),
         root_length=PROTFAM["sequences"]["root_length"], cells=cells,
         first_s=first_s, runs_s=runs_s, best_s=best,
         gcups=cells / best / 1e9, launches=launches, routed=routed,
         checked_against_align=len(sample), align_backends=single,
         checked_against_native=len(native), native_s=native_s,
         largest=list(map(len, trips[largest])))


# ------------------------------------------------ checkpoint, chain, vpu, cli


def in_runs(sweep, arrs, lens, dims, every, scoring=DEFAULT, bits=0):
    """Sweep a whole grid from a fresh state through ``sweep``
    (bk.sweep_tiles or bk.blocked_ref, which take the same state and tile
    range) in runs of ``every`` tiles; the state."""
    state = bk.new_state(dims, arrs[0].device)
    n = bk.n_tiles(dims)
    for idx in range(0, n, every):
        sweep(*arrs, *lens, dims, state=state, idx0=idx,
              count=min(every, n - idx), scoring=scoring, score_bits=bits)
    return state


def quarter_inputs(trips):
    """in_runs' arguments after the sweep for each triplet, at K3's tile
    plane, in runs of a quarter of the grid."""
    out = []
    for t in trips:
        lens = tuple(map(len, t))
        dims = bk.plan_dims(*lens)
        out.append((bk.prep_blocked(*t, dims, CUDA), lens, dims,
                    -(-bk.n_tiles(dims) // 4)))
    return out


# K3's per-tile form over quarter_inputs' arguments.
tiles_in_runs = functools.partial(in_runs, bk.sweep_tiles)


def tiles_case(trip, block, every, scoring, bits=0) -> int:
    """K3's per-tile form against blocked_ref in runs of ``every`` tiles,
    which end in the middle of anti-diagonals: the whole state (faces and
    output), exactly; the largest difference."""
    lens = tuple(map(len, trip))
    dims = bk.plan_dims(*lens, *block)
    arrs = bk.prep_blocked(*trip, dims, CUDA)
    got = in_runs(bk.sweep_tiles, arrs, lens, dims, every, scoring, bits)
    want = in_runs(bk.blocked_ref, arrs, lens, dims, every, scoring, bits)
    for g, w, name in zip(got, want, want._fields):
        require(torch.equal(g, w), f"K3 per tile {lens} {block} runs of "
                f"{every}: {name} != blocked_ref's")
    return max(_diff(g, w) for g, w in zip(got, want))


def event_ms(fn, *args):
    """(device milliseconds of one call between two CUDA events, its
    result)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def phase_checkpoint(rng, dev, headline, batch, batch_scores) -> dict:
    """The slice's path for checkpoint/resume and the resilient entry
    points, on K3's per-tile form; returns the form's summary row."""
    from trialign_torch import checkpoint as ck
    from trialign_torch import resilience

    checked, err = [], 0
    for name, every in zip(VARIANTS, (4, 5, 7, 10, 13)):
        scoring, bits, nsym = VARIANTS[name]
        err = max(err, tiles_case(triplet(rng, (37, 70, 45), nsym), (9, 17),
                                  every, scoring, bits))
        checked.append(f"(37, 70, 45)/(9, 17)/runs of {every}/{name}")

    # The main path's 1024^3 triplet: a quarter of the grid a segment, two
    # segments, a new aligner resumed from the file, to the end.
    trip, want, plain = headline
    tmp = tempfile.mkdtemp(prefix="trialign_ckpt_")
    path = os.path.join(tmp, "ck.npz")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    r1 = ck.CheckpointedAligner(*trip, ckpt_path=path)
    every = r1.n_blocks // 4
    r1.every = every
    save_s = []
    for _ in range(2):
        state = ck._segment(r1.arrs, r1.lens, r1.dims,
                            bk.BlockedState(r1.rf, r1.cf, r1.out),
                            r1.next_idx, every, r1.scoring)
        r1.rf, r1.cf, r1.out = state
        r1.next_idx += every
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        r1.save()
        save_s.append(time.perf_counter() - s0)
    stopped_at = r1.next_idx
    r2 = ck.CheckpointedAligner(*trip, ckpt_path=path, every=every)
    require(r2.resume() and r2.next_idx == stopped_at,
            f"resume found {r2.next_idx}, not {stopped_at}")
    score = r2.run()
    ckpt_s = time.perf_counter() - t0
    launches = read_launches()
    require(score == want, f"checkpointed 1024^3 {score} != main_path {want}")
    require(launches["blocked_tiles"] == 4 and not launches["blocked"],
            f"the checkpointed run made other launches than one a quarter "
            f"of K3's per-tile form: {launches}")
    require(torch.equal(r2.out[0], plain), f"checkpointed 1024^3 "
            f"{cpu_ints(r2.out[0])} != torch sweep {cpu_ints(plain)}")
    err = max(err, _diff(r2.out[0], plain))
    file_bytes = os.path.getsize(path)

    # align_resilient with one failure, raised after the second segment.
    real = ck._segment
    calls = []

    def flaky(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(args[4])
        if len(calls) == 2:
            raise RuntimeError("injected failure")
        return out

    ck._segment = flaky
    try:
        t0 = time.perf_counter()
        resilient = resilience.align_resilient(*trip, ckpt_path=path,
                                               every=every, backoff_s=0.0)
        resilient_s = time.perf_counter() - t0
    finally:
        ck._segment = real
    require(resilient == want, f"align_resilient {resilient} != {want}")
    # The failed segment runs again from the first save.
    require(calls == [0, every, every, 2 * every, 3 * every],
            f"align_resilient ran segments from {calls}")
    require(not os.path.exists(path), "align_resilient left its file")
    os.rmdir(tmp)

    # align_batch_resilient: 256 of the batch's triplets in dispatches of
    # 64, a failure raised once the second dispatch has drained.
    sub = batch[:256]
    sizes, drained = [], {"n": 0}

    def batch_fn(trips, scoring, mesh=None, on_scores=None):
        sizes.append(len(trips))

        def record(i, s):
            on_scores(i, s)
            drained["n"] += 1
            if drained["n"] == 128:
                raise RuntimeError("injected failure after the second drain")

        return mosaic.align_batch_mosaic(trips, scoring, mesh=mesh,
                                         on_scores=record)

    # K4 dispatches of 64 problems: the batch would fit one.
    real_hetero = hk.align_hetero
    hk.align_hetero = functools.partial(real_hetero, max_problems=64)
    try:
        t0 = time.perf_counter()
        got = resilience.align_batch_resilient(sub, batch_fn=batch_fn,
                                               backoff_s=0.0)
        batch_s = time.perf_counter() - t0
    finally:
        hk.align_hetero = real_hetero
    require(sizes == [256, 128], f"dispatched {sizes}, not [256, 128]")
    require(got == batch_scores[:256], "align_batch_resilient != the batch")

    # The summary row: the per-tile form and blocked_ref on one 192^3
    # sample in runs of a quarter of its grid (blocked_ref would take
    # about a minute at 1024^3); the timings phase adds the 1024^3 run's
    # shape.
    n = TILES_SAMPLE
    sample = quarter_inputs([triplet(rng, (n, n, n)) for _ in range(3)])
    ms = time_cuda_ms(tiles_in_runs, sample)
    plain_ms, plain_state = event_ms(in_runs, bk.blocked_ref, *sample[0])
    got_state = tiles_in_runs(*sample[0])
    for g, w in zip(got_state, plain_state):
        require(torch.equal(g, w), f"K3 per tile at {n}^3 != blocked_ref")
        err = max(err, _diff(g, w))
    # Inputs: the symbol vectors and the state, read once; the state
    # written once.
    state_ints = sum(t.numel() for t in plain_state)
    bms, by = bound(n ** 3, 4 * (3 * n + 2 * state_ints), dev)
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "max_abs_err": err, "launches": launches["blocked_tiles"],
           "sample": f"{n}^3 in runs of a quarter of its grid"}
    emit(phase="checkpoint", cases=checked, max_abs_err=err,
         checkpointed_1024={
             "score": score, "tiles": r2.n_blocks, "every": every,
             "stopped_at": stopped_at, "saves": 4, "seconds": ckpt_s,
             "save_s_first_two": save_s, "file_bytes": file_bytes,
             "launches": launches},
         align_resilient={"score": resilient, "segments_from": calls,
                          "seconds": resilient_s},
         align_batch_resilient={"triplets": len(sub), "dispatch_size": 64,
                                "attempt_sizes": sizes, "seconds": batch_s},
         per_tile=row)
    return row


def chain_case(rng, shape, npack, block, name):
    """K3 in chain mode against blocked_ref, every slot's seven values
    exactly; the largest difference."""
    scoring, _, nsym = VARIANTS[name]
    la, lb, lc = shape
    a_list = [triplet(rng, (la,), nsym)[0] for _ in range(npack)]
    b, c = triplet(rng, (lb, lc), nsym)
    dims = bk.plan_dims_packed(la, lb, lc, npack, *block)
    arrs = bk.prep_chain(a_list, b, c, dims, CUDA)
    got = bk.chain_values(*arrs, la, lb, lc, dims, scoring)
    want = bk.blocked_ref(*arrs, la, lb, lc, dims, scoring)
    require(torch.equal(got, want), f"K3 chain {shape} x{npack} {block} "
            f"{name}: kernel {cpu_ints(got)} != blocked_ref {cpu_ints(want)}")
    return _diff(got, want)


def phase_chain(rng, dev) -> dict:
    """K3's chain mode: exact on small multi-tile shapes, then the bench's
    chains; returns its summary row."""
    checked, err = [], 0
    names = list(VARIANTS)
    for block, shape in (((9, 17), (12, 40, 50)), ((33, 33), (30, 70, 45))):
        for npack, name in zip(range(1, 6), names):
            err = max(err, chain_case(rng, shape, npack, block, name))
            checked.append(f"{shape} x{npack}/{block}/{name}")
    # score_bits=12 under WIDE scoring, where the wrap changes the score.
    base = near_identical(rng, 40)
    a_list, b, c = [base[0], base[1], base[0]], base[1], base[2]
    dims = bk.plan_dims_packed(40, 40, 40, 3, 9, 17)
    got = bk.chain_values(*bk.prep_chain(a_list, b, c, dims, CUDA), 40, 40,
                          40, dims, WIDE, 12)
    want = bk.blocked_ref(*bk.prep_chain(a_list, b, c, dims, CUDA), 40, 40,
                          40, dims, WIDE, 12)
    g12 = [align_planes_numpy(a, b, c, WIDE, score_bits=12) for a in a_list]
    g0 = [align_planes_numpy(a, b, c, WIDE) for a in a_list]
    require(g12 != g0, "no wrap in the score_bits chain case")
    require(torch.equal(got, want) and
            got.max(dim=1).values.tolist() == g12,
            f"K3 chain score_bits=12: {cpu_ints(got)} vs {g12}")
    err = max(err, _diff(got, want))
    checked.append("(40, 40, 40) x3/(9, 17)/wide/score_bits=12")

    # The bench's chains (bench.py chain_512 and chain_1k): every slot's
    # seven values against the torch sweep of its own triplet, exactly.
    runs = {}
    for n, npack in CHAIN_BENCH:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        g, dt, values, (a_list, b, c) = benchmarks.bench_blocked_chain(
            n, npack, return_values=True)
        launches = read_launches()
        seconds = time.perf_counter() - t0
        require(launches["blocked_chain"] > 0,
                f"chain mode did not launch: {launches}")
        t0 = time.perf_counter()
        want = chain_sweep(a_list, b, c)
        for m in range(npack):
            require(torch.equal(values[m], want[m]), f"chain {n}^3 x{npack} "
                    f"slot {m}: {cpu_ints(values[m])} != torch sweep "
                    f"{cpu_ints(want[m])}")
        err = max(err, _diff(values, want))
        scores = values.max(dim=1).values.tolist()
        bms, _ = bound(n ** 3, 4 * (3 * n + NUM_MATRICES), dev)
        runs[f"{n}x{npack}"] = {"ms_per_alignment": dt * 1e3, "gcups": g,
                                "bound_ms_per_alignment": bms,
                                "launches": launches["blocked_chain"],
                                "seconds": seconds,
                                "slots_equal_to_sweep": npack,
                                "sweep_s": time.perf_counter() - t0}
        if (n, npack) == CHAIN_BENCH[0]:
            chain_launches = launches["blocked_chain"]
            for m in (0, npack - 1):
                r = trialign_torch.align(a_list[m], b, c)
                require(r.score == scores[m], f"chain slot {m}: {scores[m]} "
                        f"!= align() ({r.backend}) {r.score}")
            t0 = time.perf_counter()
            nat = score_native(a_list[1], b, c)
            runs[f"{n}x{npack}"]["native_s"] = time.perf_counter() - t0
            require(nat == scores[1], f"chain slot 1: {scores[1]} != native "
                    f"{nat}")
        else:
            r = trialign_torch.align(a_list[0], b, c)
            require(r.score == scores[0], f"chain 1024 slot 0: {scores[0]} "
                    f"!= align() {r.score}")

    # The summary row: kernel and blocked_ref on one chain of 4 slots of
    # 128^3 (blocked_ref would take minutes at the bench's shapes).
    la, npack = CHAIN_SAMPLE
    block = bk.choose_block_shape(0, 0, 0)
    dims = bk.plan_dims_packed(la, la, la, npack, *block)
    sample = []
    for _ in range(3):
        a_list = [triplet(rng, (la,))[0] for _ in range(npack)]
        b, c = triplet(rng, (la, la))
        sample.append((*bk.prep_chain(a_list, b, c, dims, CUDA), la, la, la,
                       dims))
    ms = time_cuda_ms(bk.chain_values, sample)
    plain_ms, want = event_ms(bk.blocked_ref, *sample[0])
    got = bk.chain_values(*sample[0])
    require(torch.equal(got, want), f"K3 chain {la}^3 x{npack} != blocked_ref")
    err = max(err, _diff(got, want))
    bms, by = bound(npack * la ** 3, 4 * (npack * la + 2 * la
                                          + npack * NUM_MATRICES), dev)
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "max_abs_err": err, "launches": chain_launches,
           "sample": f"{npack} slots of {la}^3",
           **{f"ms_per_alignment_{k}": v["ms_per_alignment"]
              for k, v in runs.items()}}
    emit(phase="chain", cases=checked, max_abs_err=err, bench=runs,
         summary=row)
    return row


class ClockSampler:
    """Samples the SM clock with nvidia-smi while installed."""

    def __enter__(self):
        self.mhz, self.stop = [], threading.Event()

        def poll():
            while not self.stop.is_set():
                self.mhz.append(float(smi("clocks.sm").split()[0]))
                self.stop.wait(0.05)

        self.thread = threading.Thread(target=poll, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def phase_vpu(rng, dev) -> dict:
    """K6 on its main path, ``benchmarks.roofline()``: the int32 and DPX
    rates beside the rate int32_peak_ops() assumes.  The faster of the two
    measured rates becomes ``dev["int32_ops_per_s"]``, the peak every later
    bound divides by.  Then K6 against its plain version, exactly, on a
    short sample that must take at least its bound; returns its summary
    row."""
    n = vpu.full_card_lanes(CUDA)
    reset_launches()
    with ClockSampler() as clocks:
        roof = benchmarks.roofline()
    launches = read_launches()["vpu"]
    require(launches > 0, "K6 did not launch in roofline()")
    peak = max(roof["vpu_int32_measured"], roof["vpu_dpx_measured"])
    dev["int32_ops_per_s"] = peak
    iters, ops = 16, 512
    err, rows = 0, {}
    for dpx in (False, True):
        xs = [torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32))
              .to(CUDA) for _ in range(3)]
        ms = time_cuda_ms(vpu.vpu_chains, [(x, iters, ops, dpx) for x in xs])
        plain_ms, want = event_ms(vpu.vpu_ref, xs[0], iters, ops, dpx)
        got = vpu.vpu_chains(xs[0], iters, ops, dpx)
        require(torch.equal(got, want), f"K6 dpx={dpx} != vpu_ref")
        err = max(err, _diff(got, want))
        # Each lane's seed read and its result written: 8 bytes a lane.
        ops_ms = n * iters * ops / peak * 1e3
        bytes_ms = 8 * n / HBM_BYTES_PER_S * 1e3
        bms = max(ops_ms, bytes_ms)
        require(ms >= bms, f"K6 dpx={dpx} took {ms} ms, under its bound "
                f"{bms} ms")
        rows["dpx" if dpx else "int32"] = {
            "ms": ms, "plain_ms": plain_ms, "ops": n * iters * ops,
            "bound_ms": bms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    # roofline()'s own run: measure_vpu_rate's default iters and ops.
    main_ops = n * benchmarks.VPU_ITERS * benchmarks.VPU_OPS
    row = {**rows["int32"], "max_abs_err": err, "launches": launches,
           "sample": f"{n} lanes x {iters} rounds x {ops} ops",
           "dpx_ms": rows["dpx"]["ms"], "dpx_plain_ms": rows["dpx"]["plain_ms"],
           "main_path_ms": main_ops / roof["vpu_int32_measured"] * 1e3,
           "main_path_dpx_ms": main_ops / roof["vpu_dpx_measured"] * 1e3,
           "main_path_bound_ms": main_ops / peak * 1e3}
    emit(phase="vpu", lanes=n, samples=rows, max_abs_err=err,
         roofline=roof, sm_clock_mhz_during={
             "samples": len(clocks.mhz), "min": min(clocks.mhz),
             "max": max(clocks.mhz)},
         peak_ops_per_s=peak,
         int32_vs_assumed=roof["vpu_int32_measured"]
         / roof["int32_ops_per_s_assumed"],
         dpx_vs_assumed=roof["vpu_dpx_measured"]
         / roof["int32_ops_per_s_assumed"], launches=launches)
    return row


# ------------------------------------------------------------- multi-device


def card_mesh(data, model):
    """A (data, model) mesh whose slots all share the one card."""
    return dmesh.make_mesh(data, model, devices=[CUDA] * (data * model))


def halo_state_case(trip, block, ndev, overlap, scoring=DEFAULT,
                    band=None) -> int:
    """K3's per-tile form in ``ndev`` stripes sharing the card, in bands of
    ``band`` tile rows (the model's by default), against blocked_ref's
    whole sweep: the last stripe's column faces and output, and each
    stripe's row faces of its own columns, exactly; one launch a band a
    stripe.  The largest difference."""
    lens = tuple(map(len, trip))
    row = dh.model_row(card_mesh(1, ndev))
    rows = band or dh.halo_efficiency(*lens, ndev, block, overlap)["band"]
    before = bk.sweep_tiles.launches
    dims, stripes = dh.sweep_stripes(*trip, scoring, row, block, overlap,
                                     rows)
    what = f"halo {lens} {block} {ndev} stripes overlap={overlap} band={rows}"
    require(bk.sweep_tiles.launches - before == len(stripes) * len(
        dh.bands(dims.n_jb, rows)), f"{what}: launches "
        f"{bk.sweep_tiles.launches - before}")
    torch.cuda.synchronize()
    want = bk.new_state(dims, CUDA)
    bk.blocked_ref(*bk.prep_blocked(*trip, dims, CUDA), *lens, dims, scoring,
                   0, want)
    last = stripes[-1].state
    pairs = [(last.cf, want.cf), (last.out, want.out)]
    pairs += [(s.state.rf[s.kb0:s.kb1], want.rf[s.kb0:s.kb1])
              for s in stripes]
    for got, w in pairs:
        require(torch.equal(got, w), f"{what}: != blocked_ref's state")
    return max(_diff(g, w) for g, w in pairs)


def face_copy_rate(dims) -> dict:
    """Device-to-device bytes a second of one column face (nrows x 7 x hb
    int32) copied between two tensors on the card: 50 copies between two
    CUDA events."""
    src = torch.zeros((dims.nrows, NUM_MATRICES, dims.hb), dtype=torch.int32,
                      device=CUDA)
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms, _ = event_ms(lambda: [dst.copy_(src) for _ in range(50)])
    nbytes = src.numel() * 4
    return {"face_bytes": nbytes, "copies": 50, "ms": ms,
            "bytes_per_s": 50 * nbytes / (ms / 1e3)}


def phase_halo(rng, headline) -> dict:
    """The halo (dist/halo.py) on stripes sharing the card: K3's per-tile
    form in 2 and 3 stripes, in the model's bands and in bands of 1 and 2
    rows, against blocked_ref, whole state; the main path's 1024^3 triplet
    in 1, 2 and 4 stripes under both schedules, all seven values equal to
    the torch sweep's (main_path's), one launch a band a stripe; ms beside
    K3's whole-grid sweep; the measured face-copy rate and the model's time
    on separate cards."""
    checked, err = [], 0
    for shape, block, ndev in (((37, 70, 45), (9, 17), 2),
                               ((37, 70, 45), (9, 17), 3),
                               ((20, 100, 150), (9, 17), 3),
                               ((30, 60, 300), (17, 33), 2)):
        for name, overlap, band in (("default", True, None),
                                    ("sub4", False, None),
                                    ("default", False, 1),
                                    ("rtl", True, 2)):
            scoring, _, nsym = VARIANTS[name]
            err = max(err, halo_state_case(triplet(rng, shape, nsym), block,
                                           ndev, overlap, scoring, band))
            checked.append(f"{shape}/{block}/{ndev} stripes/{name}/"
                           f"overlap={overlap}/band={band or 'model'}")

    trip, _, want = headline
    lens = tuple(map(len, trip))
    block = bk.choose_block_shape(*lens)
    dims = bk.plan_dims(*lens, *block)
    k3_ms = time_blocked([trip] * 3, block)
    rate = face_copy_rate(dims)
    inputs = [(trip,)] + [(triplet(rng, lens),) for _ in range(2)]
    runs = {}
    for ndev in (1, 2, 4):
        m = card_mesh(1, ndev)
        for overlap in (True, False):
            model = dh.halo_efficiency(*lens, ndev, block, overlap,
                                       rate["bytes_per_s"])
            reset_launches()
            got = dh.halo_values(*trip, mesh=m, block_shape=block,
                                 overlap=overlap)
            launches = read_launches()
            what = f"halo 1024^3 on {ndev} stripes overlap={overlap}"
            require(torch.equal(got, want.cpu()),
                    f"{what}: {cpu_ints(got)} != torch sweep "
                    f"{cpu_ints(want)}")
            err = max(err, _diff(got, want.cpu()))
            expect = ndev * len(dh.bands(dims.n_jb, model["band"]))
            require(launches["blocked_tiles"] == expect and
                    not launches["blocked"],
                    f"{what}: {launches}, not {expect} launches of K3's "
                    "per-tile form")

            def halo(t):
                return dh.halo_values(*t, DEFAULT, m, block, overlap)

            runs[f"{ndev}/{'overlap' if overlap else 'tight'}"] = {
                "band_rows": model["band"], "launches": expect,
                "model_s_on_separate_cards": model["seconds"],
                "model_pipeline": model["pipeline"],
                "ms": time_cuda_ms(halo, inputs)}
    emit(phase="halo", cases=checked, max_abs_err=err, k3_1024_ms=k3_ms,
         stripes_sharing_one_card=runs,
         face_copy=rate, values=cpu_ints(want))
    return {"max_abs_err": err, "rate": rate["bytes_per_s"]}


def slab_tiles_case(rng, name, variant, shape=(10, 30, 40), block=(9, 9)):
    """K5's per-tile form against slab_ref's whole sweep: in runs of 3 and 7
    tiles (most end mid-diagonal) and in 2 and 3 stripes sharing the card
    (a stripe past column 0 reads the face it is handed); capture and final
    vector exactly.  The largest difference."""
    scoring, _, nsym = SLAB_VARIANTS[name]
    seqs = tuple(x.astype(np.int32) for x in triplet(rng, shape, nsym))
    ev = onehot(int(rng.integers(0, NUM_MATRICES)))
    dims = sk._plan(*shape, block)
    arrs = sk.prep_blocked(*seqs, dims, CUDA)
    f_r, cap_r = sk.slab_ref(*arrs, *shape, dims, variant, ev, scoring)
    got = []
    n = bk.n_tiles(dims)
    for every in (3, 7):
        state = sk.new_state(*shape, dims, ev, CUDA)
        for idx in range(0, n, every):
            sk.sweep_tiles(*arrs, *shape, dims, variant, state, idx,
                           min(every, n - idx), scoring)
        got.append((state.out, state.cap, f"runs of {every}"))
    for ndev, overlap in ((2, True), (3, False)):
        _, stripes = halo_tb._sharded_sweep(
            *seqs, scoring, dh.model_row(card_mesh(1, ndev)), variant, ev,
            block, overlap)
        cap = halo_tb._gather_caps(dims, stripes, stripes[0], 0)
        got.append((stripes[-1].state.out, cap, f"{ndev} stripes"))
    err = 0
    for out, cap, how in got:
        what = f"K5 per tile {shape} {block} {name} {variant} {how}"
        require(torch.equal(cap, cap_r), f"{what}: capture != slab_ref's")
        err = max(err, _diff(cap, cap_r))
        if variant != "bwd":
            require(torch.equal(out, f_r), f"{what}: final != slab_ref's")
            err = max(err, _diff(out, f_r))
    return err


def slab_split_tiles(trip, dev) -> dict:
    """K5's per-tile form at the main path's shape: both slab sweeps of the
    top split (m = |A| / 2) of the sharded 1024^3 traceback, in 2 stripes
    sharing the card at the halo's tile plane, schedule and bands, as
    sharded_split_point runs them.  The gathered F capture and final vector
    and the G capture against the torch engine, exactly; ms of the F sweep
    in stripes beside the engine's and the bound."""
    a, b, c = (np.asarray(x, np.int32) for x in trip)
    m, lb, lc = len(a) // 2, len(b), len(c)
    row = dh.model_row(card_mesh(1, 2))
    end_v = np.zeros(NUM_MATRICES, np.int32)

    def forward(a_half):
        return halo_tb._sharded_sweep(a_half, b, c, DEFAULT, row, "free",
                                      None, None, None)

    fdims, fst = forward(a[:m])
    f_slab = sk._assemble(halo_tb._gather_caps(fdims, fst, fst[0], 0), fdims,
                          lb, lc)
    gdims, gst = halo_tb._sharded_sweep(
        a[m:][::-1].copy(), b[::-1].copy(), c[::-1].copy(), DEFAULT, row,
        "bwd", end_v, None, None)
    g_slab = sk._assemble(halo_tb._gather_caps(gdims, gst, gst[0], 0), gdims,
                          lb, lc)
    plain_ms, fin = event_ms(functools.partial(
        torch_engine.forward_sweep_torch_async, a[:m], b, c, DEFAULT,
        mode="free", capture_m=m, device=CUDA))
    f_e, s_e = fin()
    g_e = torch_engine.backward_slab_torch_async(a[m:], b, c, DEFAULT,
                                                 end_v=end_v, device=CUDA)()
    err = 0
    for got, want, what in (
            (f_slab, torch.from_numpy(s_e).to(CUDA), "F capture"),
            (fst[-1].state.out, torch.from_numpy(f_e).to(CUDA), "F final"),
            (g_slab, torch.from_numpy(g_e).to(CUDA).flip(1, 2), "G capture")):
        require(got.shape == want.shape and torch.equal(got, want),
                f"K5 per tile in 2 stripes, 1024^3 top split: {what} != the "
                "torch engine's")
        err = max(err, _diff(got, want))
    # Three distinct halves of |A| = 512 against the same B and C.
    halves = [(a[:m],), (a[m:].copy(),), (a[:m][::-1].copy(),)]
    ms = time_cuda_ms(forward, halves)
    nbytes = 4 * (m + lb + lc + fst[0].state.cap.numel() + NUM_MATRICES)
    bms, by = bound(m * lb * lc, nbytes, dev)
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "max_abs_err": err,
            "sample": f"the 1024^3 sharded traceback's top split, "
                      f"{m}x{lb}x{lc} free, 2 stripes; plain: torch engine"}


def phase_halo_tb(rng, dev, tb_case) -> dict:
    """The sharded traceback (dist/halo_tb.py) on K5's per-tile form: exact
    against slab_ref in runs and stripes for every variant under default
    and 16-symbol scoring; then hirschberg_align_sharded on the traceback
    phase's 1024^3 triplet in 2 stripes, with single_cells lowered so that
    two levels split on the stripes: it rescores to the score path's score
    and holds the inputs, one launch a band a stripe; its seconds split
    into the sweeps on the stripes (every sharded split and free_jk guard,
    each ending in a synchronize) and the rest (the single-device leaves and
    the host); its top split's two slab sweeps in stripes against the torch
    engine (slab_split_tiles).  Returns K5's per-tile summary row."""
    checked, err = [], 0
    for name in ("default", "sub16"):
        for variant in sk.VARIANTS:
            err = max(err, slab_tiles_case(rng, name, variant))
        checked.append(f"(10, 30, 40)/(9, 9)/{name}/runs of 3, 7/2, 3 "
                       "stripes")

    trip, rec = tb_case
    splits, expect, striped_s = [], [], []
    real = halo_tb.sharded_split_point
    real_guard = halo_tb._sharded_final_vector
    real_run = dh.run_stripes

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        striped_s.append(time.perf_counter() - t0)
        return out

    def spy(a, b, c, m, *args, **kwargs):
        splits.append([len(a), kwargs.get("mode")])
        return timed(real, a, b, c, m, *args, **kwargs)

    def count_bands(dims, row, overlap, start, sweep, band_rows=None):
        stripes = real_run(dims, row, overlap, start, sweep, band_rows)
        expect.append(len(stripes) * len(dh.bands(dims.n_jb,
                                                  band_rows or dims.n_jb)))
        return stripes

    def sharded():
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = halo_tb.hirschberg_align_sharded(
            *trip, mesh=card_mesh(1, 2), single_cells=64 << 20)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, read_launches()

    with mock.patch.object(halo_tb, "sharded_split_point", spy), \
            mock.patch.object(halo_tb, "_sharded_final_vector",
                              functools.partial(timed, real_guard)), \
            mock.patch.object(dh, "run_stripes", count_bands):
        (score, rows), seconds, launches = sharded()
    require(len(splits) >= 2 and splits[0][0] == len(trip[0]),
            f"fewer than two levels split on the stripes: {splits}")
    require(launches["slab_tiles"] == sum(expect) and not launches["slab"],
            f"the sharded traceback made other launches than one a band a "
            f"stripe of K5's per-tile form ({sum(expect)}): {launches}")
    require(score == rec["score"], f"sharded traceback {score} != "
            f"{rec['score']}")
    rescored = rescore_alignment(rows)
    require(rescored == score, f"sharded alignment rescores {rescored}")
    for row, seq in zip(rows, trip):
        require([v for v in row if v != -1] == [int(x) for x in seq],
                "a sharded alignment row without its gaps is not its input")
    row = slab_split_tiles(trip, dev)
    err = max(err, row.pop("max_abs_err"))
    row.update(max_abs_err=err, launches=launches["slab_tiles"],
               main_path_s=seconds)
    emit(phase="halo_tb", cases=checked, max_abs_err=err,
         sharded_1024={"stripes": 2, "single_cells": 64 << 20,
                       "score": score, "seconds": seconds,
                       "striped_s": sum(striped_s),
                       "striped_calls": len(striped_s),
                       "rest_s": seconds - sum(striped_s),
                       "splits": splits, "launches": launches,
                       "columns": len(rows[0])},
         align_return_alignment_1024_s=rec["seconds"], per_tile=row)
    return row


def hetero_tiles_case(trips, scoring, block) -> int:
    """K4's per-tile form in runs of 2 and 11 table entries against
    hetero_ref's whole sweep: faces and final values, exactly."""
    batch = hk.prep_hetero(trips, *block, CUDA)
    want = hk.new_state(batch)
    hk.hetero_ref(batch, scoring, want)
    err = 0
    n = len(batch.tiles)
    for every in (2, 11):
        got = hk.new_state(batch)
        for idx in range(0, n, every):
            hk.sweep_tiles(batch, got, idx, min(every, n - idx), scoring)
        for g, w, f in zip(got, want, want._fields):
            require(torch.equal(g, w), f"K4 per tile {block} runs of "
                    f"{every}: {f} != hetero_ref's")
            err = max(err, _diff(g, w))
    return err


def hetero_in_runs(batch, step=None):
    """K4's per-tile form over a whole dispatch from a fresh state: one run
    of the whole table (as the sharded mosaic sweeps) if ``step`` is None,
    one diagonal a run if "diagonal", else runs of ``step`` entries; the
    final values."""
    state = hk.new_state(batch)
    n = len(batch.tiles)
    if step is None:
        bounds = [0, n]
    elif step == "diagonal":
        bounds = [int(x) for x in batch.diag_start]
    else:
        bounds = list(range(0, n, step)) + [n]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        hk.sweep_tiles(batch, state, int(lo), int(hi - lo))
    return state.out


def hetero_quarters(batch):
    """The per-tile form in runs of a quarter of the table (four launches,
    each ending mid-diagonal)."""
    return hetero_in_runs(batch, max(1, len(batch.tiles) // 4))


def phase_sharded_batch(rng, batch, batch_scores) -> dict:
    """The data axis: K4's per-tile form against hetero_ref in runs that end
    mid-diagonal (default and sub4 scoring; the hetero phase holds K4 under
    four); align_batch_sharded on the 1024-triplet batch over 2 data
    slots sharing the card (K4's per-tile form, one diagonal a slot in
    turn), equal to the batch phase's scores; align_batch_resilient(mesh=)
    with a failure as a slot packs its second dispatch.  Returns K4's
    per-tile summary row without its times, which the timings phase takes
    at the batch's scale (time_hetero)."""
    lens = [(20, 30, 12), (3, 5, 4), (0, 4, 3), (7, 17, 40), (1, 1, 1),
            (25, 9, 26), (60, 70, 50)]
    checked, err = [], 0
    for name in ("default", "sub4"):
        scoring, _, nsym = VARIANTS[name]
        trips = [triplet(rng, n, nsym) for n in lens]
        for block in ((9, 17), bk.choose_block_shape(0, 0, 0)):
            err = max(err, hetero_tiles_case(trips, scoring, block))
            checked.append(f"{len(trips)} problems/{block}/{name}")

    m = card_mesh(2, 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    scores = trialign_torch.align_batch_sharded(batch, mesh=m)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    require(scores == batch_scores, "align_batch_sharded != align_batch")
    err = max(err, max(abs(a - b) for a, b in zip(scores, batch_scores)))
    require(launches["hetero_tiles"] == 2 and not launches["hetero"],
            f"the sharded batch did not run K4's per-tile form once a slot: "
            f"{launches}")
    runs_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = trialign_torch.align_batch_sharded(batch, mesh=m)
        torch.cuda.synchronize()
        runs_s.append(time.perf_counter() - t0)
        require(again == scores, "a sharded rerun disagrees")

    # align_batch_resilient on 256 of the batch over the 2 slots in K4
    # dispatches of 64 (two a slot), a failure raised as a slot packs its
    # second dispatch: the dispatches swept by then drain, and only the
    # rest is dispatched again.
    sub = batch[:256]
    sizes, fired, preps = [], [], {"n": 0}
    real_plan, real_prep = hk.plan_dispatches, hk.prep_hetero

    def flaky_prep(*args, **kwargs):
        preps["n"] += 1
        if preps["n"] == 3:
            raise RuntimeError("injected failure packing a second dispatch")
        return real_prep(*args, **kwargs)

    def batch_fn(trips, scoring, mesh=None, on_scores=None):
        sizes.append(len(trips))
        require(mesh is m, "align_batch_resilient dropped the mesh")

        def record(i, s):
            fired.append(len(sizes))
            on_scores(i, s)

        return mosaic.align_batch_mosaic(trips, scoring, mesh=mesh,
                                         on_scores=record)

    hk.plan_dispatches = functools.partial(real_plan, max_problems=64)
    hk.prep_hetero = flaky_prep
    try:
        got = resilience.align_batch_resilient(sub, mesh=m,
                                               batch_fn=batch_fn,
                                               backoff_s=0.0)
    finally:
        hk.plan_dispatches, hk.prep_hetero = real_plan, real_prep
    first = fired.count(1)
    require(first >= 64 and sizes == [256, 256 - first],
            f"dispatched {sizes} with {first} scores drained before the "
            "failure")
    require(got == batch_scores[:256], "align_batch_resilient(mesh) != batch")

    row = {"max_abs_err": err, "launches": launches["hetero_tiles"],
           "main_path_s": min(runs_s)}
    best = row["main_path_s"]
    emit(phase="sharded_batch", cases=checked, max_abs_err=err,
         batch={"triplets": len(batch), "data_slots": 2, "first_s": first_s,
                "runs_s": runs_s, "best_s": best,
                "gcups": batch_cells(batch) / best / 1e9,
                "triplets_per_s": len(batch) / best, "launches": launches},
         resilient={"triplets": len(sub), "dispatch_size": 64,
                    "attempt_sizes": sizes, "drained_before_failure": first},
         per_tile=row)
    return row


# The multihost phase's striped triplet, tile plane and split gate.
MH_HALO, MH_BLOCK, MH_SINGLE = (64, 400, 600), (33, 33), 2 << 20


def start_multihost() -> list:
    """Start the multihost phase's two worker processes (``python -m
    trialign_torch.dist.worker``, gloo, both on the one card)."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    args = ["--device", CUDA.type, "--halo", ",".join(map(str, MH_HALO)),
            "--block", ",".join(map(str, MH_BLOCK)),
            "--single-cells", str(MH_SINGLE)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "trialign_torch.dist.worker",
         f"tcp://localhost:{port}", "2", str(rank), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for rank in range(2)]
    return procs, time.perf_counter()


def phase_multihost(procs, t0) -> None:
    """The two workers of :func:`start_multihost`: align_batch_multihost
    over a data axis across them, a halo whose model axis spans them and
    the sharded traceback across them, each equal to this process's run of
    the same functions."""
    from trialign_torch.dist.worker import inputs

    try:
        trips, halo_trip = inputs(MH_HALO)
        one = card_mesh(1, 1)
        want = {
            "scores": trialign_torch.align_batch_sharded(
                trips, mesh=card_mesh(4, 1)),
            "halo_values": cpu_ints(dh.halo_values(
                *halo_trip, mesh=one, block_shape=MH_BLOCK))}
        score, rows = halo_tb.hirschberg_align_sharded(
            *halo_trip, mesh=one, single_cells=MH_SINGLE,
            block_shape=MH_BLOCK)
        want.update(tb_score=score, tb_rescore=rescore_alignment(rows),
                    tb_rows=rows)
        require(want["tb_score"] == want["tb_rescore"]
                == max(want["halo_values"])
                == trialign_torch.align(*halo_trip, device=CUDA).score,
                f"one-process multihost references disagree: {want}")
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            require(p.returncode == 0, f"worker exited {p.returncode}: "
                    f"{err[-2000:]}")
            outs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            p.kill()
    seconds = time.perf_counter() - t0
    for rank, rec in enumerate(outs):
        for key, value in want.items():
            require(rec[key] == value, f"rank {rank}: {key} differs from the "
                    "one-process run")
    emit(phase="multihost", processes=2, backend="gloo",
         batch_scores=want["scores"], halo=list(MH_HALO),
         halo_values=want["halo_values"], tb_score=want["tb_score"],
         seconds=seconds)


def run_cli(*args) -> tuple:
    """Run the port's CLI in a subprocess from the repository's root; its
    (stdout, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "trialign_torch.cli", *args],
                         capture_output=True, text=True, cwd=ROOT)
    require(out.returncode == 0, f"cli {' '.join(args)} exited "
            f"{out.returncode}: {out.stderr[-2000:]}")
    return out.stdout, time.perf_counter() - t0


def phase_cli(rng) -> None:
    """selftest, align, bench and batch --sharded run at once (each process
    spends most of its seconds starting), so bench's ms shares the card and
    is no measurement: the timings phase times K3 alone."""
    from trialign_torch.config import decode

    data = os.path.join(ROOT, "trialign_torch", "io", "data")
    # batch --sharded: 70 triplets (the mosaic route over the card's data
    # slot), equal to align_batch.
    trips = batch_triplets(rng, 70, (16, 200))
    with tempfile.NamedTemporaryFile("w", suffix=".tsv", delete=False) as f:
        for t in trips:
            f.write(" ".join(decode(x) for x in t) + "\n")
    runs = {"selftest": ("selftest",),
            "align": ("align", "--json", *(
                x for n in "abc" for x in (
                    f"--{n}-file", os.path.join(data, f"{n.upper()}_seq.dat")))),
            "batch_sharded": ("batch", "--tsv", f.name, "--sharded"),
            "bench": ("bench", "--size", "1024", "--json")}
    with ThreadPoolExecutor(len(runs)) as ex:
        done = dict(zip(runs, ex.map(lambda a: run_cli(*a), runs.values())))
    os.remove(f.name)
    out = done["selftest"][0]
    lines = out.strip().splitlines()
    require(len(lines) == 8 and all(ln.endswith("OK") for ln in lines[:-1])
            and lines[-1] == "backend: cuda  ->  PASS",
            f"cli selftest: {out}")
    got = json.loads(done["align"][0])
    want = align_planes_numpy(*load_reference_triplet())
    require(got["score"] == want, f"cli align {got} != golden {want}")
    want = [f"{i}\t{r.score}" for i, r in
            enumerate(trialign_torch.align_batch(trips))]
    require(done["batch_sharded"][0].strip().splitlines() == want,
            "cli batch --sharded != align_batch")
    bench = json.loads(done["bench"][0])
    require(bench["parity"] == "exact" and bench["mode"] == "blocked",
            f"cli bench: {bench}")
    emit(phase="cli", selftest=lines, align=got,
         bench={k: bench[k] for k in ("size", "mode", "parity", "device")},
         batch_sharded={"triplets": len(trips)},
         seconds={k: v[1] for k, v in done.items()})


def _inputs(rng, shape, count=4):
    return [triplet(rng, shape) for _ in range(count)]


def wavefront_inputs(trips):
    return [wf.prep(*t, CUDA) for t in trips]


def blocked_inputs(trips, block_shape=None):
    out = []
    for a, b, c in trips:
        dims = bk.plan_dims(len(a), len(b), len(c),
                            *(block_shape or bk.choose_block_shape(0, 0, 0)))
        out.append((*bk.prep_blocked(a, b, c, dims, CUDA), len(a), len(b),
                    len(c), dims))
    return out


def time_blocked(trips, block_shape):
    return time_cuda_ms(bk.final_values, blocked_inputs(trips, block_shape))


def in_turns(first, second, inputs) -> dict:
    """Two variants of one sweep timed in turns, first, second, second,
    first (each the minimum over ``inputs``): each one's ms and the four in
    order."""
    turns = [time_cuda_ms(f, inputs) for f in (first, second, second, first)]
    return {"first_ms": min(turns[0], turns[3]),
            "second_ms": min(turns[1:3]), "turns_ms": turns}


# The plain versions repeat their kernels' arithmetic and are no yardstick
# of speed: each is timed in one run (CUDA events) on one of the kernel's
# inputs, after earlier phases have run it.
def time_plain(trip):
    return event_ms(plain_sweep, *trip)[0]


def slab_inputs(trips, variant):
    ev = np.zeros(NUM_MATRICES, np.int32)
    args = []
    for a, b, c in trips:
        la, lb, lc = len(a), len(b), len(c)
        dims = sk._plan(la, lb, lc)
        args.append((*sk.prep_blocked(a, b, c, dims, CUDA), la, lb, lc, dims,
                     variant, ev))
    return args


def dispatch_triplets(trips):
    """The problems of the K4 dispatch that align_batch gives a batch, in
    the dispatch's order (rotated, the longest |A| first); the batch must
    fit one."""
    rot = [mosaic._rotate(t, DEFAULT) for t in trips]
    hb_, wc_ = bk.choose_block_shape(0, 0, 0)
    plan = hk.plan_dispatches([list(map(len, t)) for t in rot], hb_, wc_,
                              hk.default_budget(CUDA))
    require(len(plan) == 1, f"the batch took {len(plan)} dispatches")
    return [rot[i] for i in plan[0]]


def hetero_dispatch(trips):
    """The K4 dispatch that align_batch gives a batch."""
    return hk.prep_hetero(dispatch_triplets(trips),
                          *bk.choose_block_shape(0, 0, 0), CUDA)


def hetero_bound(trips, dev) -> tuple:
    """bound() of one K4 dispatch of ``trips``: each problem's three symbol
    vectors read once, its 7 final values written once."""
    nbytes = 4 * sum(len(a) + len(b) + len(c) + NUM_MATRICES
                     for a, b, c in trips)
    return bound(batch_cells(trips), nbytes, dev)


def time_hetero(rng, trips, dev) -> dict:
    """K4, its per-tile form and hetero_ref on one sample dispatch of the
    batch's problems (the one with the most cells and the one with the
    fewest), held equal and timed on that same dispatch; then K4 and its
    per-tile form (runs of a quarter of the table) at the whole 1024-triplet
    batch (that batch and two more like it), the host's packing of its
    dispatch and its bound, with 16 of its problems' seven values held to
    the torch sweep."""
    sizes = [len(a) * len(b) * len(c) for a, b, c in trips]
    pick = [int(np.argmax(sizes)), int(np.argmin(sizes))]
    rot = [mosaic._rotate(trips[i], DEFAULT) for i in pick]
    sample = hk.prep_hetero(rot, *bk.choose_block_shape(0, 0, 0), CUDA)
    # The kernel is deterministic, so three trials of one dispatch.
    row = {"ms": time_cuda_ms(hk.final_values, [(sample,)] * 3)}
    got = hk.final_values(sample)
    plain_ms, want = event_ms(hk.hetero_ref, sample)
    require(torch.equal(got, want), f"K4 on the batch's problems "
            f"{[list(map(len, t)) for t in rot]}: kernel {cpu_ints(got)} != "
            f"hetero_ref {cpu_ints(want)}")
    sample_err = _diff(got, want)
    cells = batch_cells(rot)
    bms, by = hetero_bound(rot, dev)
    # K4's per-tile form on the same dispatch: one run of the table, as the
    # sharded mosaic sweeps (timed), one diagonal a run and runs of a
    # quarter of the table, which end mid-diagonal; each against the same
    # hetero_ref result.
    tiles = {"ms": time_cuda_ms(hetero_in_runs, [(sample,)] * 3)}
    tiles_err = 0
    for step in (None, "diagonal", max(1, len(sample.tiles) // 4)):
        tiles_got = hetero_in_runs(sample, step)
        require(torch.equal(tiles_got, want), f"K4 per tile in runs of "
                f"{step or 'the table'} on the batch's problems: "
                f"{cpu_ints(tiles_got)} != hetero_ref {cpu_ints(want)}")
        tiles_err = max(tiles_err, _diff(tiles_got, want))

    batches = [trips] + [batch_triplets(rng) for _ in range(2)]
    t0 = time.perf_counter()
    inputs = [(hetero_dispatch(trips),)]
    prep_s = time.perf_counter() - t0
    inputs += [(hetero_dispatch(t),) for t in batches[1:]]
    batch_row = {"ms": time_cuda_ms(hk.final_values, inputs)}
    batch_tiles_ms = time_cuda_ms(hetero_quarters, inputs)
    # At the batch's scale hetero_ref would take minutes: K4 and its
    # per-tile form on 16 of the dispatch's problems (its first, its last
    # and 14 spread between) against the torch sweep, all seven values.
    order = dispatch_triplets(trips)
    got = hk.final_values(inputs[0][0])
    quarters = hetero_quarters(inputs[0][0])
    batch_err = 0
    for p in np.linspace(0, len(order) - 1, 16).round().astype(int):
        want = plain_sweep(*order[p])
        for what, values in (("K4", got), ("K4 per tile in quarters",
                                           quarters)):
            require(torch.equal(values[p], want), f"{what} on the batch, "
                    f"problem {p} {list(map(len, order[p]))}: "
                    f"{cpu_ints(values[p])} != torch sweep {cpu_ints(want)}")
            batch_err = max(batch_err, _diff(values[p], want))
    batch_bms, batch_by = hetero_bound(trips, dev)
    return {**row, "gcups": gcups(cells, row["ms"]),
            "lengths": [list(map(len, t)) for t in rot], "cells": cells,
            "plain": "hetero_ref on the same dispatch, one run",
            "plain_ms": plain_ms, "plain_gcups": gcups(cells, plain_ms),
            "bound_ms": bms, "bound_by": by, "max_abs_err": sample_err,
            "tiles": {**tiles, "plain_ms": plain_ms, "bound_ms": bms,
                      "bound_by": by, "max_abs_err": tiles_err,
                      "cells": cells,
                      "sample": "the batch's largest and smallest problems, "
                                "one run of the table; plain: the same "
                                "hetero_ref run as K4's",
                      "batch_ms": batch_tiles_ms},
            "batch": {**batch_row, "gcups": gcups(batch_cells(trips),
                                                  batch_row["ms"]),
                      "triplets": len(trips), "cells": batch_cells(trips),
                      "host_prep_s": prep_s, "bound_ms": batch_bms,
                      "bound_by": batch_by, "checked_against_sweep": 16,
                      "max_abs_err": batch_err}}


# The candidates of the persistent K3 at 1024^3: tile planes (hb, wc) and
# planes a chunk (at most bk.MAX_CHUNK, what the register step's rings
# take; its block follows from the plane), which K5 is timed over too.
TUNE_TILES = ((17, 17), (33, 17), (33, 33))
TUNE_K3_CHUNKS = (2, 4, 8)


# K4's chunks in the tuning phase.
TUNE_HETERO_CHUNKS = (2, 4, 8)
# K2's candidates: tile planes and chunks, at the shapes of its timings.
TUNE_K2_TILES = ((17, 17), (33, 17), (33, 33))
TUNE_K2_CHUNKS = (2, 4, 8)
K2_SHAPES = ((64, 64, 64), (255, 255, 255), (4096, 255, 255))


def tune_wavefront(rng) -> dict:
    """K2 over TUNE_K2_TILES x TUNE_K2_CHUNKS at each of K2_SHAPES (3
    inputs each; every candidate's values equal the default's on the
    first), and its registers and spills by tile plane and register width."""
    out = {}
    for shape in K2_SHAPES:
        inputs = wavefront_inputs(_inputs(rng, shape, 3))
        want = wf.final_values(*inputs[0])
        row = {}
        for block in TUNE_K2_TILES:
            for chunk in TUNE_K2_CHUNKS:
                fn = functools.partial(wf.final_values, block=block,
                                       chunk=chunk)
                require(torch.equal(fn(*inputs[0]), want),
                        f"K2 {shape} at {block} / chunk {chunk} differs")
                row[f"{block[0]}x{block[1]}/{chunk}"] = time_cuda_ms(
                    fn, inputs)
        out["x".join(map(str, shape))] = row
    out["resources"] = {
        f"{b[0]}x{b[1]}/score_bits={bits}": wf.step_resources(
            b, score_bits=bits) for b in TUNE_K2_TILES for bits in (0, 12)}
    return out


def phase_tuning(rng, batch) -> None:
    """K2 over tile planes and chunks; the persistent K3 at 1024^3 over
    every tile plane and chunk of TUNE_*; K5 "free" at the 2048^3 top
    split's shape over the chunks; K4 on the batch over its chunks."""
    k2 = tune_wavefront(rng)
    trips = _inputs(rng, (1024, 1024, 1024))
    k3 = {}
    for tile in TUNE_TILES:
        inputs = blocked_inputs(trips, tile)
        for chunk in TUNE_K3_CHUNKS:
            k3[f"{tile[0]}x{tile[1]}/{chunk}"] = time_cuda_ms(
                functools.partial(bk.final_values, chunk=chunk), inputs)
    inputs = slab_inputs(_inputs(rng, SPLIT_SHAPE, 3), "free")
    k5 = {chunk: time_cuda_ms(functools.partial(sk.slab_sweep, chunk=chunk),
                              inputs) for chunk in TUNE_K3_CHUNKS}
    # K4 on the 1024-triplet batch (and two more like it) by chunk.
    inputs = [(hetero_dispatch(t),)
              for t in [batch] + [batch_triplets(rng) for _ in range(2)]]
    hb_, wc_ = bk.choose_block_shape(0, 0, 0)
    k4 = {chunk: time_cuda_ms(functools.partial(hk.final_values, chunk=chunk),
                              inputs) for chunk in TUNE_HETERO_CHUNKS}
    # Where the step's warps spend their cycles on the batch (its build
    # with the phase clock): each strip's share of its cycles by phase, and
    # its cycles a plane in the planes phase.
    phases = []
    for w, row in enumerate(hk.step_phases(inputs[0][0])):
        total = sum(row[name] for name in hk.PHASES)
        phases.append({"strip": w, **{name: row[name] / total
                                      for name in hk.PHASES},
                       "planes_cycles_per_plane":
                           row["planes"] / (row["chunks"] * hk.CHUNK)})
    emit(phase="tuning", wavefront_ms_by_tile_chunk=k2,
         blocked_1024_ms_by_tile_chunk=k3,
         slab_free_split_ms_by_chunk=k5,
         hetero_batch_ms_by_chunk=k4,
         hetero_resources=hk.step_resources(hb_, wc_),
         hetero_batch_phase_shares=phases,
         chosen={"wavefront_tile": wf.TILE, "wavefront_chunk": wf.CHUNK,
                 "blocked_tile": bk.choose_block_shape(0, 0, 0),
                 "blocked_threads": bk.THREADS, "chunk": bk.CHUNK,
                 "hetero_chunk": hk.CHUNK})


# int32 operations a cell of the direct engine's choice step
# (csrc/plane_step.cuh cell_step_choices), a max that keeps its argmax
# counted as one: six targets of seven sources each (7 adds of a weight, 6
# max-with-argmax steps; an argmax takes every source, ungrouped), 3 adds
# of a pair score (Ixy, Iyz, Ixz), M's add of S3 and the 6 steps of max7
# with its argmax over the stored values.
CHOICE_OPS = 6 * (7 + 6) + 3 + 1 + 6


def bound(cells, nbytes, dev, ops=None) -> tuple:
    """(least ms the card could take, "bytes" or "operations") for a sweep
    of ``cells`` cells at ``ops`` int32 operations a cell
    (op_count(Scoring()), the grouped step's, by default), at the peak rate
    K6 measured in this run, moving ``nbytes``."""
    ops = op_count(DEFAULT) if ops is None else ops
    ops_ms = cells * ops / dev["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_timings(rng, dev, batch) -> tuple:
    """The timing rows, and K5's largest difference from the torch engine at
    the split's shape; ``batch`` is the batch phase's 1024 triplets."""
    rows = {}
    for shape in K2_SHAPES:
        rows["wavefront_" + "x".join(map(str, shape))] = time_k2(
            rng, shape, dev)
    for n in K3_TIMED:
        trips = _inputs(rng, (n, n, n))
        inputs = blocked_inputs(trips)
        row = {"ms": time_cuda_ms(bk.final_values, inputs)}
        got = bk.final_values(*inputs[0])
        cells = n ** 3
        # Inputs read once (3 symbol vectors), the final vector written.
        bms, by = bound(cells, 4 * (3 * n + NUM_MATRICES + 1), dev)
        rows[f"blocked_{n}"] = {**row, "gcups": gcups(cells, row["ms"]),
                                "bound_ms": bms, "bound_by": by}
        # All seven values against the torch sweep (about 15 s at 1536^3).
        plain_ms, plain = event_ms(plain_sweep, *trips[0])
        require(torch.equal(got, plain),
                f"K3 at {n}^3 differs from the torch sweep")
        rows[f"blocked_{n}"].update(plain_ms=plain_ms,
                                    plain_gcups=gcups(cells, plain_ms))
    for n, npack in CHAIN_BENCH:
        dims = bk.plan_dims_packed(n, n, n, npack)
        inputs = []
        for _ in range(3):
            a_list = [triplet(rng, (n,))[0] for _ in range(npack)]
            b, c = triplet(rng, (n, n))
            inputs.append((*bk.prep_chain(a_list, b, c, dims, CUDA), n, n, n,
                           dims))
        ms = time_cuda_ms(bk.chain_values, inputs)
        bms, by = bound(n ** 3, 4 * (3 * n + NUM_MATRICES), dev)
        rows[f"chain_{n}x{npack}"] = {
            "ms": ms, "ms_per_alignment": ms / npack,
            "bound_ms_per_alignment": bms, "bound_by": by}
    la, lb, lc = SPLIT_SHAPE
    trips = _inputs(rng, SPLIT_SHAPE)
    dims = sk._plan(la, lb, lc)
    # Inputs read once; the capture (every tile's plane) and final written.
    nbytes = 4 * (la + lb + lc + dims.n_jb * dims.n_kb * NUM_MATRICES
                  * dims.hb * dims.wc + NUM_MATRICES)
    bms, by = bound(la * lb * lc, nbytes, dev)
    # K5 against the torch engine at the shape the 2048^3 traceback gives
    # it (slab_ref would take too long there): the slab and final vector of
    # "free", the slab of "bwd" with a pinned end state.  The engine's time
    # is that of this comparison's run.
    split = {v: slab_case(rng, SPLIT_SHAPE, None, "default", v,
                          tiled_ref=False) for v in ("free", "bwd")}
    split_err = max(e for e, _ in split.values())
    for variant in ("free", "bwd"):
        row = {"ms": time_cuda_ms(sk.slab_sweep, slab_inputs(trips, variant))}
        plain_ms = split[variant][1]
        rows[f"slab_{variant}_{la}x{lb}x{lc}"] = {
            **row, "gcups": gcups(la * lb * lc, row["ms"]),
            "plain": "torch engine", "plain_ms": plain_ms,
            "plain_gcups": gcups(la * lb * lc, plain_ms),
            "bound_ms": bms, "bound_by": by}
    # K5 at a 16S triplet's top split, each variant the split sweeps, held
    # to the torch engine as at the 2048^3 split before it is timed.
    la, lb, lc = SPLIT_16S
    trips = _inputs(rng, SPLIT_16S)
    dims = sk._plan(la, lb, lc)
    bms, by = bound(la * lb * lc, 4 * (la + lb + lc + dims.n_jb * dims.n_kb
                                       * NUM_MATRICES * dims.hb * dims.wc
                                       + NUM_MATRICES), dev)
    for variant in ("free", "free_jk", "bwd"):
        err, plain_ms = slab_case(rng, SPLIT_16S, None, "default", variant,
                                  tiled_ref=False)
        split_err = max(split_err, err)
        ms = time_cuda_ms(sk.slab_sweep, slab_inputs(trips, variant))
        rows[f"slab_{variant}_{la}x{lb}x{lc}"] = {
            "ms": ms, "gcups": gcups(la * lb * lc, ms),
            "plain": "torch engine", "plain_ms": plain_ms,
            "plain_gcups": gcups(la * lb * lc, plain_ms), "bound_ms": bms,
            "bound_by": by}
    # K3's per-tile form at the main path's 1024^3 in quarters, and the
    # halo's band heights at 1024^3 in 2 stripes sharing the card, and in 4
    # stripes the model's band against one band a stripe, in turns.
    n = 1024
    quarters = quarter_inputs(_inputs(rng, (n, n, n), 3))
    rows["blocked_tiles_1024_quarters"] = {
        "ms": time_cuda_ms(tiles_in_runs, quarters)}
    block = bk.choose_block_shape(n, n, n)
    trips = [(t,) for t in _inputs(rng, (n, n, n), 3)]

    def halo_sweep(ndev, band):
        row = dh.model_row(card_mesh(1, ndev))
        return lambda t: dh.sweep_stripes(*t, DEFAULT, row, block, True, band)

    model = {d: dh.halo_efficiency(n, n, n, d, block, True)["band"]
             for d in (2, 4)}
    rows["halo_1024_2_stripes_by_band_rows"] = {
        "model_band_rows": model[2], **{
            str(r): time_cuda_ms(halo_sweep(2, r), trips)
            for r in (1, 2, 4, 8, 16, 32)}}
    turns = [time_cuda_ms(halo_sweep(4, r), trips)
             for r in (16, 32, 32, 16)]
    rows["halo_1024_4_stripes_by_band_rows"] = {
        "model_band_rows": model[4], "16": min(turns[0], turns[3]),
        "32": min(turns[1], turns[2]), "turns_ms": turns}
    rows["blocked_1024_one_block_an_sm"] = one_block_an_sm(
        blocked_inputs([t for t, in trips]), quarters, halo_sweep(2, None),
        trips)
    rows["hetero_sample"] = time_hetero(rng, batch, dev)
    rows["direct_1024"] = time_direct(rng, dev)
    emit(phase="timings", **rows, slab_split_max_abs_err=split_err)
    return rows, split_err


def time_direct(rng, dev, n=1024) -> dict:
    """The direct engine's kernels at 1024^3, the main path's direct size:
    the choice kernel (minimum over 3 triplets after a warm-up) beside one
    run of its plain version, the walk kernel on the kernel's buffers
    beside walk_ref, each with its bound; then direct_traceback (host
    seconds, synchronised) in turns with the plain engine (kernel, plain,
    plain, kernel), the results equal."""
    lens = (n, n, n)
    trips = _inputs(rng, lens, 3)

    def sweep(a, b, c):
        return direct.choices(a, b, c, DEFAULT, "free", None, CUDA)

    ms = time_cuda_ms(sweep, trips)
    plain_ms = event_ms(direct._choices, *trips[0], DEFAULT, "free", None,
                        CUDA)[0]
    cells = (n + 1) ** 3
    # CHOICE_OPS a cell; symbols read once; 3 B of choices written for
    # every cuboid slot and the final vector.
    bms, by = bound(cells, 4 * (3 * n + NUM_MATRICES) + 3 * cells, dev,
                    CHOICE_OPS)
    choices_row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "gcups": gcups(cells, ms),
                   "plain": "direct._choices (torch sweep)"}
    walks = []
    for t in trips:
        final, lo, hi = sweep(*t)
        walks.append((lo, hi, int(torch.argmax(final)), *lens, "free"))
    ms = time_cuda_ms(direct.walk, walks)
    plain_ms, res = event_ms(direct.walk_ref, *walks[0])
    steps = int(res[0])
    del walks
    torch.cuda.empty_cache()
    # A step reads the one packed entry its state names (2 B of the int16
    # buffer for states 0-4, 1 B of the byte buffer for 5-6) and writes
    # its 4-byte state; the count and the stop are 16 B.
    states = res[4:4 + steps]
    nbytes = int(torch.where(states < 5, 2, 1).sum()) + 4 * steps + 16
    bms, by = bound(0, nbytes, dev)
    walk_row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by, "walk_steps": steps, "walk_bytes": nbytes,
                "plain": "direct.walk_ref (torch operations)"}

    def traceback(plain):
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(mock.patch.object(
                    direct, "choices", direct._choices))
                stack.enter_context(mock.patch.object(
                    direct, "walk", direct.walk_ref))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = direct.direct_traceback(*trips[0], device=CUDA)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out

    turns = [traceback(p) for p in (False, True, True, False)]
    require(all(out == turns[0][1] for _, out in turns),
            "direct_traceback at 1024^3: the plain engine's alignment "
            "differs from the kernels'")
    seconds = [t for t, _ in turns]
    return {"choices": choices_row, "walk": walk_row,
            "traceback_1024": {"kernels_s": min(seconds[0], seconds[3]),
                               "plain_s": min(seconds[1], seconds[2]),
                               "turns_s": seconds}}


def time_k2(rng, shape, dev) -> dict:
    """K2 at ``shape`` (3 inputs); its launches a call; 20 calls queued
    without waiting: the host's microseconds a call and the card's
    milliseconds a call between two events around them (the card's time
    where it outpaces the host); K3 on the same triplets; the plain sweep
    at 255^3 and below (one run); the bound."""
    trips = _inputs(rng, shape, 3)
    inputs = wavefront_inputs(trips)
    row = {"ms": time_cuda_ms(wf.final_values, inputs)}
    torch.cuda.synchronize()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(20):
        wf.final_values(*inputs[0])
    row["host_us_a_call"] = (time.perf_counter() - t0) / 20 * 1e6
    end.record()
    end.synchronize()
    row["queued_ms_a_call"] = start.elapsed_time(end) / 20
    row["launches_a_call"] = read_launches()["wavefront"] / 20
    row["k3_ms"] = time_cuda_ms(bk.final_values, blocked_inputs(trips))
    cells = int(np.prod(shape))
    row["gcups"] = gcups(cells, row["ms"])
    if max(shape) <= 255:
        row["plain_ms"] = time_plain(trips[0])
        row["plain_gcups"] = gcups(cells, row["plain_ms"])
    else:
        row["plain_ms"] = None
    # Inputs read once (3 symbol vectors), the final vector written.
    row["bound_ms"], row["bound_by"] = bound(
        cells, 4 * (sum(shape) + NUM_MATRICES + 1), dev)
    return row


def one_block_an_sm(whole, quarters, halo, trips) -> dict:
    """K3 at 1024^3 with its grid capped at one block an SM, in turns with
    the occupancy's grid (two blocks an SM): the whole-grid sweep, its
    per-tile form in quarters and the halo in 2 stripes sharing the card.
    For each, both ms and the four turns, default first."""
    sms = torch.cuda.get_device_properties(CUDA).multi_processor_count
    real = bk.sweep_run

    def capped_halo(t):
        with mock.patch.object(bk, "sweep_run",
                               functools.partial(real, blocks=sms)):
            return halo(t)

    out = {"blocks": sms}
    for name, default, capped, inputs in (
            ("whole", bk.final_values,
             functools.partial(bk.final_values, blocks=sms), whole),
            ("quarters", tiles_in_runs, functools.partial(
                in_runs, functools.partial(bk.sweep_tiles, blocks=sms)),
             quarters),
            ("halo_2_stripes", halo, capped_halo, trips)):
        turns = in_turns(default, capped, inputs)
        out[name] = {"ms": turns["first_ms"], "one_block_an_sm_ms":
                     turns["second_ms"], "turns_ms": turns["turns_ms"]}
    return out


def bench_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.strip()]


def phase_bench(dev) -> None:
    """The port's bench: its parent under a small budget, then its runner
    here with one stage cut by a cap (see the module's docstring)."""
    t0 = time.perf_counter()
    env = {**os.environ, "TRIALIGN_BENCH_BUDGET_S": str(BENCH_BUDGET_S)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "trialign_torch.bench"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_BUDGET_S + 120)
    finally:
        if proc.returncode is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    parent_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"bench parent exited {proc.returncode}: {err[-3000:]}")
    lines = bench_lines(out)
    final = lines[-1]
    name, power = (v.strip() for v in dev["smi"].split(","))
    require(final["parity"] == "exact" and final["backend"] == "cuda"
            and final["value"] == round(final["blocked_1024_gcups"], 3)
            and final["blocked_1k_launches"].get("blocked", 0) > 0,
            f"bench headline not exact on K3: {final}")
    require((final["device"], final["power_limit"]) == (name, power),
            f"bench line's card {final['device']}, {final['power_limit']} "
            f"!= nvidia-smi's {dev['smi']}")
    # Every stage landed (its launches in the line) or is named with its
    # reason; a stage cut by its timeout is followed by later lines.
    failed, skipped = final.get("failed", {}), final.get("skipped", {})
    for stage, _, _ in bench.CUDA_STAGES:
        require(f"{stage}_launches" in final or stage in failed
                or stage in skipped, f"bench stage {stage} is not named")
    for stage, reason in failed.items():
        first = next(i for i, ln in enumerate(lines)
                     if stage in ln.get("failed", {}))
        require(reason.startswith("timeout") and (
            first < len(lines) - 1 or stage == bench.CUDA_STAGES[-1][0]),
            f"bench stage {stage} failed ({reason}), or no line came "
            "after its cut")
    runner = bench.Runner()
    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        runner.run_stage("probe", 20, force=True)
        runner.run_stage("traceback_4k", 20, cap=BENCH_CUT_S)
        runner.run_stage("parity_fixtures", 10)
        runner.run_stage("single_stream_255", 10)
    runner_s = time.perf_counter() - t1
    cut = bench_lines(buf.getvalue())
    require(runner.failed == {"traceback_4k":
                              f"timeout after {BENCH_CUT_S:.0f} s"},
            f"bench stage cut: {runner.failed}")
    require(runner.landed == ["probe", "parity_fixtures",
                              "single_stream_255"],
            f"bench stages after the cut: {runner.landed}")
    require(len(cut) == 3 and "traceback_4k" in cut[0]["failed"],
            f"bench lines around the cut: {cut}")
    last = runner.fields
    require(last["parity"] == "exact"
            and last["reference_dat_score"] == align_planes_numpy(
                *load_reference_triplet())
            and last["parity_fixtures_launches"].get("wavefront", 0) > 0
            and last["parity_fixtures_launches"].get("blocked", 0) > 0
            and last["single_stream_255_launches"].get("wavefront", 0) > 0,
            f"bench child stages: {last}")
    emit(phase="bench", parent_s=parent_s, parent_line=final,
         parent_lines=len(lines), runner_s=runner_s, runner_lines=cut)


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
    sched_err = phase_schedule(rng)
    k3_err = max(k3_err, sched_err["blocked"])
    k5_err = max(k5_err, sched_err["slab"])
    k4_err = max(phase_hetero(rng), sched_err["hetero"])
    # Its own generator, so that every other phase draws what it drew before.
    direct_err = phase_direct(np.random.default_rng([args.seed, 13]))
    launches, headline = phase_main_path(rng)
    tb_launches, tb_case = phase_traceback(rng)
    launches.update(tb_launches)
    launches["hetero"], batch, batch_scores = phase_batch(rng)
    phase_protfam_batch(int(rng.integers(1 << 31, 1 << 40)))
    # K6's measured peak first: every bound below divides by it.
    k6 = phase_vpu(rng, dev)
    tiles = phase_checkpoint(rng, dev, headline, batch, batch_scores)
    chain = phase_chain(rng, dev)
    chain["max_abs_err"] = max(chain["max_abs_err"],
                               sched_err["blocked_chain"])
    halo = phase_halo(rng, headline)
    tiles["max_abs_err"] = max(tiles["max_abs_err"], halo["max_abs_err"],
                               sched_err["blocked_tiles"])
    slab_tiles = phase_halo_tb(rng, dev, tb_case)
    slab_tiles["max_abs_err"] = max(slab_tiles["max_abs_err"],
                                    sched_err["slab_tiles"])
    hetero_tiles = phase_sharded_batch(rng, batch, batch_scores)
    for name, row in (("blocked_tiles", tiles), ("blocked_chain", chain),
                      ("vpu", k6), ("slab_tiles", slab_tiles),
                      ("hetero_tiles", hetero_tiles)):
        launches[name] = row.pop("launches")
    # The two worker processes and the four CLI processes spend most of
    # their seconds starting: they start together.
    workers, t0 = start_multihost()
    try:
        phase_cli(rng)
        phase_multihost(workers, t0)
    finally:
        for p in workers:
            p.kill()
    phase_tuning(rng, batch)
    rows, split_err = phase_timings(rng, dev, batch)
    phase_bench(dev)
    k5_err = max(k5_err, split_err)
    k4 = rows["hetero_sample"]
    k4_err = max(k4_err, k4["max_abs_err"])
    tiles_at_scale = k4.pop("tiles")
    hetero_tiles["max_abs_err"] = max(hetero_tiles["max_abs_err"],
                                      tiles_at_scale.pop("max_abs_err"))
    hetero_tiles.update(tiles_at_scale)
    require("jax" not in sys.modules and "trialign" not in sys.modules,
            "JAX or the JAX package was imported")
    direct_rows = rows["direct_1024"]
    split = "x".join(map(str, SPLIT_SHAPE))
    # K3's per-tile form's, chain mode's and K6's ms, plain_ms and bound_ms
    # are of a sample on which the plain version finishes (it would take
    # minutes to hours at the main path's shapes), with the main path's
    # kernel ms beside them; K4's and its per-tile form's are of two of the
    # batch's problems, its largest and its smallest; K5's per-tile form's
    # are at the 1024^3 sharded traceback's top split; the direct engine's
    # at 1024^3.  Eight pallas_call sites, nine rows: K3's chain mode keeps a
    # row of its own; then the direct engine's two programs, which are XLA
    # in the JAX package, not pallas_call sites.
    k3_row = rows["blocked_1024"]
    chain_times = {f"{k}_{n}x{p}": rows[f"chain_{n}x{p}"][k]
                   for n, p in CHAIN_BENCH
                   for k in ("ms_per_alignment",)}
    k5_free, k5_bwd = rows[f"slab_free_{split}"], rows[f"slab_bwd_{split}"]
    quarters = rows["blocked_tiles_1024_quarters"]
    tiles.update(main_path_ms_in_quarters=quarters["ms"])
    kernels = [
        ("wavefront", "wavefront", "trialign/kernels/wavefront.py:112",
         k2_err, rows["wavefront_255x255x255"],
         {"shape": "255^3",
          "k3_ms": rows["wavefront_255x255x255"]["k3_ms"],
          **{f"{k}_{shape}": rows[f"wavefront_{shape}"][k]
             for shape in ("64x64x64", "4096x255x255")
             for k in ("ms", "k3_ms", "bound_ms")}}),
        ("blocked", "blocked", "trialign/kernels/blocked.py:225", k3_err,
         k3_row, {f"{k}_{n}": rows[f"blocked_{n}"][k]
                  for n in (512, 1536) for k in ("ms", "bound_ms")}),
        ("blocked_tiles", "blocked", "trialign/kernels/blocked.py:859",
         tiles.pop("max_abs_err"), tiles, tiles),
        ("blocked_chain", "blocked", "trialign/kernels/blocked.py:906",
         chain.pop("max_abs_err"), chain, {**chain, **chain_times}),
        ("hetero", "hetero", "trialign/kernels/blocked.py:990", k4_err, k4,
         {"cells": k4["cells"], "batch_ms": k4["batch"]["ms"],
          "batch_bound_ms": k4["batch"]["bound_ms"],
          "batch_cells": k4["batch"]["cells"]}),
        ("hetero_tiles", "hetero", "trialign/kernels/blocked.py:1075",
         hetero_tiles.pop("max_abs_err"), hetero_tiles, hetero_tiles),
        ("slab", "slab", "trialign/kernels/slab.py:74", k5_err, k5_free,
         {"bwd_ms": k5_bwd["ms"]}),
        ("slab_tiles", "slab", "trialign/kernels/slab.py:587",
         slab_tiles.pop("max_abs_err"), slab_tiles, slab_tiles),
        ("vpu", "vpu", "trialign/benchmarks.py:286", k6.pop("max_abs_err"),
         k6, k6),
        # The direct engine is XLA in the JAX package, not a pallas_call.
        ("direct_choices", "slab", "trialign/traceback/direct.py:157",
         direct_err["direct_choices"], direct_rows["choices"],
         {"tpu_form": "XLA (lax.scan), not a pallas_call", "shape": "1024^3",
          "gcups": direct_rows["choices"]["gcups"],
          "traceback_1024": direct_rows["traceback_1024"]}),
        ("direct_walk", "walk", "trialign/traceback/direct.py:321",
         direct_err["direct_walk"], direct_rows["walk"],
         {"tpu_form": "XLA (while_loop), not a pallas_call",
          "shape": "1024^3", "walk_steps": direct_rows["walk"]["walk_steps"]}),
    ]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    emit(kernels=[
        {"name": name, "route": "cuda",
         "source": f"trialign_torch/csrc/{src}.cu", "replaces": replaces,
         "launches": launches[name], "max_abs_err": err,
         **{k: row[k] for k in keys}, "library_ms": None,
         **{k: v for k, v in extra.items() if k not in keys}}
        for name, src, replaces, err, row, extra in kernels
    ])
    print(dev["smi"], flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
