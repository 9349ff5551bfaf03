"""The port's benchmark: ``python -m trialign_torch.bench``.

The twin of the root ``bench.py`` for the PyTorch/CUDA port, on one NVIDIA
GPU.  It prints an incrementally enriched JSON line to stdout after every
stage:

  {"metric": ..., "value": N, "unit": "GCUPS", "vs_baseline": N,
   "parity": ..., "backend": "cuda", "device": ..., "power_limit": ..., ...}

The last line is the complete result, but every line is a valid one.
``device`` and ``power_limit`` are what ``nvidia-smi`` says of the card, so
each number the line carries is labelled with it.  A stage that failed,
timed out or was skipped is named in ``failed`` or ``skipped`` with its
reason.

The parent process imports only the standard library and never touches the
card; every stage runs in its own subprocess (``python -m
trialign_torch.bench --stage NAME``) with its own timeout, so that a sticky
CUDA error, a persistent kernel's watchdog trap or an out-of-memory stage
kills that stage's process and nothing else.  A global wall-clock budget
(``TRIALIGN_BENCH_BUDGET_S``, default 1100 s) gates the stages by their
estimates.  Stage stderr is teed to ``trialign_torch_bench_err.log`` at the
root of the checkout.

The headline is K3's DP cell-updates a second on one card at 1024^3 (one
cell-update = one (i, j, k) lattice site across all 7 matrices), checked
against the C++ oracle on the very triplet measured; ``vs_baseline`` is its
ratio to the reference ASIC's 12.4 GCUPS at 512^3.  ``roofline_fraction``
is the headline over the ceiling from the faster int32 rate K6 measured
(DPX); the assumed int32 ceiling ``roofline_gcups`` (SMs x 64 lanes x the
SM clock) is printed beside it.

The parent exits 0 only when the headline landed with exact parity; a
parity failure in any stage exits 1.  A stage that timed out or ran out of
memory is named and changes nothing else.  Without a CUDA device the
parent runs ``cpu_smoke`` in a child with CUDA hidden, prints that line
with ``"backend": "cpu"`` and exits 2: a run with a card never gives way to
the plain CPU versions.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERR_LOG = os.path.join(ROOT, "trialign_torch_bench_err.log")

# The reference ASIC at 512^3 (pic/Result.png), the figure vs_baseline
# divides by; inlined from trialign_torch.benchmarks.BASELINE_ASIC_GCUPS
# (tests/test_torch_bench.py holds the two equal) so that the parent never
# imports torch.
BASELINE_ASIC_GCUPS = 12.4
HEADLINE_METRIC = ("single-card DP cell-updates/s at 1024^3 "
                   "(7-matrix cells, blocked CUDA sweep K3)")
CPU_METRIC = ("CPU smoke GCUPS at 32^3 (plain CPU versions of the kernels; "
              "no CUDA device)")
# A child's last stdout line on success, and on a failure it caught.
FIELDS, FAILED = "FIELDS ", "FAILED "
# Below this many seconds of budget a stage is not started.
GATE_S = 75.0


def say(msg: str) -> None:
    """A stage's progress line, on its stderr (the parent tees it)."""
    print(msg, file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# Stages (run inside per-stage subprocesses).  Each returns a dict of
# result fields; sizes and the device are keyword defaults so that the
# tests can call each one small on the CPU.
# ----------------------------------------------------------------------


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.splitlines()[0].strip()


def stage_probe():
    """The card's name and power limit, and every kernel built: no later
    stage's timeout pays for nvcc.  Without a card, backend "cpu"."""
    import torch

    if not torch.cuda.is_available():
        return {"backend": "cpu", "device": "cpu", "power_limit": None}
    from trialign_torch import _build, native

    name, power = (s.strip() for s in _smi("name,power.limit").split(","))
    t0 = time.perf_counter()
    _build.build()
    for src in _build.SOURCES:
        _build.load(src)
    native.build()
    return {"backend": "cuda", "device": name, "power_limit": power,
            "torch_device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "build_s": time.perf_counter() - t0}


def stage_cpu_smoke(n=32, device="cpu"):
    """K2's plain version against the golden model on a 12-symbol triplet,
    and its single-stream rate at n^3 on the CPU."""
    import numpy as np

    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring
    from trialign_torch.golden import align_planes_numpy
    from trialign_torch.kernels.wavefront import align_wavefront

    scoring = Scoring()
    rng = np.random.default_rng(1)
    a, b, c = (rng.integers(0, 4, 12).astype(np.uint8) for _ in range(3))
    got = align_wavefront(a, b, c, scoring, device=device)
    want = align_planes_numpy(a, b, c, scoring)
    if got != want:
        raise AssertionError(f"CPU parity FAILED: {got} != {want}")
    g, dt = B.bench_single_stream(n, 2, scoring, device=device)
    say(f"single-stream {n}^3 (CPU smoke): {dt*1e3:.2f} ms")
    return {"cpu_smoke_gcups": g, "parity": "exact"}


def stage_blocked_1k(n=1024, repeats=4, device="cuda"):
    """The headline: K3 at n^3, and the C++ oracle on the measured triplet
    (host time, outside the measured window)."""
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring
    from trialign_torch.native import score_native

    g, dt, score0, trip0 = B.bench_blocked(n, repeats, Scoring(),
                                           return_score0=True, device=device)
    say(f"blocked {n}^3: {dt*1e3:.3f} ms/alignment -> {g:.2f} GCUPS")
    t0 = time.perf_counter()
    want = score_native(*trip0)
    if score0 != want:
        raise AssertionError(
            f"{n}^3 parity vs C++ oracle FAILED: {score0} != {want}")
    oracle_s = time.perf_counter() - t0
    say(f"parity OK at {n}^3 vs the C++ oracle ({score0}, {oracle_s:.1f} s)")
    return {"blocked_1024_gcups": g, "blocked_1024_ms": dt * 1e3,
            "blocked_1024_score": score0, "blocked_1024_oracle_s": oracle_s,
            "parity": "exact"}


def stage_parity_fixtures(device="cuda"):
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring

    score = B.parity_check(Scoring(), include_alt=False, device=device)
    say(f"parity OK on the reference dat triplet (score {score}, "
        "wavefront + blocked)")
    return {"parity": "exact", "reference_dat_score": int(score)}


def stage_single_512(n=512, repeats=8, device="cuda"):
    """The ASIC's own protocol: one n^3 alignment, ramp included
    (pic/Result.png Table III: 10.82 ms at 512^3)."""
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring

    g, dt = B.bench_blocked(n, repeats, Scoring(), device=device)
    say(f"blocked {n}^3 single-stream: {dt*1e3:.3f} ms -> {g:.2f} GCUPS "
        "(ASIC: 10.82 ms)")
    return {"blocked_512_single_ms": dt * 1e3, "blocked_512_single_gcups": g}


def stage_chain_512(n=512, npack=16, device="cuda"):
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring

    g, dt = B.bench_blocked_chain(n, npack, Scoring(), device=device)
    say(f"blocked {n}^3 chained x{npack} (shared B and C, one sweep): "
        f"{dt*1e3:.3f} ms/alignment -> {g:.2f} GCUPS")
    return {"blocked_512_ms": dt * 1e3, "blocked_512_gcups": g}


def stage_hetero_512(n=512, npack=16, device="cuda"):
    """npack fully distinct triplets of about n^3 through K4."""
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring
    from trialign_torch.native import score_native

    g, dt = B.bench_hetero_chain(n, npack, Scoring(),
                                 parity_oracle=score_native, device=device)
    say(f"hetero {n}^3 chained x{npack} (distinct triplets): "
        f"{dt*1e3:.3f} ms/alignment -> {g:.2f} GCUPS")
    return {"hetero_512_ms": dt * 1e3, "hetero_512_gcups": g}


def stage_batch_mixed(n=1024, lo=128, hi=512, device="cuda"):
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring

    g, s, tps = B.bench_batch_mixed(n, Scoring(), lo=lo, hi=hi,
                                    device=device)
    say(f"batch {n} triplets len {lo}-{hi} end to end: {s:.3f} s -> "
        f"{g:.2f} GCUPS aggregate, {tps:.0f} triplets/s (parity "
        "spot-checked)")
    return {"batch_mixed_1024_s": s, "batch_mixed_1024_gcups": g,
            "batch_mixed_1024_triplets_per_s": tps}


def stage_blocked_2k(n=2048, repeats=2, device="cuda"):
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring

    g, dt = B.bench_blocked(n, repeats, Scoring(), device=device)
    say(f"blocked {n}^3: {dt*1e3:.3f} ms -> {g:.2f} GCUPS")
    return {"blocked_2048_gcups": g, "blocked_2048_ms": dt * 1e3}


def stage_chain_1k(n=1024, npack=8, device="cuda"):
    """The reference passes its TPU block shape (520, 384, 16); the port
    sweeps its own tile plane (block_shape=None)."""
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring

    g, dt = B.bench_blocked_chain(n, npack, Scoring(), device=device)
    say(f"blocked {n}^3 chained x{npack}: {dt*1e3:.3f} ms/alignment -> "
        f"{g:.2f} GCUPS")
    return {"blocked_1024_chained_gcups": g,
            "blocked_1024_chained_ms": dt * 1e3}


def _traceback_at(n, seed, key, trials, device):
    """A full alignment (score and traceback) at n^3: one warm-up run,
    checked (it rescores to its score, its rows are the inputs, and the
    score equals the score path's), then the minimum of ``trials`` timed
    runs."""
    import numpy as np
    import torch

    from trialign_torch.api import align
    from trialign_torch.golden import rescore_alignment

    rng = np.random.default_rng(seed)
    a, b, c = (rng.integers(0, 4, n).astype(np.uint8) for _ in range(3))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = align(a, b, c, return_alignment=True, device=device)
    first = time.perf_counter() - t0
    say(f"{n}^3 full alignment, first run: {first:.2f} s")
    rescored = rescore_alignment(res.alignment)
    if rescored != res.score:
        raise AssertionError(
            f"{n}^3 traceback parity FAILED: rescored {rescored} != "
            f"{res.score}")
    for row, seq in zip(res.alignment, (a, b, c)):
        if [v for v in row if v != -1] != seq.tolist():
            raise AssertionError(
                f"{n}^3 traceback FAILED: a row without its gaps is not "
                "its input")
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        align(a, b, c, return_alignment=True, device=device)
        best = min(best, time.perf_counter() - t0)
    say(f"{n}^3 full alignment (score + traceback, warm): {best:.2f} s "
        "(rescore-validated)")
    out = {key: best, f"{key[:-2]}_first_s": first}
    if on_card:
        out[f"{key[:-2]}_peak_bytes"] = torch.cuda.max_memory_allocated()
    path = align(a, b, c, device=device).score
    if path != res.score:
        raise AssertionError(
            f"{n}^3 traceback parity FAILED: {res.score} != score path "
            f"{path}")
    return out


def stage_traceback_512(n=512, device="cuda"):
    """Full alignment at 512^3 -- the capability the reference stubbed out
    (src/PE_1cyc.v:12-14,30)."""
    return _traceback_at(n, 13, "traceback_512_s", 3, device)


def stage_traceback_1k(n=1024, device="cuda"):
    return _traceback_at(n, 13, "traceback_1k_s", 2, device)


def stage_traceback_2k(n=2048, device="cuda"):
    """Full alignment at 2k^3: the Hirschberg top split sweeps on K5, the
    halves on the direct engine."""
    return _traceback_at(n, 13, "traceback_2k_s", 2, device)


def stage_traceback_4k(n=4096, device="cuda"):
    return _traceback_at(n, 29, "traceback_4k_s", 2, device)


def stage_traceback_8k(n=8192, device="cuda"):
    """One timed run after the warm one, as in the reference."""
    return _traceback_at(n, 31, "traceback_8k_s", 1, device)


def stage_roofline(device="cuda"):
    """The card's ceilings (trialign_torch.benchmarks.roofline): K6's
    measured int32 and DPX rates unless TRIALIGN_ROOFLINE_LIVE=0.  Raises
    without a CUDA device."""
    import torch

    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring

    if torch.device(device).type != "cuda":
        raise RuntimeError("the roofline stage measures a CUDA device")
    live = os.environ.get("TRIALIGN_ROOFLINE_LIVE", "1") == "1"
    rf = B.roofline(Scoring(), measure_live=live, device=device)
    say(f"roofline: {rf['ops_per_cell']} int32 ops/cell; ceiling "
        f"{rf['roofline_gcups']:.1f} GCUPS assumed, "
        f"{rf.get('roofline_gcups_dpx_measured', float('nan')):.1f} from "
        "K6's DPX rate")
    return {k: v for k, v in rf.items() if k != "roofline_fraction"}


def stage_single_stream_255(n=255, repeats=16, device="cuda"):
    from trialign_torch import benchmarks as B
    from trialign_torch.config import Scoring

    g, dt = B.bench_single_stream(n, repeats, Scoring(), device=device)
    say(f"single-stream {n}^3: {dt*1e3:.3f} ms -> {g:.2f} GCUPS")
    return {"single_stream_255_gcups": g, "single_stream_255_ms": dt * 1e3}


STAGE_FNS = {
    "probe": stage_probe,
    "cpu_smoke": stage_cpu_smoke,
    "blocked_1k": stage_blocked_1k,
    "parity_fixtures": stage_parity_fixtures,
    "single_512": stage_single_512,
    "chain_512": stage_chain_512,
    "hetero_512": stage_hetero_512,
    "batch_mixed": stage_batch_mixed,
    "blocked_2k": stage_blocked_2k,
    "chain_1k": stage_chain_1k,
    "traceback_512": stage_traceback_512,
    "traceback_1k": stage_traceback_1k,
    "traceback_2k": stage_traceback_2k,
    "traceback_4k": stage_traceback_4k,
    "traceback_8k": stage_traceback_8k,
    "roofline": stage_roofline,
    "single_stream_255": stage_single_stream_255,
}

# The kernels each stage must launch on a card (by their counters' names
# in _counters); a stage that launched none of one fails.  Every traceback
# stage runs the direct engine's choice and walk kernels: traceback_512 and
# traceback_1k on the whole triplet, the larger ones in the leaves below
# their K5 splits (their score path is K3's, not required here).
DIRECT = ("direct_choices", "direct_walk")
STAGE_KERNELS = {
    "blocked_1k": ("blocked",),
    "parity_fixtures": ("wavefront", "blocked"),
    "single_512": ("blocked",),
    "chain_512": ("blocked_chain",),
    "hetero_512": ("hetero",),
    "batch_mixed": ("hetero",),
    "blocked_2k": ("blocked",),
    "chain_1k": ("blocked_chain",),
    "traceback_512": DIRECT,
    "traceback_1k": DIRECT,
    "traceback_2k": ("slab", *DIRECT),
    "traceback_4k": ("slab", *DIRECT),
    "traceback_8k": ("slab", *DIRECT),
    "roofline": ("vpu",),
    "single_stream_255": ("wavefront",),
}

# (name, estimate s, cap s or None) in execution order, the reference's
# (bench.py TPU_STAGES): the headline, the flagship-scale tracebacks, then
# the 512^3 protocols, the mixed batch and breadth.  Each estimate is the
# stage's seconds on an H100 80GB HBM3 at 700 W, subprocess start (about
# 7 s) included, rounded up; the timeout rule (Runner.stage_timeout) gives
# it at least 180 s more.  traceback_8k alone has a cap, so that its worst
# case leaves the later stages their budget.
CUDA_STAGES = [
    ("blocked_1k", 40, None),        # 32 s, 24 s of it the C++ oracle
    ("traceback_4k", 20, None),      # 18 s: a first run and two timed
    ("traceback_8k", 75, 300),       # 72 s; runs only if traceback_4k landed
    ("traceback_1k", 10, None),      # 9 s
    ("batch_mixed", 90, None),       # 88 s, most of it the golden samples
    ("chain_512", 10, None),         # 8 s
    ("hetero_512", 10, None),        # 10 s
    ("single_512", 10, None),        # 8 s
    ("traceback_512", 10, None),     # 7 s
    ("roofline", 10, None),          # 8 s
    ("traceback_2k", 10, None),      # 9 s
    ("chain_1k", 10, None),          # 8 s
    ("blocked_2k", 10, None),        # 8 s
    ("parity_fixtures", 10, None),   # 8 s
    ("single_stream_255", 10, None),  # 9 s
]


def _counters() -> dict:
    """Each kernel entry point's launch counter, by name."""
    from trialign_torch.kernels import blocked, hetero, slab, vpu, wavefront
    from trialign_torch.traceback import direct

    return {"wavefront": wavefront.final_values,
            "blocked": blocked.final_values,
            "blocked_chain": blocked.chain_values,
            "hetero": hetero.final_values, "slab": slab.slab_sweep,
            "vpu": vpu.vpu_chains, "direct_choices": slab.choice_sweep,
            "direct_walk": direct.walk}


def child_main(name: str) -> int:
    """Run one stage; print its fields (``FIELDS {...}``), or the failure it
    caught (``FAILED {"kind": "parity" | "out of memory" | "error", ...}``)
    and return 1."""
    import torch

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    try:
        fields = STAGE_FNS[name]()
        launches = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        if torch.cuda.is_available():
            missing = [k for k in STAGE_KERNELS.get(name, ())
                       if k not in launches]
            if missing:
                raise RuntimeError(f"{name} launched no {missing} kernel")
            fields[f"{name}_launches"] = launches
    except Exception as e:  # noqa: BLE001 -- reported to the parent
        traceback.print_exc()
        kind = ("parity" if isinstance(e, AssertionError) else
                "out of memory" if isinstance(e, torch.cuda.OutOfMemoryError)
                else "error")
        msg = f"{type(e).__name__}: {e}".splitlines()[0][:300]
        print(FAILED + json.dumps({"kind": kind, "message": msg}),
              flush=True)
        return 1
    print(FIELDS + json.dumps(fields), flush=True)
    return 0


# ----------------------------------------------------------------------
# Parent orchestration (standard library only).
# ----------------------------------------------------------------------


class Runner:
    """Runs stages in subprocesses under the global budget and keeps the
    result line."""

    def __init__(self):
        self.budget = float(os.environ.get("TRIALIGN_BENCH_BUDGET_S", "1100"))
        self.t0 = time.time()
        self.fields = {}
        self.landed = []
        self.failed = {}
        self.skipped = {}
        self.parity_failed = []
        self._last_emitted = None

    def elapsed(self) -> float:
        return time.time() - self.t0

    def remaining(self) -> float:
        return self.budget - self.elapsed()

    def log(self, msg: str) -> None:
        """To stderr and appended to ERR_LOG."""
        print(msg, file=sys.stderr, flush=True)
        try:
            with open(ERR_LOG, "a") as fh:
                fh.write(msg if msg.endswith("\n") else msg + "\n")
        except OSError:
            pass

    def argv(self, name: str) -> list:
        """The command of one stage's subprocess."""
        return [sys.executable, "-m", "trialign_torch.bench", "--stage", name]

    def emit(self) -> None:
        """Print the result line, unless nothing has landed or failed yet
        or nothing but the elapsed time changed since the last one."""
        f = self.fields
        cpu = f.get("backend") == "cpu"
        value = f.get("cpu_smoke_gcups" if cpu else "blocked_1024_gcups")
        if value is None and not (self.failed or
                                  set(self.landed) - {"probe"}):
            return
        parity = f.get("parity", "pending")
        if self.parity_failed:
            parity = "FAILED: " + ", ".join(self.parity_failed)
        result = {
            "metric": CPU_METRIC if cpu else HEADLINE_METRIC,
            "value": None if value is None else round(value, 3),
            "unit": "GCUPS",
            "vs_baseline": (None if value is None
                            else round(value / BASELINE_ASIC_GCUPS, 3)),
            "parity": parity,
            "backend": f.get("backend", "?"),
            "device": f.get("device"),
            "power_limit": f.get("power_limit"),
        }
        for k, v in f.items():
            result.setdefault(k, v)
        if "blocked_1024_gcups" in f and "roofline_gcups_dpx_measured" in f:
            result["roofline_fraction"] = round(
                f["blocked_1024_gcups"] / f["roofline_gcups_dpx_measured"], 3)
        if self.failed:
            result["failed"] = dict(self.failed)
        if self.skipped:
            result["skipped"] = dict(self.skipped)
        key = json.dumps(result, sort_keys=True)
        if key == self._last_emitted:
            return
        self._last_emitted = key
        result["elapsed_s"] = round(self.elapsed(), 1)
        print(json.dumps(result), flush=True)

    def stage_timeout(self, est: float, cap=None) -> float:
        """The reference's rule (bench.py Runner._stage_timeout): bounded by
        the budget, generous to a slow stage but never all of what is left;
        ``cap`` bounds it further."""
        t = max(60.0, min(self.remaining() - 15.0,
                          max(1.5 * est, est + 180.0)))
        return t if cap is None else min(t, cap)

    def skip(self, name: str, reason: str) -> None:
        self.skipped[name] = reason
        self.log(f"[{name}] SKIPPED ({reason})")

    def run_stage(self, name, est, extra_env=None, force=False, cap=None):
        """Run one stage in its own process group; on success merge its
        fields and emit.  Returns the fields, or None when the stage was
        skipped, failed or timed out (named in the line with its reason)."""
        if not force and self.remaining() < GATE_S:
            self.skip(name, f"{self.remaining():.0f} s of "
                      f"{self.budget:.0f} s left")
            return None
        timeout = self.stage_timeout(est, cap)
        self.log(f"[{name}] start (elapsed {self.elapsed():.0f} s, "
                 f"timeout {timeout:.0f} s)")
        env = dict(os.environ)
        env.update(extra_env or {})
        if self.remaining() < 300.0:
            env["TRIALIGN_ROOFLINE_LIVE"] = "0"
        t0 = time.time()
        proc = subprocess.Popen(self.argv(name), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=ROOT,
                                env=env, start_new_session=True)
        timed_out = False
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
        finally:
            if proc.returncode is None:
                os.killpg(proc.pid, signal.SIGKILL)
                out, err = proc.communicate()
        dt = time.time() - t0
        if err:
            self.log(err.rstrip())
        fields = failure = None
        for line in out.splitlines():
            if line.startswith(FIELDS):
                fields = json.loads(line[len(FIELDS):])
            elif line.startswith(FAILED):
                failure = json.loads(line[len(FAILED):])
        if timed_out:
            self.failed[name] = f"timeout after {timeout:.0f} s"
        elif proc.returncode != 0 or fields is None:
            reason = f"exit code {proc.returncode}"
            if failure is not None:
                reason += f", {failure['kind']}: {failure['message']}"
                if failure["kind"] == "parity":
                    self.parity_failed.append(name)
            self.failed[name] = reason
        if name in self.failed:
            self.log(f"[{name}] FAILED after {dt:.0f} s: "
                     f"{self.failed[name]}; continuing")
            self.emit()
            return None
        self.log(f"[{name}] done in {dt:.0f} s")
        self.landed.append(name)
        self.fields.update(fields)
        self.emit()
        return fields


def parent_main() -> int:
    # A SIGTERM (a caller's time limit) unwinds through run_stage's
    # finally, which kills the running stage's process group.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    r = Runner()
    r.log(f"=== trialign_torch bench start {time.strftime('%Y-%m-%d %H:%M:%S')}"
          f" (budget {r.budget:.0f} s) ===")
    # Without a card the probe is a torch import; with one it builds every
    # kernel (7 s with the libraries built, about 20 s without).
    probe = r.run_stage("probe", 20, force=True)
    if probe is None:
        r.log("probe failed: no stage runs")
        r.emit()
        return 1
    r.log(f"backend={probe['backend']} device={probe['device']} "
          f"power_limit={probe['power_limit']} budget={r.budget:.0f} s")
    if probe["backend"] != "cuda":
        r.run_stage("cpu_smoke", 20, extra_env={"CUDA_VISIBLE_DEVICES": ""},
                    force=True)
        r.emit()
        return 2
    r.fields["reference_asic_512_ms"] = 10.82
    r.fields["reference_software_512_gcups"] = 0.058
    for name, est, cap in CUDA_STAGES:
        if name == "traceback_8k" and "traceback_4k_s" not in r.fields:
            r.skip(name, "traceback_4k did not land")
            continue
        r.run_stage(name, est, cap=cap)
    r.emit()
    r.log(f"bench complete in {r.elapsed():.0f} s; landed: {r.landed}; "
          f"failed: {r.failed}; skipped: {sorted(r.skipped)}")
    return 0 if "blocked_1024_gcups" in r.fields and not r.parity_failed \
        else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trialign_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=sorted(STAGE_FNS),
                    help="run one stage in this process (the parent runs "
                    "each stage so)")
    args = ap.parse_args(argv)
    return child_main(args.stage) if args.stage else parent_main()


if __name__ == "__main__":
    sys.exit(main())
