"""The port's bench, ``python -m trialign_torch.bench``.

The twin of tests/test_bench_script.py: the parent emits a valid, complete
JSON line after every stage and imports only the standard library; every
stage of the reference's ``bench.py`` has a port stage, and each runs here
at toy size on the CPU plain versions with its parity checks live; a stage
cut by its timeout is named and the next one still lands; without a card
the parent prints a line labelled CPU and exits 2.  The one ``cuda`` case
runs the headline's body on the card against the C++ oracle.

Imports neither JAX nor the JAX package at module level, so that the
``cuda`` case also runs on a GPU machine without them::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_bench.py
"""

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import trialign_torch.golden
import trialign_torch.native
from trialign_torch import bench, benchmarks
from trialign_torch.traceback import hirschberg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = {"backend": "cuda", "device": "NVIDIA H100 80GB HBM3",
         "power_limit": "700.00 W"}


@pytest.fixture
def runner(tmp_path, monkeypatch):
    """A Runner whose log goes to a temporary file, not the checkout's."""
    monkeypatch.setattr(bench, "ERR_LOG", str(tmp_path / "err.log"))
    return bench.Runner()


def printed(capsys) -> list:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.strip()]


def reference_assignments(name: str):
    """The value assigned to ``name`` at the top of the root bench.py."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return node.value
    raise AssertionError(f"bench.py assigns no {name}")


# ---------------------------------------------------------------- parent


def test_inlined_baseline_matches_benchmarks(runner, capsys):
    assert bench.BASELINE_ASIC_GCUPS == benchmarks.BASELINE_ASIC_GCUPS
    runner.fields = {**PROBE,
                     "blocked_1024_gcups": benchmarks.BASELINE_ASIC_GCUPS}
    runner.emit()
    assert printed(capsys)[-1]["vs_baseline"] == 1.0


def test_emit_json_line_shape(runner, capsys):
    # Nothing landed -> no line (not a broken one); the probe alone neither.
    runner.emit()
    runner.fields.update(PROBE)
    runner.landed.append("probe")
    runner.emit()
    runner.fields.update(blocked_1024_gcups=46.3, blocked_1024_ms=23.2,
                         parity="exact")
    runner.landed.append("blocked_1k")
    runner.emit()
    runner.emit()  # nothing changed but the clock: deduplicated
    runner.fields.update(roofline_gcups=257.4,
                         roofline_gcups_dpx_measured=513.6,
                         hetero_512_ms=2.0)
    runner.emit()
    lines = printed(capsys)
    assert len(lines) == 2
    for rec in lines:
        for key in ("metric", "value", "unit", "vs_baseline", "parity",
                    "backend", "device", "power_limit", "elapsed_s"):
            assert key in rec, (key, rec)
        assert rec["unit"] == "GCUPS" and "CUDA" in rec["metric"]
    final = lines[-1]
    assert final["value"] == 46.3 and final["blocked_1024_gcups"] == 46.3
    assert final["device"] == PROBE["device"]
    assert final["power_limit"] == PROBE["power_limit"]
    assert final["hetero_512_ms"] == 2.0
    assert final["roofline_gcups"] == 257.4
    # The yardstick is K6's measured DPX ceiling, not the assumed one.
    assert final["roofline_fraction"] == round(46.3 / 513.6, 3)
    assert "failed" not in final and "skipped" not in final


def test_emit_names_failures_and_parity(runner, capsys):
    runner.fields.update(PROBE, blocked_1024_gcups=46.3, parity="exact")
    runner.failed["traceback_8k"] = "timeout after 460 s"
    runner.skipped["blocked_2k"] = "60 s of 1100 s left"
    runner.emit()
    runner.failed["chain_1k"] = "exit code 1, parity: AssertionError: x"
    runner.parity_failed.append("chain_1k")
    runner.emit()
    first, second = printed(capsys)
    assert first["failed"] == {"traceback_8k": "timeout after 460 s"}
    assert first["skipped"] == {"blocked_2k": "60 s of 1100 s left"}
    assert first["parity"] == "exact"
    assert second["parity"] == "FAILED: chain_1k"
    assert set(second["failed"]) == {"traceback_8k", "chain_1k"}


def test_a_failed_headline_still_prints_a_line(runner, capsys):
    runner.fields.update(PROBE)
    runner.landed.append("probe")
    runner.failed["blocked_1k"] = "exit code 1, error: RuntimeError: x"
    runner.emit()
    (rec,) = printed(capsys)
    assert rec["value"] is None and rec["vs_baseline"] is None
    assert rec["failed"] == {"blocked_1k": "exit code 1, error: "
                                           "RuntimeError: x"}


def test_stage_timeout_follows_the_reference_rule(runner):
    runner.budget = 1100.0
    runner.t0 = time.time()
    assert runner.stage_timeout(60) == pytest.approx(240.0, abs=1)
    assert runner.stage_timeout(400) == pytest.approx(600.0, abs=1)
    assert runner.stage_timeout(400, cap=420) == pytest.approx(420.0, abs=1)
    runner.budget = 100.0
    assert runner.stage_timeout(400) == pytest.approx(85.0, abs=1)
    runner.budget = 20.0
    assert runner.stage_timeout(400) == 60.0


def test_parent_module_imports_standard_library_only():
    """The parent never imports torch, JAX or either package: a sticky CUDA
    error must kill one stage's process, not the parent."""
    with open(os.path.join(ROOT, "trialign_torch", "bench.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.append(node.module)
    assert names
    for name in names:
        assert name.split(".")[0] in sys.stdlib_module_names, name


def test_every_reference_stage_has_a_port_stage():
    ref = reference_assignments("STAGE_FNS")
    names = [k.value for k in ref.keys]
    assert len(names) == 17
    assert names == list(bench.STAGE_FNS)
    # The same execution order as the reference's TPU_STAGES.
    order = [e.elts[0].value for e in reference_assignments("TPU_STAGES").elts]
    assert order == [name for name, _, _ in bench.CUDA_STAGES]
    assert set(bench.STAGE_KERNELS) <= set(bench.STAGE_FNS)


def test_stages_take_their_device_as_a_keyword_default():
    """Every stage but the probe takes its device as a keyword default:
    "cuda", or "cpu" for the CPU smoke."""
    import inspect

    for name, fn in bench.STAGE_FNS.items():
        if name == "probe":
            continue
        want = "cpu" if name == "cpu_smoke" else "cuda"
        assert inspect.signature(fn).parameters["device"].default == want


# ---------------------------------------------------------------- stages

# (stage, toy keyword arguments, fields it must return)
TOY = [
    ("cpu_smoke", {"n": 16}, ["cpu_smoke_gcups"]),
    ("blocked_1k", {"n": 24, "repeats": 2},
     ["blocked_1024_gcups", "blocked_1024_ms", "blocked_1024_oracle_s"]),
    ("parity_fixtures", {}, ["reference_dat_score"]),
    ("single_512", {"n": 24, "repeats": 3},
     ["blocked_512_single_ms", "blocked_512_single_gcups"]),
    ("chain_512", {"n": 24, "npack": 4},
     ["blocked_512_ms", "blocked_512_gcups"]),
    ("hetero_512", {"n": 24, "npack": 4},
     ["hetero_512_ms", "hetero_512_gcups"]),
    ("batch_mixed", {"n": 6, "lo": 8, "hi": 20},
     ["batch_mixed_1024_s", "batch_mixed_1024_gcups",
      "batch_mixed_1024_triplets_per_s"]),
    ("blocked_2k", {"n": 40, "repeats": 2},
     ["blocked_2048_gcups", "blocked_2048_ms"]),
    ("chain_1k", {"n": 24, "npack": 3},
     ["blocked_1024_chained_gcups", "blocked_1024_chained_ms"]),
    ("traceback_512", {"n": 20}, ["traceback_512_s", "traceback_512_first_s"]),
    ("traceback_1k", {"n": 24}, ["traceback_1k_s", "traceback_1k_first_s"]),
    ("single_stream_255", {"n": 20, "repeats": 3},
     ["single_stream_255_gcups", "single_stream_255_ms"]),
]


@pytest.mark.parametrize("name,kwargs,keys", TOY, ids=[t[0] for t in TOY])
def test_stage_at_toy_size_on_the_cpu(name, kwargs, keys):
    fields = bench.STAGE_FNS[name](device="cpu", **kwargs)
    for key in keys:
        assert fields[key] > 0, (key, fields)
    if name in ("cpu_smoke", "blocked_1k", "parity_fixtures"):
        assert fields["parity"] == "exact"


@pytest.mark.parametrize("name,n", [("traceback_2k", 26), ("traceback_4k", 28),
                                    ("traceback_8k", 30)])
def test_traceback_stage_splits_on_k5s_plain_version(monkeypatch, name, n):
    """The >= 2k stages' route at toy size: Hirschberg splits whose slabs
    sweep on K5's plain version, then direct leaves; rescored, rows equal
    to the inputs, score equal to the score path's."""
    monkeypatch.setattr(hirschberg, "BASE_CELLS", 500)
    monkeypatch.setattr(hirschberg, "DIRECT_CELLS", 6000)
    monkeypatch.setenv("TRIALIGN_SLAB_FORCE", "1")
    from trialign_torch.kernels import slab

    calls = []
    orig = slab.slab_sweep

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(slab, "slab_sweep", spy)
    fields = bench.STAGE_FNS[name](n=n, device="cpu")
    key = name + "_s"
    assert fields[key] > 0 and fields[name + "_first_s"] > 0
    assert calls, "no split swept on K5's plain version"


def test_probe_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this case needs a machine without a CUDA device")
    assert bench.stage_probe() == {"backend": "cpu", "device": "cpu",
                                   "power_limit": None}


def test_roofline_stage_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.stage_roofline(device="cpu")


def test_headline_parity_is_live(monkeypatch):
    """The headline checks the measured triplet against the C++ oracle: an
    oracle one off fails the stage."""
    orig = trialign_torch.native.score_native
    monkeypatch.setattr(trialign_torch.native, "score_native",
                        lambda *t: orig(*t) + 1)
    with pytest.raises(AssertionError, match="C\\+\\+ oracle"):
        bench.stage_blocked_1k(n=20, repeats=2, device="cpu")


def test_traceback_parity_is_live(monkeypatch):
    orig = trialign_torch.golden.rescore_alignment
    monkeypatch.setattr(trialign_torch.golden, "rescore_alignment",
                        lambda rows: orig(rows) - 1)
    with pytest.raises(AssertionError, match="rescored"):
        bench.stage_traceback_512(n=16, device="cpu")


def test_reference_dat_score_matches_the_jax_package():
    from trialign.config import Scoring as JScoring
    from trialign.golden import align_planes_numpy
    from trialign.io import load_reference_triplet

    want = align_planes_numpy(*load_reference_triplet(), JScoring())
    got = bench.stage_parity_fixtures(device="cpu")["reference_dat_score"]
    assert got == want


# ---------------------------------------------------------------- children


class FakeRunner(bench.Runner):
    """Stages named in ``fake`` run the given Python code instead."""

    def __init__(self, fake):
        super().__init__()
        self.fake = fake

    def argv(self, name):
        if name in self.fake:
            return [sys.executable, "-c", self.fake[name]]
        return super().argv(name)


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return any(ln.split()[1] == "Z" for ln in f
                       if ln.startswith("State:"))
    except FileNotFoundError:
        return True


def test_a_stage_past_its_timeout_is_named_and_the_next_lands(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "ERR_LOG", str(tmp_path / "err.log"))
    pidfile = tmp_path / "grandchild.pid"
    sleepy = (
        "import subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-c', "
        "'import time; time.sleep(120)'])\n"
        f"open({str(pidfile)!r}, 'w').write(str(p.pid))\n"
        "print('a line before the cut', file=sys.stderr, flush=True)\n"
        "time.sleep(120)\n")
    r = FakeRunner({"sleepy": sleepy, "crash": "import sys; sys.exit(3)"})
    r.fields["backend"] = "cpu"
    t0 = time.time()
    assert r.run_stage("sleepy", 1, cap=3.0) is None
    assert time.time() - t0 < 30
    assert r.failed == {"sleepy": "timeout after 3 s"}
    # The stage's whole process group was killed.
    pid = int(pidfile.read_text())
    for _ in range(50):
        if _gone(pid):
            break
        time.sleep(0.1)
    assert _gone(pid)
    assert r.run_stage("crash", 1) is None
    assert r.failed["crash"] == "exit code 3"
    fields = r.run_stage("cpu_smoke", 60,
                         extra_env={"CUDA_VISIBLE_DEVICES": ""})
    assert fields["parity"] == "exact"
    lines = printed(capsys)
    assert len(lines) == 3
    assert lines[0]["failed"] == {"sleepy": "timeout after 3 s"}
    assert lines[-1]["value"] == round(fields["cpu_smoke_gcups"], 3)
    assert set(lines[-1]["failed"]) == {"sleepy", "crash"}
    log = (tmp_path / "err.log").read_text()
    assert "a line before the cut" in log and "[sleepy] FAILED" in log


def test_a_stage_failure_is_classified(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "ERR_LOG", str(tmp_path / "err.log"))
    fake = {
        "wrong": ("print('FAILED ' + '{\"kind\": \"parity\", \"message\": "
                  "\"AssertionError: 1 != 2\"}'); raise SystemExit(1)"),
        "oom": ("print('FAILED ' + '{\"kind\": \"out of memory\", "
                "\"message\": \"OutOfMemoryError: x\"}'); raise SystemExit(1)"),
    }
    r = FakeRunner(fake)
    r.fields.update(PROBE)
    r.run_stage("oom", 1)
    assert not r.parity_failed
    assert r.failed["oom"] == "exit code 1, out of memory: OutOfMemoryError: x"
    r.run_stage("wrong", 1)
    assert r.parity_failed == ["wrong"]
    assert printed(capsys)[-1]["parity"] == "FAILED: wrong"


def test_child_reports_a_parity_failure(monkeypatch, capsys):
    def wrong(device="cuda"):
        raise AssertionError("parity FAILED: 1 != 2")

    monkeypatch.setitem(bench.STAGE_FNS, "parity_fixtures", wrong)
    assert bench.child_main("parity_fixtures") == 1
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1][len(bench.FAILED):]) == {
        "kind": "parity", "message": "AssertionError: parity FAILED: 1 != 2"}


def test_child_prints_its_fields(capsys):
    assert bench.child_main("cpu_smoke") == 0
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith(bench.FIELDS)
    assert json.loads(line[len(bench.FIELDS):])["parity"] == "exact"


def test_parent_without_a_card_prints_a_cpu_line_and_exits_2(tmp_path):
    """CUDA hidden: the probe finds no card, the CPU smoke runs in a child,
    its line says so, and the parent exits 2."""
    code = ("import sys\n"
            "from trialign_torch import bench\n"
            f"bench.ERR_LOG = {str(tmp_path / 'err.log')!r}\n"
            "sys.exit(bench.main([]))\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT, env=env)
    assert out.returncode == 2, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.splitlines()]
    assert lines, out.stderr
    final = lines[-1]
    assert final["backend"] == "cpu" and final["parity"] == "exact"
    assert "CPU" in final["metric"] and "plain" in final["metric"]
    assert final["value"] == round(final["cpu_smoke_gcups"], 3)
    assert "blocked_1024_gcups" not in final
    assert "[cpu_smoke] done" in (tmp_path / "err.log").read_text()


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_headline_body_on_the_card_against_the_oracle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fields = bench.stage_blocked_1k(n=256, repeats=3, device="cuda")
    assert fields["parity"] == "exact"
    assert fields["blocked_1024_gcups"] > 0
