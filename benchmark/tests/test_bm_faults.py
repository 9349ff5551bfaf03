"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (the plain versions of the
kernels, the toy cells of ``conftest.toy``) with one fault planted in the
program, and checks that ``correct`` is false; a sound run of each cell is
correct.  The faults these cells can have: a step that returns its state
unchanged, half of a batch left out, and an answer altered where it is
produced.  No cell exchanges anything between chips."""

from __future__ import annotations

import pytest

from benchmark import harness

CELLS = ("tinydna.batch", "tinyrna.align", "tinyrna.score", "tinydna.single")


def _run(toy, cell, seed=2**31 + 9):
    root, bench = toy
    return harness.run_cell(cell, seed, 0.3, False, "cpu", root=root,
                            bench_dir=bench)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(toy, cell):
    out = _run(toy, cell)
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"


def _no_steps(*args, **kwargs):
    return iter(())


def _zero_sweep(*args, **kwargs):
    import torch

    return torch.zeros(7, dtype=torch.int32)


@pytest.mark.parametrize("cell,module,attr,step", [
    # K4's plain version steps its tiles through K3's pillar steps.
    ("tinydna.batch", "blocked", "pillar_steps", _no_steps),
    # K2's plain version sweeps each problem's planes whole.
    ("tinyrna.score", "wavefront", "sweep", _zero_sweep),
    ("tinydna.single", "wavefront", "sweep", _zero_sweep),
])
def test_step_that_leaves_its_state_unchanged(toy, cell, module, attr, step,
                                              monkeypatch):
    import importlib

    monkeypatch.setattr(importlib.import_module(
        "trialign_torch.kernels." + module), attr, step)
    out = _run(toy, cell)
    assert not out["correct"]
    assert out["checks"]["wrong_scores"]["value"] > 0


def test_half_of_the_batch_left_out(toy, monkeypatch):
    from trialign_torch.kernels import mosaic

    real = mosaic.align_batch_mosaic

    def half(triplets, *args, **kwargs):
        n = len(triplets) // 2
        return real(triplets[:n], *args, **kwargs) + [0] * (len(triplets) - n)

    monkeypatch.setattr(mosaic, "align_batch_mosaic", half)
    out = _run(toy, "tinydna.batch")
    assert not out["correct"]


def test_batch_score_altered(toy, monkeypatch):
    from trialign_torch.kernels import mosaic

    real = mosaic.align_batch_mosaic

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        return [s + 1 for s in out]

    monkeypatch.setattr(mosaic, "align_batch_mosaic", altered)
    assert not _run(toy, "tinydna.batch")["correct"]


@pytest.mark.parametrize("cell", ["tinyrna.score", "tinydna.single"])
def test_score_altered(toy, cell, monkeypatch):
    from trialign_torch.kernels import wavefront

    real = wavefront.align_wavefront
    monkeypatch.setattr(wavefront, "align_wavefront",
                        lambda *a, **k: real(*a, **k) - 1)
    assert not _run(toy, cell)["correct"]


def test_alignment_altered(toy, monkeypatch):
    from trialign_torch import traceback

    real = traceback.hirschberg_align

    def swapped(*args, **kwargs):
        score, rows = real(*args, **kwargs)
        for r in rows:  # the last two columns change places
            r[-1], r[-2] = r[-2], r[-1]
        return score, rows

    monkeypatch.setattr(traceback, "hirschberg_align", swapped)
    out = _run(toy, "tinyrna.align")
    assert not out["correct"]
    assert out["checks"]["wrong_alignments"]["value"] > 0
    assert out["checks"]["wrong_scores"]["value"] == 0


def test_alignment_score_altered(toy, monkeypatch):
    from trialign_torch import traceback

    real = traceback.hirschberg_align
    monkeypatch.setattr(traceback, "hirschberg_align",
                        lambda *a, **k: (real(*a, **k)[0] + 1,
                                         real(*a, **k)[1]))
    out = _run(toy, "tinyrna.align")
    assert not out["correct"]
    assert out["checks"]["wrong_scores"]["value"] > 0


def test_failed_request_counts_against_every_limit(toy, monkeypatch):
    from trialign_torch import traceback

    real = traceback.hirschberg_align
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) > 4 and len(calls) % 2:
            raise RuntimeError("planted")
        return real(*args, **kwargs)

    monkeypatch.setattr(traceback, "hirschberg_align", flaky)
    out = _run(toy, "tinyrna.align")
    assert out["failed"] > 0 and not out["correct"]
    assert all(c["value"] >= out["failed"] for c in out["checks"].values())
