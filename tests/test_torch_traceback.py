"""Alignment recovery of the port against the JAX package's.

``trialign_torch.traceback.hirschberg_align`` on the CPU (NumPy engine, torch
engine, direct engine, and the slab kernel's plain version) must return the
same score AND the same rows as ``trialign.traceback.hirschberg_align`` under
the same forced route: the base-case walk, the recursion on engine slabs,
the direct engine in all its modes, and splits through the slab sweep with
pin nodes.  Inputs come from a seeded numpy generator; equality is exact.
"""

import numpy as np
import pytest
import torch

import trialign
import trialign.traceback.direct as JD
import trialign.traceback.hirschberg as JH
import trialign_torch
from tests.conftest import random_triplet
from trialign.config import Scoring as JScoring
from trialign.io import load_reference_triplet
from trialign_torch.config import Scoring
from trialign_torch.golden import align_planes_numpy, rescore_alignment
from trialign_torch.kernels import slab
from trialign_torch.traceback import direct as D
from trialign_torch.traceback import hirschberg as H

torch.set_num_threads(1)

SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
SCORINGS = {
    "sop": {},
    "rtl": {"match": 2, "mismatch": -1, "gap_open": 3, "gap_extend": 1,
            "s3_mode": "rtl"},
    "sub4": {"submatrix": SUB4},
}
# Forced routes: module attributes set alike on both packages.
ROUTES = {
    "walk": {},
    "recursive": {"BASE_CELLS": 2000},
    "engine_slabs": {"BASE_CELLS": 256, "XLA_CELLS": 0},
    "direct_modes": {"BASE_CELLS": 400, "DIRECT_CELLS": 6000},
    "direct_top": {"BASE_CELLS": 500, "DIRECT_CELLS": 10**9},
}


def both(monkeypatch, **attrs):
    for name, value in attrs.items():
        monkeypatch.setattr(H, name, value)
        monkeypatch.setattr(JH, name, value)


def check(a, b, c, name="sop"):
    """Port (CPU) against the reference: same score, same rows; the rows
    rescore to the score and reproduce the sequences."""
    want = JH.hirschberg_align(a, b, c, JScoring(**SCORINGS[name]))
    got = H.hirschberg_align(a, b, c, Scoring(**SCORINGS[name]),
                             device="cpu")
    assert got == want
    score, rows = got
    assert rescore_alignment(rows, Scoring(**SCORINGS[name])) == score
    for row, seq in zip(rows, (a, b, c)):
        assert [v for v in row if v != -1] == list(map(int, seq))
    return score


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_match_reference(rng, monkeypatch, route):
    both(monkeypatch, **ROUTES[route])
    sizes = (10, 12, 14) if route == "walk" else (22, 26, 19)
    check(*random_triplet(rng, *sizes))


@pytest.mark.parametrize("name", ["rtl", "sub4"])
@pytest.mark.parametrize("route", ["recursive", "direct_top"])
def test_scorings_match_reference(rng, monkeypatch, route, name):
    both(monkeypatch, **ROUTES[route])
    check(*random_triplet(rng, 18, 21, 16, nsym=6), name)


def test_direct_traceback_matches_reference(rng):
    sc = {"match": 2, "mismatch": -3, "gap_open": 4, "gap_extend": 1}
    a, b, c = random_triplet(rng, 25, 30, 35)
    for mode, v0, end in (("free", None, None), ("free_jk", None, 4),
                          ("pin", np.array([0] + [H.NEG] * 6, np.int32), 0)):
        want = JD.direct_traceback(a, b, c, JScoring(**sc), mode, v0, end)
        got = D.direct_traceback(a, b, c, Scoring(**sc), mode, v0, end,
                                 device="cpu")
        assert got == want, mode


@pytest.mark.parametrize("thresholds,sizes", [
    ({"BASE_CELLS": 1 << 12, "DIRECT_CELLS": 1 << 16,
      "_DIRECT_SAFE_CELLS": 1 << 16}, (18, 26, 130)),
    ({"BASE_CELLS": 1 << 9, "DIRECT_CELLS": 1 << 10,
      "_DIRECT_SAFE_CELLS": 1 << 10}, (18, 26, 60)),
], ids=["top_split", "pin_splits"])
def test_slab_splits_match_reference(rng, monkeypatch, thresholds, sizes):
    """Splits through the slab sweep (its plain version here) give the
    reference's rows: F and G equal the NumPy engine's cell for cell, so the
    crossings are the same.  The reference runs its engine slabs; its own
    slab kernel is checked in tests/test_torch_slab.py."""
    both(monkeypatch, **thresholds)
    a, b, c = random_triplet(rng, *sizes)
    want = JH.hirschberg_align(a, b, c)
    calls = {"free": 0, "pin": 0}
    orig = slab.split_point_blocked_async

    def spy(*args, **kwargs):
        calls[kwargs.get("mode", "free")] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(slab, "split_point_blocked_async", spy)
    monkeypatch.setattr(slab.bk, "choose_block_shape",
                        lambda la, lb, lc: (9, 17))
    monkeypatch.setenv("TRIALIGN_SLAB_FORCE", "1")
    got = H.hirschberg_align(a, b, c, device="cpu")
    assert got == want
    assert calls["free"] >= 1
    if thresholds["DIRECT_CELLS"] < 1 << 16:
        assert calls["pin"] >= 1, "no pin node ran the slab sweep"


def test_fixtures(monkeypatch):
    """The dat triplet, an identical triplet (ties everywhere: the argmaxes
    must take the first index, as the reference's do) and empty sequences."""
    both(monkeypatch, BASE_CELLS=2000)
    a, b, c = load_reference_triplet()
    assert check(a, b, c) == align_planes_numpy(a, b, c)
    same = np.tile(np.arange(4, dtype=np.uint8), 6)
    assert check(same, same, same) == 3 * len(same)
    both(monkeypatch, BASE_CELLS=500, DIRECT_CELLS=10**9)
    assert check(same, same, same) == 3 * len(same)
    e = np.zeros(0, dtype=np.uint8)
    assert check(same[:3], e, same[:3]) == 0
    assert H.hirschberg_align(e, e, e, device="cpu") == (0, [[], [], []])


def test_api_return_alignment_matches_reference(rng):
    a, b, c = random_triplet(rng, 20, 17, 23)
    got = trialign_torch.align(a, b, c, return_alignment=True, device="cpu")
    want = trialign.align(a, b, c, return_alignment=True)
    assert (got.backend, got.score, got.alignment) == \
        ("hirschberg", want.score, want.alignment)
    assert got.cells == 20 * 17 * 23


def test_alignment_actions_match_reference(rng):
    _, rows = H.hirschberg_align(*random_triplet(rng, 20, 18, 22),
                                 device="cpu")
    assert H.alignment_actions(rows) == JH.alignment_actions(rows)
    with pytest.raises(ValueError):
        H.alignment_actions([[-1], [-1], [-1]])


def test_direct_oom_falls_back_to_split(rng, monkeypatch):
    """An out-of-memory error of the direct engine above the safe size
    falls through to the split; below it, it surfaces."""
    calls = []

    def boom(*args, **kwargs):
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    both(monkeypatch, BASE_CELLS=2000, DIRECT_CELLS=10**9)
    monkeypatch.setattr(H, "_DIRECT_SAFE_CELLS", 0)
    monkeypatch.setattr(D, "direct_traceback", boom)
    check(*random_triplet(rng, 16, 18, 20))
    assert calls
    monkeypatch.setattr(H, "_DIRECT_SAFE_CELLS", 10**9)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        H.hirschberg_align(*random_triplet(rng, 16, 18, 20), device="cpu")


def test_other_direct_errors_surface(rng, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("out of memory")  # text alone is not an OOM

    monkeypatch.setattr(H, "BASE_CELLS", 2000)
    monkeypatch.setattr(H, "_DIRECT_SAFE_CELLS", 0)
    monkeypatch.setattr(D, "direct_traceback", boom)
    with pytest.raises(RuntimeError, match="out of memory"):
        H.hirschberg_align(*random_triplet(rng, 16, 18, 20), device="cpu")


def test_byte_gate_routes_oversize_proactively(rng, monkeypatch):
    def boom(*args, **kwargs):  # pragma: no cover - must not be reached
        raise AssertionError("direct engine attempted despite byte gate")

    both(monkeypatch, BASE_CELLS=2000, DIRECT_CELLS=10**9)
    monkeypatch.setattr(D, "direct_traceback", boom)
    monkeypatch.setattr(H, "_direct_fits", lambda *args: False)
    monkeypatch.setattr(JH, "_direct_fits", lambda *args: False)
    check(*random_triplet(rng, 16, 18, 20))


@pytest.mark.parametrize("dims", [(512, 512, 512), (1024, 1024, 1024),
                                  (1024, 2048, 2048), (2048, 2048, 2048),
                                  (1024, 1059, 1082), (7, 300, 5)])
def test_routing_model_matches_reference(dims):
    """The footprint model and the constants are the reference's, so every
    size takes its route: 2048^3 must split, its halves fit."""
    assert D.direct_shapes(*dims) == JD.direct_shapes(*dims)
    assert D.direct_memory_bytes(*dims) == JD.direct_memory_bytes(*dims)
    for name in ("BASE_CELLS", "XLA_CELLS", "DIRECT_CELLS",
                 "_DIRECT_SAFE_CELLS", "_DIRECT_FIT_FRACTION"):
        assert getattr(H, name) == getattr(JH, name)
    assert H.SLAB_KERNEL_CELLS == JH.SLAB_PALLAS_CELLS
    assert D.device_memory_budget("cpu") > 2**40
    assert not H._use_slab_kernel(*dims, Scoring(), torch.device("cpu"))


def test_slab_kernel_gate(monkeypatch):
    cuda = torch.device("cuda")
    assert H._use_slab_kernel(1024, 2048, 2048, Scoring(), cuda)
    assert not H._use_slab_kernel(512, 512, 512, Scoring(), cuda)
    big = Scoring(submatrix=tuple(tuple(int(i == j) for j in range(12))
                                  for i in range(12)))
    assert H._use_slab_kernel(1024, 2048, 2048, big, cuda)
    monkeypatch.setenv("TRIALIGN_SLAB_FORCE", "1")
    assert H._use_slab_kernel(3, 4, 5, Scoring(), torch.device("cpu"))
    assert not H._use_slab_kernel(3, 0, 5, Scoring(), torch.device("cpu"))
