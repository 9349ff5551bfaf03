"""trialign_torch.align against trialign.align, backend by backend.

The port runs with device="cpu", where its kernel backends run their plain
versions; the reference runs its CPU paths.  Scores are integers: equality is
exact.
"""

import os
import subprocess
import sys

import pytest
import torch

import trialign
import trialign_torch
from tests.conftest import random_triplet
from trialign.config import Scoring
from trialign.io import load_reference_triplet
from trialign_torch import api

torch.set_num_threads(1)

SUB12 = tuple(tuple(1 if i == j else -1 for j in range(12)) for i in range(12))


@pytest.mark.parametrize("port,reference", [
    ("torch", "xla"), ("wavefront", "pallas_interpret"), ("blocked", "blocked"),
    ("golden", "golden"), ("native", "native"),
])
def test_backend_pairs_agree(rng, port, reference):
    a, b, c = random_triplet(rng, 6, 5, 7)
    got = trialign_torch.align(a, b, c, backend=port, device="cpu")
    want = trialign.align(a, b, c, backend=reference)
    assert got.backend == port
    assert got.score == want.score
    assert got.cells == want.cells == 6 * 5 * 7


def test_auto_on_dat_fixture():
    a, b, c = load_reference_triplet()
    got = trialign_torch.align(a, b, c, device="cpu")
    assert got.backend == "wavefront"
    assert got.score == trialign.align(a, b, c, backend="golden").score


@pytest.mark.parametrize("dims", [(4096, 255, 255), (4097, 10, 10),
                                  (10, 256, 10), (10, 10, 256), (1, 1, 1),
                                  (1024, 1024, 1024)])
def test_routing_matches_reference(dims):
    """The reference sends |B|,|C| <= 255 and |A| <= 4096 to its single-block
    kernel (trialign/api.py:59-62) and everything else to the blocked one."""
    la, lb, lc = dims
    small = lb <= 255 and lc <= 255 and la <= 4096
    assert api._pick_backend(*dims) == ("wavefront" if small else "blocked")


def test_score_bits_and_strings(rng):
    a = "ACGTTGCA" * 2
    got = trialign_torch.align(a, a, a, backend="torch", score_bits=4,
                               device="cpu")
    want = trialign.align(a, a, a, backend="xla", score_bits=4)
    assert got.score == want.score


def test_big_submatrix_auto_routes_to_plain_sweep(rng):
    sc = Scoring(submatrix=SUB12)
    a, b, c = random_triplet(rng, 5, 6, 4, nsym=12)
    got = trialign_torch.align(a, b, c, sc, device="cpu")
    assert got.backend == "torch"
    assert got.score == trialign.align(a, b, c, sc, backend="golden").score
    got = trialign_torch.align(a, b, c, sc, score_bits=12, device="cpu")
    assert got.backend == "torch"


@pytest.mark.parametrize("port,reference,kwargs", [
    ("nope", "nope", {}),
    ("native", "native", {"score_bits": 12}),
    ("golden", "golden", {"score_bits": 12, "return_alignment": True}),
    ("wavefront", "pallas_interpret", {"scoring": Scoring(submatrix=SUB12)}),
    ("blocked", "blocked", {"scoring": Scoring(submatrix=SUB12)}),
])
def test_same_value_errors(rng, port, reference, kwargs):
    a, b, c = random_triplet(rng, 3, 3, 3)
    with pytest.raises(ValueError):
        trialign.align(a, b, c, backend=reference, **kwargs)
    with pytest.raises(ValueError):
        trialign_torch.align(a, b, c, backend=port, device="cpu", **kwargs)


def test_return_alignment(rng):
    a, b, c = random_triplet(rng, 6, 5, 7)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        trialign_torch.align(a, b, c, return_alignment=True, device="cpu")
    got = trialign_torch.align(a, b, c, backend="native",
                               return_alignment=True, device="cpu")
    want = trialign.align(a, b, c, backend="native", return_alignment=True)
    assert (got.score, got.alignment) == (want.score, want.alignment)


def test_needs_a_card_unless_cpu_is_asked_for(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, b, c = random_triplet(rng, 3, 3, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trialign_torch.align(a, b, c)


def test_gcups():
    r = api.AlignResult(score=1, cells=2_000_000_000, seconds=2.0)
    assert r.gcups == 1.0
    assert api.AlignResult(score=1).gcups == 0.0


def test_port_imports_without_jax():
    """Every module of the port imports, and align() runs on the CPU, with
    JAX blocked.  A subprocess, since this one has imported JAX already."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import trialign_torch\n"
        "from trialign_torch import api, benchmarks, _build\n"
        "from trialign_torch.kernels import ref, wavefront, blocked\n"
        "s = np.array([0, 1, 2, 3], dtype=np.uint8)\n"
        "for bk in ('auto', 'torch', 'blocked', 'golden'):\n"
        "    assert trialign_torch.align(s, s, s, backend=bk,\n"
        "                                device='cpu').score == 12\n"
        "assert not any(m == 'jax' or m.startswith('jax.')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
