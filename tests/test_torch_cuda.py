"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a GPU machine without it, where
tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Inputs come from a seeded numpy generator; scores are integers, so equality
is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from trialign.config import Scoring
from trialign.golden import align_planes_numpy
from trialign_torch import api
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import ref
from trialign_torch.kernels import wavefront as wf

pytestmark = pytest.mark.cuda

SCORINGS = {
    "sop": (Scoring(), 4),
    "rtl": (Scoring(s3_mode="rtl"), 4),
    "nondefault": (Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2), 4),
    "sub4": (Scoring(submatrix=((3, -1, -2, 0), (-2, 2, -1, -3),
                                (0, -3, 4, -1), (-1, -2, -1, 1))), 6),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def triplet(seed, shape, nsym=4):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in shape)


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("dims", [(1, 1, 1), (6, 5, 7), (64, 64, 64),
                                  (300, 40, 255)])
def test_wavefront_kernel_matches_sweep(card, dims, name):
    scoring, nsym = SCORINGS[name]
    args = wf.prep(*triplet(1, dims, nsym), card)
    got = wf.final_values(*args, scoring)[0]
    want = ref.sweep(args[0][0], args[1][0], args[2][0], *dims, scoring)
    assert got.cpu().tolist() == want.cpu().tolist()


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("dims,block", [((10, 40, 50), (16, 128)),
                                        ((37, 70, 45), (9, 17)),
                                        ((20, 300, 280), None)])
def test_blocked_kernel_matches_plain(card, dims, block, name):
    scoring, nsym = SCORINGS[name]
    d = bk.plan_dims(*dims, *(block or bk.choose_block_shape(*dims)))
    arrs = bk.prep_blocked(*triplet(2, dims, nsym), d, card)
    got = bk.final_values(*arrs, *dims, d, scoring).cpu().tolist()
    assert got == bk.blocked_ref(*arrs, *dims, d, scoring).cpu().tolist()
    assert got == ref.sweep(*arrs, *dims, scoring).cpu().tolist()


@pytest.mark.parametrize("dims,backend", [((30, 40, 50), "wavefront"),
                                          ((20, 300, 30), "blocked")])
def test_align_on_card_matches_golden(card, dims, backend):
    a, b, c = triplet(3, dims)
    r = api.align(a, b, c)
    assert r.backend == backend
    assert r.score == align_planes_numpy(a, b, c)
