"""The port's plain torch sweep (trialign_torch.kernels.ref) against the
reference's golden model and XLA sweep.

Inputs come from a seeded numpy generator and go to both packages; scores are
integers, so equality is exact (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.conftest import random_triplet
from trialign.config import Scoring as JScoring
from trialign.golden import align_planes_numpy
from trialign.io import load_reference_triplet
from trialign.kernels.xla_ref import align_xla
from trialign_torch.config import Scoring
from trialign_torch.kernels.ref import align_ref


def ref_scoring(sc):
    """The JAX package's Scoring with the same fields as the port's."""
    return JScoring(**dataclasses.asdict(sc))


torch.set_num_threads(1)

SCORINGS = {
    "sop": Scoring(),
    "rtl": Scoring(s3_mode="rtl"),
    "nondefault": Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2),
}
# Asymmetric, so a swapped lookup shows.
SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
SUB12 = tuple(tuple(int(v) for v in row)
              for row in np.random.default_rng(11).integers(-5, 7, (12, 12)))
# Large enough that a short near-identical triplet passes 2047.
WIDE = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)


def near_identical(rng, n):
    a = rng.integers(0, 4, n).astype(np.uint8)
    b, c = a.copy(), a.copy()
    b[::7] = (b[::7] + 1) % 4
    c[::5] = (c[::5] + 2) % 4
    return a, b, c


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("dims", [(0, 3, 4), (3, 0, 2), (2, 3, 0), (1, 1, 1),
                                  (1, 5, 3), (6, 5, 7), (12, 9, 11),
                                  (20, 4, 13)])
def test_ref_matches_golden(rng, dims, name):
    a, b, c = random_triplet(rng, *dims)
    sc = SCORINGS[name]
    assert align_ref(a, b, c, sc) == \
        align_planes_numpy(a, b, c, ref_scoring(sc))


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_ref_matches_xla(rng, name):
    a, b, c = random_triplet(rng, 9, 8, 10)
    sc = SCORINGS[name]
    assert align_ref(a, b, c, sc) == align_xla(a, b, c, ref_scoring(sc))


@pytest.mark.parametrize("matrix", [SUB4, SUB12], ids=["sub4", "sub12"])
def test_ref_submatrix(rng, matrix):
    """Sequences draw two symbols past the matrix: those score its floor."""
    sc = Scoring(submatrix=matrix)
    a, b, c = random_triplet(rng, 11, 9, 10, nsym=len(matrix) + 2)
    got = align_ref(a, b, c, sc)
    assert got == align_planes_numpy(a, b, c, ref_scoring(sc))
    assert got == align_xla(a, b, c, ref_scoring(sc))


def test_ref_dat_fixture():
    a, b, c = load_reference_triplet()
    got = align_ref(a, b, c)
    assert got == align_planes_numpy(a, b, c)
    assert got == align_xla(a, b, c)


def test_ref_score_bits_overflow(rng):
    """A 12-bit register wraps: golden with score_bits=12 differs from the
    unwrapped score, and the sweep reproduces both."""
    a, b, c = near_identical(rng, 40)
    want12 = align_planes_numpy(a, b, c, ref_scoring(WIDE), score_bits=12)
    want0 = align_planes_numpy(a, b, c, ref_scoring(WIDE))
    assert want12 != want0
    assert align_ref(a, b, c, WIDE, score_bits=12) == want12
    assert align_xla(a, b, c, ref_scoring(WIDE), score_bits=12) == want12
    assert align_ref(a, b, c, WIDE) == want0


def test_ref_scores_are_int32(rng):
    from trialign_torch.kernels.ref import PAD_A, PAD_B, PAD_C, extend, sweep

    a, b, c = random_triplet(rng, 5, 4, 6)
    final = sweep(extend(a, 6, PAD_A, "cpu"), extend(b, 5, PAD_B, "cpu"),
                  extend(c, 7, PAD_C, "cpu"), 5, 4, 6)
    assert final.dtype == torch.int32 and final.shape == (7,)


@pytest.mark.parametrize("name", ["sop", "rtl"])
def test_ref_sweep_of_a_batch_of_a(rng, name):
    """A's stacked (S, n) against one B and C: each row equals the sweep of
    that A alone, and its max equals golden."""
    from trialign_torch.kernels.ref import PAD_A, PAD_B, PAD_C, extend, sweep

    sc = SCORINGS[name]
    a_list = [random_triplet(rng, 6, 1, 1)[0] for _ in range(3)]
    _, b, c = random_triplet(rng, 1, 5, 7)
    bx, cx = extend(b, 6, PAD_B, "cpu"), extend(c, 8, PAD_C, "cpu")
    ax = [extend(a, 7, PAD_A, "cpu") for a in a_list]
    got = sweep(torch.stack(ax), bx, cx, 6, 5, 7, sc)
    assert got.dtype == torch.int32 and got.shape == (3, 7)
    for row, a, x in zip(got, a_list, ax):
        assert torch.equal(row, sweep(x, bx, cx, 6, 5, 7, sc))
        assert int(row.max()) == align_planes_numpy(a, b, c, ref_scoring(sc))
