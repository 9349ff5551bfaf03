"""The plain reference against brute force, the program's golden model and
the program's alignments, on the CPU at tiny sizes."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import dp, rescore

RTL = {"match": 1, "mismatch": -1, "gap_open": 2, "gap_extend": 1,
       "s3": "sop", "submatrix": None}
SUB = ((2, -1, -2, 0), (-1, 3, 0, -2), (-2, 0, 1, -1), (0, -2, -1, 2))
SCORINGS = {
    "rtl_constants": RTL,
    "rtl_s3": dict(RTL, s3="rtl"),
    "wide_gaps": dict(RTL, match=2, mismatch=-3, gap_open=4, gap_extend=1),
    "submatrix": dict(RTL, submatrix=SUB),
}


def _trips(rng, count, lo, hi):
    return [tuple(rng.integers(0, 4, int(rng.integers(lo, hi + 1)))
                  .astype(np.uint8) for _ in range(3)) for _ in range(count)]


def _alignments(a, b, c):
    """Every alignment of the three sequences, as rows with -1 for gaps."""
    moves = dp.CONSUMES

    def walk(i, j, k):
        if (i, j, k) == (len(a), len(b), len(c)):
            yield []
            return
        for di, dj, dk in moves:
            if i + di <= len(a) and j + dj <= len(b) and k + dk <= len(c):
                col = (a[i] if di else -1, b[j] if dj else -1,
                       c[k] if dk else -1)
                for rest in walk(i + di, j + dj, k + dk):
                    yield [col] + rest

    for cols in walk(0, 0, 0):
        yield [list(r) for r in zip(*cols)]


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_dp_is_the_best_rescored_alignment(name):
    """Brute force: the DP's score is the best score the rescorer gives
    any alignment of the triplet."""
    scoring = SCORINGS[name]
    rng = np.random.default_rng(7)
    trips = _trips(rng, 6, 1, 3)
    want = [max(rescore.rescore(rows, t, scoring)
                for rows in _alignments(*t)) for t in trips]
    assert dp.scores(trips, scoring) == want


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_dp_matches_golden(name):
    from trialign_torch.config import Scoring
    from trialign_torch.golden import align_planes_numpy

    sc = SCORINGS[name]
    scoring = Scoring(match=sc["match"], mismatch=sc["mismatch"],
                      gap_open=sc["gap_open"], gap_extend=sc["gap_extend"],
                      s3_mode=sc["s3"], submatrix=sc["submatrix"])
    rng = np.random.default_rng(11)
    trips = _trips(rng, 30, 1, 16)
    want = [align_planes_numpy(*t, scoring) for t in trips]
    # Small blocks: triplets of different lengths share padded sweeps.
    assert dp.scores(trips, sc, block_cells=3000) == want
    assert dp.scores(trips, sc) == want


@pytest.mark.parametrize("bits", [3, 4])
def test_wrapped_registers_match_golden(bits):
    from trialign_torch.config import Scoring
    from trialign_torch.golden import align_planes_numpy

    rng = np.random.default_rng(bits)
    trips = _trips(rng, 12, 4, 14)
    want = [align_planes_numpy(*t, Scoring(), score_bits=bits)
            for t in trips]
    assert dp.scores(trips, RTL, wrap_bits=bits) == want
    assert want != dp.scores(trips, RTL)


def test_empty_sequence_scores_zero():
    t = (np.zeros(0, np.uint8), np.array([1, 2], np.uint8),
         np.array([3], np.uint8))
    assert dp.scores([t, t], RTL) == [0, 0]


def test_rescore_holds_the_programs_alignments():
    from trialign_torch.config import Scoring
    from trialign_torch.traceback import hirschberg_align

    rng = np.random.default_rng(3)
    for t in _trips(rng, 8, 1, 24):
        score, rows = hirschberg_align(*t, Scoring(), device="cpu")
        assert rescore.rescore(rows, t, RTL) == score == dp.scores([t],
                                                                    RTL)[0]


def test_rescore_refuses_what_does_not_spell_the_inputs():
    t = (np.array([0, 1], np.uint8), np.array([0], np.uint8),
         np.array([1], np.uint8))
    assert rescore.rescore([[0, 1], [0, -1], [-1, 1]], t, RTL) is not None
    assert rescore.rescore([[0, 1], [0, -1], [1, -1]], t, RTL) is not None
    assert rescore.rescore([[1, 0], [0, -1], [-1, 1]], t, RTL) is None
    assert rescore.rescore([[0, 1, -1], [0, -1, -1], [-1, 1, -1]], t,
                           RTL) is None
    assert rescore.rescore([[0, 1], [0, -1]], t, RTL) is None
