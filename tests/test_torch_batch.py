"""trialign_torch.align_batch and its routes against trialign.align_batch.

The port runs with device="cpu", where K2, K3 and K4 run their plain
versions; the reference runs its CPU path (the padded XLA sweep).  The
mosaic route is forced on the CPU with TRIALIGN_FORCE_MOSAIC=1, as in the
reference's own tests.  Scores are integers: equality is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import trialign
import trialign_torch
from trialign.config import Scoring as JScoring
from trialign_torch import api
from trialign_torch.config import Scoring
from trialign_torch.dist import batch as db
from trialign_torch.golden import align_planes_numpy, rescore_alignment
from trialign_torch.kernels import chain, mosaic
from trialign_torch.kernels import wavefront as wf

torch.set_num_threads(1)

SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
SCORINGS = {
    "sop": (Scoring(), 4),
    "rtl": (Scoring(s3_mode="rtl"), 4),
    "sub4": (Scoring(submatrix=SUB4), 6),
}
EMPTY = (np.zeros(0, np.uint8), np.zeros(3, np.uint8), np.zeros(3, np.uint8))


def mixed(rng, n, hi=20, nsym=4):
    """n triplets with each length uniform in [1, hi], plus empties."""
    trips = [tuple(rng.integers(0, nsym, int(m)).astype(np.uint8)
                   for m in rng.integers(1, hi + 1, 3)) for _ in range(n)]
    trips[2] = EMPTY
    trips[-1] = (np.zeros(4, np.uint8), np.zeros(5, np.uint8),
                 np.zeros(0, np.uint8))
    return trips


def jscoring(sc):
    return JScoring(**dataclasses.asdict(sc))


def reference_scores(trips, sc):
    return [r.score for r in trialign.align_batch(trips, jscoring(sc))]


def golden(trips, sc=Scoring()):
    return [align_planes_numpy(*t, sc) if min(map(len, t)) else 0
            for t in trips]


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_mosaic_and_chained_match_reference(rng, name):
    """Mixed lengths with empty sequences; rtl rotates only A and B."""
    sc, nsym = SCORINGS[name]
    trips = mixed(rng, 14, nsym=nsym)
    want = reference_scores(trips, sc)
    assert want == golden(trips, sc)
    assert mosaic.align_batch_mosaic(trips, sc, device="cpu") == want
    assert chain.align_batch_chained(trips, sc, max_p=4, device="cpu") == want


@pytest.mark.parametrize("route", ["auto", "chain", "blocked"])
def test_mosaic_on_scores_and_residue_route(rng, route):
    trips = mixed(rng, 9)
    fired = []
    got = mosaic.align_batch_mosaic(
        trips, device="cpu", residue_route=route,
        on_scores=lambda i, s: fired.append((i, s)))
    assert got == golden(trips)
    assert sorted(fired) == list(enumerate(got))


def test_mosaic_refuses_mesh_and_unknown_route(rng):
    """A mesh is taken now: a CPU mesh of 2 data slots gives the scores of
    no mesh.  An unknown residue route is still refused."""
    from trialign_torch.dist.mesh import make_mesh

    trips = mixed(rng, 3)
    cpu2 = make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    assert mosaic.align_batch_mosaic(trips, mesh=cpu2) == \
        mosaic.align_batch_mosaic(trips, device="cpu")
    with pytest.raises(ValueError, match="residue_route"):
        mosaic.align_batch_mosaic(trips, residue_route="tall", device="cpu")


def test_rotate_keeps_the_score():
    """sop rotates every axis, rtl only A and B, and an asymmetric
    submatrix none; the reference rotates under SUB4 all the same, and the
    score changes (first triplet: 4 by golden, 2 after its rotation)."""
    a, b, c = (np.zeros(n, np.uint8) for n in (3, 5, 7))
    assert [len(x) for x in mosaic._rotate((a, b, c), Scoring())] == \
        [7, 5, 3]
    assert [len(x) for x in mosaic._rotate(
        (a, b, c), Scoring(s3_mode="rtl"))] == [5, 3, 7]
    sub4 = Scoring(submatrix=SUB4)
    assert [len(x) for x in mosaic._rotate((a, b, c), sub4)] == [3, 5, 7]
    sym = Scoring(submatrix=((2, -1), (-1, 2)))
    assert [len(x) for x in mosaic._rotate((a, b, c), sym)] == [7, 5, 3]
    rng = np.random.default_rng(3)
    trips = [tuple(rng.integers(0, 6, n).astype(np.uint8)
                   for n in (5, 12, 9)) for _ in range(3)]
    want = golden(trips, sub4)
    assert want == [4, -7, -3]
    assert mosaic.align_batch_mosaic(trips, sub4, device="cpu") == want
    rotated = [align_planes_numpy(*mosaic._rotate(t, Scoring()), sub4)
               for t in trips]
    assert rotated[0] != want[0]


def test_batch_routes():
    sop, rtl = Scoring(), Scoring(s3_mode="rtl")
    small = [(100, 90, 80)] * 64
    assert api.batch_routes(small, sop, True) == ["mosaic"] * 64
    assert api.batch_routes(small, sop, False) == ["padded"] * 64
    assert api.batch_routes(small[:63], sop, True) == ["padded"] * 63
    # Long A leaves the mosaic route; the rest keeps it while >= 64 remain.
    long_a = small + [(2000, 10, 10)]
    assert api.batch_routes(long_a, sop, True) == ["mosaic"] * 64 + ["padded"]
    assert api.batch_routes(long_a[1:], sop, True) == ["padded"] * 64
    # sop rotates every axis onto A, rtl only A and B.
    long_c = small[:-1] + [(10, 10, 2000)]
    assert api.batch_routes(long_c, sop, True)[-1] == "padded"
    assert api.batch_routes(long_c, rtl, True)[-1] == "mosaic"
    # The submatrix gate: past 4 symbols padded, past 8 the plain sweep.
    five = Scoring(submatrix=tuple(tuple(1 if i == j else -1 for j in range(5))
                                   for i in range(5)))
    nine = Scoring(submatrix=tuple(tuple(1 if i == j else -1 for j in range(9))
                                   for i in range(9)))
    assert api.batch_routes(small, five, True) == ["padded"] * 64
    assert api.batch_routes(small, nine, True) == ["torch"] * 64
    assert api.batch_routes(small, Scoring(submatrix=SUB4), True) == \
        ["mosaic"] * 64


@pytest.mark.parametrize("force", [False, True])
def test_align_batch_force_mosaic(rng, monkeypatch, force):
    """64+ triplets: TRIALIGN_FORCE_MOSAIC=1 takes the mosaic route on the
    CPU, its absence the padded one; both match the reference."""
    monkeypatch.delenv("TRIALIGN_FORCE_MOSAIC", raising=False)
    trips = mixed(rng, 66, hi=12)
    # The reference too reads the variable: its padded path, read first.
    want = reference_scores(trips, Scoring())
    if force:
        monkeypatch.setenv("TRIALIGN_FORCE_MOSAIC", "1")
    calls = {"mosaic": 0, "padded": 0}
    for mod, name in ((mosaic, "align_batch_mosaic"),
                      (db, "align_batch_padded")):
        orig = getattr(mod, name)

        def spy(*args, _orig=orig, _key=name.split("_")[-1], **kwargs):
            calls[_key] += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod, name, spy)
    got = trialign_torch.align_batch(trips, device="cpu")
    # align_batch_padded calls itself once more to set the empties aside.
    assert (calls["mosaic"], calls["padded"] > 0) == \
        ((1, False) if force else (0, True))
    assert [r.score for r in got] == want
    assert {r.backend for r in got} == {"batch"}
    assert [r.cells for r in got] == [len(a) * len(b) * len(c)
                                      for a, b, c in trips]


def test_align_batch_submatrix_routes_match_reference(rng):
    five = tuple(tuple(3 if i == j else -1 for j in range(5))
                 for i in range(5))
    nine = tuple(tuple(2 if i == j else -2 for j in range(9))
                 for i in range(9))
    for sub, backend in ((five, "padded"), (nine, "torch")):
        sc = Scoring(submatrix=sub)
        trips = mixed(rng, 5, hi=9, nsym=len(sub) + 1)
        got = trialign_torch.align_batch(trips, sc, device="cpu")
        assert [r.score for r in got] == reference_scores(trips, sc)
        assert {r.backend for r in got} == {backend}


def test_padded_and_bucketed(rng):
    """Triplets past K2's caps go to K3, the rest stay one K2 bucket."""
    trips = [tuple(rng.integers(0, 4, n).astype(np.uint8) for n in lens)
             for lens in ((6, 9, 8), (4, 260, 7), (3, 5, 300), (9, 2, 4),
                          (0, 3, 3))]
    got = db.align_batch_padded(trips, device="cpu")
    assert got == golden(trips)
    assert db.align_batch_bucketed(trips, device="cpu") == got
    a, b, c, lens = db.prep_padded([trips[0], trips[3]], "cpu")
    assert lens.tolist() == [[6, 9, 8], [9, 2, 4]]
    assert a.shape == (2, 10) and b.shape == (2, 10) and c.shape == (2, 9)
    assert b[1, 1:3].tolist() == trips[3][1].tolist()
    assert b[1, 3:].tolist() == [wf.PAD_B] * 7


def test_align_batch_return_alignment(rng):
    trips = mixed(rng, 6, hi=14)[:-1]
    trips[2] = tuple(rng.integers(0, 4, 5).astype(np.uint8) for _ in range(3))
    got = trialign_torch.align_batch(trips, return_alignment=True,
                                     device="cpu")
    want = reference_scores(trips, Scoring())
    assert [r.score for r in got] == want
    for r, t in zip(got, trips):
        assert rescore_alignment(r.alignment) == r.score
        for row, seq in zip(r.alignment, t):
            assert [v for v in row if v != -1] == [int(x) for x in seq]


def test_align_batch_needs_a_card_by_default(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trialign_torch.align_batch(mixed(rng, 3))
