"""K2's tiles (kernels/wavefront.plan_tiles) against the reference's K2.

On the card K2 sweeps every problem of a call as tiles of at most 32 x 32
cells, listed from the host lengths in one table in diagonal order, on the
register step.  Here that table is swept in its order by K3's plain version
(``wavefront.tiles_ref``, which reads each problem's symbols as the kernel
reads them), at the tile planes the tuning chooses between (17 x 17, 33 x
17, 33 x 33) and a small one that cuts CPU-sized problems into many tiles;
it must
equal the whole-plane plain sweep (``ref.sweep``, the wrapper's CPU path)
on all seven values and the JAX package's K2 (in interpret mode, as
tests/test_torch_wavefront.py runs it) on the score.  The register step's
own model with ``score_bits`` is in tests/test_torch_hetero_step.py.
Inputs come from seeded numpy generators; integers, tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from trialign.config import Scoring as JScoring
from trialign.golden import align_planes_numpy
from trialign.kernels import wavefront as jax_wf
from trialign_torch.config import Scoring
from trialign_torch.dist.batch import prep_padded
from trialign_torch.kernels import hetero, ref
from trialign_torch.kernels import wavefront as wf

torch.set_num_threads(1)

SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
# (scoring, alphabet): the scorings of chip_smoke.py's wavefront phase.
SCORINGS = {
    "default": (Scoring(), 4),
    "rtl": (Scoring(s3_mode="rtl"), 4),
    "nondefault": (Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2),
                   4),
    "sub4": (Scoring(submatrix=SUB4), 6),
}
WIDE = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)
# The tuning's tile planes, then a small one.
PLANES = [(17, 17), (33, 17), (33, 33)]
BLOCKS = PLANES + [(5, 9)]
# A ragged batch: tiles ragged in both directions at every plane, a
# multi-tile problem, a 1 x 1 one, an empty sequence, |B| = 1 and an |A|
# much longer than |B| and |C|.
RAGGED = [(30, 40, 35), (6, 5, 7), (0, 5, 6), (50, 1, 60), (120, 5, 7),
          (1, 1, 1)]


def jscoring(sc):
    return JScoring(**dataclasses.asdict(sc))


def triplets(seed, lens, nsym=4):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in t)
            for t in lens]


def near_identical(seed, n):
    """A triplet whose WIDE score passes 2047, so that 12 bits wrap."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, n).astype(np.uint8)
    b, c = a.copy(), a.copy()
    b[::7] = (b[::7] + 1) % 4
    c[::5] = (c[::5] + 2) % 4
    return a, b, c


def jax_k2(t, scoring, score_bits=0):
    if min(map(len, t)) == 0:
        return 0
    return jax_wf.align_wavefront(*t, jscoring(scoring), interpret=True,
                                  score_bits=score_bits)


def tiled_and_plain(trips, scoring, score_bits, block):
    """(tiles_ref, final_values) of a padded batch on the CPU."""
    args = prep_padded(trips, "cpu")
    return (wf.tiles_ref(*args, scoring, score_bits, block),
            wf.final_values(*args, scoring, score_bits))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_ragged_batch_equals_plain_sweep(name, block):
    """Every problem of a ragged batch, all seven values, under each
    scoring at each tile plane; the scores are the golden model's."""
    scoring, nsym = SCORINGS[name]
    trips = triplets(1, RAGGED, nsym)
    got, want = tiled_and_plain(trips, scoring, 0, block)
    assert torch.equal(got, want)
    assert got.max(dim=1).values.tolist() == [
        align_planes_numpy(*t, jscoring(scoring)) if min(map(len, t)) else 0
        for t in trips]


@pytest.mark.parametrize("block", PLANES)
def test_batch_equals_pallas(block):
    """The ragged batch's scores are the JAX package's K2's."""
    trips = triplets(2, RAGGED)
    got, _ = tiled_and_plain(trips, Scoring(), 0, block)
    assert got.max(dim=1).values.tolist() == [
        jax_k2(t, Scoring()) for t in trips]


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_each_scoring_equals_pallas(name):
    """A problem of several tiles at 17 x 17 under each scoring."""
    scoring, nsym = SCORINGS[name]
    t = triplets(3, [(21, 35, 20)], nsym)[0]
    got = wf.tiles_ref(*wf.prep(*t, "cpu"), scoring, block=(17, 17))
    assert int(got.max()) == jax_k2(t, scoring)


@pytest.mark.parametrize("block", PLANES[:2])
def test_long_a_equals_pallas(block):
    """(4096, 16, 16), the longest |A| K2 takes, on one tile."""
    t = triplets(4, [(4096, 16, 16)])[0]
    args = wf.prep(*t, "cpu")
    got = wf.tiles_ref(*args, block=block)
    assert torch.equal(got, wf.final_values(*args))
    assert int(got.max()) == jax_k2(t, Scoring())


@pytest.mark.parametrize("block", BLOCKS)
def test_score_bits_where_the_wrap_changes_the_answer(block):
    """score_bits=12 on a triplet whose unwrapped score passes 2047: the
    tiles equal the plain sweep and the JAX package's K2 with the wrap."""
    t = near_identical(5, 30)
    args = wf.prep(*t, "cpu")
    got = wf.tiles_ref(*args, WIDE, 12, block)
    assert torch.equal(got, wf.final_values(*args, WIDE, 12))
    assert int(got.max()) == jax_k2(t, WIDE, 12)
    assert int(got.max()) != int(wf.tiles_ref(*args, WIDE, 0, block).max())


def test_symbols_past_the_ends_do_not_matter():
    """The kernel reads the last symbol for a row or column past |B| or
    |C|; arrays exactly as wide as the sequences, and padded ones, give
    the same values."""
    trips = triplets(6, [(9, 20, 13), (5, 3, 4)])
    padded = prep_padded(trips, "cpu")
    for p, t in enumerate(trips):
        alone = wf.tiles_ref(*wf.prep(*t, "cpu"), block=(9, 9))
        assert torch.equal(alone[0],
                           wf.tiles_ref(*padded, block=(9, 9))[p])


@pytest.mark.parametrize("block", BLOCKS)
def test_table_order_and_neighbours(block):
    """Diagonal order, the longest |A| first within a diagonal; each
    entry's upper and left neighbours are entries before it (so the
    persistent launch cannot deadlock); an empty problem has no tiles."""
    lens = np.array(RAGGED)
    plan = wf.plan_tiles(lens, (130, 50, 70), block)
    table = plan.table
    geom = plan.geom
    col = {name: c for c, name in enumerate(hetero.GEOM_FIELDS)}
    tb, tc = block[0] - 1, block[1] - 1
    d = table[:, 1] + table[:, 2]
    assert (np.diff(d) >= 0).all()
    la = lens[table[:, 0], 0]
    same = np.diff(d) == 0
    assert (np.diff(la)[same] <= 0).all()
    for e, (p, jb, kb, up, left) in enumerate(table):
        for nb, (dj, dk) in ((up, (1, 0)), (left, (0, 1))):
            if jb - dj < 0 or kb - dk < 0:
                assert nb == -1
            else:
                assert 0 <= nb < e
                assert tuple(table[nb][:3]) == (p, jb - dj, kb - dk)
    for p, (a, b, c) in enumerate(lens):
        n = int((table[:, 0] == p).sum())
        assert n == (0 if min(a, b, c) == 0 else -(-b // tb) * -(-c // tc))
        assert geom[p, col["a_off"]] == 130 * p
        assert geom[p, col["c_off"]] == 70 * p
    rows = geom[:, col["n_kb"]] * geom[:, col["nrows"]] * 7 * block[1]
    assert (geom[1:, col["rf_off"]] == np.cumsum(rows)[:-1]).all()
    assert plan.rf_ints == rows.sum()


def test_launches_split_at_the_budget():
    """Runs of consecutive problems whose faces fit the budget; a problem
    past it alone; no budget, one launch."""
    lens = [(10, 10, 10), (0, 3, 3), (200, 40, 40), (10, 10, 10)]
    block = (17, 17)
    need = [hetero.face_bytes(*t, *block) for t in lens]
    assert wf.plan_launches(lens, block, None) == [(0, 4)]
    assert wf.plan_launches(lens, block, need[0]) == [(0, 2), (2, 3), (3, 4)]
    assert wf.plan_launches(lens, block, sum(need)) == [(0, 4)]


@pytest.mark.parametrize("block", [(1, 9), (9, 1), (34, 33), (33, 34)])
def test_tile_planes_past_one_sub_tile_are_refused(block):
    with pytest.raises(ValueError, match="tile plane"):
        wf.plan_tiles([(5, 5, 5)], (6, 6, 6), block)


def test_plain_is_one_sweep_per_problem():
    """On the CPU the wrapper is ref.sweep per problem and counts no
    launch."""
    trips = triplets(8, [(7, 8, 9), (3, 2, 5)])
    before = wf.final_values.launches
    args = prep_padded(trips, "cpu")
    got = wf.final_values(*args)
    assert wf.final_values.launches == before
    for p, t in enumerate(trips):
        assert torch.equal(got[p], ref.sweep(args[0][p], args[1][p],
                                             args[2][p], *map(len, t)))
