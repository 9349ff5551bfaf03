"""K4's register step (csrc/pillar_warp.cuh), modelled on the CPU.

``kernels.hetero.step_layout_ref`` sweeps a dispatch's tiles in the order and
layout of the kernel's tile step: lanes as tile rows, strips of R columns,
each cell's values reduced into the partials their consumers take
(``hetero.PARTIALS``), the row above's partials handed down, a strip's last
column handed to the next through a ring of 2 * chunk + 1 planes, strips as
far apart as the kernel's barriers let them be, and every partial the kernel
does not carry poisoned.  Per tile it must equal K3's plain version
``blocked_ref``, per dispatch ``hetero_ref`` and the JAX package's golden
model; the partial table must equal the JAX package's weight groups and
plane offsets.  A ring one plane short must differ.  Inputs come from
seeded numpy generators; integers, tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from trialign.config import Scoring as JScoring
from trialign.golden import align_planes_numpy
from trialign.kernels import plane_math as jpm
from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.kernels import hetero

torch.set_num_threads(1)

SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
# The scorings of chip_smoke.VARIANTS that K4 takes: (scoring, alphabet).
SCORINGS = {
    "default": (Scoring(), 4),
    "rtl": (Scoring(s3_mode="rtl"), 4),
    "nondefault": (Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2),
                   4),
    "sub4": (Scoring(submatrix=SUB4), 6),
}
# Ragged problems at tile plane (5, 9) (tb = 4, tc = 8): several tile
# counts, final cells inside their tiles, a 1 x 1-tile problem and an empty
# sequence.
LENS = [(9, 10, 13), (3, 5, 4), (0, 4, 3), (1, 1, 1), (6, 9, 17)]
BLOCK = (5, 9)


def jscoring(sc):
    return JScoring(**dataclasses.asdict(sc))


def dispatch(seed, nsym=4, lens=LENS, block=BLOCK):
    rng = np.random.default_rng(seed)
    trips = [tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in t)
             for t in lens]
    return trips, hetero.prep_hetero(trips, *block, "cpu")


def assert_states_equal(got, want):
    for g, w, name in zip(got, want, want._fields):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("name", sorted(SCORINGS) + ["gaps_7_1", "gaps_1_3"])
def test_partial_groups_are_the_weight_matrix(name):
    """Each target's groups cover the seven sources once, and every source
    of a group carries the group's charge in Scoring.weight_matrix()."""
    scoring = {"gaps_7_1": Scoring(gap_open=7, gap_extend=1),
               "gaps_1_3": Scoring(gap_open=1, gap_extend=3)}.get(
        name, SCORINGS.get(name, (None,))[0])
    w = scoring.weight_matrix()
    for t, (groups, _) in enumerate(hetero.PARTIALS):
        srcs = sorted(s for g, _, _ in groups for s in g)
        assert srcs == list(range(NUM_MATRICES))
        for g, opens, extends in groups:
            for s in g:
                assert w[t, s] == -(opens * scoring.gap_open
                                    + extends * scoring.gap_extend)


def test_partials_go_where_the_jax_step_reads_them():
    """(planes later, rows down, columns right) of each target's partial is
    the JAX package's plane delta and shift of that target."""
    for t, (_, delay) in enumerate(hetero.PARTIALS):
        assert delay == (jpm.PLANE_DELTA[t], *jpm.SHIFTS[t])
    assert set(hetero.FROM_ABOVE) == {t for t, (_, (_, dj, _)) in
                                      enumerate(hetero.PARTIALS) if dj}
    assert set(hetero.ACROSS) == {t for t, (_, (_, _, dk)) in
                                  enumerate(hetero.PARTIALS) if dk}


def test_partials_of_a_cell_equal_the_grouped_update():
    """A partial is the grouped max-plus update of the JAX package's step
    for one source cell."""
    rng = np.random.default_rng(0)
    scoring = SCORINGS["nondefault"][0]
    v = rng.integers(-50, 50, (NUM_MATRICES, 6)).astype(np.int32)
    groups = jpm.transition_groups(jscoring(scoring).weight_matrix())
    got = hetero.partials(torch.from_numpy(v), scoring).numpy()
    for t in range(NUM_MATRICES):
        want = jpm.target_update(v, groups[t], np.maximum)
        np.testing.assert_array_equal(got[t], want)


@pytest.mark.parametrize("strip,chunk", [(2, 1), (4, 3), (8, 2)])
@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_each_tile_equals_blocked_ref(name, strip, chunk):
    """Entry after entry of the table, the model's state equals K3's plain
    version sweeping that one tile (hetero_ref on one entry)."""
    scoring, nsym = SCORINGS[name]
    _, batch = dispatch(1, nsym, [(9, 10, 13), (6, 9, 17)])
    got, want = hetero.new_state(batch), hetero.new_state(batch)
    for e in range(len(batch.tiles)):
        hetero.step_layout_ref(batch, scoring, got, e, 1, strip, chunk)
        hetero.hetero_ref(batch, scoring, want, e, 1)
        assert_states_equal(got, want)


@pytest.mark.parametrize("strip,chunk", [(2, 2), (4, 1), (8, 5)])
@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_dispatch_equals_hetero_ref_and_golden(name, strip, chunk):
    scoring, nsym = SCORINGS[name]
    trips, batch = dispatch(2, nsym)
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, scoring, want)
    got = hetero.new_state(batch)
    hetero.step_layout_ref(batch, scoring, got, strip=strip, chunk=chunk)
    assert_states_equal(got, want)
    assert got.out.max(dim=1).values.tolist() == [
        align_planes_numpy(*t, jscoring(scoring)) if min(map(len, t)) else 0
        for t in trips]


@pytest.mark.parametrize("block,strip", [((33, 33), 8), ((9, 17), 4),
                                         ((2, 2), 2), ((17, 12), 8)])
def test_tile_planes_and_ragged_strips(block, strip):
    """The default plane, planes whose last strip is ragged (tc not a
    multiple of R) and 1 x 1 tiles."""
    big = (5, 6, 4) if block == (2, 2) else (12, 40, 35)
    trips, batch = dispatch(3, lens=[big, (2, 3, 2), (1, 1, 1)], block=block)
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, state=want)
    got = hetero.new_state(batch)
    hetero.step_layout_ref(batch, state=got, strip=strip, chunk=4)
    assert_states_equal(got, want)


def test_runs_in_table_order_resume_anywhere():
    """Runs that end mid-diagonal, then the rest: the same state."""
    _, batch = dispatch(4)
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, state=want)
    got = hetero.new_state(batch)
    n = len(batch.tiles)
    for lo in range(0, n, 3):
        hetero.step_layout_ref(batch, state=got, idx0=lo,
                               count=min(3, n - lo), strip=2, chunk=2)
    assert_states_equal(got, want)
    assert got.done.tolist() == [
        int(batch.lens[p][0]) + sum(BLOCK) - 2 for p in batch.tiles[:, 0]]


@pytest.mark.parametrize("chunk", [1, 3])
def test_a_ring_one_plane_short_differs(chunk):
    """A ring of 2 * chunk planes lets a strip overwrite a plane of the
    boundary column before the next strip reads it: a poisoned partial
    reaches a cell and the state differs; 2 * chunk + 1 is exact."""
    _, batch = dispatch(5, lens=[(9, 4, 16)])
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, state=want)
    got = hetero.new_state(batch)
    hetero.step_layout_ref(batch, state=got, strip=2, chunk=chunk,
                           ring_depth=2 * chunk)
    assert not torch.equal(got.out, want.out)
    exact = hetero.new_state(batch)
    hetero.step_layout_ref(batch, state=exact, strip=2, chunk=chunk,
                           ring_depth=2 * chunk + 1)
    assert_states_equal(exact, want)


# Tiles past one sub-tile: (tile plane, lanes, strips a block, strip, the
# dispatch's lengths).  The kernel's own sub-tile (32 rows, 8 strips of 4)
# at planes of two row sub-tiles (the second one row), of four ragged column
# sub-tiles and of 2 x 2; small sub-tiles that cut CPU-sized tiles into many,
# one strip a sub-tile in one of them.
SUB_TILES = [
    ((9, 17), 3, 2, 2, [(9, 20, 40), (3, 5, 4), (1, 1, 1)]),
    ((6, 13), 2, 1, 4, [(7, 12, 30), (1, 1, 1)]),
    ((34, 33), 32, 8, 4, [(6, 40, 30), (2, 3, 2)]),
    ((16, 128), 32, 8, 4, [(4, 14, 100), (1, 1, 1)]),
    ((34, 65), 32, 8, 4, [(2, 30, 60)]),
]


@pytest.mark.parametrize("block,lanes,max_strips,strip,lens", SUB_TILES)
def test_sub_tiles_equal_blocked_ref(block, lanes, max_strips, strip, lens):
    """A tile past one sub-tile is swept as sub-tiles on its face slabs,
    shifted to each sub-tile's corner: entry after entry of the table the
    state (faces, final values, progress words) equals K3's plain version
    sweeping that one tile."""
    _, batch = dispatch(6, lens=lens, block=block)
    got, want = hetero.new_state(batch), hetero.new_state(batch)
    for e in range(len(batch.tiles)):
        hetero.step_layout_ref(batch, state=got, idx0=e, count=1,
                               strip=strip, chunk=3, lanes=lanes,
                               max_strips=max_strips)
        hetero.hetero_ref(batch, state=want, idx0=e, count=1)
        assert_states_equal(got, want)


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_sub_tiles_under_each_scoring(name):
    """Sub-tiles of 3 rows and 2 strips of 2 under every scoring: the
    dispatch's state equals hetero_ref's and the scores the golden model's."""
    scoring, nsym = SCORINGS[name]
    trips, batch = dispatch(7, nsym, lens=LENS, block=(9, 17))
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, scoring, want)
    got = hetero.new_state(batch)
    hetero.step_layout_ref(batch, scoring, got, strip=2, chunk=2, lanes=3,
                           max_strips=2)
    assert_states_equal(got, want)
    assert got.out.max(dim=1).values.tolist() == [
        align_planes_numpy(*t, jscoring(scoring)) if min(map(len, t)) else 0
        for t in trips]


# K2's mode of the step (score_bits): each value wraps where it is made.
@pytest.mark.parametrize("strip,chunk", [(2, 1), (4, 3)])
@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_score_bits_each_tile_equals_blocked_ref(name, strip, chunk):
    """Values wrapped to 4 bits, which wraps many cells: entry after entry
    of the table, the model's state equals K3's plain version with the same
    wrap (hetero_ref with score_bits), whose faces differ from the
    unwrapped ones."""
    scoring, nsym = SCORINGS[name]
    _, batch = dispatch(8, nsym, [(9, 10, 13), (6, 9, 17)])
    got, want = hetero.new_state(batch), hetero.new_state(batch)
    for e in range(len(batch.tiles)):
        hetero.step_layout_ref(batch, scoring, got, e, 1, strip, chunk,
                               score_bits=4)
        hetero.hetero_ref(batch, scoring, want, e, 1, score_bits=4)
        assert_states_equal(got, want)
    plain = hetero.new_state(batch)
    hetero.hetero_ref(batch, scoring, plain)
    assert not torch.equal(want.rf, plain.rf)


def test_score_bits_equal_the_golden_wrap():
    """score_bits=12 where the wrap changes the answer: the step's model
    gives the JAX package's golden score with the wrap."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, 30).astype(np.uint8)
    b, c = a.copy(), a.copy()
    b[::7] = (b[::7] + 1) % 4
    c[::5] = (c[::5] + 2) % 4
    wide = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)
    batch = hetero.prep_hetero([(a, b, c)], 9, 17, "cpu")
    got = hetero.step_layout_ref(batch, wide, strip=4, chunk=3, score_bits=12)
    want = align_planes_numpy(a, b, c, jscoring(wide), score_bits=12)
    assert want != align_planes_numpy(a, b, c, jscoring(wide))
    assert int(got.max()) == want


def test_k4_refuses_score_bits():
    """K4 has no register width (the reference's hetero path has none):
    its entry points take no score_bits."""
    _, batch = dispatch(10)
    with pytest.raises(TypeError):
        hetero.final_values(batch, Scoring(), score_bits=12)
    with pytest.raises(TypeError):
        hetero.sweep_tiles(batch, hetero.new_state(batch), 0, 1, Scoring(),
                           score_bits=12)
