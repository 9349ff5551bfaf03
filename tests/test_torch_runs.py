"""The per-tile forms of K3 and K5 as one persistent launch a run, on the CPU.

On the card ``blocked.sweep_run`` and ``slab.sweep_run`` (and ``sweep_tiles``,
a run of the tile table) sweep a run of tiles in one persistent launch: a
tile starts each chunk of planes once its neighbours in the run have
finished the planes ``blocked.planes_needed`` names, and a neighbour outside
the run, swept by an earlier launch, counts as finished.  The model here
(``tests/test_torch_schedule.py`` readiness_sweep) sweeps the plain versions'
own plane steps in random orders the rule allows, run after run: runs of the
table that end mid-diagonal, and the bands of stripes that ``dist/halo.py``
launches.  The state must equal ``blocked_ref`` and ``slab_ref`` in table
order, and the scores the JAX package's golden model and engine; one plane
short of the rule must differ.  The host side of a run (its table, the
order it checks, the plain versions over a list of tiles) is tested too.
Inputs come from seeded numpy generators; integers, tolerance 0.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_schedule import (
    BLOCK, GRIDS, assert_states_equal, at_random, eager, k3_case, k3_model,
    k5_case, k5_model,
)
from trialign.golden import align_planes_numpy
from trialign.traceback import engine as jengine
from trialign_torch.config import Scoring
from trialign_torch.dist import halo
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import slab as sk

torch.set_num_threads(1)


def table_cuts(every):
    def runs(dims):
        n = bk.n_tiles(dims)
        return [bk.table_run(dims, i, min(every, n - i))
                for i in range(0, n, every)]
    return runs


def stripe_bands(band, ndev):
    """Each stripe's bands, band by band, as dist/halo.py launches them."""
    def runs(dims):
        out = [bk.rect_tiles(rows, cols)
               for rows in halo.bands(dims.n_jb, band)
               for cols in halo.stripe_columns(dims.n_kb, ndev)]
        return [r for r in out if r]
    return runs


# Runs of the table that end mid-diagonal, and stripe x band rectangles.
RUNS = {
    "runs of 5": table_cuts(5),
    "runs of 7": table_cuts(7),
    "bands of 1 in 2 stripes": stripe_bands(1, 2),
    "bands of 2 in 3 stripes": stripe_bands(2, 3),
}


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("runs", sorted(RUNS))
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_k3_runs_in_any_allowed_order_equal_table_order(grid, runs, chunk):
    trip, lens, dims, arrs, want = k3_case(grid, Scoring(), 0, 4, chunk)
    got = k3_model(arrs, lens, dims, Scoring(), 0, chunk, at_random(chunk),
                   runs=RUNS[runs](dims))
    assert_states_equal(got, want)
    assert int(got.out[0].max()) == align_planes_numpy(*trip)


@pytest.mark.parametrize("runs", sorted(RUNS))
@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
def test_k5_runs_in_any_allowed_order_equal_table_order(variant, runs):
    trip, lens, dims, arrs, ev, want = k5_case((4, 4), variant, 1)
    got = k5_model(arrs, lens, dims, variant, ev, Scoring(), 3, at_random(1),
                   runs=RUNS[runs](dims))
    assert_states_equal(got, want)
    if variant == "free":
        f, s, _ = jengine.forward_sweep(*trip, capture_m=lens[0])
        np.testing.assert_array_equal(got.out.numpy(), f)
        np.testing.assert_array_equal(
            sk._assemble(got.cap, dims, lens[1], lens[2]).numpy(), s)


def test_runs_one_plane_short_of_the_rule_differ():
    """Inside a band, waiting one plane less than planes_needed lets a tile
    read a face row its neighbour has not written yet."""
    runs = stripe_bands(2, 2)
    trip, lens, dims, arrs, want = k3_case((4, 4), Scoring(), 0, 4, 0)
    got = k3_model(arrs, lens, dims, Scoring(), 0, 1, eager, slack=1,
                   runs=runs(dims))
    assert not torch.equal(got.out, want.out)
    assert_states_equal(k3_model(arrs, lens, dims, Scoring(), 0, 1, eager,
                                 runs=runs(dims)), want)
    trip, lens, dims, arrs, ev, want = k5_case((4, 4), "bwd", 0)
    got = k5_model(arrs, lens, dims, "bwd", ev, Scoring(), 1, eager, slack=1,
                   runs=runs(dims))
    assert not torch.equal(got.cap, want.cap)


def test_a_run_must_follow_its_outside_neighbours():
    """The model refuses a run whose neighbour outside it is not swept, as
    the kernel would read faces nobody wrote."""
    trip, lens, dims, arrs, want = k3_case((4, 4), Scoring(), 0, 4, 0)
    with pytest.raises(AssertionError, match="not swept"):
        k3_model(arrs, lens, dims, Scoring(), 0, 3, at_random(0),
                 runs=[bk.rect_tiles((2, 4), (0, 4)),
                       bk.rect_tiles((0, 2), (0, 4))])


def test_rect_tiles_and_bands():
    assert bk.rect_tiles((1, 3), (2, 4)) == [(1, 2), (1, 3), (2, 2), (2, 3)]
    assert bk.rect_tiles((0, 3), (5, 6)) == [(0, 5), (1, 5), (2, 5)]
    assert bk.rect_tiles((0, 2), (3, 3)) == []
    assert halo.bands(7, 3) == [(0, 3), (3, 6), (6, 7)]
    assert halo.bands(4, 4) == halo.bands(4, 9) == [(0, 4)]


def test_run_table_names_neighbours_in_the_run():
    dims = bk.plan_dims(7, 20, 30, *BLOCK)  # 7 x 8 tiles
    table = bk.run_table(dims, bk.rect_tiles((2, 4), (3, 5)))
    assert table.dtype == np.int32 and table.shape == (4, len(bk.RUN_FIELDS))
    # (2, 3) (2, 4) (3, 3) (3, 4): the band's first row and column have
    # their neighbours outside the run.
    assert table.tolist() == [[2, 3, -1, -1], [2, 4, -1, 0], [3, 3, 0, -1],
                              [3, 4, 1, 2]]
    # A run of the table that ends mid-diagonal.
    run = bk.table_run(dims, 4, 5)
    assert run == bk.tile_table(dims)[4:9]
    for e, (jb, kb, up, left) in enumerate(bk.run_table(dims, run)):
        assert up == (run.index((jb - 1, kb)) if (jb - 1, kb) in run else -1)
        assert left == (run.index((jb, kb - 1)) if (jb, kb - 1) in run
                        else -1)
        assert up < e and left < e


@pytest.mark.parametrize("tiles,match", [
    ([(1, 0), (0, 0)], "feeds"),
    ([(0, 1), (0, 0)], "feeds"),
    ([(0, 0), (0, 0)], "twice"),
    ([(0, 8)], "outside"),
    ([(-1, 0)], "outside"),
])
def test_run_table_refuses_a_bad_run(tiles, match):
    dims = bk.plan_dims(7, 20, 30, *BLOCK)
    with pytest.raises(ValueError, match=match):
        bk.run_table(dims, tiles)
    trip = tuple(np.zeros(n, np.uint8) for n in (7, 20, 30))
    with pytest.raises(ValueError, match=match):
        bk.sweep_run(*bk.prep_blocked(*trip, dims, "cpu"), 7, 20, 30, dims,
                     bk.new_state(dims, "cpu"), tiles)


def test_plain_versions_over_a_list_equal_the_table_order(rng):
    """blocked_ref and slab_ref over lists of tiles (bands of stripes) equal
    their sweeps in table order; sweep_tiles is sweep_run of a table run;
    an empty list changes nothing."""
    lens = (9, 30, 40)
    trip = tuple(rng.integers(0, 4, n).astype(np.uint8) for n in lens)
    dims = bk.plan_dims(*lens, 9, 9)
    arrs = bk.prep_blocked(*trip, dims, "cpu")
    want = bk.new_state(dims, "cpu")
    bk.blocked_ref(*arrs, *lens, dims, state=want)
    got = bk.new_state(dims, "cpu")
    bk.sweep_run(*arrs, *lens, dims, got, [])
    assert int((got.rf != bk.UNWRITTEN).sum()) == 0
    for tiles in stripe_bands(2, 3)(dims):
        bk.sweep_run(*arrs, *lens, dims, got, tiles)
    assert_states_equal(got, want)
    got = bk.new_state(dims, "cpu")
    for tiles in table_cuts(4)(dims):
        bk.blocked_ref(*arrs, *lens, dims, state=got, tiles=tiles)
    assert_states_equal(got, want)

    seqs = tuple(x.astype(np.int32) for x in trip)
    ev = np.zeros(7, np.int32)
    sarrs = sk.prep_blocked(*seqs, dims, "cpu")
    for variant in sk.VARIANTS:
        swant = sk.new_state(*lens, dims, ev, "cpu")
        sk.slab_ref(*sarrs, *lens, dims, variant, None, state=swant)
        sgot = sk.new_state(*lens, dims, ev, "cpu")
        for tiles in stripe_bands(1, 2)(dims):
            sk.sweep_run(*sarrs, *lens, dims, variant, sgot, tiles)
        assert_states_equal(sgot, swant)
