"""The readiness rule of the persistent sweeps (K3, K4, K5), modelled in torch.

On the card, K3's whole-grid sweep (with its chain mode), K5's slab sweep
and every run of K4's table are one persistent launch each: a tile sweeps
its pillar in chunks of planes and starts a chunk once its upper and left
neighbours have finished the planes that ``kernels.blocked.planes_needed``
names (csrc/schedule.cuh).  The model here sweeps every tile's pillar with the plain versions' own plane
steps (``blocked.pillar_steps``, ``slab.pillar_steps``) on the same in-place
face slabs, one chunk at a time, taking the next chunk of a tile chosen at
random among those the rule allows.  Whatever the order, the state (faces,
final values, capture) must equal the anti-diagonal order of ``blocked_ref``
and ``slab_ref``, and the scores the JAX package's golden model and engine.
K4's table holds many problems and is swept in runs that may end
mid-diagonal; its progress words carry from run to run, and the state must
equal ``hetero_ref``'s.  A model that breaks the rule by one plane must
differ, which shows that the comparison can fail.  Inputs come from seeded
numpy generators; integers, tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from trialign.config import Scoring as JScoring
from trialign.golden import align_planes_numpy
from trialign.traceback import engine as jengine
from trialign_torch.config import Scoring
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import hetero
from trialign_torch.kernels import slab as sk
from trialign_torch.traceback.engine import NEG

torch.set_num_threads(1)

SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
# (scoring, score_bits, alphabet): the scorings of the port's K3 tests.
SCORINGS = {
    "default": (Scoring(), 0, 4),
    "rtl": (Scoring(s3_mode="rtl"), 0, 4),
    "nondefault": (Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2),
                   0, 4),
    "sub4": (Scoring(submatrix=SUB4), 0, 6),
    "wide_bits12": (Scoring(match=60, mismatch=-20, gap_open=80,
                            gap_extend=10), 12, 4),
}
# Tile grids (n_jb, n_kb) at tile plane (hb, wc) = (4, 5): tb = 3, tc = 4.
GRIDS = [(2, 3), (4, 4), (5, 2)]
BLOCK = (4, 5)
CHUNKS = [1, 3, 8]


def jscoring(sc):
    return JScoring(**dataclasses.asdict(sc))


def lengths(grid, la):
    """|A|, |B|, |C| that cut into ``grid`` tiles at BLOCK, ragged."""
    tb, tc = BLOCK[0] - 1, BLOCK[1] - 1
    return la, grid[0] * tb - 1, grid[1] * tc - 1


def triplet(seed, shape, nsym=4):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in shape)


def readiness_sweep(steps, dims, first, chunk, pick, slack=0, runs=None):
    """Sweep every tile's pillar ``chunk`` planes at a time, the next chunk
    that of the tile ``pick`` chooses among the tiles the readiness rule
    allows; ``steps(jb, kb)`` is the tile's plane generator from plane
    ``first``.  ``runs`` (lists of tiles; the whole table by default) go one
    after another, as the per-tile forms' launches do: a neighbour outside
    its tile's run must have finished in an earlier run, and counts as
    finished.  ``slack`` planes less than the rule asks break it."""
    done = {t: -1 for t in bk.tile_table(dims)}
    for run in runs or [bk.tile_table(dims)]:
        for jb, kb in run:
            for nb in ((jb - 1, kb), (jb, kb - 1)):
                assert nb in run or done.get(nb, dims.nq) == dims.nq, \
                    f"{nb} is outside the run of {(jb, kb)} and not swept"
        gens = {t: steps(*t) for t in run}
        nxt = {t: first for t in run}
        while True:
            ready = []
            for jb, kb in run:
                q1 = min(nxt[jb, kb] + chunk, dims.nq + 1)
                if nxt[jb, kb] > dims.nq:
                    continue
                up, left = bk.planes_needed(q1, dims)
                if (jb == 0 or done[jb - 1, kb] >= up - slack) and \
                        (kb == 0 or done[jb, kb - 1] >= left - slack):
                    ready.append((jb, kb))
            if not ready:
                break
            t = pick(ready)
            q1 = min(nxt[t] + chunk, dims.nq + 1)
            for _ in range(q1 - nxt[t]):
                next(gens[t])
            done[t], nxt[t] = q1 - 1, q1
        assert all(q > dims.nq for q in nxt.values()), "the model deadlocked"


def at_random(seed):
    rng = np.random.default_rng(seed)
    return lambda ready: ready[int(rng.integers(len(ready)))]


def eager(ready):
    """The tile furthest along the table: a successor as soon as allowed."""
    return ready[-1]


def k3_model(arrs, lens, dims, scoring, bits, chunk, pick, slack=0,
             runs=None):
    state = bk.new_state(dims, "cpu")

    def steps(jb, kb):
        return bk.pillar_steps(*arrs, lens[1], lens[2], dims, state,
                               torch.tensor([jb]), torch.tensor([kb]),
                               scoring, bits)

    readiness_sweep(steps, dims, 1, chunk, pick, slack, runs)
    return state


def k3_case(grid, scoring, bits, nsym, seed):
    lens = lengths(grid, 7)
    trip = triplet(seed, lens, nsym)
    dims = bk.plan_dims(*lens, *BLOCK)
    assert (dims.n_jb, dims.n_kb) == grid
    arrs = bk.prep_blocked(*trip, dims, "cpu")
    want = bk.new_state(dims, "cpu")
    bk.blocked_ref(*arrs, *lens, dims, scoring, bits, want)
    return trip, lens, dims, arrs, want


def assert_states_equal(got, want):
    for g, w, name in zip(got, want, want._fields):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_k3_any_allowed_order_equals_diagonal_order(grid, chunk, seed):
    trip, lens, dims, arrs, want = k3_case(grid, Scoring(), 0, 4, seed)
    got = k3_model(arrs, lens, dims, Scoring(), 0, chunk, at_random(seed))
    assert_states_equal(got, want)
    assert int(got.out[0].max()) == align_planes_numpy(*trip)


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_k3_model_under_each_scoring(grid, name):
    scoring, bits, nsym = SCORINGS[name]
    trip, lens, dims, arrs, want = k3_case(grid, scoring, bits, nsym, 5)
    got = k3_model(arrs, lens, dims, scoring, bits, 3, at_random(5))
    assert_states_equal(got, want)
    assert int(got.out[0].max()) == align_planes_numpy(
        *trip, jscoring(scoring), score_bits=bits)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_chain_of_three_slots(grid, chunk):
    la, lb, lc = lengths(grid, 4)
    rng = np.random.default_rng(chunk)
    a_list = [rng.integers(0, 4, la).astype(np.uint8) for _ in range(3)]
    b, c = (rng.integers(0, 4, n).astype(np.uint8) for n in (lb, lc))
    dims = bk.plan_dims_packed(la, lb, lc, 3, *BLOCK)
    arrs = bk.prep_chain(a_list, b, c, dims, "cpu")
    want = bk.new_state(dims, "cpu")
    bk.blocked_ref(*arrs, la, lb, lc, dims, state=want)
    got = k3_model(arrs, (la, lb, lc), dims, Scoring(), 0, chunk,
                   at_random(chunk))
    assert_states_equal(got, want)
    assert got.out.max(dim=1).values.tolist() == [
        align_planes_numpy(a, b, c) for a in a_list]


def k5_model(arrs, lens, dims, variant, ev, scoring, chunk, pick, slack=0,
             runs=None):
    state = sk.new_state(*lens, dims, ev, "cpu")

    def steps(jb, kb):
        return sk.pillar_steps(*arrs, lens[0], dims, variant, state,
                               np.array([jb * dims.n_kb + kb]), scoring)

    first = 0 if variant in ("pin", "bwd") else 1
    readiness_sweep(steps, dims, first, chunk, pick, slack, runs)
    return state


def k5_case(grid, variant, seed, scoring=Scoring(), nsym=4):
    lens = lengths(grid, 6)
    trip = tuple(x.astype(np.int32) for x in triplet(seed, lens, nsym))
    ev = np.full(7, NEG, np.int32)
    ev[seed % 7] = 0
    dims = sk._plan(*lens, BLOCK)
    arrs = sk.prep_blocked(*trip, dims, "cpu")
    want = sk.new_state(*lens, dims, ev, "cpu")
    sk.slab_ref(*arrs, *lens, dims, variant, ev, scoring, want)
    return trip, lens, dims, arrs, ev, want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
def test_k5_any_allowed_order_equals_diagonal_order(variant, grid, chunk,
                                                    seed):
    trip, lens, dims, arrs, ev, want = k5_case(grid, variant, seed)
    got = k5_model(arrs, lens, dims, variant, ev, Scoring(), chunk,
                   at_random(seed))
    assert_states_equal(got, want)
    if variant == "free":
        f, s, _ = jengine.forward_sweep(*trip, capture_m=lens[0])
        np.testing.assert_array_equal(got.out.numpy(), f)
        np.testing.assert_array_equal(
            sk._assemble(got.cap, dims, lens[1], lens[2]).numpy(), s)


@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
def test_k5_model_under_a_submatrix(variant):
    trip, lens, dims, arrs, ev, want = k5_case(
        (4, 4), variant, 3, Scoring(submatrix=SUB4), 6)
    got = k5_model(arrs, lens, dims, variant, ev, Scoring(submatrix=SUB4),
                   3, at_random(3))
    assert_states_equal(got, want)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_k3_one_plane_short_of_the_rule_differs(grid):
    """Waiting one plane less than planes_needed lets a tile read a face row
    its neighbour has not written yet (UNWRITTEN), and the state differs."""
    trip, lens, dims, arrs, want = k3_case(grid, Scoring(), 0, 4, 0)
    got = k3_model(arrs, lens, dims, Scoring(), 0, 1, eager, slack=1)
    assert not torch.equal(got.out, want.out)
    assert int(got.out[0].max()) >= bk.UNWRITTEN // 2
    # The rule itself, with the same eager order, is exact.
    assert_states_equal(
        k3_model(arrs, lens, dims, Scoring(), 0, 1, eager), want)


@pytest.mark.parametrize("variant", ["free", "bwd"])
def test_k5_one_plane_short_of_the_rule_differs(variant):
    trip, lens, dims, arrs, ev, want = k5_case((4, 4), variant, 0)
    got = k5_model(arrs, lens, dims, variant, ev, Scoring(), 1, eager,
                   slack=1)
    assert not torch.equal(got.cap, want.cap)
    assert_states_equal(
        k5_model(arrs, lens, dims, variant, ev, Scoring(), 1, eager), want)


def test_planes_needed_is_one_tile_width_behind():
    dims = bk.plan_dims(100, 60, 80, 17, 33)  # tb = 16, tc = 32
    assert bk.planes_needed(1, dims) == (16, 32)
    assert bk.planes_needed(41, dims) == (56, 72)
    assert bk.planes_needed(dims.nq + 1, dims) == (dims.nq, dims.nq)


@pytest.mark.parametrize("chunk,blocks", [(0, None), (-3, None), (8, 0),
                                          (8, -1)])
def test_persistent_wrappers_refuse_a_bad_schedule(chunk, blocks):
    lens = (5, 6, 7)
    trip = triplet(0, lens)
    dims = bk.plan_dims(*lens, *BLOCK)
    arrs = bk.prep_blocked(*trip, dims, "cpu")
    with pytest.raises(ValueError, match="chunk|blocks"):
        bk.final_values(*arrs, *lens, dims, chunk=chunk, blocks=blocks)
    sdims = sk._plan(*lens, BLOCK)
    with pytest.raises(ValueError, match="chunk|blocks"):
        sk.slab_sweep(*sk.prep_blocked(*trip, sdims, "cpu"), *lens, sdims,
                      "free", np.zeros(7, np.int32), chunk=chunk,
                      blocks=blocks)


@pytest.mark.parametrize("chunk,blocks", [(1, 1), (5, 3), (64, None)])
def test_scores_do_not_depend_on_the_schedule_arguments(chunk, blocks):
    """On the CPU the wrappers run the plain versions, whatever the chunk
    and the grid cap; so do the scores at other tile planes."""
    lens = (9, 13, 11)
    trip = triplet(4, lens)
    want = align_planes_numpy(*trip)
    for block in (BLOCK, (9, 17), None):
        dims = bk.plan_dims(*lens, *(block or bk.choose_block_shape(*lens)))
        got = bk.final_values(*bk.prep_blocked(*trip, dims, "cpu"), *lens,
                              dims, chunk=chunk, blocks=blocks)
        assert int(got.max()) == want


# K4: a dispatch's table of tiles over several problems, swept in runs.
K4_LENS = [(7, 11, 14), (3, 5, 4), (0, 4, 3), (1, 1, 1), (5, 8, 19)]


def k4_model(batch, scoring, runs, chunk, pick, slack=0):
    """K4's persistent sweep of ``runs`` ((idx0, count) in table order) on
    one state: within a run, the next chunk of an entry ``pick`` chooses
    among those the readiness rule allows against its neighbours' progress
    words; a neighbour of an earlier run reads as finished.  Each entry's
    planes are hetero_ref's own (blocked.pillar_steps on the dispatch's
    views), and its progress word is the last plane it finished."""
    state = hetero.new_state(batch)
    for idx0, count in runs:
        entries = list(range(idx0, idx0 + count))
        gens, dims, nxt = {}, {}, {}
        for e in entries:
            p, jb, kb = (int(x) for x in batch.table[e, :3])
            arrs, lens, d, pst = hetero._problem(batch, state, p)
            gens[e] = bk.pillar_steps(*arrs, lens[1], lens[2], d, pst,
                                      torch.tensor([jb]), torch.tensor([kb]),
                                      scoring)
            dims[e], nxt[e] = d, 1
        while True:
            ready = []
            for e in entries:
                if nxt[e] > dims[e].nq:
                    continue
                q1 = min(nxt[e] + chunk, dims[e].nq + 1)
                need = bk.planes_needed(q1, dims[e])
                if all(nb < 0 or int(state.done[nb]) >= n - slack
                       for nb, n in zip(batch.table[e, 3:], need)):
                    ready.append(e)
            if not ready:
                break
            e = pick(ready)
            q1 = min(nxt[e] + chunk, dims[e].nq + 1)
            for _ in range(q1 - nxt[e]):
                next(gens[e])
            state.done[e], nxt[e] = q1 - 1, q1
        assert all(nxt[e] > dims[e].nq for e in entries), "deadlocked"
    return state


def k4_case(name, seed):
    scoring, _, nsym = SCORINGS[name]
    rng = np.random.default_rng(seed)
    trips = [tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in t)
             for t in K4_LENS]
    batch = hetero.prep_hetero(trips, *BLOCK, "cpu")
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, scoring, want)
    return trips, scoring, batch, want


def k4_runs(batch, cut):
    """The whole table as runs of ``cut`` entries (0: one run)."""
    n = len(batch.tiles)
    step = cut or n
    return [(lo, min(step, n - lo)) for lo in range(0, n, step)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cut", [0, 5, 13])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_k4_any_allowed_order_equals_table_order(chunk, cut, seed):
    """Runs of 5 or 13 entries end mid-diagonal; the progress words carry
    from run to run.  Faces, final values and progress words equal
    hetero_ref's, and the scores the golden model."""
    trips, scoring, batch, want = k4_case("default", seed)
    got = k4_model(batch, scoring, k4_runs(batch, cut), chunk,
                   at_random(seed + cut))
    assert_states_equal(got, want)
    assert got.out.max(dim=1).values.tolist() == [
        align_planes_numpy(*t) if min(map(len, t)) else 0 for t in trips]


@pytest.mark.parametrize("name", ["rtl", "nondefault", "sub4"])
def test_k4_model_under_each_scoring(name):
    _, scoring, batch, want = k4_case(name, 3)
    got = k4_model(batch, scoring, k4_runs(batch, 7), 3, at_random(3))
    assert_states_equal(got, want)


def test_k4_one_plane_short_of_the_rule_differs():
    """Waiting one plane less than planes_needed lets a tile read a face row
    its neighbour has not written yet, and the state differs."""
    _, scoring, batch, want = k4_case("default", 0)
    got = k4_model(batch, scoring, k4_runs(batch, 0), 1, eager, slack=1)
    assert not torch.equal(got.out, want.out)
    assert_states_equal(
        k4_model(batch, scoring, k4_runs(batch, 0), 1, eager), want)


@pytest.mark.parametrize("chunk,blocks", [(0, None), (hetero.MAX_CHUNK + 1,
                                                      None), (1000, None),
                                          (8, 0), (8, -1)])
def test_k4_refuses_a_bad_schedule(chunk, blocks):
    """A chunk past the rings K4 holds (MAX_CHUNK) is refused on every
    device, as a chunk below 1 and a grid cap below 1 are, never run as
    another."""
    _, scoring, batch, _ = k4_case("default", 0)
    with pytest.raises(ValueError, match="chunk|blocks"):
        hetero.final_values(batch, scoring, chunk=chunk, blocks=blocks)
    with pytest.raises(ValueError, match="chunk|blocks"):
        hetero.sweep_tiles(batch, hetero.new_state(batch), 0, 1, scoring,
                           chunk=chunk, blocks=blocks)
