"""The port's data axis on CPU meshes: K4's per-tile form, the sharded
mosaic, ``align_batch_sharded`` and ``align_batch_resilient(mesh=...)``.

K4's per-tile form (``kernels/hetero.sweep_tiles``) runs through its plain
version ``hetero_ref`` on the CPU; in runs that end mid-diagonal it must
leave the whole sweep's final values, equal to the JAX package's
``align_chain`` in interpret mode (which reaches ``make_hetero_block_call``).
A mesh of n CPU slots spreads a batch over its data axis; every score must
equal the JAX package's ``align_batch_sharded`` on its virtual CPU devices
or the golden model.  Integers: equality is exact.
"""

import numpy as np
import pytest
import torch

from trialign.dist.batch import align_batch_sharded as jax_sharded
from trialign.dist.mesh import make_mesh as jax_make_mesh
from trialign.kernels.chain import align_chain as jax_align_chain
from trialign.golden import align_planes_numpy
from trialign_torch import resilience
from trialign_torch.config import Scoring
from trialign_torch.dist import batch as dbatch
from trialign_torch.dist import mesh
from trialign_torch.kernels import hetero, mosaic

torch.set_num_threads(1)

CPU = torch.device("cpu")
SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))


def cpu_mesh(data):
    return mesh.make_mesh(data, 1, devices=[CPU] * data)


def _rt(rng, *lens, nsym=4):
    return tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in lens)


def golden(trips, scoring=Scoring()):
    return [align_planes_numpy(*t, scoring) if min(map(len, t)) else 0
            for t in trips]


def in_runs(batch, every, scoring=Scoring()):
    state = hetero.new_state(batch)
    n = len(batch.tiles)
    for idx in range(0, n, every):
        hetero.sweep_tiles(batch, state, idx, min(every, n - idx), scoring)
    return state


@pytest.mark.parametrize("scoring,nsym", [
    (Scoring(), 4), (Scoring(s3_mode="rtl"), 4),
    (Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2), 4),
    (Scoring(submatrix=SUB4), 6),
], ids=["default", "rtl", "nondefault", "sub4"])
def test_per_tile_runs_equal_the_whole_dispatch(rng, scoring, nsym):
    """Ragged problems (an empty one, a 1 x 1-tile one) in runs of 2 and 11
    table entries: the faces and final values of the whole sweep."""
    trips = [_rt(rng, *n, nsym=nsym) for n in
             ((20, 30, 12), (3, 5, 4), (0, 4, 3), (7, 17, 40), (1, 1, 1),
              (25, 9, 26))]
    batch = hetero.prep_hetero(trips, 9, 9, CPU)
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, scoring, want)
    assert torch.equal(want.out, hetero.final_values(batch, scoring))
    for every in (2, 11):
        got = in_runs(batch, every, scoring)
        for g, w in zip(got, want):
            assert torch.equal(g, w), every
    assert want.out.max(dim=1).values.tolist() == golden(trips, scoring)


def test_per_tile_runs_match_jax_align_chain(rng):
    """tests/test_chain.py's basic chain: the reference's align_chain in
    interpret mode, one block a call through make_hetero_block_call."""
    trips = [_rt(rng, *n) for n in
             ((12, 10, 14), (9, 13, 11), (15, 8, 16), (11, 12, 9))]
    want = jax_align_chain(trips, interpret=True, block_shape=(24, 128, 8))
    batch = hetero.prep_hetero(trips, 5, 9, CPU)
    assert len(batch.tiles) > 20
    got = in_runs(batch, 3).out.max(dim=1).values.tolist()
    assert got == want == golden(trips)


def test_sweep_tiles_refuses_a_range_past_the_table(rng):
    batch = hetero.prep_hetero([_rt(rng, 5, 9, 9)], 5, 5, CPU)
    state = hetero.new_state(batch)
    with pytest.raises(ValueError, match="not in a table"):
        hetero.sweep_tiles(batch, state, 3, len(batch.tiles))


def batch_of(rng, n, lo=5, hi=20):
    return [_rt(rng, *rng.integers(lo, hi, 3)) for _ in range(n)]


def test_align_batch_sharded_matches_jax(rng):
    """7 triplets (not a multiple of the data axis) on 2 data slots."""
    trips = batch_of(rng, 7)
    want = jax_sharded(trips, mesh=jax_make_mesh(data=2, model=1))
    assert want == golden(trips)
    for ndata in (1, 2, 3):
        assert dbatch.align_batch_sharded(trips, mesh=cpu_mesh(ndata)) == want
    assert dbatch.align_batch_sharded([], mesh=cpu_mesh(2)) == []


def test_align_batch_sharded_long_and_empty(rng):
    """Triplets past K2's caps run K3 on the slots in turn; an empty
    sequence scores 0."""
    trips = batch_of(rng, 5) + [_rt(rng, 3, 260, 4), _rt(rng, 4, 0, 6),
                                _rt(rng, 2, 5, 258)]
    assert dbatch.align_batch_sharded(trips, mesh=cpu_mesh(2)) == \
        golden(trips)


def test_align_batch_sharded_takes_the_mosaic_route(rng, monkeypatch):
    """64 triplets with TRIALIGN_FORCE_MOSAIC=1: the mosaic over 2 data
    slots on K4's per-tile form, equal to the golden model."""
    monkeypatch.setenv("TRIALIGN_FORCE_MOSAIC", "1")
    trips = batch_of(rng, 64, 1, 9)
    calls = []
    real = hetero.sweep_tiles

    def spy(batch, *args, **kwargs):
        calls.append(batch.syms.device)
        return real(batch, *args, **kwargs)

    monkeypatch.setattr(hetero, "sweep_tiles", spy)
    assert dbatch.align_batch_sharded(trips, mesh=cpu_mesh(2)) == \
        golden(trips)
    assert calls


def test_mosaic_over_slots_and_on_scores(rng):
    """Each slot's share contiguous and balanced by cells; on_scores fires
    once a problem, an empty one included."""
    costs = [9, 1, 5, 7, 3, 8]
    chunks = mosaic._snake_chunks(costs, 2)
    assert sorted(i for ch in chunks for i in ch) == list(range(6))
    assert [sum(costs[i] for i in ch) for ch in chunks] == [17, 16]
    trips = batch_of(rng, 9) + [_rt(rng, 0, 4, 4)]
    fired = []
    got = mosaic.align_batch_mosaic(trips, mesh=cpu_mesh(3),
                                    on_scores=lambda i, s: fired.append(
                                        (i, s)))
    assert got == golden(trips)
    assert sorted(fired) == list(enumerate(got))
    assert mosaic.align_batch_mosaic(trips, mesh=cpu_mesh(2),
                                     residue_route="blocked") == got


def test_mosaic_refuses_a_data_axis_across_processes(rng):
    other = mesh.make_mesh(2, 1, devices=[mesh.Slot(0, CPU),
                                          mesh.Slot(1, CPU)])
    with pytest.raises(ValueError, match="align_batch_multihost"):
        mosaic.align_batch_mosaic(batch_of(rng, 2), mesh=other)


def test_memory_budget_is_shared_by_the_slots_of_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (1000, 4000))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 0)
    card = torch.device("cuda", 0)
    assert hetero.default_budget(card) == 500
    assert hetero.default_budget(card, 2) == 250
    assert hetero.default_budget(CPU, 2) is None


def test_memory_budget_counts_torch_cache_as_free(monkeypatch):
    """Bytes torch's allocator holds unused (reserved, not allocated) are
    free for a dispatch's faces: a large cache left by earlier work does not
    cut a batch into more dispatches."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (1000, 9000))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 6000)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 2000)
    card = torch.device("cuda", 0)
    assert hetero.default_budget(card) == 2500
    assert hetero.default_budget(card, 5) == 500


def test_align_batch_resilient_passes_the_mesh(rng):
    """One injected failure after the first dispatch drains: the retry
    dispatches only the unscored problems, on the same mesh."""
    trips = batch_of(rng, 12)
    m = cpu_mesh(2)
    seen, drained = [], {"n": 0}

    def batch_fn(sub, scoring, mesh=None, on_scores=None):
        seen.append((len(sub), mesh))

        def record(i, s):
            on_scores(i, s)
            drained["n"] += 1
            if drained["n"] == 4:
                raise RuntimeError("injected failure")

        return mosaic.align_batch_mosaic(sub, scoring, mesh=mesh,
                                         on_scores=record)

    got = resilience.align_batch_resilient(trips, mesh=m, batch_fn=batch_fn,
                                           backoff_s=0.0)
    assert got == golden(trips)
    assert [n for n, _ in seen] == [12, 8]
    assert all(x is m for _, x in seen)


def test_align_batch_resilient_keeps_the_finished_dispatches(rng,
                                                             monkeypatch):
    """Dispatches of one problem each (a one-byte memory budget) on 2 data
    slots; a failure raised as slot 0 packs its second dispatch.  Each
    slot's first dispatch has finished and drained by then, so the retry
    packs only the other 10 problems."""
    trips = batch_of(rng, 12)
    monkeypatch.setattr(hetero, "default_budget", lambda dev, sharing=1: 1)
    real = hetero.prep_hetero
    count = {"attempt": 0, "preps": 0}
    seen, fired = [], []

    def flaky(*args, **kwargs):
        if count["attempt"] == 1:
            count["preps"] += 1
            if count["preps"] == 3:
                raise RuntimeError("injected failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(hetero, "prep_hetero", flaky)

    def batch_fn(sub, scoring, mesh=None, on_scores=None):
        count["attempt"] += 1
        seen.append(len(sub))

        def record(i, s):
            fired.append(count["attempt"])
            on_scores(i, s)

        return mosaic.align_batch_mosaic(sub, scoring, mesh=mesh,
                                         on_scores=record)

    got = resilience.align_batch_resilient(trips, mesh=cpu_mesh(2),
                                           batch_fn=batch_fn, backoff_s=0.0)
    assert got == golden(trips)
    assert fired.count(1) == 2
    assert seen == [12, 10]
