"""The port's heterogeneous batch sweep (K4) and chains against the reference.

On the CPU, K4's wrapper runs hetero_ref, which sweeps each problem of a
dispatch with K3's plain version from the dispatch's packed symbol buffer and
geometry table; so these tests exercise the packing, the per-diagonal tile
table and the dispatch split that the CUDA kernel uses; the packer and the
split are also held, field for field, to plain loops over the triplets
(plain_prep, plain_plan).  The reference's chains run in interpret mode at
the shapes tests/test_chain.py uses.  The CUDA kernel itself is compared
with hetero_ref in tests/test_torch_cuda.py.
Scores are integers: equality is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from trialign.config import Scoring as JScoring
from trialign.kernels.chain import align_chain as jax_align_chain
from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.golden import align_planes_numpy
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import chain, hetero, mosaic
from trialign_torch.kernels.ref import PAD_A, PAD_B, PAD_C

torch.set_num_threads(1)

RTL_NONDEFAULT = Scoring(match=2, mismatch=-3, gap_open=4, gap_extend=1,
                         s3_mode="rtl")
SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))


def _rt(rng, la, lb, lc, nsym=4):
    return tuple(rng.integers(0, nsym, s).astype(np.uint8)
                 for s in (la, lb, lc))


def golden(trips, scoring=Scoring()):
    return [align_planes_numpy(*t, scoring) if min(map(len, t)) else 0
            for t in trips]


def ref_values(trips, block, scoring=Scoring()):
    batch = hetero.prep_hetero(trips, *block, "cpu")
    return hetero.hetero_ref(batch, scoring).max(dim=1).values.tolist()


@pytest.mark.parametrize("lens,jax_block,scoring", [
    # tests/test_chain.py: basic, multiblock, nondefault (rtl) scoring
    (((12, 10, 14), (9, 13, 11), (15, 8, 16), (11, 12, 9)), (24, 128, 8),
     Scoring()),
    (((10, 25, 140), (8, 28, 135), (12, 22, 150)), (16, 128, 8), Scoring()),
    (((10, 12, 15), (8, 14, 10), (13, 9, 18)), (24, 128, 8),
     RTL_NONDEFAULT),
], ids=["basic", "multiblock", "rtl_nondefault"])
def test_matches_jax_align_chain(rng, lens, jax_block, scoring):
    trips = [_rt(rng, *n) for n in lens]
    want = jax_align_chain(trips, JScoring(**dataclasses.asdict(scoring)),
                           interpret=True, block_shape=jax_block)
    assert want == golden(trips, scoring)
    # Several tiles a problem (9 x 17), the reference's row count, and the
    # default 33 x 33 plane.
    for block in ((9, 17), (jax_block[0], 33), None):
        got = chain.align_chain(trips, scoring, block, device="cpu")
        assert got == want, block
    assert ref_values(trips, (9, 17), scoring) == want


def test_ragged_batch_over_several_dispatches(rng):
    """Different |A|, tile counts, a 1 x 1-tile problem, empty sequences and
    repeated final cells, cut into several dispatches by a small budget; the
    scores come back in input order and on_scores fires once a problem."""
    empty = (np.zeros(0, np.uint8), np.zeros(4, np.uint8),
             np.zeros(3, np.uint8))
    trips = [_rt(rng, 20, 30, 12), _rt(rng, 3, 5, 4), empty,
             _rt(rng, 7, 17, 40), _rt(rng, 25, 9, 9), _rt(rng, 11, 30, 12),
             _rt(rng, 1, 1, 1), _rt(rng, 14, 8, 33)]
    block = (9, 17)
    budget = 2 * hetero.face_bytes(20, 30, 12, *block)
    lens = [[len(x) for x in t] for t in trips]
    plan = hetero.plan_dispatches(lens, *block, budget)
    assert len(plan) >= 2
    fired = []
    got = hetero.align_hetero(trips, device="cpu", block_shape=block,
                              budget_bytes=budget,
                              on_scores=lambda i, s: fired.append((i, s)))
    assert got == golden(trips)
    assert sorted(fired) == list(enumerate(got))
    assert ref_values(trips, block) == got


def test_plan_dispatches_order_and_cuts():
    lens = [(5, 9, 9), (30, 9, 9), (0, 3, 3), (12, 9, 9), (30, 40, 40),
            (1, 1, 1)]
    block = (9, 9)
    one = hetero.plan_dispatches(lens, *block)
    assert one == [[1, 4, 3, 0, 5]]  # longest |A| first, empties left out
    assert hetero.plan_dispatches(lens, *block, max_problems=2) == \
        [[1, 4], [3, 0], [5]]
    big = hetero.face_bytes(30, 40, 40, *block)
    cut = hetero.plan_dispatches(lens, *block, budget_bytes=big - 1)
    assert [4] in cut  # past the budget alone: a dispatch of its own
    assert sorted(i for d in cut for i in d) == [0, 1, 3, 4, 5]
    for d in cut:
        need = sum(hetero.face_bytes(*lens[i], *block) for i in d)
        assert len(d) == 1 or need <= big - 1


def test_prep_hetero_tables(rng):
    """Each diagonal lists (problem, jb) pairs with jb + kb = d, problems in
    their order; symbol and face offsets of the problems do not overlap."""
    trips = [_rt(rng, 6, 20, 9), _rt(rng, 4, 3, 30),
             (np.zeros(0, np.uint8),) * 3, _rt(rng, 2, 9, 9)]
    b = hetero.prep_hetero(trips, 9, 9, "cpu")
    g = {name: b.geom[:, col] for col, name in
         enumerate(hetero.GEOM_FIELDS)}
    assert list(g["n_jb"]) == [3, 1, 0, 2]
    assert list(g["n_kb"]) == [2, 4, 0, 2]
    seen = set()
    for d in range(len(b.diag_start) - 1):
        rows = b.tiles[b.diag_start[d]:b.diag_start[d + 1]].tolist()
        assert [p for p, _ in rows] == sorted(p for p, _ in rows)
        for p, jb in rows:
            kb = d - jb
            assert 0 <= jb < g["n_jb"][p] and 0 <= kb < g["n_kb"][p]
            seen.add((p, jb, kb))
    assert len(seen) == len(b.tiles) == int((g["n_jb"] * g["n_kb"]).sum())
    assert b.rf_ints == int((g["n_kb"] * g["nrows"] * 7 * 9).sum())
    a0 = int(g["a_off"][0])
    assert b.syms[a0 + 1:a0 + 7].tolist() == trips[0][0].tolist()


def plain_prep(triplets, hb, wc):
    """The packer as a loop over triplets, each problem's arrays, geometry
    and tiles on its own, then a sort of every tile and a search for its
    neighbours: the plain version prep_hetero is held to.  Returns the
    fields of its HeteroBatch, the symbols as a NumPy array."""
    g_ = {name: col for col, name in enumerate(hetero.GEOM_FIELDS)}
    tb, tc = hb - 1, wc - 1
    n = len(triplets)
    geom = np.zeros((n, len(hetero.GEOM_FIELDS)), np.int64)
    lens = np.zeros((n, 3), np.int64)
    parts, off, rf, cf = [], 0, 0, 0
    tiles = []  # (diagonal, problem, jb)
    for p, t in enumerate(triplets):
        la, lb, lc = (len(x) for x in t)
        lens[p] = la, lb, lc
        if min(la, lb, lc) == 0:
            continue
        d = bk.plan_dims(la, lb, lc, hb, wc)
        g = geom[p]
        g[g_["la"]], g[g_["n_jb"]], g[g_["n_kb"]] = la, d.n_jb, d.n_kb
        g[g_["nrows"]] = d.nrows
        g[g_["jlstar"]] = lb - (d.n_jb - 1) * tb
        g[g_["klstar"]] = lc - (d.n_kb - 1) * tc
        for name, seq, size, pad in (
                ("a_off", t[0], la + 1, PAD_A),
                ("b_off", t[1], d.n_jb * tb + 1, PAD_B),
                ("c_off", t[2], d.n_kb * tc + 1, PAD_C)):
            arr = np.full(size, pad, np.int32)
            arr[1:len(seq) + 1] = np.asarray(seq, dtype=np.int32)
            parts.append(arr)
            g[g_[name]] = off
            off += size
        g[g_["rf_off"]], g[g_["cf_off"]] = rf, cf
        rf += d.n_kb * d.nrows * NUM_MATRICES * wc
        cf += d.n_jb * d.nrows * NUM_MATRICES * hb
        jb, kb = np.meshgrid(np.arange(d.n_jb), np.arange(d.n_kb),
                             indexing="ij")
        tiles.append(np.stack([(jb + kb).ravel(), np.full(jb.size, p),
                               jb.ravel()], axis=1))
    tiles = np.concatenate(tiles) if tiles else np.zeros((0, 3), np.int64)
    tiles = tiles[np.lexsort((tiles[:, 1], tiles[:, 0]))]
    n_diag = int(tiles[:, 0].max()) + 1 if len(tiles) else 0
    diag_start = np.searchsorted(tiles[:, 0], np.arange(n_diag + 1))
    syms = np.concatenate(parts) if parts else np.zeros(1, np.int32)
    # Each tile's upper and left neighbours, searched by 64-bit key.
    d, p, jb = (tiles[:, c].astype(np.int64) for c in range(3))
    kb = d - jb

    def key(jb_, kb_):
        return (p << 42) | ((jb_ & 0x1FFFFF) << 21) | (kb_ & 0x1FFFFF)

    keys = key(jb, kb)
    order = np.argsort(keys, kind="stable")
    table = np.stack([p, jb, kb, p, p], axis=1).astype(np.int32)
    for col, (dj, dk) in ((3, (1, 0)), (4, (0, 1))):
        want = key(jb - dj, kb - dk)
        at = np.minimum(np.searchsorted(keys[order], want), len(keys) - 1)
        found = (keys[order][at] == want) & (jb - dj >= 0) & (kb - dk >= 0)
        table[:, col] = np.where(found, order[at], -1)
    return dict(syms=syms, geom=geom, lens=lens,
                tiles=np.ascontiguousarray(table[:, :2]),
                diag_start=diag_start, rf_ints=rf, cf_ints=cf, table=table)


def plain_plan(lens, hb, wc, budget_bytes=None, max_problems=None):
    """plan_dispatches as a loop over triplets: each problem's face bytes
    from its own plan_dims, cut greedily, the longest |A| first."""
    def need(la, lb, lc):
        d = bk.plan_dims(la, lb, lc, hb, wc)
        return 4 * NUM_MATRICES * d.nrows * (d.n_kb * wc + d.n_jb * hb)

    lens = [tuple(int(x) for x in t) for t in lens]
    order = sorted((i for i, t in enumerate(lens) if min(t) > 0),
                   key=lambda i: -lens[i][0])
    out, used = [], 0
    for i in order:
        b = need(*lens[i])
        full = out and (
            (budget_bytes is not None and used + b > budget_bytes)
            or (max_problems is not None and len(out[-1]) >= max_problems))
        if not out or full:
            out.append([])
            used = 0
        out[-1].append(i)
        used += b
    return out


def _trips(rng, shapes, kind=np.uint8):
    """Triplets of the given lengths, as ``kind`` arrays or ("list")
    Python lists."""
    trips = []
    for shape in shapes:
        t = tuple(rng.integers(0, 4, n) for n in shape)
        trips.append(tuple(x.tolist() if kind == "list" else x.astype(kind)
                           for x in t))
    return trips


def _ragged(rng, n, lo, hi):
    return [tuple(int(x) for x in rng.integers(lo, hi + 1, 3))
            for _ in range(n)]


EMPTY = (0, 7, 9)
# (tile plane, lengths, element type) for each case of the packer's test.
PACK_CASES = {
    "plane_5x9": ((5, 9), lambda r: _ragged(r, 12, 1, 40), np.uint8),
    "plane_9x9": ((9, 9), lambda r: _ragged(r, 12, 1, 40), np.uint8),
    "plane_33x17": ((33, 17), lambda r: _ragged(r, 12, 1, 90), np.uint8),
    "plane_33x33": ((33, 33), lambda r: _ragged(r, 12, 1, 90), np.uint8),
    "empty_first": ((9, 17), lambda r: [EMPTY] + _ragged(r, 6, 1, 40),
                    np.uint8),
    "empty_middle": ((9, 17), lambda r: _ragged(r, 3, 1, 40) + [
        (5, 0, 4), (6, 3, 0)] + _ragged(r, 3, 1, 40), np.uint8),
    "empty_last": ((9, 17), lambda r: _ragged(r, 6, 1, 40) + [EMPTY],
                   np.uint8),
    "empty_only": ((9, 9), lambda r: [EMPTY, (0, 0, 0), (3, 0, 2)],
                   np.uint8),
    "lengths_1_tb_tb1": ((9, 17), lambda r: [
        (1, 1, 1), (8, 8, 16), (9, 9, 17), (1, 8, 17), (9, 1, 16),
        (8, 9, 1)], np.uint8),
    "single_problem": ((9, 17), lambda r: [(30, 25, 40)], np.uint8),
    "random_200": ((9, 17), lambda r: _ragged(r, 200, 1, 120), np.uint8),
    "int64_arrays": ((9, 17), lambda r: _ragged(r, 10, 1, 40), np.int64),
    "python_lists": ((9, 17), lambda r: _ragged(r, 10, 1, 40), "list"),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_prep_hetero_equals_plain_packer(rng, case):
    """prep_hetero packs exactly what the loop over triplets packs: every
    field, element for element and in its dtype; on the CPU the device
    tensors are the host arrays."""
    (hb, wc), shapes, kind = PACK_CASES[case]
    trips = _trips(rng, shapes(rng), kind)
    got = hetero.prep_hetero(trips, hb, wc, "cpu")
    want = plain_prep(trips, hb, wc)
    assert (got.hb, got.wc) == (hb, wc)
    for name, w in want.items():
        g = getattr(got, name)
        if name == "syms":
            assert g.dtype == torch.int32
            g = g.numpy()
        if isinstance(w, int):
            assert type(g) is int and g == w, name
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert np.array_equal(g, w), name
    assert np.array_equal(got.geom_dev.numpy(), want["geom"])
    assert np.array_equal(got.table_dev.numpy(), want["table"])


@pytest.mark.parametrize("budget,max_problems", [
    (None, None), ("small", None), (None, 3), ("small", 3)],
    ids=["no_limit", "budget", "max_problems", "budget_and_max_problems"])
def test_plan_dispatches_equals_greedy_loop(budget, max_problems):
    """plan_dispatches cuts as the loop over triplets does, ties in |A|
    and empty problems included, over random lengths and tile planes."""
    rng = np.random.default_rng(16)
    for block in ((9, 9), (9, 17), (33, 33)):
        for rep in range(6):
            lens = [(int(rng.integers(0, 4)) * int(rng.integers(1, 60)),
                     int(rng.integers(1, 90)), int(rng.integers(0, 90)))
                    for _ in range(int(rng.integers(1, 60)))]
            if rep == 0:  # dispatches that fill the budget exactly
                lens = [(30, 45, 45)] * 7 + [(0, 45, 45)]
            limit = None
            if budget:  # a few problems a dispatch, the largest alone
                limit = int(rng.integers(1, 6)) * \
                    hetero.face_bytes(30, 45, 45, *block)
            got = hetero.plan_dispatches(lens, *block, limit, max_problems)
            assert got == plain_plan(lens, *block, limit, max_problems)
            assert all(type(i) is int for d in got for i in d)


@pytest.mark.parametrize("fn", [
    lambda t, s: chain.align_chain(t, s, device="cpu"),
    lambda t, s: chain.align_batch_chained(t, s, device="cpu"),
    lambda t, s: mosaic.align_batch_mosaic(t, s, device="cpu"),
], ids=["align_chain", "align_batch_chained", "align_batch_mosaic"])
def test_refuses_submatrix_past_hetero_gate(rng, fn):
    """As the reference: more than 4 symbols, or entries outside a byte."""
    five = tuple(tuple(1 if i == j else -1 for j in range(5))
                 for i in range(5))
    for sub in (five, ((300, -1), (-1, 300))):
        with pytest.raises(ValueError, match="4 symbols"):
            fn([_rt(rng, 5, 5, 5)], Scoring(submatrix=sub))


def test_submatrix_and_batch_chained(rng):
    """A 4-symbol submatrix, codes past it scoring the floor, through
    align_batch_chained with two problems a dispatch."""
    sc = Scoring(submatrix=SUB4)
    trips = [_rt(rng, 11, 9, 17, 6), _rt(rng, 6, 9, 13, 6),
             _rt(rng, 14, 21, 8, 6), _rt(rng, 3, 10, 17, 6),
             (np.zeros(2, np.uint8), np.zeros(0, np.uint8),
              np.zeros(5, np.uint8))]
    got = chain.align_batch_chained(trips, sc, max_p=2, device="cpu")
    assert got == golden(trips, sc)


def test_kernel_wrapper_refuses_other_devices(rng):
    batch = hetero.prep_hetero([_rt(rng, 3, 3, 3)], 9, 9, "meta")
    with pytest.raises(ValueError, match="no hetero kernel"):
        hetero.final_values(batch)


def test_failed_dispatch_drains_the_queued_ones(rng, monkeypatch):
    """A failure as the second dispatch is packed: the first dispatch's
    scores still reach on_scores before the error, and
    align_batch_resilient (through align_batch_mosaic) then dispatches only
    the problems that had not drained."""
    from trialign_torch import resilience

    trips = [_rt(rng, 9, 12, 10), _rt(rng, 8, 11, 13), _rt(rng, 7, 10, 9),
             _rt(rng, 6, 9, 12), _rt(rng, 5, 13, 8)]
    real = hetero.prep_hetero
    preps, fired = [], []

    def flaky(*args, **kwargs):
        preps.append(len(args[0]))
        if len(preps) == 2:
            raise RuntimeError("injected failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(hetero, "prep_hetero", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        hetero.align_hetero(trips, device="cpu", block_shape=(9, 9),
                            max_problems=2,
                            on_scores=lambda i, s: fired.append((i, s)))
    want = golden(trips)
    assert len(fired) == 2
    assert all(want[i] == s for i, s in fired)

    # The batch in dispatches of two problems, the second failing once.
    real_align = hetero.align_hetero
    monkeypatch.setattr(hetero, "align_hetero", lambda *a, **k: real_align(
        *a, **{**k, "max_problems": 2}))
    preps.clear()
    seen = []

    def batch_fn(sub, scoring, mesh=None, on_scores=None):
        seen.append(len(sub))
        return mosaic.align_batch_mosaic(sub, scoring, device="cpu",
                                         on_scores=on_scores)

    got = resilience.align_batch_resilient(trips, batch_fn=batch_fn,
                                           backoff_s=0.0)
    assert got == want
    assert seen == [5, 3]
