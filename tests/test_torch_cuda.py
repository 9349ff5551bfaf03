"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
without them, where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Inputs come from a seeded numpy generator; scores are integers, so equality
is exact (tolerance 0).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from trialign_torch import api
from trialign_torch.config import Scoring
from trialign_torch.golden import align_planes_numpy, rescore_alignment
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import hetero
from trialign_torch.kernels import ref
from trialign_torch.kernels import slab as sk
from trialign_torch.kernels import vpu
from trialign_torch.kernels import wavefront as wf
from trialign_torch.native import score_native_batch
from trialign_torch.traceback.engine import NEG

pytestmark = pytest.mark.cuda

SCORINGS = {
    "sop": (Scoring(), 4),
    "rtl": (Scoring(s3_mode="rtl"), 4),
    "nondefault": (Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2), 4),
    "sub4": (Scoring(submatrix=((3, -1, -2, 0), (-2, 2, -1, -3),
                                (0, -3, 4, -1), (-1, -2, -1, 1))), 6),
    # The kernels' largest table, BLOSUM62's 24 symbols, its entries in
    # BLOSUM62's range and not symmetric, and BLASTP's gaps; codes 24 and
    # 25 score the floor row, as pads do.
    "sub24": (Scoring(gap_open=12, gap_extend=1, submatrix=tuple(
        tuple(int(v) for v in row)
        for row in np.random.default_rng(24).integers(-4, 12, (24, 24)))),
        26),
}
# A 16-symbol table, on K5 and the direct engine.
SUB16 = Scoring(submatrix=tuple(
    tuple(int(v) for v in row)
    for row in np.random.default_rng(16).integers(-4, 6, (16, 16))))
# NCBI BLOSUM62 with BLASTP's gaps, as the benchmark's protein
# configuration states it; codes 24 and 25 score the floor row.
with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "configs",
        "protfam.json")) as _f:
    _PROT = json.load(_f)["scoring"]
BLOSUM62 = Scoring(gap_open=_PROT["gap_open"], gap_extend=_PROT["gap_extend"],
                   submatrix=tuple(map(tuple, _PROT["submatrix"])))
SLAB_SCORINGS = {**SCORINGS, "sub16": (SUB16, 18), "blosum62": (BLOSUM62, 26)}


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


# K2's tiles on the card: the shapes of chip_smoke.py's wavefront phase
# (ragged last tiles, tiny problems, |A| much longer than |B| and |C|) at
# the tile planes its tuning chooses between and a plane of 4 x 8 cells.
K2_SHAPES = [(1, 1, 1), (6, 5, 7), (40, 4, 6), (50, 1, 60), (64, 64, 64),
             (255, 255, 255), (4096, 16, 16)]
K2_PLANES = [(17, 17), (33, 17), (33, 33), (5, 9)]
WIDE = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)


@pytest.mark.parametrize("block", K2_PLANES)
@pytest.mark.parametrize("dims", K2_SHAPES)
def test_wavefront_tiles_match_sweep(card, dims, block):
    """One launch a call, all seven values the plain sweep's, at chunks 1,
    4 and the longest, and grids of 1 and 3 blocks and the occupancy's."""
    args = wf.prep(*triplet(4, dims), card)
    want = ref.sweep(args[0][0], args[1][0], args[2][0], *dims)
    for chunk, blocks in ((1, 1), (4, 3), (hetero.MAX_CHUNK, None)):
        before = wf.final_values.launches
        got = wf.final_values(*args, block=block, chunk=chunk,
                              blocks=blocks)
        assert wf.final_values.launches == before + 1
        assert got[0].cpu().tolist() == want.cpu().tolist()


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("dims", [(64, 64, 64), (255, 255, 255)])
def test_wavefront_tiles_under_each_scoring(card, dims, name):
    scoring, nsym = SCORINGS[name]
    args = wf.prep(*triplet(5, dims, nsym), card)
    got = wf.final_values(*args, scoring, block=(17, 17))[0]
    want = ref.sweep(args[0][0], args[1][0], args[2][0], *dims, scoring)
    assert got.cpu().tolist() == want.cpu().tolist()


@pytest.mark.parametrize("block", K2_PLANES)
def test_wavefront_score_bits_on_card(card, block):
    """score_bits=12 where the wrap changes the answer: the register step's
    wrap equals the plain sweep's and the golden model's."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 4, 64).astype(np.uint8)
    b, c = a.copy(), a.copy()
    b[::7] = (b[::7] + 1) % 4
    c[::5] = (c[::5] + 2) % 4
    args = wf.prep(a, b, c, card)
    got = wf.final_values(*args, WIDE, 12, block=block)[0]
    want = ref.sweep(args[0][0], args[1][0], args[2][0], 64, 64, 64, WIDE, 12)
    assert got.cpu().tolist() == want.cpu().tolist()
    g12 = align_planes_numpy(a, b, c, WIDE, score_bits=12)
    assert int(got.max()) == g12 != align_planes_numpy(a, b, c, WIDE)


def padded_batch(card, seed, n=40):
    """A padded batch of mixed lengths, |B| and |C| up to 255, |A| up to
    600, with an empty sequence among them."""
    from trialign_torch.dist.batch import prep_padded

    rng = np.random.default_rng(seed)
    lens = [(int(rng.integers(1, 601)), int(rng.integers(1, 256)),
             int(rng.integers(1, 256))) for _ in range(n)]
    lens[3] = (0, 10, 10)
    trips = [tuple(rng.integers(0, 4, x).astype(np.uint8) for x in t)
             for t in lens]
    return trips, prep_padded(trips, card)


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_wavefront_matches_plain_on_a_padded_batch(card, name):
    """40 triplets in one launch, all seven values of each the plain
    sweep's on the card; the empty one all zero."""
    scoring, _ = SCORINGS[name]
    _, (a, b, c, lens) = padded_batch(card, 7)
    before = wf.final_values.launches
    got = wf.final_values(a, b, c, lens, scoring)
    assert wf.final_values.launches == before + 1
    for p, dims in enumerate(lens.tolist()):
        want = ref.sweep(a[p], b[p], c[p], *dims, scoring) if min(dims) \
            else torch.zeros(7, dtype=torch.int32, device=card)
        assert torch.equal(got[p], want), p
    assert got[3].tolist() == [0] * 7


def test_wavefront_launches_split_at_the_budget(card, monkeypatch):
    """Faces past the share of the card one launch takes, and past the
    budget: launches of consecutive problems, the same values."""
    _, args = padded_batch(card, 8, 12)
    want = wf.final_values(*args)
    monkeypatch.setattr(wf, "ONE_LAUNCH_SHARE", 0)
    monkeypatch.setattr(hetero, "default_budget", lambda dev: 1)
    before = wf.final_values.launches
    got = wf.final_values(*args)
    assert wf.final_values.launches == before + 11  # the empty one: none
    assert torch.equal(got, want)


def test_wavefront_on_two_streams_at_once(card):
    """Two persistent launches, each sized to the whole card, on two
    streams at once: each has its own progress words, neither waits on the
    other."""
    from trialign_torch.dist import mesh

    inputs = [padded_batch(card, s)[1] for s in (9, 10)]
    want = [wf.final_values(*x) for x in inputs]
    streams = mesh.SlotStreams([card, card])
    got = []
    for k, x in enumerate(inputs):
        with streams.on(k):
            got.append(wf.final_values(*x))
    streams.join()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bits", [0, 12])
@pytest.mark.parametrize("block,threads", [((33, 33), 256), ((33, 17), 128),
                                           ((17, 17), 128)])
def test_wavefront_step_resources(card, block, threads, bits):
    res = wf.step_resources(block, score_bits=bits)
    assert res["threads"] == threads
    assert res["blocks_per_sm"] >= 1 and res["registers"] > 0


@pytest.mark.parametrize("block", [(33, 33), (33, 17)])
def test_only_a_submatrix_reserves_the_table(card, block):
    """K2's and K4's match/mismatch modes reserve no shared memory for the
    table, their submatrix modes the whole 25 x 25 ints; K5's block
    likewise (csrc/slab.cu), as kernels/slab.py counts it."""
    from trialign_torch import _build

    table = 4 * (_build.SUBMATRIX_NSYM_CAP + 1) ** 2
    sub, rtl = SCORINGS["sub24"][0], SCORINGS["rtl"][0]
    k4 = [hetero.step_resources(*block, s)["shared_bytes"]
          for s in (Scoring(), sub, rtl)]
    k2 = [wf.step_resources(block, s)["shared_bytes"]
          for s in (Scoring(), sub, rtl)]
    assert k4[1] == k4[0] + table and k4[2] == k4[0]
    assert k2[1] == k2[0] + table and k2[2] == k2[0]
    lib = _build.load("slab")
    for nsym in (0, 4, 24):
        assert lib.trialign_slab_shared_bytes(*block, nsym) == \
            sk.shared_bytes(*block) - (0 if nsym else table)


def test_hetero_entry_refuses_score_bits(card):
    """K4's C entry refuses score_bits: K2's mode of the step is not K4's."""
    from trialign_torch import _build

    batch = hetero_batch(card, 25, (33, 33))
    state = hetero.new_state(batch)
    lib = _build.load("hetero")
    step, table = _build.kernel_scoring(Scoring(), 12, card)
    nxt = torch.zeros(1, dtype=torch.int32, device=card)
    code = lib.trialign_hetero_sweep(
        batch.syms.data_ptr(), batch.geom_dev.data_ptr(),
        batch.table_dev.data_ptr(), 0, len(batch.tiles), batch.hb, batch.wc,
        table.data_ptr(), step, state.rf.data_ptr(), state.cf.data_ptr(),
        state.out.data_ptr(), state.done.data_ptr(), nxt.data_ptr(),
        hetero.CHUNK, 0, 0, torch.cuda.current_stream().cuda_stream)
    assert code != 0


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("dims,block", [((10, 40, 50), (17, 33)),
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


@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
@pytest.mark.parametrize("name", sorted(SLAB_SCORINGS))
@pytest.mark.parametrize("dims,block", [((12, 20, 30), (9, 17)),
                                        ((7, 8, 9), (9, 17)),
                                        ((15, 40, 33), (17, 9)),
                                        ((40, 100, 70), None)])
def test_slab_kernel_matches_plain(card, dims, block, name, variant):
    """K5's capture (every tile's plane, halo included) and final vector
    equal slab_ref's, on multi-tile, ragged and single-tile shapes, at the
    tile planes 9 x 17, 17 x 9 and 33 x 33."""
    scoring, nsym = SLAB_SCORINGS[name]
    a, b, c = (x.astype(np.int32) for x in triplet(4, dims, nsym))
    ev = np.full(7, NEG, np.int32)
    ev[len(a) % 7] = 0
    d = sk._plan(*dims, block)
    arrs = sk.prep_blocked(a, b, c, d, card)
    f_k, cap_k = sk.slab_sweep(*arrs, *dims, d, variant, ev, scoring)
    f_r, cap_r = sk.slab_ref(*arrs, *dims, d, variant, ev, scoring)
    assert torch.equal(cap_k, cap_r)
    if variant != "bwd":
        assert torch.equal(f_k, f_r)


@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
def test_slab_step_resources(card, variant):
    """K5 on K3's register step: a warp a strip of 4 columns, 8 warps at the
    33 x 33 plane, two blocks an SM, at most 128 registers a thread."""
    d = sk._plan(64, 64, 64)
    for scoring in (Scoring(), SCORINGS["rtl"][0], BLOSUM62):
        res = sk.step_resources(d, scoring, variant)
        assert res["threads"] == 256 and res["blocks_per_sm"] == 2
        assert 0 < res["registers"] <= 128
    assert sk.blocks_per_sm(d) == 2


def test_traceback_on_card_rescores(card, monkeypatch):
    """A top split through K5 (caps lowered so that 60 x 70 x 80 splits),
    on the card: the alignment rescores to the score path's score."""
    from trialign_torch.traceback import hirschberg as hb

    monkeypatch.setattr(hb, "BASE_CELLS", 1 << 12)
    monkeypatch.setattr(hb, "DIRECT_CELLS", 1 << 17)
    monkeypatch.setattr(hb, "SLAB_KERNEL_CELLS", 1 << 16)
    a, b, c = triplet(5, (60, 70, 80))
    before = sk.slab_sweep.launches
    r = api.align(a, b, c, return_alignment=True)
    assert sk.slab_sweep.launches > before
    assert r.score == api.align(a, b, c).score
    assert rescore_alignment(r.alignment) == r.score


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("block", [(9, 17), None])
def test_hetero_kernel_matches_plain(card, block, name):
    """K4's final vectors equal hetero_ref's: ragged lengths, several tile
    counts, a 1 x 1-tile problem and an empty sequence in one dispatch."""
    scoring, nsym = SCORINGS[name]
    rng = np.random.default_rng(6)
    trips = [tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in lens)
             for lens in ((20, 30, 12), (3, 5, 4), (0, 4, 3), (7, 17, 40),
                          (25, 9, 9), (1, 1, 1), (60, 70, 50))]
    hb, wc = block or bk.choose_block_shape(0, 0, 0)
    batch = hetero.prep_hetero(trips, hb, wc, card)
    got = hetero.final_values(batch, scoring)
    assert torch.equal(got, hetero.hetero_ref(batch, scoring))


def test_hetero_pack_one_copy(card):
    """A dispatch packed for the card: its symbols, geometry and table are
    the host arrays (and the CPU packing's), views of one device
    allocation; align_hetero on 64 triplets of 128-512 symbols gives the
    exact scores.  The scores are held to the C++ oracle, whose scores
    hetero_ref's equal (tests/test_torch_hetero.py); hetero_ref itself
    takes minutes on a dispatch of this size."""
    rng = np.random.default_rng(16)
    trips = [tuple(rng.integers(0, 4, int(n)).astype(np.uint8)
                   for n in rng.integers(128, 513, 3)) for _ in range(64)]
    block = bk.choose_block_shape(0, 0, 0)
    batch = hetero.prep_hetero(trips, *block, card)
    host = hetero.prep_hetero(trips, *block, "cpu")
    assert torch.equal(batch.syms.cpu(), host.syms)
    assert torch.equal(batch.geom_dev.cpu(), torch.from_numpy(batch.geom))
    assert torch.equal(batch.table_dev.cpu(), torch.from_numpy(batch.table))
    assert np.array_equal(batch.geom, host.geom)
    assert np.array_equal(batch.table, host.table)
    assert len({t.untyped_storage().data_ptr() for t in
                (batch.syms, batch.geom_dev, batch.table_dev)}) == 1
    assert hetero.align_hetero(trips, device=card) == \
        score_native_batch(trips)


def test_align_batch_on_card_matches_align(card):
    """70 triplets take K4; 10 take one K2 launch and K3."""
    rng = np.random.default_rng(7)
    trips = [tuple(rng.integers(0, 4, int(n)).astype(np.uint8)
                   for n in rng.integers(1, 90, 3)) for _ in range(70)]
    before = hetero.final_values.launches
    got = [r.score for r in api.align_batch(trips)]
    assert hetero.final_values.launches > before
    assert got == [api.align(*t).score for t in trips]
    small = trips[:8] + [tuple(rng.integers(0, 4, n).astype(np.uint8)
                               for n in (20, 300, 30)),
                          (trips[0][0], trips[0][1][:0], trips[0][2])]
    got = [r.score for r in api.align_batch(small)]
    assert got == [api.align(*t).score if min(map(len, t)) else 0
                   for t in small]


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("dims,block,cuts", [
    ((10, 40, 50), (9, 17), (2, 3, 1, 4)),      # 5 x 3 tiles, cuts mid-diagonal
    ((37, 70, 45), (17, 9), (5, 1, 7)),
    ((20, 300, 280), None, (13, 30, 2)),
])
def test_per_tile_form_matches_plain(card, dims, block, cuts, name):
    """K3's per-tile form run in segments that end in the middle of
    anti-diagonals: the state (faces and output) after every segment equals
    blocked_ref's over the same tiles, and the final values equal the
    whole-grid sweep's."""
    scoring, nsym = SCORINGS[name]
    d = bk.plan_dims(*dims, *(block or bk.choose_block_shape(*dims)))
    trip = triplet(8, dims, nsym)
    arrs = bk.prep_blocked(*trip, d, card)
    arrs_cpu = bk.prep_blocked(*trip, d, "cpu")
    got, want = bk.new_state(d, card), bk.new_state(d, "cpu")
    idx = 0
    for cut in (*cuts, bk.n_tiles(d)):
        count = min(cut, bk.n_tiles(d) - idx)
        if count <= 0:
            break
        before = bk.sweep_tiles.launches
        bk.sweep_tiles(*arrs, *dims, d, got, idx, count, scoring)
        assert bk.sweep_tiles.launches == before + 1
        bk.blocked_ref(*arrs_cpu, *dims, d, scoring, 0, want, idx, count)
        idx += count
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert got.out[0].cpu().tolist() == \
        bk.final_values(*arrs, *dims, d, scoring).cpu().tolist()


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("dims,block", [((12, 40, 50), (9, 17)),
                                        ((30, 70, 45), (33, 33)),
                                        ((5, 20, 9), (9, 9))])
def test_chain_kernel_matches_plain(card, dims, block, name):
    """K3 in chain mode, 3 slots over multi-tile shapes (slot borders cross
    the face exchange): every slot's final values equal blocked_ref's, and
    each slot's score the golden model's."""
    scoring, nsym = SCORINGS[name]
    la, lb, lc = dims
    rng = np.random.default_rng(9)
    a_list = [rng.integers(0, nsym, la).astype(np.uint8) for _ in range(3)]
    b, c = (rng.integers(0, nsym, n).astype(np.uint8) for n in (lb, lc))
    d = bk.plan_dims_packed(la, lb, lc, 3, *block)
    arrs = bk.prep_chain(a_list, b, c, d, card)
    before = bk.chain_values.launches
    got = bk.chain_values(*arrs, la, lb, lc, d, scoring)
    assert bk.chain_values.launches > before
    want = bk.blocked_ref(*bk.prep_chain(a_list, b, c, d, "cpu"), la, lb, lc,
                          d, scoring)
    assert torch.equal(got.cpu(), want)
    assert got.max(dim=1).values.tolist() == \
        [align_planes_numpy(a, b, c, scoring) for a in a_list]


@pytest.mark.parametrize("dpx", [False, True])
@pytest.mark.parametrize("ops", vpu.OPS)
def test_vpu_kernel_matches_plain(card, ops, dpx):
    x = torch.from_numpy(np.random.default_rng(10).integers(
        -1000, 1000, 3000).astype(np.int32))
    before = vpu.vpu_chains.launches
    got = vpu.vpu_chains(x.to(card), 3, ops, dpx)
    assert vpu.vpu_chains.launches == before + 1
    assert torch.equal(got.cpu(), vpu.vpu_ref(x, 3, ops, dpx))


@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
@pytest.mark.parametrize("name", ["sop", "sub16"])
def test_slab_per_tile_form_matches_plain(card, name, variant):
    """K5's per-tile form in runs of 3 and 7 tiles (4 x 5 tiles, most runs
    ending mid-diagonal): the capture and final vector after the last run
    equal slab_ref's whole sweep."""
    scoring, nsym = SLAB_SCORINGS[name]
    dims = (10, 30, 40)
    a, b, c = (x.astype(np.int32) for x in triplet(11, dims, nsym))
    ev = np.full(7, NEG, np.int32)
    ev[3] = 0
    d = sk._plan(*dims, (9, 9))
    arrs = sk.prep_blocked(a, b, c, d, card)
    f_r, cap_r = sk.slab_ref(*arrs, *dims, d, variant, ev, scoring)
    for every in (3, 7):
        state = sk.new_state(*dims, d, ev, card)
        n = bk.n_tiles(d)
        before = sk.sweep_tiles.launches
        for idx in range(0, n, every):
            sk.sweep_tiles(*arrs, *dims, d, variant, state, idx,
                           min(every, n - idx), scoring)
        assert sk.sweep_tiles.launches == before + -(-n // every)
        assert torch.equal(state.cap, cap_r)
        if variant != "bwd":
            assert torch.equal(state.out, f_r)


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_hetero_per_tile_form_matches_plain(card, name):
    """K4's per-tile form in runs of 2 and 11 table entries: the faces and
    final values equal hetero_ref's whole sweep."""
    scoring, nsym = SCORINGS[name]
    rng = np.random.default_rng(12)
    trips = [tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in lens)
             for lens in ((20, 30, 12), (3, 5, 4), (0, 4, 3), (7, 17, 40),
                          (1, 1, 1), (25, 9, 26))]
    batch = hetero.prep_hetero(trips, 9, 9, card)
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, scoring, want)
    before = hetero.sweep_tiles.launches
    for every in (2, 11):
        got = hetero.new_state(batch)
        n = len(batch.tiles)
        for idx in range(0, n, every):
            hetero.sweep_tiles(batch, got, idx, min(every, n - idx), scoring)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert hetero.sweep_tiles.launches > before


@pytest.mark.parametrize("overlap", [True, False])
def test_halo_on_card_matches_whole_sweep(card, overlap):
    """Two stripes sharing the card, each on its own stream, the face copy
    on a copy stream or on the stripe's: K3's whole-grid values."""
    from trialign_torch.dist import halo, mesh

    dims = (40, 200, 300)
    trip = triplet(13, dims)
    d = bk.plan_dims(*dims, 33, 33)
    want = bk.final_values(*bk.prep_blocked(*trip, d, card), *dims, d)
    m = mesh.make_mesh(1, 2, devices=[card, card])
    got = halo.halo_values(*trip, mesh=m, block_shape=(33, 33),
                           overlap=overlap)
    assert torch.equal(got, want.cpu())


def test_sharded_traceback_on_card_rescores(card):
    """Splits swept in 2 stripes on the card: the golden score and an
    alignment that rescores to it."""
    from trialign_torch.dist import halo_tb, mesh

    a, b, c = triplet(14, (40, 50, 60))
    m = mesh.make_mesh(1, 2, devices=[card, card])
    score, rows = halo_tb.hirschberg_align_sharded(
        a, b, c, mesh=m, single_cells=20000, block_shape=(9, 17))
    assert score == align_planes_numpy(a, b, c) == rescore_alignment(rows)


@functools.lru_cache(maxsize=None)
def blocked_plain(dims, block):
    """blocked_ref's final values of triplet(15, dims) at tile plane
    ``block``, on the card; each parametrised case reuses them."""
    d = bk.plan_dims(*dims, *block)
    arrs = bk.prep_blocked(*triplet(15, dims), d, torch.device("cuda"))
    return bk.blocked_ref(*arrs, *dims, d)


@pytest.mark.parametrize("blocks", [1, 3, None])
@pytest.mark.parametrize("chunk", [1, 3, 7, bk.MAX_CHUNK])
@pytest.mark.parametrize("dims,block", [
    ((37, 70, 45), (9, 17)),       # 8 x 3 tiles, ragged
    ((60, 200, 300), (33, 33)),    # 7 x 10 tiles
    ((50, 130, 90), (17, 17)),
])
def test_persistent_sweep_matches_plain(card, dims, block, chunk, blocks):
    """K3's whole grid in one persistent launch, at any chunk its rings take
    and any grid cap (1 block sweeps the table alone): the final values
    equal blocked_ref's over the same tile table on the card, and the
    golden score."""
    d = bk.plan_dims(*dims, *block)
    trip = triplet(15, dims)
    arrs = bk.prep_blocked(*trip, d, card)
    want = blocked_plain(dims, block)
    before = bk.final_values.launches
    got = bk.final_values(*arrs, *dims, d, chunk=chunk, blocks=blocks)
    assert bk.final_values.launches == before + 1
    assert torch.equal(got, want)
    assert int(got.max()) == align_planes_numpy(*trip)


@pytest.mark.parametrize("blocks", [1, 3, None])
def test_persistent_chain_matches_plain(card, blocks):
    """Chain mode in one persistent launch: every slot's seven values equal
    blocked_ref's on the card."""
    la, lb, lc = 30, 100, 70
    rng = np.random.default_rng(16)
    a_list = [rng.integers(0, 4, la).astype(np.uint8) for _ in range(4)]
    b, c = (rng.integers(0, 4, n).astype(np.uint8) for n in (lb, lc))
    d = bk.plan_dims_packed(la, lb, lc, 4, 17, 17)
    arrs = bk.prep_chain(a_list, b, c, d, card)
    want = bk.blocked_ref(*arrs, la, lb, lc, d)
    before = bk.chain_values.launches
    got = bk.chain_values(*arrs, la, lb, lc, d, chunk=5, blocks=blocks)
    assert bk.chain_values.launches == before + 1
    assert torch.equal(got, want)


def slab_inputs(card, name):
    """The persistent slab test's inputs: (dims, tile dims, arrays, ev)."""
    _, nsym = SLAB_SCORINGS[name]
    dims = (20, 60, 50)
    a, b, c = (x.astype(np.int32) for x in triplet(17, dims, nsym))
    ev = np.full(7, NEG, np.int32)
    ev[2] = 0
    d = sk._plan(*dims, (9, 17))
    return dims, d, sk.prep_blocked(a, b, c, d, card), ev


@functools.lru_cache(maxsize=None)
def slab_plain(name, variant):
    """slab_ref's (final, capture) on slab_inputs, on the card; each
    parametrised case reuses them."""
    dims, d, arrs, ev = slab_inputs(torch.device("cuda"), name)
    return sk.slab_ref(*arrs, *dims, d, variant, ev, SLAB_SCORINGS[name][0])


@pytest.mark.parametrize("blocks", [1, 3, None])
@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
@pytest.mark.parametrize("name", ["sop", "sub16"])
def test_persistent_slab_matches_plain(card, name, variant, blocks):
    """K5's whole grid in one persistent launch: capture and final vector
    bit for bit those of slab_ref over the same tile table on the card."""
    dims, d, arrs, ev = slab_inputs(card, name)
    f_want, cap_want = slab_plain(name, variant)
    before = sk.slab_sweep.launches
    f, cap = sk.slab_sweep(*arrs, *dims, d, variant, ev,
                           SLAB_SCORINGS[name][0], chunk=3, blocks=blocks)
    assert sk.slab_sweep.launches == before + 1
    assert torch.equal(cap, cap_want)
    assert torch.equal(f, f_want)


def hetero_batch(card, seed, block, nsym=4):
    """A ragged dispatch: several tile counts, a 1 x 1-tile problem, an
    empty sequence, final cells inside their tiles."""
    rng = np.random.default_rng(seed)
    trips = [tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in lens)
             for lens in ((60, 70, 50), (20, 30, 12), (3, 5, 4), (0, 4, 3),
                          (7, 17, 40), (1, 1, 1), (25, 9, 26), (40, 64, 64))]
    return hetero.prep_hetero(trips, *block, card)


def assert_hetero_states_equal(got, want):
    for g, w, name in zip(got, want, want._fields):
        assert torch.equal(g, w), name


@functools.lru_cache(maxsize=None)
def hetero_plain(block):
    """hetero_ref's whole state on hetero_batch(card, 20, block); each
    parametrised case reuses it."""
    batch = hetero_batch(torch.device("cuda"), 20, block)
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, state=want)
    return want


# K4's tile planes on the card: one sub-tile ((9, 17), the default), and
# tiles cut into 2 x 2 sub-tiles and into four ragged columns of them.
HETERO_PLANES = [(9, 17), (33, 33), (34, 65), (16, 128)]


@pytest.mark.parametrize("blocks", [1, 3, None])
@pytest.mark.parametrize("chunk", [1, 7, hetero.MAX_CHUNK])
@pytest.mark.parametrize("block", HETERO_PLANES)
def test_persistent_hetero_matches_plain(card, block, chunk, blocks):
    """K4 over a whole dispatch in one persistent launch, at chunks up to
    the longest its rings take and at any grid cap (1 block sweeps the
    table alone): faces, final values and progress words equal hetero_ref's
    on the card."""
    batch = hetero_batch(card, 20, block)
    n = len(batch.tiles)
    want = hetero_plain(block)
    before = hetero.sweep_tiles.launches
    got = hetero.sweep_tiles(batch, hetero.new_state(batch), 0, n,
                             chunk=chunk, blocks=blocks)
    assert hetero.sweep_tiles.launches == before + 1
    assert_hetero_states_equal(got, want)


@pytest.mark.parametrize("block", HETERO_PLANES)
@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_hetero_step_matches_plain_under_each_scoring(card, name, block):
    """Every scoring mode at every plane: one launch a dispatch, the final
    values hetero_ref's."""
    scoring, nsym = SCORINGS[name]
    batch = hetero_batch(card, 21, block, nsym)
    before = hetero.final_values.launches
    got = hetero.final_values(batch, scoring)
    assert hetero.final_values.launches == before + 1
    assert torch.equal(got, hetero.hetero_ref(batch, scoring))


@pytest.mark.parametrize("run", ["entry", "diagonal", "quarter"])
def test_hetero_per_tile_runs_match_plain(card, run):
    """K4's per-tile form in runs of one entry, of one diagonal and of a
    quarter of the table, one launch a run: the whole state equals
    hetero_ref's (its progress words included)."""
    batch = hetero_batch(card, 22, (9, 17))
    n = len(batch.tiles)
    if run == "entry":
        bounds = list(range(n + 1))
    elif run == "diagonal":
        bounds = [int(x) for x in batch.diag_start]
    else:
        bounds = list(range(0, n, max(1, n // 4))) + [n]
    want = hetero.new_state(batch)
    hetero.hetero_ref(batch, state=want)
    got = hetero.new_state(batch)
    before = hetero.sweep_tiles.launches
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        hetero.sweep_tiles(batch, got, lo, hi - lo)
    assert hetero.sweep_tiles.launches == before + len(bounds) - 1
    assert_hetero_states_equal(got, want)


def test_hetero_mesh_of_two_slots_on_one_card(card):
    """The sharded batch on two data slots of one card: one launch a
    dispatch on each slot's stream, the scores those of one device."""
    from trialign_torch.dist import mesh
    from trialign_torch.kernels import mosaic

    rng = np.random.default_rng(23)
    trips = [tuple(rng.integers(0, 4, int(n)).astype(np.uint8)
                   for n in rng.integers(1, 90, 3)) for _ in range(70)]
    m = mesh.make_mesh(2, 1, devices=[card, card])
    before = hetero.sweep_tiles.launches
    got = mosaic.align_batch_mosaic(trips, mesh=m)
    assert hetero.sweep_tiles.launches == before + 2
    assert got == mosaic.align_batch_mosaic(trips, device=card)
    assert got == [api.align(*t).score if min(map(len, t)) else 0
                   for t in trips]


def test_hetero_refuses_a_chunk_past_its_rings(card):
    batch = hetero_batch(card, 24, (33, 33))
    with pytest.raises(ValueError, match="chunk"):
        hetero.final_values(batch, chunk=hetero.MAX_CHUNK + 1)


@pytest.mark.parametrize("block,threads", [((33, 33), 256), ((9, 17), 128),
                                           ((16, 128), 256)])
def test_hetero_step_resources(card, block, threads):
    """A warp a strip of 4 columns, at most 8: two blocks an SM."""
    res = hetero.step_resources(*block)
    assert res["threads"] == threads
    assert res["blocks_per_sm"] >= 2 and res["registers"] > 0


# K3's and K5's per-tile forms, one persistent launch a call: runs of the
# tile table (most end mid-diagonal) and bands of stripes' columns, at grid
# caps of 1 and 3 blocks and the occupancy's.
RUNS = (1, 5, 7, 13)
CAPS = (1, 3, None)


def stripe_bands(n_jb, n_kb, band, ndev):
    """Every band of every stripe, band by band, in run_stripes' order."""
    from trialign_torch.dist import halo

    return [bk.rect_tiles(rows, cols)
            for rows in halo.bands(n_jb, band)
            for cols in halo.stripe_columns(n_kb, ndev)]


def blocked_runs(card, name, runs, blocks):
    """K3's per-tile form over ``runs`` (tile lists) on one state against
    blocked_ref over the same lists: the whole state after every run, one
    launch a run."""
    scoring, nsym = SCORINGS[name]
    dims = (30, 80, 100)
    d = bk.plan_dims(*dims, 9, 17)
    assert (d.n_jb, d.n_kb) == (10, 7)
    trip = triplet(30, dims, nsym)
    arrs = bk.prep_blocked(*trip, d, card)
    arrs_cpu = bk.prep_blocked(*trip, d, "cpu")
    got, want = bk.new_state(d, card), bk.new_state(d, "cpu")
    for tiles in runs(d):
        before = bk.sweep_tiles.launches
        bk.sweep_run(*arrs, *dims, d, got, tiles, scoring, blocks=blocks)
        assert bk.sweep_tiles.launches == before + 1
        bk.blocked_ref(*arrs_cpu, *dims, d, scoring, 0, want, tiles=tiles)
        for g, w, field in zip(got, want, want._fields):
            assert torch.equal(g.cpu(), w), field
    assert int(got.out[0].max()) == align_planes_numpy(*trip, scoring)


@pytest.mark.parametrize("blocks", CAPS)
@pytest.mark.parametrize("every", RUNS)
def test_blocked_per_tile_runs_one_launch_each(card, every, blocks):
    blocked_runs(card, "sop", lambda d: [
        bk.table_run(d, i, min(every, bk.n_tiles(d) - i))
        for i in range(0, bk.n_tiles(d), every)], blocks)


@pytest.mark.parametrize("blocks", CAPS)
@pytest.mark.parametrize("band,ndev", [(1, 2), (2, 3), (3, 2), (10, 3)])
def test_blocked_per_tile_bands_one_launch_each(card, band, ndev, blocks):
    blocked_runs(card, "sop", lambda d: stripe_bands(d.n_jb, d.n_kb, band,
                                                     ndev), blocks)


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_blocked_per_tile_runs_under_each_scoring(card, name):
    blocked_runs(card, name, lambda d: [
        bk.table_run(d, i, min(13, bk.n_tiles(d) - i))
        for i in range(0, bk.n_tiles(d), 13)], None)


def slab_runs(card, name, variant, runs):
    """K5's per-tile form over ``runs`` on one state, at every grid cap,
    against slab_ref's whole sweep: capture and final vector, one launch a
    run."""
    scoring, nsym = SLAB_SCORINGS[name]
    dims = (12, 40, 60)
    a, b, c = (x.astype(np.int32) for x in triplet(31, dims, nsym))
    ev = np.full(7, NEG, np.int32)
    ev[5] = 0
    d = sk._plan(*dims, (9, 9))
    arrs = sk.prep_blocked(a, b, c, d, card)
    f_r, cap_r = sk.slab_ref(*arrs, *dims, d, variant, ev, scoring)
    for blocks in CAPS:
        state = sk.new_state(*dims, d, ev, card)
        tiles = runs(d)
        before = sk.sweep_tiles.launches
        for t in tiles:
            sk.sweep_run(*arrs, *dims, d, variant, state, t, scoring,
                         blocks=blocks)
        assert sk.sweep_tiles.launches == before + len(tiles)
        assert torch.equal(state.cap, cap_r)
        if variant != "bwd":
            assert torch.equal(state.out, f_r)


@pytest.mark.parametrize("every", RUNS)
@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
def test_slab_per_tile_runs_one_launch_each(card, variant, every):
    slab_runs(card, "sop", variant, lambda d: [
        bk.table_run(d, i, min(every, bk.n_tiles(d) - i))
        for i in range(0, bk.n_tiles(d), every)])


@pytest.mark.parametrize("band,ndev", [(1, 2), (2, 3), (5, 2)])
@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
def test_slab_per_tile_bands_one_launch_each(card, variant, band, ndev):
    slab_runs(card, "sub16", variant, lambda d: stripe_bands(
        d.n_jb, d.n_kb, band, ndev))


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("band", [1, 2, None])
@pytest.mark.parametrize("ndev", [2, 3])
def test_halo_in_bands_on_card(card, ndev, band, overlap):
    """Stripes sharing the card in bands of 1, 2 and all tile rows under
    both schedules: K3's whole-grid values, one launch a band a stripe."""
    from trialign_torch.dist import halo, mesh

    dims = (40, 200, 300)
    trip = triplet(32, dims)
    d = bk.plan_dims(*dims, 33, 33)
    want = bk.final_values(*bk.prep_blocked(*trip, d, card), *dims, d)
    row = halo.model_row(mesh.make_mesh(1, ndev, devices=[card] * ndev))
    before = bk.sweep_tiles.launches
    _, stripes = halo.sweep_stripes(*trip, Scoring(), row, (33, 33),
                                    overlap, band_rows=band or d.n_jb)
    assert bk.sweep_tiles.launches == before + ndev * len(
        halo.bands(d.n_jb, band or d.n_jb))
    assert torch.equal(stripes[-1].state.out[0], want)


@pytest.mark.parametrize("band", [1, 3])
@pytest.mark.parametrize("variant", sorted(sk.VARIANTS))
def test_sharded_slab_in_bands_on_card(card, variant, band):
    """K5's stripes in bands on the card: the gathered capture and the
    final vector equal slab_sweep's."""
    from trialign_torch.dist import halo, halo_tb, mesh

    dims = (20, 60, 80)
    a, b, c = (x.astype(np.int32) for x in triplet(33, dims))
    ev = np.full(7, NEG, np.int32)
    ev[1] = 0
    d = sk._plan(*dims, (9, 17))
    f_w, cap_w = sk.slab_sweep(*sk.prep_blocked(a, b, c, d, card), *dims, d,
                               variant, ev)
    row = halo.model_row(mesh.make_mesh(1, 2, devices=[card] * 2))
    before = sk.sweep_tiles.launches
    _, stripes = halo_tb._sharded_sweep(a, b, c, Scoring(), row, variant, ev,
                                        (9, 17), True, band)
    assert sk.sweep_tiles.launches == before + 2 * len(halo.bands(d.n_jb,
                                                                  band))
    cap = halo_tb._gather_caps(d, stripes, stripes[0], 0)
    assert torch.equal(cap, cap_w)
    if variant != "bwd":
        assert torch.equal(stripes[-1].state.out, f_w)


def test_per_tile_forms_refuse_a_neighbour_after_its_tile(card):
    trip = triplet(34, (10, 20, 20))
    d = bk.plan_dims(10, 20, 20, 9, 9)
    arrs = bk.prep_blocked(*trip, d, card)
    before = bk.sweep_tiles.launches
    with pytest.raises(ValueError, match="feeds"):
        bk.sweep_run(*arrs, 10, 20, 20, d, bk.new_state(d, card),
                     [(1, 0), (0, 0)])
    assert bk.sweep_tiles.launches == before


# The direct engine's kernels (traceback/direct.py): the choice-capture
# sweep against its plain torch version on every cuboid slot, under every
# scoring K5 takes and one where every gap charge ties, in every mode, on
# ragged shapes (a length of 1, an empty B or C, several 33 x 33 tiles);
# the walk against the host walk.
DIRECT_SCORINGS = {**SLAB_SCORINGS,
                   "ties": (Scoring(match=2, mismatch=-1, gap_open=3,
                                    gap_extend=3), 2)}
DIRECT_SHAPES = [(1, 1, 1), (1, 40, 3), (30, 1, 45), (12, 0, 40),
                 (3, 50, 0), (9, 70, 40), (40, 34, 66)]


def direct_inputs(seed, dims, nsym, mode):
    """A triplet of ``dims`` and, for "pin", a start vector: small values
    with NEG walls."""
    rng = np.random.default_rng(seed)
    trip = tuple(rng.integers(0, nsym, n).astype(np.int32) for n in dims)
    if mode != "pin":
        return trip, None
    v0 = rng.integers(-9, 10, 7).astype(np.int32)
    v0[rng.random(7) < 0.5] = NEG
    return trip, v0


def assert_choices_equal(got, want, dims):
    """Equal final vectors, and equal packed entries on every cuboid slot."""
    from trialign_torch.traceback import direct as D

    assert torch.equal(got[0].cpu(), want[0].cpu())
    on = D.cuboid_slots(*dims, device=got[1].device)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g[on], w[on])


@pytest.mark.parametrize("mode", ["free", "free_jk", "pin"])
@pytest.mark.parametrize("name", sorted(DIRECT_SCORINGS))
@pytest.mark.parametrize("dims", DIRECT_SHAPES)
def test_choice_kernel_matches_plain(card, dims, name, mode):
    from trialign_torch.traceback import direct as D

    scoring, nsym = DIRECT_SCORINGS[name]
    (a, b, c), v0 = direct_inputs(7, dims, nsym, mode)
    before = sk.choice_sweep.launches
    got = D.choices(a, b, c, scoring, mode, v0, card)
    assert sk.choice_sweep.launches == before + 1
    assert_choices_equal(got, D._choices(a, b, c, scoring, mode, v0, card),
                         dims)


@pytest.mark.parametrize("mode", ["free", "free_jk", "pin"])
def test_choice_kernel_at_scale(card, mode):
    """Many tiles (7 x 8 of 33 x 33), all seven states chosen."""
    from trialign_torch.traceback import direct as D

    dims = (200, 220, 250)
    (a, b, c), v0 = direct_inputs(8, dims, 4, mode)
    got = D.choices(a, b, c, Scoring(), mode, v0, card)
    assert_choices_equal(got, D._choices(a, b, c, Scoring(), mode, v0, card),
                         dims)


@pytest.mark.parametrize("mode", ["free", "free_jk", "pin"])
@pytest.mark.parametrize("dims", [(30, 1, 45), (40, 34, 66),
                                  (120, 90, 100)])
def test_walk_kernel_matches_host_walk(card, dims, mode):
    """From every end state: the walk kernel's count, steps and stop equal
    its plain version's, on the kernel's buffers."""
    from trialign_torch.traceback import direct as D

    (a, b, c), v0 = direct_inputs(9, dims, 4, mode)
    _, lo, hi = D.choices(a, b, c, Scoring(), mode, v0, card)
    for t0 in range(7):
        before = D.walk.launches
        got = D.walk(lo, hi, t0, *dims, mode).cpu()
        assert D.walk.launches == before + 1
        want = D.walk_ref(lo, hi, t0, *dims, mode).cpu()
        n = int(want[0])
        assert torch.equal(got[:4 + n], want[:4 + n])


@pytest.mark.parametrize("mode", ["free", "free_jk", "pin"])
@pytest.mark.parametrize("name", ["sop", "rtl", "sub16", "ties"])
def test_direct_traceback_on_card_matches_cpu(card, monkeypatch, name,
                                              mode):
    """direct_traceback on the card (one launch of each kernel, the torch
    sweep never called) equals it on the CPU."""
    from trialign_torch.traceback import direct as D

    scoring, nsym = DIRECT_SCORINGS[name]
    (a, b, c), v0 = direct_inputs(10, (50, 61, 47), nsym, mode)
    end = None if mode == "free" else 3
    want = D.direct_traceback(a, b, c, scoring, mode, v0, end, device="cpu")
    launches = sk.choice_sweep.launches, D.walk.launches

    def plain(*args, **kwargs):
        raise AssertionError("the torch sweep ran on the card path")

    monkeypatch.setattr(D, "_choices", plain)
    got = D.direct_traceback(a, b, c, scoring, mode, v0, end, device=card)
    assert (sk.choice_sweep.launches, D.walk.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert got == want
