"""K3 on the register step, on the card: the whole grid, chain mode and the
per-tile form against the plain versions on the card (``blocked_ref`` over
the same tiles, the whole-plane sweep ``ref.sweep``), the golden model and
the C++ oracle.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports neither JAX nor the JAX package (run it as tests/test_torch_cuda.py
says).  Each case runs under default scoring, RTL, BLOSUM62 (codes past its
24 symbols drawn) and score_bits; the tile planes are one sub-tile of the
register step (K3 takes no larger one), of one to eight strips, ragged
against the triplet.  Scores are integers: equality is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from trialign_torch.config import Scoring
from trialign_torch.golden import align_planes_numpy
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import ref
from trialign_torch.native import score_native

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "configs", "protfam.json")) as f:
    _PROTFAM = json.load(f)["scoring"]
BLOSUM62 = Scoring(gap_open=_PROTFAM["gap_open"],
                   gap_extend=_PROTFAM["gap_extend"],
                   submatrix=tuple(map(tuple, _PROTFAM["submatrix"])))
# Large enough that values pass a 12-bit register.
WIDE = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)

# name -> (scoring, score_bits, alphabet the sequences draw from).
MODES = {
    "sop": (Scoring(), 0, 4),
    "rtl": (Scoring(s3_mode="rtl"), 0, 4),
    "blosum62": (BLOSUM62, 0, 26),
    "bits": (WIDE, 12, 4),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def seqs(seed, lens, nsym):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, nsym, n).astype(np.uint8) for n in lens)


# (lens, tile plane): ragged last tiles in j and k; |A| shorter than a
# tile; 16-row tiles of 8 strips; 7 strips, the last 3 columns wide; 2
# strips, the last one column; one row of tiles, 20 columns of them.
WHOLE = [((37, 70, 45), (9, 17)), ((20, 300, 280), (33, 33)),
         ((10, 40, 50), (17, 33)), ((12, 80, 100), (33, 28)),
         ((25, 90, 70), (33, 6)), ((15, 20, 600), (21, 31))]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("lens,block", WHOLE)
def test_whole_grid_matches_plain(card, lens, block, mode):
    scoring, bits, nsym = MODES[mode]
    trip = seqs(41, lens, nsym)
    d = bk.plan_dims(*lens, *block)
    arrs = bk.prep_blocked(*trip, d, card)
    before = bk.final_values.launches
    got = bk.final_values(*arrs, *lens, d, scoring, bits)
    assert bk.final_values.launches == before + 1
    assert torch.equal(got, bk.blocked_ref(*arrs, *lens, d, scoring, bits))
    if not bits:
        assert int(got.max()) == align_planes_numpy(*trip, scoring)


def test_whole_grid_near_1500(card):
    """A ~1500^3 triplet at the default plane (47 x 47 tiles, the last
    ragged): all seven values equal the whole-plane sweep's on the card, and
    the score the C++ oracle's (about 95 s on the card's host)."""
    lens = (1500, 1503, 1490)
    trip = seqs(42, lens, 4)
    d = bk.plan_dims(*lens)
    assert (d.n_jb, d.n_kb) == (47, 47)
    arrs = bk.prep_blocked(*trip, d, card)
    got = bk.final_values(*arrs, *lens, d)
    assert torch.equal(got, ref.sweep(*arrs, *lens))
    assert int(got.max()) == score_native(*trip)


# (slot lens, tile plane, slots): pitch d = |A| + 1 at most tb + tc (9 x 17:
# 24; 33 x 33: 64) and past it, one of at most 4 (a strip's width), and
# 16-row tiles of 8 strips.
CHAINS = [((2, 30, 40), (9, 17), 5), ((10, 40, 50), (9, 17), 3),
          ((40, 40, 50), (9, 17), 3), ((40, 70, 45), (33, 33), 4),
          ((80, 70, 45), (33, 33), 3), ((7, 50, 60), (17, 33), 3)]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("lens,block,npack", CHAINS)
def test_chain_matches_plain(card, lens, block, npack, mode):
    scoring, bits, nsym = MODES[mode]
    la, lb, lc = lens
    rng = np.random.default_rng(43)
    a_list = [rng.integers(0, nsym, la).astype(np.uint8)
              for _ in range(npack)]
    b, c = (rng.integers(0, nsym, n).astype(np.uint8) for n in (lb, lc))
    d = bk.plan_dims_packed(la, lb, lc, npack, *block)
    arrs = bk.prep_chain(a_list, b, c, d, card)
    before = bk.chain_values.launches
    got = bk.chain_values(*arrs, la, lb, lc, d, scoring, bits)
    assert bk.chain_values.launches == before + 1
    assert got.shape == (npack, 7)
    assert torch.equal(got, bk.blocked_ref(*arrs, la, lb, lc, d, scoring,
                                           bits))
    if not bits:
        assert got.max(dim=1).values.tolist() == \
            [align_planes_numpy(a, b, c, scoring) for a in a_list]


def checkpoint_runs(d):
    """Runs of 5 tiles of the table, cut in the middle of diagonals."""
    n = bk.n_tiles(d)
    return [bk.table_run(d, i, min(5, n - i)) for i in range(0, n, 5)]


def band_runs(rows, ndev):
    """The halo's runs: bands of ``rows`` tile rows of each stripe."""
    from trialign_torch.dist import halo

    def runs(d):
        return [bk.rect_tiles(r, c) for r in halo.bands(d.n_jb, rows)
                for c in halo.stripe_columns(d.n_kb, ndev)]
    return runs


RUN_KINDS = {"checkpoint": checkpoint_runs, "band1": band_runs(1, 2),
             "band2": band_runs(2, 3)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", sorted(RUN_KINDS))
@pytest.mark.parametrize("lens,block", [((30, 80, 100), (9, 17)),
                                        ((30, 80, 150), (33, 33))])
def test_per_tile_runs_match_plain(card, lens, block, kind, mode):
    """K3's per-tile form, one launch a run: after every run the face slabs
    and the output equal blocked_ref's over the same tiles, and at the end
    blocked_ref's over the whole table in table order, bit for bit."""
    scoring, bits, nsym = MODES[mode]
    trip = seqs(44, lens, nsym)
    d = bk.plan_dims(*lens, *block)
    arrs = bk.prep_blocked(*trip, d, card)
    got, want = bk.new_state(d, card), bk.new_state(d, card)
    for tiles in RUN_KINDS[kind](d):
        before = bk.sweep_tiles.launches
        bk.sweep_run(*arrs, *lens, d, got, tiles, scoring, bits)
        assert bk.sweep_tiles.launches == before + 1
        bk.blocked_ref(*arrs, *lens, d, scoring, bits, want, tiles=tiles)
        for g, w, field in zip(got, want, want._fields):
            assert torch.equal(g, w), field
    whole = bk.new_state(d, card)
    bk.blocked_ref(*arrs, *lens, d, scoring, bits, whole)
    for g, w, field in zip(got, whole, whole._fields):
        assert torch.equal(g, w), field


@pytest.mark.parametrize("lens,block", [((512, 512, 512), (33, 33)),
                                        ((640, 600, 620), (33, 33)),
                                        ((900, 900, 900), (33, 33)),
                                        ((300, 700, 700), (17, 17))])
def test_progress_words_on_both_sides_of_the_threshold(card, lens, block):
    """Grids under RAMP_WAVES waves (a word a strip) and past it (one a
    tile), and the same grid capped to a few blocks (one a tile): the final
    values equal the whole-plane sweep's on the card, and the score the C++
    oracle's."""
    trip = seqs(46, lens, 4)
    d = bk.plan_dims(*lens, *block)
    arrs = bk.prep_blocked(*trip, d, card)
    waves = bk.n_tiles(d) / bk.resident_blocks(d)
    assert bk.schedule(d, bk.n_tiles(d), bk.resident_blocks(d)).strip_words \
        == (waves <= bk.RAMP_WAVES)
    want = ref.sweep(*arrs, *lens)
    for blocks in (None, 5):
        assert torch.equal(bk.final_values(*arrs, *lens, d, blocks=blocks),
                           want)
    assert int(want.max()) == score_native(*trip)


@pytest.mark.parametrize("strip_words,chain", [(False, False), (True, False),
                                               (False, True)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_resources(card, mode, strip_words, chain):
    """A block of 8 strips at the default plane, two an SM, the shared
    memory kernels/blocked.py counts (the table only under a submatrix)."""
    scoring, bits, _ = MODES[mode]
    d = bk.plan_dims_packed(40, 60, 60, 2) if chain else \
        bk.plan_dims(40, 60, 60)
    res = bk.step_resources(d, scoring, bits, strip_words=strip_words)
    table = 0 if scoring.submatrix is None else 4 * 25 * 25
    assert res["threads"] == bk.THREADS == 256
    assert res["shared_bytes"] == bk.shared_bytes(33, 33) - 4 * 25 * 25 + \
        table
    assert res["registers"] <= 128 and res["blocks_per_sm"] == 2
    assert bk.blocks_per_sm(d) == 2


def test_k3_refuses_a_chunk_past_its_rings_on_card(card):
    lens = (10, 40, 40)
    d = bk.plan_dims(*lens)
    arrs = bk.prep_blocked(*seqs(45, lens, 4), d, card)
    before = bk.final_values.launches
    with pytest.raises(ValueError, match="chunks of at most"):
        bk.final_values(*arrs, *lens, d, chunk=bk.MAX_CHUNK + 1)
    assert bk.final_values.launches == before
    assert int(bk.final_values(*arrs, *lens, d, chunk=1).max()) == \
        int(bk.final_values(*arrs, *lens, d, chunk=bk.MAX_CHUNK).max())


@pytest.mark.parametrize("block", [(34, 33), (33, 34), (16, 128)])
def test_planes_past_one_sub_tile_are_refused_on_card(card, block):
    """A tile plane past 33 x 33 is refused before any launch, by the host
    (plan_dims) and by the kernel's C entry (step_resources on hand-made
    dims), and the default plane still runs."""
    lens = (10, 40, 40)
    with pytest.raises(ValueError, match="past one sub-tile"):
        bk.plan_dims(*lens, *block)
    d = bk.plan_dims(*lens)
    with pytest.raises(RuntimeError):
        bk.step_resources(d._replace(hb=block[0], wc=block[1]))
    trip = seqs(47, lens, 4)
    arrs = bk.prep_blocked(*trip, d, card)
    assert int(bk.final_values(*arrs, *lens, d).max()) == \
        align_planes_numpy(*trip)
