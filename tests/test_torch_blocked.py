"""The port's blocked sweep (K3) against the reference.

On the CPU the wrapper runs blocked_ref, the plain torch version of the
kernel's tile schedule and face slabs, so these tests exercise the geometry
and face logic the CUDA kernel uses, at small tiles.  The CUDA kernel itself
is compared with blocked_ref in tests/test_torch_cuda.py.  Scores are
integers: equality is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.conftest import random_triplet
from trialign.config import Scoring as JScoring
from trialign.golden import align_planes_numpy
from trialign.kernels.blocked import align_blocked as jax_align_blocked
from trialign.kernels.xla_ref import align_xla
from trialign_torch.config import Scoring
from trialign_torch.kernels import blocked as bk


def ref_scoring(sc):
    """The JAX package's Scoring with the same fields as the port's."""
    return JScoring(**dataclasses.asdict(sc))


torch.set_num_threads(1)

WIDE = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)
SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))


def port(a, b, c, scoring=Scoring(), block_shape=None, score_bits=0):
    return bk.align_blocked(a, b, c, scoring, block_shape, score_bits,
                            device="cpu")


def test_matches_pallas_blocked(rng):
    """16-row tiles, as tests/test_blocked.py runs the reference kernel (its
    128 columns are past the port's one sub-tile: 32 here)."""
    a, b, c = random_triplet(rng, 10, 40, 50)
    got = port(a, b, c, block_shape=(17, 33))
    assert got == jax_align_blocked(a, b, c, interpret=True,
                                    block_shape=(16, 128))
    assert got == align_planes_numpy(a, b, c)
    assert got == align_xla(a, b, c)


@pytest.mark.parametrize("dims,block", [
    ((8, 20, 70), (32, 16)),     # several tiles in k only
    ((9, 35, 30), (9, 8)),       # several tiles in j and k
    ((11, 37, 29), (9, 9)),      # ragged last tile row and column
    ((6, 16, 21), (17, 11)),     # exact fit in j, ragged in k
    ((7, 5, 6), None),           # one tile, default shape
    ((1, 1, 1), (2, 2)),         # one-cell tiles
])
def test_multi_tile_matches_golden(rng, dims, block):
    a, b, c = random_triplet(rng, *dims)
    assert port(a, b, c, block_shape=block) == align_planes_numpy(a, b, c)


def test_rtl_mode(rng):
    sc = Scoring(s3_mode="rtl")
    a, b, c = random_triplet(rng, 12, 30, 25)
    got = port(a, b, c, sc, (9, 9))
    assert got == align_planes_numpy(a, b, c, ref_scoring(sc))
    assert got == align_xla(a, b, c, ref_scoring(sc))


def test_nondefault_scoring_and_submatrix(rng):
    for sc, nsym in ((Scoring(match=2, mismatch=-3, gap_open=5,
                              gap_extend=2), 4),
                     (Scoring(submatrix=SUB4), 6)):
        a, b, c = random_triplet(rng, 10, 19, 23, nsym=nsym)
        assert port(a, b, c, sc, (7, 9)) == \
            align_planes_numpy(a, b, c, ref_scoring(sc))


def test_score_bits(rng):
    a = rng.integers(0, 4, 20).astype(np.uint8)
    b, c = a.copy(), a.copy()
    b[::7] = (b[::7] + 1) % 4
    c[::5] = (c[::5] + 2) % 4
    want = align_planes_numpy(a, b, c, ref_scoring(WIDE), score_bits=12)
    assert want != align_planes_numpy(a, b, c, ref_scoring(WIDE))
    assert port(a, b, c, WIDE, (9, 9), score_bits=12) == want


def test_empty():
    e = np.zeros(0, dtype=np.uint8)
    assert port(e, e, e) == 0


@pytest.mark.parametrize("lb,lc,hb,wc", [(1, 1, 2, 2), (40, 50, 16, 33),
                                         (1024, 1024, 33, 33),
                                         (257, 700, 33, 33), (32, 33, 33, 33),
                                         (300, 7, 17, 33)])
def test_plan_dims_invariants(lb, lc, hb, wc):
    la = 13
    d = bk.plan_dims(la, lb, lc, hb, wc)
    tb, tc = hb - 1, wc - 1
    assert (d.hb, d.wc) == (hb, wc)
    assert (d.n_jb - 1) * tb < lb <= d.n_jb * tb
    assert (d.n_kb - 1) * tc < lc <= d.n_kb * tc
    assert d.nq == la + tb + tc and d.nrows == d.nq + 1
    jl, kl = bk._target(lb, lc, d)
    assert 1 <= jl <= tb and 1 <= kl <= tc
    assert bk.shared_bytes(hb, wc) <= bk.SMEM_CAP


def test_plan_dims_rejects_impossible_tiles():
    with pytest.raises(ValueError):
        bk.plan_dims(5, 5, 5, 1, 33)
    with pytest.raises(ValueError):
        bk.plan_dims(5, 5, 5, 33, 1)
    # A tile is one sub-tile of the register step, at most 32 x 32 cells.
    for hb, wc in ((128, 128), (34, 33), (33, 34), (16, 128)):
        with pytest.raises(ValueError, match="past one sub-tile"):
            bk.plan_dims(5, 5, 5, hb, wc)
        with pytest.raises(ValueError, match="past one sub-tile"):
            bk.plan_dims_packed(5, 5, 5, 2, hb, wc)
    assert bk.plan_dims(5, 5, 5, 33, 33).n_jb == 1
    # K4 and K5 lay out their grids alike and take larger planes.
    assert bk.grid_dims(5, 5, 5, 128, 128).n_jb == 1
    with pytest.raises(ValueError):
        bk.grid_dims(5, 5, 5, 1, 33)


def test_public_entry_points_refuse_planes_past_one_sub_tile(rng, tmp_path):
    """Every entry point that takes K3's tile plane refuses one past 33 x 33
    with the same ValueError, before it sweeps."""
    from trialign_torch.checkpoint import CheckpointedAligner
    from trialign_torch.dist import mesh as dmesh
    from trialign_torch.dist.halo import align_sharded_triplet

    a, b, c = random_triplet(rng, 6, 20, 30)
    msg = "past one sub-tile"
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match=msg):
        port(a, b, c, block_shape=(16, 128))
    with pytest.raises(ValueError, match=msg):
        bk.align_blocked_chain([a, a], b, c, Scoring(), (33, 65),
                               device="cpu")
    with pytest.raises(ValueError, match=msg):
        CheckpointedAligner(a, b, c, device="cpu", block_shape=(65, 33),
                            ckpt_path=str(tmp_path / "ckpt.npz"))
    with pytest.raises(ValueError, match=msg):
        align_sharded_triplet(a, b, c, mesh=dmesh.make_mesh(
            1, 2, devices=[cpu] * 2), block_shape=(34, 34))
    assert port(a, b, c, block_shape=(33, 33)) == align_planes_numpy(a, b, c)


def test_block_of_the_register_step():
    """K3's block: a warp a strip of 4 tile columns, at most 8; 256 threads
    at the default 33 x 33 plane, and the rings and buffers of 8 strips at
    chunk 8 beside the 25 x 25 table."""
    assert bk.THREADS == bk.block_threads(bk.DEF_WC) == 256
    assert [bk.block_threads(wc) for wc in (2, 5, 6, 17, 33, 34, 200)] == \
        [32, 32, 64, 128, 256, 256, 256]
    assert bk.shared_bytes(33, 33) == \
        16 * (7 * 17 * 33 + 8 * 8 * 13) + 4 * 25 * 25
    assert bk.shared_bytes(33, 33, chunk=4) < bk.shared_bytes(33, 33)


@pytest.mark.parametrize("lens,block,chain,resident,want", [
    ((512, 512, 512), (33, 33), False, 264, (True, 4)),     # 0.97 waves
    ((640, 640, 640), (33, 33), False, 264, (True, 4)),     # 1.52
    ((768, 768, 768), (33, 33), False, 264, (False, 6)),    # 2.18
    ((1536, 1536, 1536), (33, 33), False, 264, (False, 6)),  # 8.73
    ((512, 512, 512), (33, 33), False, 1, (False, 6)),      # a grid of 1
    ((100, 512, 512), (33, 33), True, 264, (False, 4)),     # chain mode
    ((300, 300, 300), (17, 17), False, 264, (True, 4)),     # 1.37
])
def test_schedule_by_waves(lens, block, chain, resident, want):
    """K3's schedule: a word a strip (outside chain mode) and chunks of 4
    up to RAMP_WAVES waves, then one word a tile and chunks of 6."""
    dims = (bk.plan_dims_packed(*lens, 2, *block) if chain
            else bk.plan_dims(*lens, *block))
    assert tuple(bk.schedule(dims, bk.n_tiles(dims), resident)) == want


def test_k3_refuses_a_chunk_past_its_rings(rng):
    a, b, c = random_triplet(rng, 5, 20, 20)
    dims = bk.plan_dims(5, 20, 20, 9, 9)
    arrs = bk.prep_blocked(a, b, c, dims, "cpu")
    with pytest.raises(ValueError, match="chunks of at most"):
        bk.final_values(*arrs, 5, 20, 20, dims, chunk=bk.MAX_CHUNK + 1)
    with pytest.raises(ValueError, match="chunks of at most"):
        bk.sweep_tiles(*arrs, 5, 20, 20, dims, bk.new_state(dims, "cpu"), 0,
                       1, chunk=bk.MAX_CHUNK + 1)
    assert bk.final_values(*arrs, 5, 20, 20, dims, chunk=bk.MAX_CHUNK
                           ).max() == align_planes_numpy(a, b, c)


def test_final_values_rejects_unplanned_dims(rng):
    a, b, c = random_triplet(rng, 5, 20, 20)
    dims = bk.plan_dims(5, 20, 20, 9, 9)
    arrs = bk.prep_blocked(a, b, c, dims, "cpu")
    with pytest.raises(ValueError):
        bk.final_values(*arrs, 5, 20, 30, dims)
    with pytest.raises(ValueError):
        bk.final_values(arrs[0].long(), *arrs[1:], 5, 20, 20, dims)

