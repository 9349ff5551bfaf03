"""K3's chain mode and the K6 rate probe of the port, against the reference.

On the CPU ``align_blocked_chain`` runs ``blocked_ref`` in chain mode (slot
borders i = 0 mod d zeroed in every matrix, in the ring and in the faces);
the JAX package runs its Pallas chain kernel in interpret mode.  Scores are
integers: equality is exact.  The CUDA kernels are held against these plain
versions in tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.conftest import random_triplet
from trialign.config import Scoring as JScoring
from trialign.golden import align_planes_numpy
from trialign.kernels.blocked import align_blocked_chain as jax_chain
from trialign_torch.config import Scoring
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import vpu

torch.set_num_threads(1)

WIDE = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)


def jsc(sc):
    return JScoring(**dataclasses.asdict(sc))


def port(a_list, b, c, scoring=Scoring(), block_shape=None, score_bits=0):
    return bk.align_blocked_chain(a_list, b, c, scoring, block_shape,
                                  score_bits, device="cpu")


def test_chain_parity_multi_and_single_tile(rng):
    """tests/test_blocked.py's case: 5 A's of 20 against shared B, C."""
    a_list = [random_triplet(rng, 20, 1, 1)[0] for _ in range(5)]
    _, b, c = random_triplet(rng, 1, 30, 40)
    want = [align_planes_numpy(a, b, c) for a in a_list]
    assert jax_chain(a_list, b, c, block_shape=(16, 128)) == want
    # Multi-tile: borders cross the face exchange in j and k.
    assert port(a_list, b, c, block_shape=(9, 17)) == want
    assert port(a_list, b, c, block_shape=(16, 9)) == want
    # One tile.
    assert port(a_list, b, c, block_shape=(33, 65)) == want


def test_chain_single_and_empty(rng):
    a, b, c = random_triplet(rng, 12, 18, 25)
    want = align_planes_numpy(a, b, c)
    assert port([a], b, c, block_shape=(9, 9)) == [want] == \
        jax_chain([a], b, c, block_shape=(32, 128))
    assert port([], b, c) == [] == jax_chain([], b, c)
    e = np.zeros(0, dtype=np.uint8)
    assert port([a, a], e, c) == [0, 0] == jax_chain([a, a], e, c)
    assert port([e, e], b, c) == [0, 0]
    with pytest.raises(ValueError, match="equal-length"):
        port([a, a[:5]], b, c)


def test_chain_nondefault_scoring(rng):
    sc = Scoring(match=2, mismatch=-3, gap_open=4, gap_extend=1,
                 s3_mode="rtl")
    a_list = [random_triplet(rng, 15, 1, 1)[0] for _ in range(3)]
    _, b, c = random_triplet(rng, 1, 22, 35)
    want = [align_planes_numpy(a, b, c, jsc(sc)) for a in a_list]
    assert jax_chain(a_list, b, c, jsc(sc), block_shape=(16, 128)) == want
    assert port(a_list, b, c, sc, block_shape=(9, 17)) == want


def test_chain_submatrix(rng):
    sc = Scoring(submatrix=((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1),
                            (-1, -2, -1, 1)))
    a_list = [random_triplet(rng, 9, 1, 1, nsym=6)[0] for _ in range(4)]
    _, b, c = random_triplet(rng, 1, 20, 19, nsym=6)
    want = [align_planes_numpy(a, b, c, jsc(sc)) for a in a_list]
    assert port(a_list, b, c, sc, block_shape=(9, 9)) == want


def test_chain_score_bits(rng):
    """A near-identical chain whose scores pass 2047 under WIDE scoring:
    with score_bits=12 each slot equals the reference's wrapped score."""
    base = rng.integers(0, 4, 30).astype(np.uint8)
    b, c = base.copy(), base.copy()
    b[::7] = (b[::7] + 1) % 4
    c[::5] = (c[::5] + 2) % 4
    a_list = [base.copy(), base.copy(), b.copy()]
    a_list[1][::11] = (a_list[1][::11] + 3) % 4
    want = [align_planes_numpy(a, b, c, jsc(WIDE), score_bits=12)
            for a in a_list]
    assert want != [align_planes_numpy(a, b, c, jsc(WIDE)) for a in a_list]
    assert jax_chain(a_list, b, c, jsc(WIDE), block_shape=(16, 128),
                     score_bits=12) == want
    assert port(a_list, b, c, WIDE, (9, 17), score_bits=12) == want


@pytest.mark.parametrize("npack", [1, 2, 5])
def test_chain_values_per_slot(rng, npack):
    """Each slot's seven values equal the one-problem sweep's."""
    a_list = [random_triplet(rng, 7, 1, 1)[0] for _ in range(npack)]
    _, b, c = random_triplet(rng, 1, 17, 26)
    dims = bk.plan_dims_packed(7, 17, 26, npack, 9, 9)
    assert (dims.d, dims.npack) == (8, npack)
    assert bk.swept_length(dims) == npack * 8 - 1
    got = bk.chain_values(*bk.prep_chain(a_list, b, c, dims, "cpu"), 7, 17,
                          26, dims)
    assert got.shape == (npack, 7)
    one = bk.plan_dims(7, 17, 26, 9, 9)
    for m, a in enumerate(a_list):
        want = bk.final_values(*bk.prep_blocked(a, b, c, one, "cpu"), 7, 17,
                               26, one)
        assert torch.equal(got[m], want)


def test_chain_rejects_unplanned_dims(rng):
    a_list = [random_triplet(rng, 5, 1, 1)[0] for _ in range(2)]
    _, b, c = random_triplet(rng, 1, 10, 10)
    dims = bk.plan_dims_packed(5, 10, 10, 2, 9, 9)
    arrs = bk.prep_chain(a_list, b, c, dims, "cpu")
    with pytest.raises(ValueError):
        bk.chain_values(*arrs, 5, 10, 20, dims)
    with pytest.raises(ValueError):
        bk.final_values(*arrs, 5, 10, 10, dims)
    with pytest.raises(ValueError):
        bk.plan_dims_packed(5, 10, 10, 0)


def numpy_chains(x, iters, ops, dpx, step=vpu.DPX_STEP):
    """The probe's chains evaluated directly in numpy, lane by lane."""
    out = np.empty_like(x)
    with np.errstate(over="ignore"):
        for t, x0 in enumerate(x):
            acc = [np.int32(x0) + np.int32(r) for r in range(8)]
            for _ in range(iters):
                for r in range(ops // 2):
                    j = r % 4
                    if dpx:
                        h = (r // 4) % 2
                        acc[2 * j + h] = max(acc[2 * j + 1 - h] + np.int32(step),
                                             acc[2 * j + h])
                    else:
                        acc[2 * j] = max(acc[2 * j], acc[2 * j + 1])
                        acc[2 * j + 1] = acc[2 * j + 1] + acc[2 * j]
            out[t] = max(acc)
    return out


@pytest.mark.parametrize("dpx", [False, True])
def test_vpu_plain_version_matches_numpy(dpx):
    """K6's plain version (what the kernel is held against on the card)
    against a direct evaluation of the same chains; the int32 mix wraps."""
    x = np.random.default_rng(5).integers(-2**31, 2**31 - 1, 6).astype(
        np.int32)
    got = vpu.vpu_chains(torch.from_numpy(x), 2, 64, dpx)
    np.testing.assert_array_equal(got.numpy(), numpy_chains(x, 2, 64, dpx))
    with pytest.raises(ValueError):
        vpu.vpu_chains(torch.from_numpy(x), 2, 100, dpx)
