"""The slab sweep (K5) and the torch engine against the JAX package.

On the CPU the port's slab functions run the kernel's plain version
(``kernels.slab.slab_ref``), the tile schedule the CUDA kernel runs.  Every
captured cell and final vector must equal the JAX package's NumPy engine
(``trialign.traceback.engine``) exactly, for all four variants, at the block
shapes ``tests/test_slab_kernel.py`` uses (a 2x2 tile grid and a single
tile); one case each runs against the JAX slab kernel itself, in interpret
mode.  Inputs come from a seeded numpy generator; tolerance 0.
"""

import numpy as np
import pytest
import torch

import trialign.kernels.slab as jslab
from tests.conftest import random_triplet
from trialign.config import Scoring as JScoring
from trialign.traceback import engine as jengine
from trialign_torch.config import Scoring
from trialign_torch.kernels import slab
from trialign_torch.traceback import torch_engine
from trialign_torch.traceback.engine import NEG

torch.set_num_threads(1)

# tests/test_slab_kernel.py's shapes: (20, 30, 150) is a 2x2 tile grid and
# (12, 18, 40) a single tile at its (hb, wc) = (24, 128); at (24, 33), the
# port's tile plane of that row count within one sub-tile of K5's register
# step, they are 2 x 5 and 1 x 2 tiles.
BS = (24, 33)
SHAPES = {"grid2x2": (20, 30, 150), "single": (12, 18, 40)}
SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
SCORINGS = {
    "sop": {},
    "rtl": {"s3_mode": "rtl"},
    "sub4": {"submatrix": SUB4},
}


def pair(name):
    """The same scoring as the port's and as the JAX package's object."""
    return Scoring(**SCORINGS[name]), JScoring(**SCORINGS[name])


def onehot(state):
    v = np.full(7, NEG, np.int32)
    v[state] = 0
    return v


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mode", ["free", "free_jk"])
def test_forward_slab_matches_engine(rng, shape, mode, scoring):
    sc, jsc = pair(scoring)
    a, b, c = random_triplet(rng, *SHAPES[shape], nsym=6)
    f_ref, s_ref, _ = jengine.forward_sweep(a, b, c, jsc, mode=mode,
                                            capture_m=len(a))
    f, s = slab.forward_slab_blocked_async(a, b, c, sc, mode=mode,
                                           block_shape=BS, device="cpu")()
    np.testing.assert_array_equal(f, f_ref)
    np.testing.assert_array_equal(s, s_ref)


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pin_slab_matches_engine(rng, shape, scoring):
    sc, jsc = pair(scoring)
    a, b, c = random_triplet(rng, *SHAPES[shape], nsym=6)
    v0 = onehot(int(rng.integers(0, 7)))
    f_ref, s_ref, _ = jengine.forward_sweep(a, b, c, jsc, mode="pin", v0=v0,
                                            capture_m=len(a))
    final, cap, dims = slab._sweep(*(x.astype(np.int32) for x in (a, b, c)),
                                   sc, "pin", v0, BS, "cpu")
    np.testing.assert_array_equal(final.numpy(), f_ref)
    np.testing.assert_array_equal(
        slab._assemble(cap, dims, len(b), len(c)).numpy(), s_ref)


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("end_state", [None, 0, 3])
def test_backward_slab_matches_engine(rng, shape, end_state, scoring):
    sc, jsc = pair(scoring)
    a, b, c = random_triplet(rng, *SHAPES[shape], nsym=6)
    end_v = None if end_state is None else onehot(end_state)
    g_ref = jengine.backward_slab(a, b, c, jsc, end_v=end_v)
    g = slab.backward_slab_blocked_async(a, b, c, sc, end_v=end_v,
                                         block_shape=BS, device="cpu")()
    np.testing.assert_array_equal(g, g_ref)


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_torch_engine_matches_numpy_engine(rng, scoring):
    """The torch twins equal the JAX package's NumPy engine on all three
    forward modes, at the split plane and at i = 0, and the backward slab
    with a free and a pinned end."""
    sc, jsc = pair(scoring)
    a, b, c = random_triplet(rng, 14, 11, 9, nsym=6)
    for m in (0, 7):
        for mode in ("free", "free_jk", "pin"):
            v0 = onehot(2) if mode == "pin" else None
            f_ref, s_ref, _ = jengine.forward_sweep(a, b, c, jsc, mode=mode,
                                                    v0=v0, capture_m=m)
            f, s = torch_engine.forward_sweep_torch_async(
                a, b, c, sc, mode=mode, v0=v0, capture_m=m, device="cpu")()
            np.testing.assert_array_equal(f, f_ref)
            np.testing.assert_array_equal(s, s_ref)
    for end_v in (None, onehot(4)):
        g_ref = jengine.backward_slab(a[7:], b, c, jsc, end_v=end_v)
        g = torch_engine.backward_slab_torch_async(a[7:], b, c, sc,
                                                   end_v=end_v,
                                                   device="cpu")()
        np.testing.assert_array_equal(g, g_ref)


def test_forward_slab_matches_jax_slab_kernel(rng):
    """Against the JAX slab kernel itself (Pallas interpret mode), at the
    geometry of its own submatrix test."""
    sc, jsc = pair("sub4")
    a, b, c = random_triplet(rng, 12, 24, 100)
    want = jslab.forward_slab_blocked_async(
        a, b, c, jsc, mode="free", block_shape=(24, 128, 8), interpret=True)()
    got = slab.forward_slab_blocked_async(a, b, c, sc, mode="free",
                                          block_shape=BS, device="cpu")()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("end_state", [None, 5])
def test_split_point_matches_jax_slab_kernel(rng, end_state):
    """The crossing of plane i = m (F + G argmax on the device, ties to the
    first flat index) equals the JAX kernel's, interpret mode."""
    a, b, c = random_triplet(rng, 8, 10, 12)
    end_v = None if end_state is None else onehot(end_state)
    want = jslab.split_point_blocked_async(a, b, c, 4, JScoring(),
                                           end_v=end_v, interpret=True)()
    got = slab.split_point_blocked_async(a, b, c, 4, Scoring(), end_v=end_v,
                                         block_shape=(5, 7), device="cpu")()
    assert got == want


def test_split_point_ties_go_to_the_first_flat_index():
    """Identical sequences tie along the diagonal: the crossing must be the
    first maximal flat index, as the host argmax picks it."""
    a = np.tile(np.arange(4, dtype=np.uint8), 5)
    f = jengine.forward_sweep(a[:10], a, a, capture_m=10)[1].astype(np.int64)
    g = jengine.backward_slab(a[10:], a, a).astype(np.int64)
    total = f + g
    flat = int(np.argmax(total))
    want = (*np.unravel_index(flat, total.shape), int(total.reshape(-1)[flat]))
    got = slab.split_point_blocked_async(a, a, a, 10, block_shape=(9, 9),
                                         device="cpu")()
    assert got == tuple(int(x) for x in want)


def test_slab_sweep_checks_its_inputs():
    dims = slab._plan(4, 5, 6, (5, 5))
    arrs = slab.prep_blocked(np.zeros(4), np.zeros(5), np.zeros(6), dims,
                             "cpu")
    ev = np.zeros(7, np.int32)
    with pytest.raises(ValueError, match="variant"):
        slab.slab_sweep(*arrs, 4, 5, 6, dims, "sideways", ev)
    with pytest.raises(ValueError, match="planned"):
        slab.slab_sweep(*arrs, 4, 5, 9, dims, "free", ev)
    with pytest.raises(ValueError, match="shared memory"):
        slab._plan(4, 5, 6, (100, 100))
    with pytest.raises(ValueError, match="ev"):
        slab.slab_sweep(*arrs, 4, 5, 6, dims, "free", ev[:6])


@pytest.mark.parametrize("block", [(34, 33), (33, 34), (24, 80)])
def test_slab_refuses_a_plane_past_one_sub_tile(block):
    """K5 sweeps a tile as one sub-tile of K3's register step, 33 x 33 cells
    at most: _plan refuses a larger plane, though the choice sweep's shared
    memory would hold it, and so does a sweep given such dims."""
    assert slab.shared_bytes(*block) <= slab.bk.SMEM_CAP
    with pytest.raises(ValueError, match="sub-tile"):
        slab._plan(4, 5, 6, block)
    dims = slab.bk.grid_dims(4, 5, 6, *block)
    arrs = slab.prep_blocked(np.zeros(4), np.zeros(5), np.zeros(6), dims,
                             "cpu")
    with pytest.raises(ValueError, match="sub-tile"):
        slab.slab_sweep(*arrs, 4, 5, 6, dims, "free", np.zeros(7, np.int32))
    assert slab._plan(4, 5, 6, (33, 33)).hb == 33


@pytest.mark.parametrize("case", ["bwd", "planned", "cpu"])
def test_choice_sweep_checks_its_inputs(case):
    """The direct engine's choice sweep takes the forward modes only, the
    arrays prep_blocked planned (an empty B allowed), and runs on a card
    only: on the CPU, direct.choices runs its plain version instead."""
    la, lb, lc = 4, 0, 6
    dims = slab._plan(la, lb, lc)
    arrs = slab.prep_blocked(np.zeros(la), np.zeros(lb), np.zeros(lc), dims,
                             "cpu")
    shape = (la + lb + lc, (lb + 1) * (lc + 1))
    lo = torch.empty(shape, dtype=torch.int16)
    hi = torch.empty(shape, dtype=torch.uint8)
    mode, lens, match = {"bwd": ("bwd", (la, lb, lc), "variant"),
                         "planned": ("free", (la, lb, 40), "planned"),
                         "cpu": ("pin", (la, lb, lc), "CUDA")}[case]
    with pytest.raises(ValueError, match=match):
        slab.choice_sweep(*arrs, *lens, dims, mode, np.zeros(7, np.int32),
                          Scoring(), lo, hi)
    assert slab.choice_sweep.launches == 0


def test_slab_takes_every_alphabet(rng):
    """A 16-symbol submatrix (the most Scoring accepts, past K2's and K3's
    8): the slab sweeps equal the JAX package's engine, as its slab kernel
    takes any alphabet."""
    sub = tuple(tuple(int(v) for v in row)
                for row in rng.integers(-4, 6, (16, 16)))
    sc, jsc = Scoring(submatrix=sub), JScoring(submatrix=sub)
    a, b, c = random_triplet(rng, 9, 20, 25, nsym=18)
    f_ref, s_ref, _ = jengine.forward_sweep(a, b, c, jsc, capture_m=len(a))
    f, s = slab.forward_slab_blocked_async(a, b, c, sc, block_shape=(9, 17),
                                           device="cpu")()
    np.testing.assert_array_equal(f, f_ref)
    np.testing.assert_array_equal(s, s_ref)
    end_v = onehot(6)
    g_ref = jengine.backward_slab(a, b, c, jsc, end_v=end_v)
    g = slab.backward_slab_blocked_async(a, b, c, sc, end_v=end_v,
                                         block_shape=(9, 17), device="cpu")()
    np.testing.assert_array_equal(g, g_ref)
