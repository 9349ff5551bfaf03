"""The port's sharded alignment recovery (dist/halo_tb.py) on CPU meshes.

K5's per-tile form (``kernels/slab.sweep_tiles``) runs through its plain
version ``slab_ref`` on the CPU: in runs that end mid-diagonal and in
stripes of tile columns it must leave the same capture and final vector as
the whole sweep, for every variant.  ``hirschberg_align_sharded`` must
return the golden score and an alignment that rescores to it, equal to the
JAX package's in interpret mode (which reaches ``make_slab_block_call``) in
one tiny case, and its split points must break ties as the single-device
split does.  Integers: equality is exact.
"""

import numpy as np
import pytest
import torch

from tests.conftest import random_triplet
from trialign.dist.halo_tb import hirschberg_align_sharded as jax_sharded
from trialign.dist.mesh import make_mesh as jax_make_mesh
from trialign.golden import align_planes_numpy, rescore_alignment
from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.dist import halo as dh
from trialign_torch.dist import halo_tb, mesh
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import slab as sk
from trialign_torch.traceback import hirschberg as hb
from trialign_torch.traceback.engine import NEG

torch.set_num_threads(1)

CPU = torch.device("cpu")
SUB16 = Scoring(submatrix=tuple(
    tuple(int(v) for v in row)
    for row in np.random.default_rng(16).integers(-4, 6, (16, 16))))
SCORINGS = {"default": (Scoring(), 4), "sub16": (SUB16, 18)}


def cpu_mesh(model):
    return mesh.make_mesh(1, model, devices=[CPU] * model)


def check_rows(rows, a, b, c):
    for row, seq in zip(rows, (a, b, c)):
        assert [v for v in row if v != -1] == [int(x) for x in seq]


def slab_inputs(rng, variant, name, shape=(10, 30, 40), block=(9, 9)):
    scoring, nsym = SCORINGS[name]
    a, b, c = (x.astype(np.int32) for x in random_triplet(rng, *shape, nsym))
    ev = np.full(NUM_MATRICES, NEG, np.int32)
    ev[int(rng.integers(0, NUM_MATRICES))] = 0
    dims = sk._plan(*shape, block)
    return scoring, (a, b, c), ev, dims, sk.prep_blocked(a, b, c, dims, CPU)


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("variant", list(sk.VARIANTS))
def test_per_tile_runs_equal_the_whole_sweep(rng, variant, name):
    """Runs of 3 and of 7 tiles (4 x 5 tiles: most runs end mid-diagonal)
    leave every capture entry and the final vector as the whole sweep."""
    scoring, seqs, ev, dims, arrs = slab_inputs(rng, variant, name)
    lens = tuple(map(len, seqs))
    assert (dims.n_jb, dims.n_kb) == (4, 5)
    f_want, cap_want = sk.slab_sweep(*arrs, *lens, dims, variant, ev, scoring)
    n = bk.n_tiles(dims)
    for every in (3, 7):
        state = sk.new_state(*lens, dims, ev, CPU)
        for idx in range(0, n, every):
            sk.sweep_tiles(*arrs, *lens, dims, variant, state, idx,
                           min(every, n - idx), scoring)
        assert torch.equal(state.cap, cap_want)
        if variant != "bwd":
            assert torch.equal(state.out, f_want)


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("variant", list(sk.VARIANTS))
def test_stripes_equal_the_whole_sweep(rng, variant, name):
    """Two stripes with the face copied on a copy stream's schedule and
    three with the tight one (5 tile columns: 2/3 and 1/2/2): each stripe's
    columns of the capture, and the owner's final vector, equal the whole
    sweep's; a stripe past column 0 reads the face it is handed, not the
    variant's border fill."""
    scoring, seqs, ev, dims, arrs = slab_inputs(rng, variant, name)
    lens = tuple(map(len, seqs))
    f_want, cap_want = sk.slab_sweep(*arrs, *lens, dims, variant, ev, scoring)
    for ndev, overlap in ((2, True), (3, False)):
        row = dh.model_row(cpu_mesh(ndev))
        gdims, stripes = halo_tb._sharded_sweep(
            *seqs, scoring, row, variant, ev, (dims.hb, dims.wc), overlap)
        assert gdims == dims
        cap = halo_tb._gather_caps(dims, stripes, stripes[0], 0)
        assert torch.equal(cap, cap_want)
        if variant != "bwd":
            assert torch.equal(stripes[-1].state.out, f_want)


@pytest.mark.parametrize("band", [1, 2, None])
@pytest.mark.parametrize("variant", list(sk.VARIANTS))
def test_stripes_in_bands_equal_the_whole_sweep(rng, variant, band):
    """Bands of 1, 2 and all 4 tile rows in 2 stripes (copy-stream
    schedule) and 3 (tight): the gathered capture and the owner's final
    vector equal the whole sweep's."""
    scoring, seqs, ev, dims, arrs = slab_inputs(rng, variant, "default")
    lens = tuple(map(len, seqs))
    f_want, cap_want = sk.slab_sweep(*arrs, *lens, dims, variant, ev, scoring)
    for ndev, overlap in ((2, True), (3, False)):
        row = dh.model_row(cpu_mesh(ndev))
        _, stripes = halo_tb._sharded_sweep(
            *seqs, scoring, row, variant, ev, (dims.hb, dims.wc), overlap,
            band or dims.n_jb)
        cap = halo_tb._gather_caps(dims, stripes, stripes[0], 0)
        assert torch.equal(cap, cap_want)
        if variant != "bwd":
            assert torch.equal(stripes[-1].state.out, f_want)


def test_matches_jax_hirschberg_align_sharded(rng):
    """One tiny case against the reference on 2 virtual devices, the top
    split swept on the stripes: the same score and the same alignment."""
    a, b, c = random_triplet(rng, 10, 8, 9)
    want = jax_sharded(a, b, c, mesh=jax_make_mesh(data=1, model=2),
                       single_cells=500, block_shape=(9, 9))
    got = halo_tb.hirschberg_align_sharded(a, b, c, mesh=cpu_mesh(2),
                                           single_cells=500,
                                           block_shape=(9, 9))
    assert got[0] == want[0] == align_planes_numpy(a, b, c)
    assert got[1] == [list(map(int, r)) for r in want[1]]


@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_levels_of_sharded_splits(rng, ndev, monkeypatch):
    """single_cells lowered: the top split and the halves' splits run on the
    stripes; the score is golden's and the alignment rescores to it."""
    splits = []
    real = halo_tb.sharded_split_point

    def spy(a, b, c, m, *args, **kwargs):
        splits.append((len(a), kwargs.get("mode")))
        return real(a, b, c, m, *args, **kwargs)

    monkeypatch.setattr(halo_tb, "sharded_split_point", spy)
    a, b, c = random_triplet(rng, 24, 20, 30)
    score, rows = halo_tb.hirschberg_align_sharded(
        a, b, c, mesh=cpu_mesh(ndev), single_cells=2500, block_shape=(9, 9),
        overlap=ndev != 3)
    want = align_planes_numpy(a, b, c)
    assert score == want == rescore_alignment(rows)
    check_rows(rows, a, b, c)
    # Two levels: the top split and a pin node below it.
    assert splits[0] == (24, "free") and len(splits) >= 2
    assert any(mode == "pin" for _, mode in splits[1:])


def stripe_first(total, n_kb, ndev, tc):
    """The crossing a per-stripe argmax followed by the first maximum over
    the stripes would give: ties broken by stripe, not by flat index."""
    best = None
    for k0, k1 in dh.stripe_columns(n_kb, ndev):
        part = np.full_like(total, np.iinfo(np.int64).min)
        lo = 0 if k0 == 0 else k0 * tc + 1
        part[:, :, lo:k1 * tc + 1] = total[:, :, lo:k1 * tc + 1]
        flat = int(np.argmax(part))
        if best is None or part.reshape(-1)[flat] > best[1]:
            best = (flat, part.reshape(-1)[flat])
    return tuple(int(v) for v in np.unravel_index(best[0], total.shape))


@pytest.mark.parametrize("ndev", [2, 3])
def test_split_ties_break_as_on_one_device(ndev):
    """A triplet with 85 optimal crossings of i = m (free gaps, match 1):
    the sharded split is the single-device one, the first flat index of
    (7, |B|+1, |C|+1).  On 3 stripes, breaking ties by stripe would pick
    another crossing."""
    sc = Scoring(match=1, mismatch=0, gap_open=0, gap_extend=0)
    rng = np.random.default_rng(27)
    n, lb = int(rng.integers(8, 14)), int(rng.integers(14, 22))
    a, b, c = (rng.integers(0, 2, k).astype(np.int32) for k in (n, lb, lb + 3))
    block = (5, 5)
    m = len(a) // 2
    want = sk.split_point_blocked_async(a, b, c, m, sc, block_shape=block,
                                        device="cpu")()
    f = sk.forward_slab_blocked_async(a[:m], b, c, sc, block_shape=block,
                                      device="cpu")()[1]
    g = sk.backward_slab_blocked_async(a[m:], b, c, sc, block_shape=block,
                                       device="cpu")()
    total = f.astype(np.int64) + g
    assert (total == total.max()).sum() == 85
    assert want[:3] == tuple(int(v) for v in np.unravel_index(
        int(np.argmax(total)), total.shape))
    if ndev == 3:
        n_kb = bk.plan_dims(m, len(b), len(c), *block).n_kb
        assert stripe_first(total, n_kb, ndev, block[1] - 1) != want[:3]
    got = halo_tb.sharded_split_point(a, b, c, m, sc, cpu_mesh(ndev),
                                      block_shape=block)
    assert got == want


def test_pin_split(rng):
    """A pin node (origin seeded from v0, NEG walls) split on 2 stripes: the
    single-device solver's score, and the inputs in the rows."""
    sc = Scoring()
    a, b, c = random_triplet(rng, 20, 18, 18)
    want, _ = hb._solve(a, b, c, sc, "pin", 0, None, CPU)
    score, cols = halo_tb._solve_sharded(a, b, c, sc, "pin", 0, None,
                                         cpu_mesh(2), 2, 3000, (9, 9))
    assert score == want
    check_rows([list(r) for r in zip(*cols)], a, b, c)


def test_empty_and_default_gate(rng):
    """An empty sequence and a node inside the direct engine's gate both go
    to the single-device solver."""
    a, b, c = random_triplet(rng, 6, 0, 5)
    score, rows = halo_tb.hirschberg_align_sharded(a, b, c,
                                                   mesh=cpu_mesh(2))
    assert score == align_planes_numpy(a, b, c)
    check_rows(rows, a, b, c)
    a, b, c = random_triplet(rng, 9, 11, 13)
    score, rows = halo_tb.hirschberg_align_sharded(a, b, c,
                                                   mesh=cpu_mesh(2))
    assert score == align_planes_numpy(a, b, c) == rescore_alignment(rows)
