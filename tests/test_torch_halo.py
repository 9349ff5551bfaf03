"""The port's halo (dist/halo.py) and meshes (dist/mesh.py) on CPU meshes.

A mesh of n CPU slots (``devices=[torch.device("cpu")] * n``) is the port's
counterpart of the reference's virtual CPU devices: each stripe of tile
columns runs K3's per-tile form through its plain version ``blocked_ref``
and hands its column faces to the next stripe.  All seven final values must
equal the whole sweep's (``blocked.final_values``), and the score the golden
model's and, in one tiny case, the JAX package's ``align_sharded_triplet`` on
its 8-device CPU mesh.  Integers: equality is exact.
"""

import pytest
import torch

from tests.conftest import random_triplet
from trialign.dist import halo as jhalo
from trialign.dist.mesh import make_mesh as jax_make_mesh
from trialign.golden import align_planes_numpy
from trialign_torch.config import Scoring
from trialign_torch.dist import halo, mesh
from trialign_torch.kernels import blocked as bk

torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpu_mesh(model, data=1):
    return mesh.make_mesh(data, model, devices=[CPU] * (data * model))


def whole(a, b, c, block):
    dims = bk.plan_dims(len(a), len(b), len(c), *block)
    return bk.final_values(*bk.prep_blocked(a, b, c, dims, CPU), len(a),
                           len(b), len(c), dims)


def test_matches_jax_align_sharded_triplet(rng):
    """One tiny case against the reference's halo on 2 virtual devices."""
    a, b, c = random_triplet(rng, 6, 20, 40)
    want = jhalo.align_sharded_triplet(
        a, b, c, mesh=jax_make_mesh(data=1, model=2), block_shape=(16, 16))
    assert want == align_planes_numpy(a, b, c)
    assert halo.align_sharded_triplet(a, b, c, mesh=cpu_mesh(2),
                                      block_shape=(16, 16)) == want


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "tight"])
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_stripes_equal_the_whole_sweep(rng, ndev, overlap):
    """Ten tile columns over 1 to 8 stripes: uneven widths (3/3/4, 2/2/3/3,
    1 x 6 + 2 x 2) under both schedules."""
    a, b, c = random_triplet(rng, 8, 30, 150)
    block = (9, 17)
    assert bk.plan_dims(8, 30, 150, *block).n_kb == 10
    got = halo.halo_values(a, b, c, mesh=cpu_mesh(ndev), block_shape=block,
                           overlap=overlap)
    assert torch.equal(got, whole(a, b, c, block))
    assert int(got.max()) == align_planes_numpy(a, b, c)


@pytest.mark.parametrize("band", [1, 2, None])
@pytest.mark.parametrize("ndev", [2, 3])
def test_stripes_in_bands_equal_the_whole_sweep(rng, ndev, band,
                                                monkeypatch):
    """Bands of 1, 2 and all 4 tile rows in 2 and 3 stripes, one sweep_run
    call a band a stripe: the last stripe's column faces and output, each
    stripe's row faces of its columns, and halo_values with the model's
    band forced to the same rows, equal the whole sweep."""
    a, b, c = random_triplet(rng, 8, 30, 150)
    block = (9, 17)
    dims = bk.plan_dims(8, 30, 150, *block)
    assert (dims.n_jb, dims.n_kb) == (4, 10)
    rows = band or dims.n_jb
    calls = []
    real = bk.sweep_run

    def spy(*args, **kwargs):
        calls.append(args[8])
        return real(*args, **kwargs)

    monkeypatch.setattr(bk, "sweep_run", spy)
    _, stripes = halo.sweep_stripes(a, b, c, Scoring(),
                                    halo.model_row(cpu_mesh(ndev)), block,
                                    ndev == 2, band_rows=rows)
    assert len(calls) == ndev * len(halo.bands(dims.n_jb, rows))
    want = bk.new_state(dims, CPU)
    bk.blocked_ref(*bk.prep_blocked(a, b, c, dims, CPU), 8, 30, 150, dims,
                   state=want)
    last = stripes[-1].state
    assert torch.equal(last.cf, want.cf) and torch.equal(last.out, want.out)
    for s in stripes:
        assert torch.equal(s.state.rf[s.kb0:s.kb1], want.rf[s.kb0:s.kb1])
    model = halo.halo_efficiency
    monkeypatch.setattr(halo, "halo_efficiency",
                        lambda *args, **kw: {**model(*args, **kw),
                                             "band": rows})
    got = halo.halo_values(a, b, c, mesh=cpu_mesh(ndev), block_shape=block)
    assert torch.equal(got, whole(a, b, c, block))


def test_more_stripes_than_columns(rng):
    """Stripes past the last tile column hold nothing; the result is the
    last stripe with columns'."""
    a, b, c = random_triplet(rng, 7, 20, 40)
    block = (9, 17)
    assert [c1 - c0 for c0, c1 in halo.stripe_columns(3, 5)] == \
        [0, 1, 0, 1, 1]
    got = halo.halo_values(a, b, c, mesh=cpu_mesh(5), block_shape=block)
    assert torch.equal(got, whole(a, b, c, block))


def test_default_tile_plane_splits_columns_for_the_stripes(rng):
    """choose_halo_shape narrows the tile where |C| has fewer columns than
    stripes, so that each stripe holds one."""
    a, b, c = random_triplet(rng, 5, 12, 40)
    hb, wc = halo.choose_halo_shape(5, 12, 40, 4)
    assert (hb, wc) == (bk.DEF_HB, 11)
    assert bk.plan_dims(5, 12, 40, hb, wc).n_kb == 4
    assert halo.choose_halo_shape(5, 12, 40, 1) == (bk.DEF_HB, bk.DEF_WC)
    assert halo.align_sharded_triplet(a, b, c, mesh=cpu_mesh(4)) == \
        align_planes_numpy(a, b, c)


def test_empty_and_other_scorings(rng):
    from trialign_torch.config import Scoring

    a, b, c = random_triplet(rng, 5, 0, 9)
    assert halo.align_sharded_triplet(a, b, c, mesh=cpu_mesh(2)) == 0
    sub = Scoring(submatrix=((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1),
                             (-1, -2, -1, 1)))
    for sc in (Scoring(s3_mode="rtl"), sub):
        a, b, c = random_triplet(rng, 6, 20, 45, nsym=6)
        assert halo.align_sharded_triplet(
            a, b, c, sc, mesh=cpu_mesh(3), block_shape=(9, 9)) == \
            align_planes_numpy(a, b, c, sc)


def test_return_alignment_passes_block_shape_and_overlap(rng, monkeypatch):
    """The reference drops block_shape and overlap when it recovers an
    alignment (halo.py:349-354); the port passes them on."""
    from trialign_torch.dist import halo_tb

    seen = {}
    real = halo_tb.hirschberg_align_sharded

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(halo_tb, "hirschberg_align_sharded", spy)
    a, b, c = random_triplet(rng, 6, 12, 20)
    m = cpu_mesh(2)
    score, rows = halo.align_sharded_triplet(
        a, b, c, mesh=m, block_shape=(9, 9), overlap=False,
        return_alignment=True)
    assert seen["block_shape"] == (9, 9) and seen["overlap"] is False
    assert seen["mesh"] is m
    assert score == align_planes_numpy(a, b, c)


def test_a_missing_device_raises(rng):
    """No stripe moves to the CPU because its device is missing."""
    a, b, c = random_triplet(rng, 5, 10, 20)
    m = mesh.make_mesh(1, 2, devices=[CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="no blocked kernel for device meta"):
        halo.halo_values(a, b, c, mesh=m, block_shape=(9, 9))
    if not torch.cuda.is_available():
        m = mesh.make_mesh(1, 2, devices=[CPU, torch.device("cuda", 0)])
        with pytest.raises(RuntimeError):
            halo.halo_values(a, b, c, mesh=m, block_shape=(9, 9))


def test_scaling_efficiency_matches_reference():
    for n_jb, ndev in ((4, 2), (32, 2), (32, 8), (1, 1), (7, 3)):
        for overlap in (True, False):
            assert halo.scaling_efficiency(n_jb, ndev, overlap) == \
                jhalo.scaling_efficiency(n_jb, ndev, overlap)


def test_halo_efficiency_model():
    one = halo.halo_efficiency(1024, 1024, 1024, 1)
    assert one["pipeline"] == 1.0 and one["transfer"] == 1.0
    assert one["total"] == one["j_fill"] * one["k_fill"] == 1.0
    # One stripe is one band, one launch of the whole grid.
    assert one["band"] == 32
    assert one["seconds"] == halo.launch_seconds(32, 32, 1024 + 64)
    # Every band ends with a whole pillar of 1088 planes, and 32 x 32 tiles
    # keep one card busy: a second card adds no speed, and the model keeps
    # one band a stripe, the second stripe after the first.
    two = halo.halo_efficiency(1024, 1024, 1024, 2, overlap=False)
    assert two["band"] == 32 and two["pipeline"] < 0.5
    # Long |B| and |C|: 512 x 512 tiles, far more than a card holds at
    # once, pipeline usefully in bands of some tens of rows.
    wide = halo.halo_efficiency(256, 16384, 16384, 2, overlap=False)
    assert 0.6 < wide["pipeline"] < 1.0 and 1 < wide["band"] < 512
    for rows in (1, wide["band"] // 2, 2 * wide["band"], 512):
        assert halo.halo_efficiency(256, 16384, 16384, 2, overlap=False,
                                    band_rows=rows)["seconds"] >= \
            wide["seconds"]
    # A slow link costs the tight schedule more than the overlapped one.
    slow = dict(copy_bytes_per_s=1e8)
    tight = halo.halo_efficiency(256, 16384, 16384, 2, overlap=False, **slow)
    over = halo.halo_efficiency(256, 16384, 16384, 2, overlap=True, **slow)
    assert tight["transfer"] < over["transfer"] < 1.0
    best = halo.halo_efficiency(256, 16384, 16384, 2, **slow)
    assert best["overlap"] is True and best["total"] == over["total"]
    # Padding of the last tile row and column shows in the fills.
    part = halo.halo_efficiency(16, 40, 40, 1, block_shape=(33, 33))
    assert part["j_fill"] == part["k_fill"] == 40 / 64


@pytest.mark.parametrize("band", [1, 3, None])
def test_run_stripes_hands_each_band_its_rectangle(band):
    """The sweep callback gets each band in order and, within it, each
    stripe in order: the band's rows of the stripe's own columns, every
    tile of the grid once and after its upper and left neighbours."""
    dims = bk.plan_dims(8, 30, 150, 9, 17)
    seen = []

    def start(device):
        return (), bk.new_state(dims, device)

    def sweep(arrs, state, tiles):
        seen.append(tiles)

    stripes = halo.run_stripes(dims, halo.model_row(cpu_mesh(3)), True,
                               start, sweep, band)
    cols = [(s.kb0, s.kb1) for s in stripes]
    assert cols == halo.stripe_columns(dims.n_kb, 3)
    assert seen == [bk.rect_tiles(rows, c)
                    for rows in halo.bands(dims.n_jb, band or dims.n_jb)
                    for c in cols]
    done = set()
    for jb, kb in (t for run in seen for t in run):
        assert (jb == 0 or (jb - 1, kb) in done) and \
            (kb == 0 or (jb, kb - 1) in done)
        done.add((jb, kb))
    assert len(done) == dims.n_jb * dims.n_kb


def test_make_mesh_and_its_layouts(monkeypatch):
    with pytest.raises(ValueError, match="mesh wants 1 devices"):
        mesh.make_mesh(devices=[])
    if not torch.cuda.is_available():
        # Without a card and without explicit devices there is nothing.
        with pytest.raises(ValueError, match="only 0 available"):
            mesh.make_mesh()
        with pytest.raises(ValueError):
            mesh.default_mesh()
    m = mesh.make_mesh(2, 3, devices=[CPU] * 7)
    assert m.shape == {"data": 2, "model": 3}
    assert m.devices() == [[CPU] * 3] * 2
    with pytest.raises(ValueError, match="mesh wants 8 devices"):
        mesh.make_mesh(2, 4, devices=[CPU] * 7)
    mh = mesh.multihost_mesh(model_per_host=2, local=[CPU] * 4)
    assert mh.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="multiple of model_per_host"):
        mesh.multihost_mesh(model_per_host=3, local=[CPU] * 4)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_distributed() is False
    assert mesh.rank() == 0 and mesh.world_size() == 1
    with pytest.raises(ValueError, match="num_processes"):
        mesh.init_distributed("localhost:1")
    # No other backend than gloo, and none switched to it silently.
    with pytest.raises(ValueError, match="'gloo' only"):
        mesh.init_distributed("localhost:1", 2, 0, backend="nccl")
    assert not torch.distributed.is_initialized()
