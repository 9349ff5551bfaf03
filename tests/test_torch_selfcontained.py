"""The port stands alone: it imports neither JAX nor the JAX package.

``trialign_torch`` keeps its own copies of the scoring, encoding, host plane
algebra, golden models, datasets and C++ oracle.  These tests show that no
module of the port (nor ``chip_smoke.py``) imports ``trialign`` or ``jax``,
that all of them import with both blocked, and that each copy agrees with
the JAX package's original on seeded inputs (exact equality).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import trialign.config as jconfig
import trialign.golden as jgolden
import trialign.io as jio
import trialign.kernels.plane_math as jpm
import trialign.native as jnative
from tests.conftest import random_triplet
from trialign_torch import config, golden, io, native
from trialign_torch.kernels import plane_math as pm
from trialign_torch.traceback import hirschberg_align

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
SCORINGS = [
    {},
    {"match": 2, "mismatch": -3, "gap_open": 5, "gap_extend": 2},
    {"s3_mode": "rtl"},
    {"submatrix": SUB4},
]


def port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "trialign_torch")):
        paths += [os.path.join(dirpath, f) for f in sorted(files)
                  if f.endswith(".py")]
    return sorted(paths)


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "trialign")


def test_no_module_of_the_port_imports_the_jax_package():
    found = []
    for path in port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                      for n in names if forbidden(n)]
    assert len(port_sources()) > 20
    assert not found, found


def test_port_imports_with_jax_and_the_jax_package_blocked():
    """Every module of the port and chip_smoke.py import, and align()
    recovers an alignment, a batch scores and a 2-stripe halo runs (score
    and alignment) on the CPU, with ``jax`` and ``trialign`` unimportable.
    A subprocess, since this one has imported both."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['trialign'] = None\n"
        "import importlib, pkgutil\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import trialign_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    trialign_torch.__path__, 'trialign_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "s = np.array([0, 1, 2, 3, 1], dtype=np.uint8)\n"
        "r = trialign_torch.align(s, s, s, return_alignment=True,\n"
        "                         device='cpu')\n"
        "assert (r.score, r.backend) == (15, 'hirschberg'), r\n"
        "rs = trialign_torch.align_batch([(s, s, s), (s, s[:0], s)],\n"
        "                                device='cpu')\n"
        "assert [x.score for x in rs] == [15, 0], rs\n"
        "from trialign_torch.dist import halo, mesh\n"
        "m = mesh.make_mesh(1, 2, devices=[torch.device('cpu')] * 2)\n"
        "assert halo.align_sharded_triplet(s, s, s, mesh=m,\n"
        "                                  block_shape=(3, 3)) == 15\n"
        "sc, rows = halo.align_sharded_triplet(s, s, s, mesh=m,\n"
        "    block_shape=(3, 3), return_alignment=True)\n"
        "assert sc == 15, sc\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       m.split('.')[0] in ('jax', 'trialign')]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 15
    for new in ("kernels.hetero", "kernels.chain", "kernels.mosaic",
                "dist.batch", "checkpoint", "resilience", "metrics", "cli",
                "benchmarks", "kernels.vpu", "dist.mesh", "dist.halo",
                "dist.halo_tb", "dist.worker"):
        assert f"trialign_torch.{new}" in names


@pytest.mark.parametrize("kw", SCORINGS, ids=["sop", "nondefault", "rtl",
                                              "sub4"])
def test_config_matches_reference(rng, kw):
    sc, jsc = config.Scoring(**kw), jconfig.Scoring(**kw)
    np.testing.assert_array_equal(sc.weight_matrix(), jsc.weight_matrix())
    if sc.submatrix is not None:
        np.testing.assert_array_equal(sc.sub_lookup(), jsc.sub_lookup())
    x, y, z = (rng.integers(0, 6, 50) for _ in range(3))
    np.testing.assert_array_equal(sc.pair_score(x, y), jsc.pair_score(x, y))
    np.testing.assert_array_equal(sc.triple_score(x, y, z),
                                  jsc.triple_score(x, y, z))
    for name in ("NUM_MATRICES", "OFFSETS", "CONSUMES", "MATRIX_NAMES",
                 "PAD_SYMBOL"):
        assert getattr(config, name) == getattr(jconfig, name), name
    seq = "ACGTNTTGCA"
    np.testing.assert_array_equal(config.encode(seq), jconfig.encode(seq))
    assert config.decode(config.encode(seq)) == jconfig.decode(
        jconfig.encode(seq))
    with pytest.raises(ValueError, match="X"):
        config.encode("ACGX")


@pytest.mark.parametrize("kw", SCORINGS, ids=["sop", "nondefault", "rtl",
                                              "sub4"])
def test_plane_math_matches_reference(rng, kw):
    sc, jsc = config.Scoring(**kw), jconfig.Scoring(**kw)
    groups = pm.transition_groups(sc.weight_matrix())
    assert groups == jpm.transition_groups(jsc.weight_matrix())
    assert pm.op_count(sc) == jpm.op_count(jsc)
    assert (pm.SHIFTS, pm.PLANE_DELTA) == (jpm.SHIFTS, jpm.PLANE_DELTA)
    p1, p2 = (rng.integers(-50, 50, (7, 6, 5)).astype(np.int32)
              for _ in range(2))
    m7p3 = rng.integers(-50, 50, (6, 5)).astype(np.int32)
    subs = [rng.integers(-5, 5, (6, 5)).astype(np.int32), 0, 0, 0,
            *(rng.integers(-5, 5, (6, 5)).astype(np.int32) for _ in range(3))]

    def roll(x, axis):
        return np.roll(x, 1, axis)

    got, got_m7 = pm.fused_plane_update_m7(p1, p2, m7p3, subs, groups,
                                           np.maximum, roll)
    want, want_m7 = jpm.fused_plane_update_m7(p1, p2, m7p3, subs, groups,
                                              np.maximum, roll)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(got_m7, want_m7)
    for t in range(7):
        np.testing.assert_array_equal(
            pm.target_update(p1, groups[t], np.maximum),
            jpm.target_update(p1, groups[t], np.maximum))
    bp = rng.integers(0, 6, (6, 1))
    cp = rng.integers(0, 6, (1, 5))
    ap = rng.integers(0, 6, (6, 5))
    got = pm.submatrix_tables(bp, cp, SUB4, np.int32, np.where)
    want = jpm.submatrix_tables(bp, cp, SUB4, np.int32, np.where)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[3] == want[3]
    np.testing.assert_array_equal(
        pm.submatrix_pair(ap, got[0], got[3], np.where),
        jpm.submatrix_pair(ap, want[0], want[3], np.where))


@pytest.mark.parametrize("sub", [
    None, SUB4, ((300, -1), (-1, 2)), ((2, -129), (-1, 2)),
    tuple(tuple(1 if i == j else -1 for j in range(5)) for i in range(5)),
], ids=["none", "sub4", "past_127", "past_-128", "five_symbols"])
def test_hetero_sub_ok_matches_reference(sub):
    assert pm.hetero_sub_ok(sub) == jpm.hetero_sub_ok(sub)


@pytest.mark.parametrize("kw", SCORINGS, ids=["sop", "nondefault", "rtl",
                                              "sub4"])
def test_golden_matches_reference(rng, kw):
    sc, jsc = config.Scoring(**kw), jconfig.Scoring(**kw)
    a, b, c = random_triplet(rng, 7, 6, 8, nsym=6)
    assert golden.align_planes_numpy(a, b, c, sc) == \
        jgolden.align_planes_numpy(a, b, c, jsc)
    assert golden.align_planes_numpy(a, b, c, sc, score_bits=6) == \
        jgolden.align_planes_numpy(a, b, c, jsc, score_bits=6)
    score, cuboid = golden.align_bruteforce(a, b, c, sc, return_cuboid=True)
    jscore, jcuboid = jgolden.align_bruteforce(a, b, c, jsc,
                                               return_cuboid=True)
    assert score == jscore
    np.testing.assert_array_equal(cuboid, jcuboid)
    if sc.submatrix is None:  # the cuboid walk scores pairs by match
        tb = golden.traceback_from_cuboid(a, b, c, cuboid, sc)
        assert tb == jgolden.traceback_from_cuboid(a, b, c, jcuboid, jsc)
        assert tb[0] == score
    _, rows = hirschberg_align(a, b, c, sc, device="cpu")
    assert golden.rescore_alignment(rows, sc) == \
        jgolden.rescore_alignment(rows, jsc) == score


def test_io_matches_reference(tmp_path):
    for got, want in zip(io.load_reference_triplet(),
                         jio.load_reference_triplet()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(io.load_alt_triplet(), jio.load_alt_triplet()):
        np.testing.assert_array_equal(got, want)
    fasta = tmp_path / "t.fa"
    fasta.write_text(">one\nACGT\nTT\n>two\nGGA\n")
    assert io.read_fasta(str(fasta)) == jio.read_fasta(str(fasta))


@pytest.mark.parametrize("kw", SCORINGS, ids=["sop", "nondefault", "rtl",
                                              "sub4"])
def test_native_matches_reference(rng, kw):
    sc, jsc = config.Scoring(**kw), jconfig.Scoring(**kw)
    a, b, c = random_triplet(rng, 20, 17, 23, nsym=4)
    assert native.score_native(a, b, c, sc) == \
        jnative.score_native(a, b, c, jsc)
    assert native.align_native(a, b, c, sc) == \
        jnative.align_native(a, b, c, jsc)
