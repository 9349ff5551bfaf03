"""The direct engine's packed choices and walk against the JAX package's.

``trialign_torch.traceback.direct`` keeps the plain versions of its two CUDA
kernels: ``_choices`` (the torch choice-capture sweep) and ``walk_ref`` (the
walk in torch operations).  Here, on the CPU:

(a) ``_choices`` against ``trialign.traceback.direct._choices_seg``, driven
    as ``_direct_traceback_reserved`` drives it, its bucketed (hb, wc) mapped
    back: equal final vectors; equal 3-bit fields on every cuboid slot (0 <=
    q-j-k <= |A|) whose target has a predecessor (j >= dj and k >= dk); and
    the fields of targets without one 0 in the port, where the JAX engine
    writes the argmax of its fill values (the walk never reads them);
(b) ``walk_ref`` against ``_walk_device``, from every end state, on the
    same buffers;
(c) a pure-Python model of the kernel's step ``cell_step_choices``
    (``csrc/plane_step.cuh``: sources in order 0..6, ties to the lowest; M's
    choice the first argmax of the stored values) and of the walls the
    kernel applies, against ``_choices`` on inputs built to tie.

Inputs come from a seeded numpy generator; equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trialign.traceback.direct as JD
from trialign.config import Scoring as JScoring
from trialign_torch.config import CONSUMES, NUM_MATRICES, OFFSETS, Scoring
from trialign_torch.kernels.plane_math import SHIFTS
from trialign_torch.traceback import direct as D
from trialign_torch.traceback.engine import NEG

torch.set_num_threads(1)

MODES = ("free", "free_jk", "pin")
SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
SCORINGS = {
    "default": {},
    "rtl": {"s3_mode": "rtl"},
    "nondefault": {"match": 2, "mismatch": -3, "gap_open": 5,
                   "gap_extend": 2},
    "sub4": {"submatrix": SUB4},
}
# Every length under 16, so that the JAX engine compiles one bucket a
# scoring and mode.
SHAPES = [(1, 7, 5), (6, 1, 9), (9, 8, 1), (13, 11, 14)]


def inputs(seed, dims, mode, nsym=6):
    """A triplet (codes past a 4-symbol matrix score its floor) and, for
    "pin", a seeded start vector with NEG walls."""
    rng = np.random.default_rng(seed)
    trip = tuple(rng.integers(0, nsym, n).astype(np.int32) for n in dims)
    if mode != "pin":
        return trip, None
    v0 = rng.integers(-9, 10, NUM_MATRICES).astype(np.int32)
    v0[rng.random(NUM_MATRICES) < 0.5] = NEG
    v0[rng.integers(NUM_MATRICES)] = 0
    return trip, v0


def jax_choices(a, b, c, sc: dict, mode, v0):
    """The JAX engine's (final, packed_lo, packed_hi), driven as
    _direct_traceback_reserved drives _choices_seg, cut from its bucketed
    (qq, hb, wc) buffers to (|A|+|B|+|C|, |B|+1, |C|+1)."""
    la, lb, lc = len(a), len(b), len(c)
    qq, hb, wc = JD.direct_shapes(la, lb, lc)
    lap = qq - hb - wc
    a_pad = np.full(lap + 1, -9, np.int32)
    a_pad[:la] = a
    b_pad = np.full(hb, -7, np.int32)
    b_pad[1:lb + 1] = b
    c_pad = np.full(wc, -8, np.int32)
    c_pad[1:lc + 1] = c
    v0j = jnp.asarray(np.zeros(NUM_MATRICES, np.int32) if v0 is None
                      else v0.astype(np.int32))
    carry = JD._init_carry(v0j, hb, wc, mode)
    lo = jnp.zeros((qq, hb * wc), jnp.uint16)
    hi = jnp.zeros((qq, hb * wc), jnp.uint8)
    scoring = JScoring(**sc)
    args = (jnp.asarray(a_pad), jnp.asarray(b_pad), jnp.asarray(c_pad), v0j)
    for q0 in range(0, qq, JD.SEG_STEPS):
        lens = jnp.asarray(np.array([la, lb, lc, q0], np.int32))
        carry, lo, hi = JD._choices_seg(lens, *args, carry, lo, hi, hb, wc,
                                        qq, scoring, mode,
                                        min(JD.SEG_STEPS, qq - q0))
    qmax = la + lb + lc

    def cut(x):
        return np.asarray(x).reshape(qq, hb, wc)[:qmax, :lb + 1, :lc + 1]

    return np.asarray(carry[3]), cut(lo), cut(hi)


def fields(lo, hi) -> np.ndarray:
    """(7, ...) 3-bit fields of packed entries."""
    word = lo.astype(np.int64) & 0xFFFF | hi.astype(np.int64) << 15
    return np.stack([(word >> (3 * t)) & 7 for t in range(NUM_MATRICES)])


def port_choices(a, b, c, sc: dict, mode, v0):
    final, lo, hi = D._choices(a, b, c, Scoring(**sc), mode, v0, "cpu")
    shape = (-1, len(b) + 1, len(c) + 1)
    return final.numpy(), lo.numpy().reshape(shape), hi.numpy().reshape(shape)


def slots(la, lb, lc) -> np.ndarray:
    return D.cuboid_slots(la, lb, lc).numpy().reshape(-1, lb + 1, lc + 1)


@pytest.mark.parametrize("dims", SHAPES)
@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("mode", MODES)
def test_plain_sweep_matches_jax_sweep(mode, name, dims):
    (a, b, c), v0 = inputs(sum(dims), dims, mode)
    sc = SCORINGS[name]
    f_p, lo_p, hi_p = port_choices(a, b, c, sc, mode, v0)
    f_j, lo_j, hi_j = jax_choices(a, b, c, sc, mode, v0)
    assert f_p.tolist() == f_j.tolist()
    on = slots(*dims)
    got, want = fields(lo_p, hi_p), fields(lo_j, hi_j)
    j = np.arange(dims[1] + 1).reshape(1, -1, 1)
    k = np.arange(dims[2] + 1).reshape(1, 1, -1)
    for t, (dj, dk) in enumerate(SHIFTS):
        has = on & (j >= dj) & (k >= dk)
        assert np.array_equal(got[t][has], want[t][has]), t
        assert not got[t][on & ~has].any(), t


@pytest.mark.parametrize("dims", [(6, 1, 9), (13, 11, 14)])
@pytest.mark.parametrize("mode", MODES)
def test_walk_matches_jax_walk(mode, dims):
    """walk_ref and the JAX engine's _walk_device on the port's buffers,
    from every end state: the same steps and stop."""
    la, lb, lc = dims
    (a, b, c), v0 = inputs(7 + sum(dims), dims, mode)
    _, lo, hi = D._choices(a, b, c, Scoring(), mode, v0, "cpu")
    lo_j = jnp.asarray(lo.numpy().view(np.uint16))
    hi_j = jnp.asarray(hi.numpy())
    lens = jnp.asarray(np.array(dims, np.int32))
    for t0 in range(NUM_MATRICES):
        got = D.walk_ref(lo, hi, t0, la, lb, lc, mode)
        assert torch.equal(D.walk(lo, hi, t0, la, lb, lc, mode), got)
        n = int(got[0])
        acts, stop = got[4:4 + n].tolist(), tuple(got[1:4].tolist())
        assert (got[4 + n:] == -1).all()
        acts_j, n_j, stop_j = JD._walk_device(
            lo_j, hi_j, jnp.int32(t0), lens, la + lb + lc, lb + 1, lc + 1,
            mode)
        assert int(n_j) == n
        assert np.asarray(acts_j)[:n].tolist() == acts
        assert tuple(np.asarray(stop_j).tolist()) == stop


def model_choices(a, b, c, scoring: Scoring, mode, v0):
    """Cell by cell, in plain Python: the kernel's step (each target's max
    over sources 0..6 in order, the first that reaches it chosen; M's value
    and choice from the stored values at (i-1, j-1, k-1); no choice, 0, for
    a target without a predecessor) and its walls.  Returns (final, {(q, j,
    k): word} over the cuboid's cells with q >= 1)."""
    la, lb, lc = len(a), len(b), len(c)
    w = scoring.weight_matrix().tolist()

    def below(j, k):
        """The value of every matrix at i < 0 (the ring's start)."""
        if mode == "free" or (mode == "free_jk" and (j == 0 or k == 0)):
            return [0] * NUM_MATRICES
        return [NEG] * NUM_MATRICES

    def sub(t, i, j, k):
        ca, cb, cc = CONSUMES[t]
        if (ca and i == 0) or (cb and j == 0) or (cc and k == 0):
            return 0  # a wall or a face: the value is replaced
        x, y, z = int(a[i - 1]), int(b[j - 1]), int(c[k - 1])
        if t == 0:
            return int(scoring.triple_score(x, y, z))
        pair = {4: (x, y), 5: (y, z), 6: (x, z)}.get(t)
        return int(scoring.pair_score(*pair)) if pair else 0

    vals, words = {}, {}
    for q in range(la + lb + lc + 1):
        for j in range(lb + 1):
            for k in range(lc + 1):
                i = q - j - k
                if not 0 <= i <= la:
                    continue
                if q == 0:
                    vals[0, 0, 0] = (list(map(int, v0)) if mode == "pin"
                                     else below(0, 0))
                    continue
                new, word = [], 0
                for t, (di, dj, dk) in enumerate(OFFSETS):
                    if j < dj or k < dk:
                        new.append(NEG)
                        continue
                    pred = vals.get((i - di, j - dj, k - dk)) or \
                        below(j - dj, k - dk)
                    best, arg = pred[0] + w[t][0], 0
                    for s in range(1, NUM_MATRICES):
                        if pred[s] + w[t][s] > best:
                            best, arg = pred[s] + w[t][s], s
                    new.append(best + sub(t, i, j, k))
                    word |= arg << (3 * t)
                new = [max(v, NEG) for v in new]
                if mode == "pin":
                    new = [NEG if (i < ca or j < cb or k < cc) else v
                           for v, (ca, cb, cc) in zip(new, CONSUMES)]
                elif j == 0 or k == 0:
                    new = [0] * NUM_MATRICES
                elif i == 0:
                    new = [0 if mode == "free" else NEG] * NUM_MATRICES
                vals[i, j, k] = new
                words[q, j, k] = word
    return vals[la, lb, lc], words


# Inputs built to tie: one symbol everywhere (every match ties), gap_open =
# gap_extend (every gap charge ties), and "pin" borders that are mostly NEG
# (NEG sources ranked only by their charges).
TIES = {
    "one_symbol": ({}, 1),
    "flat_gaps": ({"match": 1, "mismatch": -1, "gap_open": 2,
                   "gap_extend": 2}, 3),
    "one_symbol_flat_gaps": ({"match": 2, "mismatch": 0, "gap_open": 1,
                              "gap_extend": 1}, 1),
    "sub4_flat_gaps": ({"submatrix": SUB4, "gap_open": 3, "gap_extend": 3},
                       2),
}


@pytest.mark.parametrize("dims", [(1, 4, 3), (6, 5, 7)])
@pytest.mark.parametrize("case", sorted(TIES))
@pytest.mark.parametrize("mode", MODES)
def test_step_tie_rule_matches_plain_sweep(mode, case, dims):
    sc, nsym = TIES[case]
    scoring = Scoring(**sc)
    (a, b, c), _ = inputs(3, dims, "free", nsym)
    v0 = None
    if mode == "pin":
        v0 = np.full(NUM_MATRICES, NEG, np.int32)
        v0[sum(dims) % NUM_MATRICES] = 0
    final, words = model_choices(a, b, c, scoring, mode, v0)
    f_p, lo_p, hi_p = port_choices(a, b, c, sc, mode, v0)
    assert f_p.tolist() == final
    packed = (lo_p.astype(np.int64) & 0xFFFF) | hi_p.astype(np.int64) << 15
    got = {(q, j, k): int(packed[q - 1, j, k]) for q, j, k in words}
    assert got == words
