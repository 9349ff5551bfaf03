"""The port's wavefront wrapper (K2) against the reference's Pallas kernel.

On the CPU the wrapper runs its plain version; the reference kernel runs in
interpret mode, at the sizes of tests/test_wavefront.py.  The CUDA kernel
itself is compared with its plain version in tests/test_torch_cuda.py.
Scores are integers: equality is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.conftest import random_triplet
from trialign.config import Scoring as JScoring
from trialign.golden import align_planes_numpy
from trialign.kernels import wavefront as jax_wf
from trialign_torch.config import Scoring
from trialign_torch.kernels import ref
from trialign_torch.kernels import wavefront as wf


def ref_scoring(sc):
    """The JAX package's Scoring with the same fields as the port's."""
    return JScoring(**dataclasses.asdict(sc))


torch.set_num_threads(1)

SUB4 = ((3, -1, -2, 0), (-2, 2, -1, -3), (0, -3, 4, -1), (-1, -2, -1, 1))
SUB8 = tuple(tuple(int(v) for v in row)
             for row in np.random.default_rng(7).integers(-4, 6, (8, 8)))
WIDE = Scoring(match=60, mismatch=-20, gap_open=80, gap_extend=10)


def both(a, b, c, scoring=Scoring(), score_bits=0):
    port = wf.align_wavefront(a, b, c, scoring, score_bits, device="cpu")
    want = jax_wf.align_wavefront(a, b, c, ref_scoring(scoring),
                                  interpret=True, score_bits=score_bits)
    return port, want


@pytest.mark.parametrize("dims", [(3, 3, 3), (6, 5, 7), (12, 9, 11)])
def test_plain_matches_pallas_small(rng, dims):
    port, want = both(*random_triplet(rng, *dims))
    assert port == want


def test_plain_rtl_s3_mode(rng):
    port, want = both(*random_triplet(rng, 8, 7, 9), Scoring(s3_mode="rtl"))
    assert port == want


def test_plain_nondefault_scoring(rng):
    sc = Scoring(match=2, mismatch=-3, gap_open=5, gap_extend=2)
    port, want = both(*random_triplet(rng, 9, 6, 8), sc)
    assert port == want


def test_plain_asymmetric_lengths(rng):
    port, want = both(*random_triplet(rng, 40, 4, 6))
    assert port == want


@pytest.mark.parametrize("matrix", [SUB4, SUB8], ids=["sub4", "sub8"])
def test_plain_submatrix(rng, matrix):
    sc = Scoring(submatrix=matrix)
    a, b, c = random_triplet(rng, 10, 8, 9, nsym=len(matrix) + 2)
    assert wf.align_wavefront(a, b, c, sc, device="cpu") == \
        align_planes_numpy(a, b, c, ref_scoring(sc))


def test_plain_score_bits(rng):
    a = rng.integers(0, 4, 30).astype(np.uint8)
    b, c = a.copy(), a.copy()
    b[::7] = (b[::7] + 1) % 4
    want = align_planes_numpy(a, b, c, ref_scoring(WIDE), score_bits=12)
    assert want != align_planes_numpy(a, b, c, ref_scoring(WIDE))
    assert wf.align_wavefront(a, b, c, WIDE, score_bits=12, device="cpu") == \
        want


@pytest.mark.parametrize("dims", [(64, 63, 63), (255, 255, 255),
                                  (4096, 255, 1), (4097, 1, 1),
                                  (100, 256, 100), (100, 100, 256)])
def test_size_caps_match_reference(dims):
    """The port accepts exactly the sizes the reference kernel buckets."""
    try:
        jax_wf.bucket_dims(*dims)
        ref_ok = True
    except ValueError:
        ref_ok = False
    if ref_ok:
        wf.check_dims(*dims)
    else:
        with pytest.raises(ValueError):
            wf.check_dims(*dims)


def test_submatrix_cap_matches_reference(rng):
    sc = Scoring(submatrix=tuple(tuple(1 if i == j else -1 for j in range(9))
                                 for i in range(9)))
    a, b, c = random_triplet(rng, 3, 3, 3)
    with pytest.raises(ValueError):
        jax_wf.align_wavefront(a, b, c, ref_scoring(sc), interpret=True)
    with pytest.raises(ValueError):
        wf.align_wavefront(a, b, c, sc, device="cpu")


def test_empty_sequence_shortcut():
    e = np.zeros(0, dtype=np.uint8)
    a = np.zeros(4, dtype=np.uint8)
    assert wf.align_wavefront(a, a, e, device="cpu") == 0


def test_batch_plain(rng):
    """A batch padded to common widths gives each problem its own score;
    an empty problem gives zeros."""
    trips = [random_triplet(rng, *d) for d in ((7, 5, 6), (3, 9, 2),
                                               (0, 4, 4))]
    pads = (ref.PAD_A, ref.PAD_B, ref.PAD_C)
    arrs = [torch.stack([ref.extend(t[x], 11, pads[x], "cpu") for t in trips])
            for x in range(3)]
    lens = [[len(s) for s in t] for t in trips]
    out = wf.final_values(*arrs, lens)
    assert out.shape == (3, 7) and out.dtype == torch.int32
    for p, t in enumerate(trips[:2]):
        assert int(out[p].max()) == align_planes_numpy(*t)
    assert out[2].tolist() == [0] * 7


def test_final_values_rejects_bad_inputs(rng):
    a, b, c, lens = wf.prep(*random_triplet(rng, 5, 4, 3), "cpu")
    with pytest.raises(ValueError):
        wf.final_values(a.long(), b, c, lens)
    with pytest.raises(ValueError):
        wf.final_values(a, b, c, [[5, 9, 3]])

