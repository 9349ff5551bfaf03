"""The single-block wavefront sweep (K2) for triplets with |B|, |C| <= 255.

Port of ``trialign/kernels/wavefront.py`` (``_make_kernel`` as launched by
``_run``/``_run_compact``, host side ``prepare_compact`` and
``align_wavefront``).  On a CUDA tensor :func:`final_values` launches
``csrc/wavefront.cu``, one thread block per problem; on a CPU tensor it runs
the kernel's plain version, the whole-plane torch sweep of ``ref.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from trialign.config import Scoring
from trialign_torch import _build
from trialign_torch.kernels.ref import PAD_A, PAD_B, PAD_C, extend, sweep

SUBMATRIX_NSYM_CAP = _build.SUBMATRIX_NSYM_CAP
# The Pallas kernel's caps (wavefront.bucket_dims), kept so that align()
# routes every size to the same kernel as the reference.
MAX_A = 4096
MAX_BC = 255
# Threads per problem: the fastest of 256/512/1024 at 255^3 on the H100
# (chip_smoke.py "tuning" phase; PERF.md).
THREADS = 1024


def check_dims(la: int, lb: int, lc: int) -> None:
    """Raise ValueError past the kernel's caps."""
    if lb > MAX_BC or lc > MAX_BC or la > MAX_A:
        raise ValueError(
            f"wavefront kernel supports |B|,|C| <= {MAX_BC} and |A| <= "
            f"{MAX_A}; got {la}/{lb}/{lc}. Use the blocked backend."
        )


def prep(a, b, c, device):
    """Kernel inputs for one triplet: (a, b, c) as (1, len+1) int32 tensors
    with the reference's sentinels (PAD_SYMBOL for A, 254 for B, 253 for C)
    at index 0 and past the end, and lens (1, 3)."""
    la, lb, lc = len(a), len(b), len(c)
    check_dims(la, lb, lc)
    tensors = (
        extend(a, la + 1, PAD_A, device)[None],
        extend(b, lb + 1, PAD_B, device)[None],
        extend(c, lc + 1, PAD_C, device)[None],
    )
    return (*tensors, np.array([[la, lb, lc]], dtype=np.int32))


def final_values(a, b, c, lens, scoring: Scoring = Scoring(),
                 score_bits: int = 0, threads: int = THREADS) -> torch.Tensor:
    """The seven final-cell values of each problem, an (n, 7) int32 tensor
    (all 0 for a problem with an empty sequence).

    ``a``, ``b``, ``c``: (n, *) int32 tensors on one device, symbol i of a
    problem's sequence at index i; ``lens``: (n, 3) host integers.  On a CPU
    tensor this is the plain ``ref.sweep``; on a CUDA tensor it launches K2
    and never falls back."""
    _build.check_submatrix(scoring)
    lens = np.asarray(lens, dtype=np.int64).reshape(-1, 3)
    n = lens.shape[0]
    for t in (a, b, c):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n or \
                not t.is_contiguous() or t.device != a.device:
            raise ValueError(
                "a, b, c must be contiguous (n, length) int32 tensors on one "
                "device"
            )
    for la, lb, lc in lens:
        check_dims(la, lb, lc)
        if min(la, lb, lc) < 0 or la >= a.shape[1] or lb >= b.shape[1] \
                or lc >= c.shape[1]:
            raise ValueError(f"lens {la, lb, lc} exceed the symbol arrays")
    if a.device.type == "cpu":
        out = torch.zeros((n, 7), dtype=torch.int32)
        for p, (la, lb, lc) in enumerate(lens.tolist()):
            if min(la, lb, lc):
                out[p] = sweep(a[p], b[p], c[p], la, lb, lc, scoring,
                               score_bits)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {a.device}")
    if b.shape[1] > MAX_BC + 1 or c.shape[1] > MAX_BC + 1:
        raise ValueError("b and c hold at most 256 symbols a problem")
    lib = _build.load()
    hb, wc = b.shape[1], c.shape[1]
    step, table = _build.kernel_scoring(scoring, score_bits, a.device)
    lens_d = torch.from_numpy(lens.astype(np.int32)).to(a.device)
    scratch = torch.empty(
        n * lib.trialign_wavefront_scratch_ints(hb, wc), dtype=torch.int32,
        device=a.device,
    )
    out = torch.empty((n, 8), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.trialign_wavefront(
            a.data_ptr(), a.shape[1], b.data_ptr(), c.data_ptr(),
            lens_d.data_ptr(), n, hb, wc, table.data_ptr(), step,
            scratch.data_ptr(), out.data_ptr(), threads, stream,
        )
    _build.check(lib, code, "wavefront kernel launch")
    final_values.launches += 1
    return out[:, :7]


# Launches of the CUDA kernel since the count was last set to 0.
final_values.launches = 0


def align_wavefront(a, b, c, scoring: Scoring = Scoring(), score_bits: int = 0,
                    device="cuda") -> int:
    """Optimal 3-sequence alignment score via the wavefront kernel (its plain
    version on ``device="cpu"``)."""
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    if min(len(a), len(b), len(c)) == 0:
        return 0
    return int(final_values(*prep(a, b, c, device), scoring,
                            score_bits).max())
