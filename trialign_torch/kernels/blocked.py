"""The blocked (sliced) sweep (K3) for triplets past the wavefront's caps.

Port of ``trialign/kernels/blocked.py`` without chain mode: ``_block_sweep``
as launched by ``make_grid_call``, and the host side ``plan_dims``,
``choose_block_shape``, ``prep_blocked``, ``align_blocked`` and
``align_blocked_async``.

The (j, k) plane is cut into tiles of tb x tc cells.  A tile's plane is
(hb, wc) = (tb + 1, tc + 1): a halo row and column that come from the faces
of its upper and left neighbours, then its own cells.  Each tile sweeps all
of its local planes q = 1 .. |A| + tb + tc (cell (jl, kl) of local plane q
holds global i = q - jl - kl), and tiles run one anti-diagonal jb + kb = d at
a time.  Faces live in skewed slabs: the bottom row of local plane q goes to
row q - tb of the row-face slab of its tile column, the right column to row
q - tc of the column-face slab of its tile row (blocked.py:6-12).

On a CUDA tensor :func:`final_values` launches ``csrc/blocked.cu`` once per
anti-diagonal.  On a CPU tensor it runs :func:`blocked_ref`, the plain torch
version of the same tile schedule and face layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from trialign_torch.config import Scoring
from trialign_torch.kernels.plane_math import (
    fused_plane_update_m7, transition_groups,
)
from trialign_torch import _build
from trialign_torch.kernels.ref import (
    PAD_A, PAD_B, PAD_C, extend, pair_fn, roll1, substitution, wrap,
)

# Default tile plane (hb, wc) = (tb + 1, tc + 1) and threads per tile: the
# fastest of chip_smoke.py's "tuning" candidates at 1024^3 on the H100
# (PERF.md).
DEF_HB, DEF_WC = 33, 33
THREADS = 512
# Shared memory one thread block may take on sm_90 (227 KB).
SMEM_CAP = 232448


class Dims(NamedTuple):
    """Static geometry of one blocked sweep."""

    hb: int      # tile plane rows: halo row + tb cells
    wc: int      # tile plane columns: halo column + tc cells
    n_jb: int    # tile rows, ceil(|B| / tb)
    n_kb: int    # tile columns, ceil(|C| / tc)
    nq: int      # local planes a tile sweeps, |A| + tb + tc
    nrows: int   # rows of each face slab (local planes 0 .. nq)


def shared_bytes(hb: int, wc: int) -> int:
    """Shared memory a tile's thread block takes, as csrc/blocked.cu
    shared_bytes counts it: 25 ring planes (3 generations of 7 matrices, 4
    of max7), the tile's B and C symbols and the 9 x 9 submatrix table."""
    return 4 * (25 * hb * wc + hb + wc + 81)


def choose_block_shape(la: int, lb: int, lc: int) -> Tuple[int, int]:
    """The tile plane (hb, wc).  A fixed default measured on the H100; the
    v5e cost model of the reference (VMEM budget, lane efficiency) does not
    apply to shared memory."""
    return DEF_HB, DEF_WC


def plan_dims(la: int, lb: int, lc: int, hb: int = DEF_HB,
              wc: int = DEF_WC) -> Dims:
    """Geometry for a blocked sweep of |A|, |B|, |C| >= 1 at tile plane
    (hb, wc); raises ValueError for a tile the card cannot hold."""
    if hb < 2 or wc < 2:
        raise ValueError(f"tile plane {hb}x{wc} needs at least one cell")
    if shared_bytes(hb, wc) > SMEM_CAP:
        raise ValueError(
            f"tile plane {hb}x{wc} needs {shared_bytes(hb, wc)} bytes of "
            f"shared memory; a block has {SMEM_CAP}"
        )
    tb, tc = hb - 1, wc - 1
    n_jb = max(1, -(-lb // tb))
    n_kb = max(1, -(-lc // tc))
    nq = la + tb + tc
    return Dims(hb, wc, n_jb, n_kb, nq, nq + 1)


def prep_blocked(a, b, c, dims: Dims, device):
    """Symbol arrays for one problem under ``dims``: A_i at index i of
    a (|A|+1), B_j at index j of b (n_jb * tb + 1), C_k likewise, with the
    reference's sentinels at index 0 and past each end."""
    tb, tc = dims.hb - 1, dims.wc - 1
    return (
        extend(a, len(a) + 1, PAD_A, device),
        extend(b, dims.n_jb * tb + 1, PAD_B, device),
        extend(c, dims.n_kb * tc + 1, PAD_C, device),
    )


def _target(lb: int, lc: int, dims: Dims):
    """Local (jl, kl) of the final cell (|B|, |C|) in the last tile
    (blocked.py:1174-1179: jbstar = (lb - 1) // tb = n_jb - 1)."""
    tb, tc = dims.hb - 1, dims.wc - 1
    return lb - (dims.n_jb - 1) * tb, lc - (dims.n_kb - 1) * tc


def _diagonal(d: int, dims: Dims):
    """Tile rows jb of anti-diagonal d (tile columns are d - jb)."""
    return range(max(0, d - dims.n_kb + 1), min(d, dims.n_jb - 1) + 1)


# A face entry the sweep never wrote.  Large and positive, so that a read of
# one would win a max and show up in the score.
_UNWRITTEN = 1 << 28


def blocked_ref(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
                scoring: Scoring = Scoring(),
                score_bits: int = 0) -> torch.Tensor:
    """Plain torch version of K3: the seven final-cell values (int32, (7,)).

    Same tile schedule, face slabs, halo install order and capture as the
    kernel; the tiles of one anti-diagonal run as one batch."""
    dev = a_ext.device
    hb, wc = dims.hb, dims.wc
    tb, tc = hb - 1, wc - 1
    groups = transition_groups(scoring.weight_matrix())
    pair = pair_fn(scoring, dev)
    jl = torch.arange(hb, device=dev)
    kl = torch.arange(wc, device=dev)
    jk = jl.view(hb, 1) + kl.view(1, wc)
    edge = (jl.view(hb, 1) >= 1) & (kl.view(1, wc) >= 1)
    # Row faces [n_kb][row][7][wc], column faces [n_jb][row][7][hb].
    rf = torch.full((dims.n_kb, dims.nrows, 7, wc), _UNWRITTEN,
                    dtype=torch.int32, device=dev)
    cf = torch.full((dims.n_jb, dims.nrows, 7, hb), _UNWRITTEN,
                    dtype=torch.int32, device=dev)
    jlstar, klstar = _target(lb, lc, dims)
    qstar = la + jlstar + klstar
    final = None

    for d in range(dims.n_jb + dims.n_kb - 1):
        jbs = torch.tensor(list(_diagonal(d, dims)), device=dev)
        kbs = d - jbs
        n = len(jbs)
        bsym = b_ext[jbs.view(n, 1) * tb + jl.view(1, hb)].view(n, hb, 1)
        csym = c_ext[kbs.view(n, 1) * tc + kl.view(1, wc)].view(n, 1, wc)
        s_bc = pair(bsym, csym)
        has_row = (jbs > 0).view(1, n, 1)
        has_col = (kbs > 0).view(1, n, 1)
        target = d == dims.n_jb + dims.n_kb - 2  # the last tile, alone

        zeros = torch.zeros((7, n, hb, wc), dtype=torch.int32, device=dev)
        p1, p2 = zeros, zeros
        m7p2, m7p3 = zeros[0], zeros[0]
        for q in range(1, dims.nq + 1):
            i = q - jk
            valid = edge & (i >= 1) & (i <= la)
            ai = a_ext[i.clamp(0, la)]
            subs = substitution(ai, bsym, csym, s_bc, scoring, pair)
            cands, m7p1 = fused_plane_update_m7(
                p1, p2, m7p3, subs, groups, torch.maximum, roll1
            )
            new = torch.where(valid, wrap(torch.stack(cands), score_bits), 0)
            # Halo: column 0 from the column face, then row 0 from the row
            # face, which wins at the corner.  A halo cell outside
            # 1 <= i <= |A| is 0 and its face row is not read.
            icol, irow = q - jl, q - kl
            col_ok = has_col & ((icol >= 1) & (icol <= la)).view(1, 1, hb)
            row_ok = has_row & ((irow >= 1) & (irow <= la)).view(1, 1, wc)
            new[:, :, :, 0] = torch.where(
                col_ok, cf[jbs, q].permute(1, 0, 2), 0)
            new[:, :, 0, :] = torch.where(
                row_ok, rf[kbs, q].permute(1, 0, 2), 0)
            # Faces, corners included: bottom row to row q - tb of the row
            # slab, right column to row q - tc of the column slab.
            if q - tb >= 0:
                rf[kbs, q - tb] = new[:, :, tb, :].permute(1, 0, 2)
            if q - tc >= 0:
                cf[jbs, q - tc] = new[:, :, :, tc].permute(1, 0, 2)
            if target and q == qstar:
                final = new[:, 0, jlstar, klstar]
            p1, p2, m7p2, m7p3 = new, p1, m7p1, m7p2
    return final


def final_values(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
                 scoring: Scoring = Scoring(), score_bits: int = 0,
                 threads: int = THREADS) -> torch.Tensor:
    """The seven final-cell values (int32, (7,)) of one problem with
    |A|, |B|, |C| >= 1, from the arrays of :func:`prep_blocked`.  On a CPU
    tensor this is :func:`blocked_ref`; on a CUDA tensor it launches K3 once
    per tile anti-diagonal and never falls back."""
    _build.check_submatrix(scoring)
    if min(la, lb, lc) < 1:
        raise ValueError("the blocked sweep needs |A|, |B|, |C| >= 1")
    if dims != plan_dims(la, lb, lc, dims.hb, dims.wc):
        raise ValueError(f"dims {dims} were not planned for {la, lb, lc}")
    tb, tc = dims.hb - 1, dims.wc - 1
    for t, n in ((a_ext, la + 1), (b_ext, dims.n_jb * tb + 1),
                 (c_ext, dims.n_kb * tc + 1)):
        if t.dtype != torch.int32 or t.shape != (n,) or \
                not t.is_contiguous() or t.device != a_ext.device:
            raise ValueError(
                "a, b, c must be contiguous int32 vectors on one device, "
                "shaped as prep_blocked makes them"
            )
    if a_ext.device.type == "cpu":
        return blocked_ref(a_ext, b_ext, c_ext, la, lb, lc, dims, scoring,
                           score_bits)
    if a_ext.device.type != "cuda":
        raise ValueError(f"no blocked kernel for device {a_ext.device}")
    lib = _build.load("blocked")
    dev = a_ext.device
    step, table = _build.kernel_scoring(scoring, score_bits, dev)
    jlstar, klstar = _target(lb, lc, dims)
    geom = _build.BlockedGeom(la, dims.hb, dims.wc, dims.n_jb, dims.n_kb,
                              dims.nrows, jlstar, klstar)
    rf = torch.empty(dims.n_kb * dims.nrows * 7 * dims.wc, dtype=torch.int32,
                     device=dev)
    cf = torch.empty(dims.n_jb * dims.nrows * 7 * dims.hb, dtype=torch.int32,
                     device=dev)
    out = torch.empty(7, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for d in range(dims.n_jb + dims.n_kb - 1):
            code = lib.trialign_blocked_diag(
                a_ext.data_ptr(), b_ext.data_ptr(), c_ext.data_ptr(), geom, d,
                table.data_ptr(), step, rf.data_ptr(), cf.data_ptr(),
                out.data_ptr(), threads, stream,
            )
            _build.check(lib, code, f"blocked kernel launch (diagonal {d})")
            final_values.launches += 1
    return out


# Launches of the CUDA kernel since the count was last set to 0.
final_values.launches = 0


def align_blocked_async(a, b, c, scoring: Scoring = Scoring(),
                        block_shape: Optional[Tuple[int, int]] = None,
                        score_bits: int = 0, device="cuda") -> torch.Tensor:
    """Like :func:`align_blocked`, but the score is a 0-d int32 tensor on
    ``device`` and nothing waits for the card: callers queue many problems
    and read all scores at the end."""
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) == 0:
        return torch.zeros((), dtype=torch.int32, device=device)
    hb, wc = block_shape or choose_block_shape(la, lb, lc)
    dims = plan_dims(la, lb, lc, hb, wc)
    return final_values(*prep_blocked(a, b, c, dims, device), la, lb, lc,
                        dims, scoring, score_bits).max()


def align_blocked(a, b, c, scoring: Scoring = Scoring(),
                  block_shape: Optional[Tuple[int, int]] = None,
                  score_bits: int = 0, device="cuda") -> int:
    """Optimal 3-sequence alignment score via the blocked kernel (its plain
    version on ``device="cpu"``).  ``block_shape`` is the tile plane
    (hb, wc), as in the reference; the default is :func:`choose_block_shape`."""
    return int(align_blocked_async(a, b, c, scoring, block_shape, score_bits,
                                   device))
