"""Plain whole-plane anti-diagonal sweep in torch: the port's bridge oracle.

Port of ``trialign/kernels/xla_ref.py`` (``_sweep``, ``align_xla``).  Plane
q of the DP cuboid is a (|B|+1, |C|+1) tensor whose (j, k) entry is cell
(i = q - j - k, j, k); each step applies the reference's plane update
(``plane_math.fused_plane_update_m7`` with ``torch.maximum``/``torch.roll``)
to the two carried planes and the carried max7.  It runs on any device, with
both ``s3_mode``s, ``score_bits`` wrap and any submatrix of <= 16 symbols.

It is the plain version the wavefront kernel is compared and timed against
on the card, and what the wavefront wrapper runs on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from trialign_torch.config import PAD_SYMBOL, Scoring
from trialign_torch.kernels.plane_math import (
    fused_plane_update_m7, transition_groups,
)

# Sentinels before and after each sequence (xla_ref.align_xla,
# wavefront.prepare_compact): distinct, so a pad never matches a pad.
PAD_A, PAD_B, PAD_C = PAD_SYMBOL, PAD_SYMBOL - 1, PAD_SYMBOL - 2


def extend(seq, length: int, pad: int, device) -> torch.Tensor:
    """int32 tensor of ``length`` with ``seq`` at indices 1..len(seq) and
    ``pad`` everywhere else (index i holds the i-th, 1-based, symbol)."""
    out = np.full(length, pad, dtype=np.int32)
    out[1 : len(seq) + 1] = np.asarray(seq, dtype=np.int32)
    return torch.from_numpy(out).to(device)


def pair_fn(scoring: Scoring, device):
    """S(x, y) on int32 tensors: match/mismatch, or the submatrix through
    ``Scoring.sub_lookup()`` (out-of-alphabet codes score its clamped floor)."""
    if scoring.submatrix is not None:
        lut = torch.tensor(scoring.sub_lookup().ravel(), device=device)

        def pair(x, y):
            return lut[(((x & 0xFF) << 8) | (y & 0xFF)).long()]

        return pair
    match = torch.tensor(scoring.match, dtype=torch.int32, device=device)
    mismatch = torch.tensor(scoring.mismatch, dtype=torch.int32, device=device)

    def pair(x, y):
        return torch.where(x == y, match, mismatch)

    return pair


def substitution(ai, b, c, s_bc, scoring: Scoring, pair):
    """Per-target bonus planes (S3, 0, 0, 0, S(a,b), S(b,c), S(a,c)) in
    matrix order (plane_math.SUB_KIND), for symbol tensors that broadcast."""
    s_ab = pair(ai, b)
    s_ac = pair(ai, c)
    if scoring.s3_mode == "sop":
        s3 = s_ab + s_ac + s_bc
    else:
        # src/PE_1cyc.v:162 precedence quirk, as Scoring.triple_score.
        def const(v):
            return torch.tensor(v, dtype=torch.int32, device=ai.device)

        m, mm = scoring.match, scoring.mismatch
        s3 = torch.where(
            ai == b,
            torch.where(b == c, const(3 * m), const(2 * (m + mm))),
            const(3 * mm),
        )
    return (s3, 0, 0, 0, s_ab, s_bc, s_ac)


def wrap(x: torch.Tensor, score_bits: int) -> torch.Tensor:
    """Stored values as signed score_bits-wide registers (the RTL's
    unsaturated SCORE_BITS, src/TriAlign_1cyc.v:6); identity for 0."""
    if not score_bits:
        return x
    half = 1 << (score_bits - 1)
    return ((x + half) & ((1 << score_bits) - 1)) - half


def roll1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """out[..., j, k] = x[..., j - 1, k] (axis 0) or x[..., j, k - 1]
    (axis 1); the wrapped-in row/column is a border the mask overwrites."""
    return torch.roll(x, 1, dims=axis - 2)


def sweep(a_ext, b_ext, c_ext, la: int, lb: int, lc: int,
          scoring: Scoring = Scoring(), score_bits: int = 0) -> torch.Tensor:
    """The seven final-cell values (int32, shape (7,)) of one triplet, or
    (S, 7) of S triplets that share B and C when ``a_ext`` is (S, n): one
    sweep of the S planes at once.

    ``a_ext[..., i]``, ``b_ext[j]``, ``c_ext[k]`` hold the 1-based symbols,
    with at least la+1, lb+1 and lc+1 entries on one device; every length
    >= 1."""
    dev = a_ext.device
    hb, wc = lb + 1, lc + 1
    groups = transition_groups(scoring.weight_matrix())
    pair = pair_fn(scoring, dev)
    j = torch.arange(hb, device=dev).view(hb, 1)
    k = torch.arange(wc, device=dev).view(1, wc)
    jk = j + k
    edge = (j >= 1) & (k >= 1)
    b = b_ext[:hb].view(hb, 1)
    c = c_ext[:wc].view(1, wc)
    s_bc = pair(b, c)

    zeros = torch.zeros((7, hb, wc), dtype=torch.int32, device=dev)
    p1, p2 = zeros, zeros
    m7p2, m7p3 = zeros[0], zeros[0]
    for q in range(1, la + lb + lc + 1):
        i = q - jk
        valid = edge & (i >= 1) & (i <= la)
        ai = a_ext[..., i.clamp(0, la)]
        subs = substitution(ai, b, c, s_bc, scoring, pair)
        cands, m7p1 = fused_plane_update_m7(
            p1, p2, m7p3, subs, groups, torch.maximum, roll1
        )
        # Gap matrices take no A symbol, so only a batch's others have S.
        cands = torch.broadcast_tensors(*cands)
        new = torch.where(valid, wrap(torch.stack(cands), score_bits), 0)
        # m7p1 (max7 of plane q-1) is max7(q-2) for the next step.
        p1, p2, m7p2, m7p3 = new, p1, m7p1, m7p2
    final = p1[..., lb, lc]
    return final if a_ext.dim() == 1 else final.T


def align_ref(a, b, c, scoring: Scoring = Scoring(), score_bits: int = 0,
              device="cpu") -> int:
    """Optimal 3-sequence alignment score via the plain torch sweep."""
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) == 0:
        return 0  # zero borders: a border face holds the final cell
    final = sweep(
        extend(a, la + 1, PAD_A, device), extend(b, lb + 1, PAD_B, device),
        extend(c, lc + 1, PAD_C, device), la, lb, lc, scoring, score_bits,
    )
    return int(final.max())
