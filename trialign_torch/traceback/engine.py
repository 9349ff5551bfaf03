"""Generalized DP sweeps for alignment recovery.

The port's copy of ``trialign/traceback/engine.py``: the host NumPy engine
(``forward_sweep``, ``backward_slab``, ``NEG``).  It is the base case of the
Hirschberg recursion and the oracle of every cell the slab kernel captures.

The reference outputs scores only; its traceback hooks were stubbed out
(commented `act` outputs and dat/action.dat include, src/PE_1cyc.v:12-14,30).
This engine restores alignments via Hirschberg-style divide and conquer,
which needs two generalizations of the plane sweep:

* a forward sweep whose start can be either the zero-border "free" mode the
  hardware computes, or *pinned* to a specific matrix state at the origin
  (for the right half of a split), with optional capture of the full
  (7, |B|+1, |C|+1) slab of cells at a given i = m;

* a backward sweep computing, for every (j, k) and state s, the best score
  of a suffix path from (m, j, k) in state s to the final cell.  A suffix
  step from state s into state u at the next cell adds W[u, s] + sub_u, so
  the backward sweep is a forward sweep over reversed sequences in which
  each *source* matrix u carries its own plane shift and substitution and
  the weight matrix transposes.

All values are int32 with NEG as -infinity; per-step clamping keeps NEG
from underflowing across long sweeps.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from trialign_torch.config import CONSUMES, NUM_MATRICES, OFFSETS, Scoring

NEG = -(2**26)


def _subs(scoring: Scoring, ai, bj, ck):
    """The 7 substitution planes for symbol planes ai/bj/ck (any shapes that
    broadcast together).  pair_score/triple_score honor a runtime
    ``scoring.submatrix`` (sentinels/pads score the clamped floor)."""
    shape = np.broadcast_shapes(np.shape(ai), np.shape(bj), np.shape(ck))
    s_ab = np.broadcast_to(scoring.pair_score(ai, bj), shape).astype(np.int32)
    s_ac = np.broadcast_to(scoring.pair_score(ai, ck), shape).astype(np.int32)
    s_bc = np.broadcast_to(scoring.pair_score(bj, ck), shape).astype(np.int32)
    if scoring.s3_mode == "sop":
        s3 = s_ab + s_ac + s_bc
    else:
        s3 = np.broadcast_to(
            scoring.triple_score(ai, bj, ck), shape
        ).astype(np.int32)
    return (s3, 0, 0, 0, s_ab, s_bc, s_ac)


def _shift_fill(x: np.ndarray, dj: int, dk: int, fill: int) -> np.ndarray:
    """out[..., j, k] = x[..., j-dj, k-dk], `fill` outside."""
    if not dj and not dk:
        return x
    out = np.full_like(x, fill)
    hb, wc = x.shape[-2], x.shape[-1]
    out[..., dj:, dk:] = x[..., : hb - dj if dj else hb, : wc - dk if dk else wc]
    return out


def forward_sweep(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    mode: str = "free",
    v0: Optional[np.ndarray] = None,
    capture_m: Optional[int] = None,
    return_cuboid: bool = False,
):
    """Forward plane sweep.

    mode="free": zero borders, interior cells only -- the hardware's
    semantics (reference: src/TriAlign_1cyc.v:157-181).
    mode="free_jk": the j=0 / k=0 faces are free (zero) but the i=0 face is
    a wall -- the geometry of "the suffix half of a split": free starts on
    the B/C borders remain legal at any i, but i=0 of the half-problem is an
    interior plane of the full problem, not a border.
    mode="pin": path starts at the origin with per-state scores v0 (NEG for
    disallowed states); borders are walls (NEG) but face cells are computed,
    since di=0 moves can travel along them.

    Returns (final (7,), slab (7,|B|+1,|C|+1) at i=capture_m or None,
    cuboid or None).
    """
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    c = np.asarray(c, dtype=np.int32)
    la, lb, lc = len(a), len(b), len(c)
    hb, wc = lb + 1, lc + 1
    w = scoring.weight_matrix().astype(np.int32)
    assert mode in ("free", "free_jk", "pin")
    free = mode == "free"
    free_jk = mode == "free_jk"
    if mode == "pin":
        assert v0 is not None and v0.shape == (NUM_MATRICES,)

    j_grid = np.arange(hb, dtype=np.int32)[:, None]
    k_grid = np.arange(wc, dtype=np.int32)[None, :]
    jk = j_grid + k_grid

    bj = np.full((hb, 1), -7, dtype=np.int32)
    bj[1:, 0] = b
    ck = np.full((1, wc), -8, dtype=np.int32)
    ck[0, 1:] = c

    fill = 0 if free else NEG
    planes = np.full((4, NUM_MATRICES, hb, wc), fill, dtype=np.int32)
    if free_jk:
        # Borders of the ring planes: j=0 / k=0 free, rest walled.
        planes[:, :, 0, :] = 0
        planes[:, :, :, 0] = 0
    if mode == "pin":
        # Plane 0: origin only.
        planes[0, :, 0, 0] = v0.astype(np.int32)

    slab = (
        np.full((NUM_MATRICES, hb, wc), NEG, dtype=np.int32)
        if capture_m is not None
        else None
    )
    if capture_m == 0 and slab is not None:
        if free:
            slab[:] = 0
        elif free_jk:
            slab[:, 0, :] = 0
            slab[:, :, 0] = 0
        else:
            slab[:, 0, 0] = v0
    cuboid = (
        np.full((NUM_MATRICES, la + 1, lb + 1, lc + 1), fill, dtype=np.int32)
        if return_cuboid
        else None
    )
    if return_cuboid and mode == "pin":
        cuboid[:, 0, 0, 0] = v0
    if return_cuboid and free_jk:
        cuboid[:, :, 0, :] = 0
        cuboid[:, :, :, 0] = 0

    final = planes[0, :, lb, lc].copy() if la + lb + lc == 0 else None

    qmax = la + lb + lc
    for q in range(1, qmax + 1):
        p1 = planes[(q - 1) % 4]
        p2 = planes[(q - 2) % 4] if q >= 2 else np.full_like(p1, fill)
        p3 = planes[(q - 3) % 4] if q >= 3 else np.full_like(p1, fill)
        # (For shallow q the ring still holds stale init planes; their fill
        # is already the correct wall/border value.)
        i_grid = q - jk
        ai = a[np.clip(i_grid - 1, 0, max(la - 1, 0))] if la else np.full((hb, wc), -9, np.int32)
        ai = np.where((i_grid >= 1) & (i_grid <= la), ai, -9)
        subs = _subs(scoring, ai, np.broadcast_to(bj, (hb, wc)), np.broadcast_to(ck, (hb, wc)))

        preds = [
            _shift_fill(p3, 1, 1, fill),  # M
            p1,  # Ix
            _shift_fill(p1, 1, 0, fill),  # Iy
            _shift_fill(p1, 0, 1, fill),  # Iz
            _shift_fill(p2, 1, 0, fill),  # Ixy
            _shift_fill(p2, 1, 1, fill),  # Iyz
            _shift_fill(p2, 0, 1, fill),  # Ixz
        ]
        new = np.empty((NUM_MATRICES, hb, wc), dtype=np.int32)
        for t in range(NUM_MATRICES):
            cand = np.max(preds[t] + w[t][:, None, None], axis=0) + subs[t]
            new[t] = np.maximum(cand, NEG)

        if free:
            valid = (i_grid >= 1) & (i_grid <= la) & (j_grid >= 1) & (k_grid >= 1)
            new = np.where(valid[None], new, 0)
        elif free_jk:
            irange = (i_grid >= 1) & (i_grid <= la)
            new = np.where(irange[None], new, NEG)
            border = (j_grid == 0) | (k_grid == 0)
            new = np.where(border[None], 0, new)
        else:
            # Face cells are computed; only out-of-cuboid positions and
            # matrices that would consume a symbol that does not exist are
            # walls.  A matrix t with consume vector (ca, cb, cc) cannot
            # live at a cell with i < ca, j < cb, or k < cc.
            inside = (i_grid >= 0) & (i_grid <= la)
            for t in range(NUM_MATRICES):
                ca, cb, cc = CONSUMES[t]
                ok = inside & (i_grid >= ca) & (j_grid >= cb) & (k_grid >= cc)
                new[t] = np.where(ok, new[t], NEG)

        planes[q % 4] = new

        if slab is not None and 0 <= capture_m <= la:
            on = i_grid == capture_m
            if on.any():
                jj, kk = np.nonzero(on)
                slab[:, jj, kk] = new[:, jj, kk]
        if cuboid is not None:
            sel = (i_grid >= 0) & (i_grid <= la)
            jj, kk = np.nonzero(sel)
            cuboid[:, i_grid[sel], jj, kk] = new[:, jj, kk]
        if q == qmax:
            final = new[:, lb, lc].copy()

    if final is None:
        final = planes[0, :, lb, lc].copy()
    return final, slab, cuboid


def backward_slab(
    a_suffix,
    b,
    c,
    scoring: Scoring = Scoring(),
    end_v: Optional[np.ndarray] = None,
):
    """G[s, j, k]: best suffix-path score from (m, j, k) in state s to the
    final cell, where a_suffix = A[m:].  end_v is the per-state terminal
    vector at the final cell (zeros for a free max-over-states end, one-hot
    0/NEG when the end state is pinned).
    """
    ra = np.asarray(a_suffix, dtype=np.int32)[::-1]
    rb = np.asarray(b, dtype=np.int32)[::-1]
    rc = np.asarray(c, dtype=np.int32)[::-1]
    la, lb, lc = len(ra), len(rb), len(rc)
    hb, wc = lb + 1, lc + 1
    w = scoring.weight_matrix().astype(np.int32)
    if end_v is None:
        end_v = np.zeros(NUM_MATRICES, dtype=np.int32)

    j_grid = np.arange(hb, dtype=np.int32)[:, None]
    k_grid = np.arange(wc, dtype=np.int32)[None, :]
    jk = j_grid + k_grid

    bj = np.full((hb, 1), -7, dtype=np.int32)
    bj[1:, 0] = rb
    ck = np.full((1, wc), -8, dtype=np.int32)
    ck[0, 1:] = rc

    planes = np.full((4, NUM_MATRICES, hb, wc), NEG, dtype=np.int32)
    planes[0, :, 0, 0] = end_v

    slab = np.full((NUM_MATRICES, hb, wc), NEG, dtype=np.int32)
    if la == 0:
        slab[:, 0, 0] = end_v

    qmax = la + lb + lc
    for q in range(1, qmax + 1):
        p1 = planes[(q - 1) % 4]
        p2 = planes[(q - 2) % 4] if q >= 2 else np.full_like(p1, NEG)
        p3 = planes[(q - 3) % 4] if q >= 3 else np.full_like(p1, NEG)

        i_grid = q - jk
        ai = ra[np.clip(i_grid - 1, 0, max(la - 1, 0))] if la else np.full((hb, wc), -9, np.int32)
        ai = np.where((i_grid >= 1) & (i_grid <= la), ai, -9)
        subs = _subs(scoring, ai, np.broadcast_to(bj, (hb, wc)), np.broadcast_to(ck, (hb, wc)))

        planes_by_delta = (None, p1, p2, p3)
        # E_u: value of the best suffix that *next* enters state u, seen
        # from the current (reversed) cell: the u-shifted previous plane's
        # u row plus u's substitution at the shifted-into cell, which in
        # reversed coordinates is evaluated right here.
        e = np.empty((NUM_MATRICES, hb, wc), dtype=np.int32)
        for u in range(NUM_MATRICES):
            du = OFFSETS[u]
            src = planes_by_delta[du[0] + du[1] + du[2]][u]
            e[u] = _shift_fill(src, du[1], du[2], NEG) + subs[u]

        new = np.empty((NUM_MATRICES, hb, wc), dtype=np.int32)
        for t in range(NUM_MATRICES):
            # max over next-state u of E_u + W[u, t]
            new[t] = np.maximum(np.max(e + w[:, t][:, None, None], axis=0), NEG)

        inside = (i_grid >= 0) & (i_grid <= la)
        new = np.where(inside[None], new, NEG)
        planes[q % 4] = new

        on = i_grid == la
        if on.any():
            jj, kk = np.nonzero(on)
            slab[:, jj, kk] = new[:, jj, kk]

    # slab is in reversed (j'', k''); flip back to original orientation:
    # G[s, j, k] = slab[s, lb - j, lc - k].
    return slab[:, ::-1, ::-1].copy()
