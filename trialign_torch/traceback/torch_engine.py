"""Whole-plane device twins of the traceback sweeps, in torch.

Port of ``trialign/traceback/xla_engine.py`` (``forward_sweep_xla_async``
:222, ``backward_slab_xla_async`` :365).  The math is the NumPy engine's
(traceback/engine.py: modes "free" / "free_jk" / "pin", NEG walls, per-state
capture slabs) as torch ops on ``device``, one (7, |B|+1, |C|+1) plane stack a
step.  The Hirschberg recursion routes slabs of 2 Mi to 256 Mi cells here
(hirschberg.XLA_CELLS), and on the card it is the second plain version of the
slab kernel K5.

Differences from the JAX twins, none of them in the values:

* no padded shape buckets: PyTorch runs eagerly, so there is no compiled
  program per shape to reuse;
* no ``SEG_STEPS`` segmentation: it bounded single executions on the TPU's
  remote worker, and an eager loop has no such execution;
* symbols are gathered per step as ``A[q - j - k]``: the Hankel shear was a
  TPU gather workaround.

Each function enqueues its sweep on ``device`` and returns a zero-arg fetch
closure, the reference's "async" contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from trialign_torch.config import CONSUMES, NUM_MATRICES, OFFSETS, Scoring
from trialign_torch.kernels.plane_math import (
    fused_plane_update_m7, target_update, transition_groups,
)
from trialign_torch.kernels.ref import pair_fn, substitution
from trialign_torch.traceback.engine import NEG

# The NumPy engine's symbol sentinels: B at j = 0, C at k = 0, A outside
# [1, |A|] (engine.forward_sweep); distinct, so no sentinel matches.
SENT_B, SENT_C, SENT_A = -7, -8, -9


def shift_fill(x: torch.Tensor, dj: int, dk: int, fill: int) -> torch.Tensor:
    """out[..., j, k] = x[..., j-dj, k-dk], ``fill`` outside."""
    if not dj and not dk:
        return x
    out = torch.full_like(x, fill)
    out[..., dj:, dk:] = x[..., : x.shape[-2] - dj, : x.shape[-1] - dk]
    return out


class _Grid:
    """Per-sweep constants on the device: the (j, k) grids and the symbol
    planes, with the engine's sentinels."""

    def __init__(self, a, b, c, scoring: Scoring, device):
        self.la, lb, lc = len(a), len(b), len(c)
        self.hb, self.wc = lb + 1, lc + 1
        dev = torch.device(device)
        self.j = torch.arange(self.hb, device=dev).view(self.hb, 1)
        self.k = torch.arange(self.wc, device=dev).view(1, self.wc)
        self.jk = self.j + self.k
        self.pair = pair_fn(scoring, dev)
        self.scoring = scoring
        self.b = torch.tensor([SENT_B, *b], dtype=torch.int32,
                              device=dev).view(self.hb, 1)
        self.c = torch.tensor([SENT_C, *c], dtype=torch.int32,
                              device=dev).view(1, self.wc)
        self.s_bc = self.pair(self.b, self.c)
        self.a = torch.tensor([SENT_A, *a, SENT_A], dtype=torch.int32,
                              device=dev)
        self.neg = torch.tensor(NEG, dtype=torch.int32, device=dev)
        self.zero = torch.tensor(0, dtype=torch.int32, device=dev)

    def subs(self, q: int):
        """(i plane, the 7 substitution planes) of plane q."""
        i = q - self.jk
        ai = self.a[i.clamp(0, self.la + 1)]
        return i, substitution(ai, self.b, self.c, self.s_bc, self.scoring,
                               self.pair)

    def mask(self, new: torch.Tensor, i: torch.Tensor, mode: str):
        """The engine's per-mode walls and borders on a new plane stack."""
        la, j, k = self.la, self.j, self.k
        if mode == "free":
            valid = (i >= 1) & (i <= la) & (j >= 1) & (k >= 1)
            return torch.where(valid, new, self.zero)
        if mode == "free_jk":
            new = torch.where((i >= 1) & (i <= la), new, self.neg)
            return torch.where((j == 0) | (k == 0), self.zero, new)
        inside = (i >= 0) & (i <= la)
        rows = [torch.where(inside & (i >= ca) & (j >= cb) & (k >= cc),
                            new[t], self.neg)
                for t, (ca, cb, cc) in enumerate(CONSUMES)]
        return torch.stack(rows)


def init_planes(g: _Grid, mode: str, v0):
    """(plane 0, the ring planes before it) of a forward sweep: the fill,
    free j = 0 / k = 0 faces for "free_jk", v0 at the origin of plane 0 for
    "pin"."""
    fill = 0 if mode == "free" else NEG
    ring = torch.full((NUM_MATRICES, g.hb, g.wc), fill, dtype=torch.int32,
                      device=g.j.device)
    if mode == "free_jk":
        ring[:, 0, :] = 0
        ring[:, :, 0] = 0
    p0 = ring.clone()
    if mode == "pin":
        p0[:, 0, 0] = torch.as_tensor(np.asarray(v0, np.int32),
                                      device=g.j.device)
    return p0, ring


def forward_sweep_torch_async(
    a, b, c, scoring: Scoring = Scoring(), mode: str = "free",
    v0: Optional[np.ndarray] = None, capture_m: Optional[int] = None,
    device="cuda",
):
    """Enqueue a forward sweep on ``device``; returns a zero-arg fetch
    producing (final (7,), slab (7, |B|+1, |C|+1) at i = capture_m or
    None), NumPy int32 -- engine.forward_sweep without the cuboid."""
    assert mode in ("free", "free_jk", "pin"), mode
    if mode == "pin":
        assert v0 is not None and len(v0) == NUM_MATRICES
    a, b, c = (np.asarray(x, dtype=np.int32) for x in (a, b, c))
    g = _Grid(a, b, c, scoring, device)
    fill = 0 if mode == "free" else NEG
    groups = transition_groups(scoring.weight_matrix())

    def shift1(x, axis):
        # Combine-then-shift is exact: every shifted-in cell is re-masked,
        # since each target's consume set covers its shift axes in every
        # mode (xla_engine.py notes).
        return shift_fill(x, 1 - axis, axis, fill)

    p0, ring = init_planes(g, mode, v0)
    m7ring = ring.max(0).values
    p1, p2, m7p2, m7p3 = p0, ring, m7ring, m7ring
    slab = None
    if capture_m is not None:
        slab = p0.clone() if capture_m == 0 else torch.full_like(p0, NEG)
    for q in range(1, len(a) + len(b) + len(c) + 1):
        i, subs = g.subs(q)
        cands, m7p1 = fused_plane_update_m7(p1, p2, m7p3, subs, groups,
                                            torch.maximum, shift1)
        new = g.mask(torch.maximum(torch.stack(cands), g.neg), i, mode)
        if capture_m is not None:
            slab = torch.where(i == capture_m, new, slab)
        p1, p2, m7p2, m7p3 = new, p1, m7p1, m7p2
    final = p1[:, len(b), len(c)]

    def fetch():
        return (final.cpu().numpy(),
                None if slab is None else slab.cpu().numpy())

    return fetch


def backward_slab_torch_async(
    a_suffix, b, c, scoring: Scoring = Scoring(),
    end_v: Optional[np.ndarray] = None, device="cuda",
):
    """Enqueue a backward sweep on ``device``; returns a zero-arg fetch
    producing G (7, |B|+1, |C|+1), engine.backward_slab's suffix slab."""
    ra, rb, rc = (np.asarray(x, dtype=np.int32)[::-1].copy()
                  for x in (a_suffix, b, c))
    g = _Grid(ra, rb, rc, scoring, device)
    w = scoring.weight_matrix()
    groups_t = transition_groups(np.ascontiguousarray(w.T))
    ev = torch.as_tensor(
        np.zeros(NUM_MATRICES, np.int32) if end_v is None
        else np.asarray(end_v, np.int32), device=g.j.device)
    ring = torch.full((NUM_MATRICES, g.hb, g.wc), NEG, dtype=torch.int32,
                      device=g.j.device)
    p0 = ring.clone()
    p0[:, 0, 0] = ev
    slab = p0.clone() if g.la == 0 else ring.clone()
    p1, p2, p3 = p0, ring, ring
    for q in range(1, len(ra) + len(rb) + len(rc) + 1):
        i, subs = g.subs(q)
        planes = (None, p1, p2, p3)
        # E_u: the best suffix that next enters state u, seen from this
        # (reversed) cell: the u-shifted plane's row u plus u's
        # substitution here (engine.backward_slab).
        e = []
        for u, (du_i, du_j, du_k) in enumerate(OFFSETS):
            src = planes[du_i + du_j + du_k][u]
            e.append(shift_fill(src, du_j, du_k, NEG) + subs[u])
        new = torch.stack([torch.maximum(
            target_update(e, groups_t[t], torch.maximum), g.neg)
            for t in range(NUM_MATRICES)])
        new = torch.where((i >= 0) & (i <= g.la), new, g.neg)
        slab = torch.where(i == g.la, new, slab)
        p1, p2, p3 = new, p1, p2

    def fetch():
        return slab.flip(1, 2).cpu().numpy()

    return fetch
