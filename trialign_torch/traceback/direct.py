"""Direct device-resident traceback: one choice-capture sweep and one walk.

Port of ``trialign/traceback/direct.py``.  Below the Hirschberg cap
(hirschberg.DIRECT_CELLS) a subproblem needs no recursion:

* a plane sweep on ``device`` records, per cell and per matrix, WHICH source
  matrix achieved the max: 7 matrices x 3 bits = 21 bits, packed into an
  int16 plane (matrices 0-4, bits 0-14) and a uint8 plane (matrices 5-6,
  bits 15-20 shifted down), 3 B a cell, in (q, (|B|+1)(|C|+1)) buffers (plane
  q at (j, k) holds cell (i = q-j-k, j, k));
* a pointer chase from the final cell over the packed buffers emits the
  consuming-matrix index of each alignment column.

The buffers are allocated once with ``torch.empty`` and filled plane by plane
in place: the JAX engine donated them to its scan instead.  On the card the
1024^3 buffers take about 10 GB.  The JAX engine pads shapes to buckets for
its compile cache; this one sweeps the exact shapes, and keeps the bucketed
``direct_shapes`` / ``direct_memory_bytes`` as the footprint model that
routes a problem (an overestimate here), so that every size takes the JAX
package's route.  The walk reads one packed entry a step from the host,
where the JAX engine ran a device while-loop: a path has at most
|A| + |B| + |C| steps.  This engine is XLA in the JAX package, not Pallas;
a CUDA choice-capture kernel is later speed work.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from trialign_torch.config import NUM_MATRICES, OFFSETS, Scoring
from trialign_torch.kernels.plane_math import PLANE_DELTA, SHIFTS
from trialign_torch.traceback.engine import NEG
from trialign_torch.traceback.torch_engine import _Grid, init_planes

# The JAX engine's shape ladder: the footprint model below uses it.
_LADDER = (16, 32, 64, 96, 128, 192, 256, 320, 384, 448, 512, 520, 576,
           640, 768, 896, 1024, 1040, 1152, 1280, 1536, 2048, 3072, 4096)


def _bucket(x: int) -> int:
    for v in _LADDER:
        if x <= v:
            return v
    return ((x + 1023) // 1024) * 1024


def direct_shapes(la: int, lb: int, lc: int) -> Tuple[int, int, int]:
    """(qq, hb, wc) of the JAX engine for this problem (the footprint
    model's shapes)."""
    hb, wc = _bucket(lb + 1), _bucket(lc + 1)
    lap = _bucket(max(la, 1))
    return lap + hb + wc, hb, wc


def direct_memory_bytes(la: int, lb: int, lc: int) -> int:
    """Device-memory footprint model for one direct_traceback call (the JAX
    package's, kept so that the routing gate is the same): the packed-choice
    buffers (3 B a plane slot), the carried planes, per-step temporaries,
    the symbol array and fixed headroom.  It overestimates this engine,
    which sweeps unpadded shapes."""
    qq, hb, wc = direct_shapes(la, lb, lc)
    plane = hb * wc
    packed = qq * plane * 3                    # int16 + uint8 buffers
    carry = 4 * NUM_MATRICES * plane * 4       # p1/p2/p3 + new (int32)
    temps = 3 * NUM_MATRICES * plane * 4       # shifted preds/terms/subs
    askew = 2 * (qq + hb + wc + 2) * wc * 4    # symbol staging
    return packed + carry + temps + askew + (192 << 20)


def device_memory_budget(device="cuda") -> int:
    """Usable device-memory bound for one process, in bytes: the card's
    total memory (``torch.cuda.mem_get_info``) on a CUDA device, effectively
    unlimited on the CPU, where hirschberg.DIRECT_CELLS is the gate."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return 1 << 62


def _choices(a, b, c, scoring: Scoring, mode: str, v0, device):
    """The choice-capture sweep: (final (7,), packed_lo (qmax, hb*wc) int16,
    packed_hi (qmax, hb*wc) uint8) on ``device``; row q-1 holds plane q."""
    g = _Grid(a, b, c, scoring, device)
    la, hb, wc = g.la, g.hb, g.wc
    qmax = la + len(b) + len(c)
    dev = g.j.device
    fill = 0 if mode == "free" else NEG
    w = torch.as_tensor(scoring.weight_matrix(), device=dev).view(
        NUM_MATRICES, NUM_MATRICES, 1, 1)
    packed_lo = torch.empty((qmax, hb * wc), dtype=torch.int16, device=dev)
    packed_hi = torch.empty((qmax, hb * wc), dtype=torch.uint8, device=dev)
    p0, ring = init_planes(g, mode, v0)
    p1, p2, p3 = p0, ring, ring
    final = p0[:, len(b), len(c)]
    for q in range(1, qmax + 1):
        i, subs = g.subs(q)
        planes = (None, p1, p2, p3)
        new = torch.full((NUM_MATRICES, hb, wc), fill, dtype=torch.int32,
                         device=dev)
        packed = torch.zeros((hb, wc), dtype=torch.int32, device=dev)
        for t in range(NUM_MATRICES):
            # Positions outside [dj:, dk:] have no predecessor; every mode
            # masks them for this target, and the walk never reads them.
            dj, dk = SHIFTS[t]
            pred = planes[PLANE_DELTA[t]][:, : hb - dj, : wc - dk]
            val, choice = (pred + w[t]).max(0)
            s = subs[t]
            new[t, dj:, dk:] = val if isinstance(s, int) else \
                val + s[dj:, dk:]
            packed[dj:, dk:] |= choice.to(torch.int32) << (3 * t)
        new = g.mask(torch.maximum(new, g.neg), i, mode)
        packed_lo[q - 1] = (packed & 0x7FFF).to(torch.int16).view(-1)
        packed_hi[q - 1] = (packed >> 15).to(torch.uint8).view(-1)
        p1, p2, p3 = new, p1, p2
        if q == qmax:
            final = new[:, len(b), len(c)]
    return final, packed_lo, packed_hi


def _walk(packed_lo, packed_hi, t0: int, la: int, lb: int, lc: int, wc: int,
          mode: str):
    """Pointer chase from (la, lb, lc) in state t0.  Returns (actions
    newest-first, the (i, j, k) the walk stopped at): free modes stop at the
    first border, "pin" at the origin."""
    freeish = mode != "pin"
    i, j, k, t = la, lb, lc, t0
    acts = []
    while (i > 0 and j > 0 and k > 0) if freeish else (i > 0 or j > 0
                                                        or k > 0):
        q, pos = i + j + k, j * wc + k
        if t < 5:
            s = (int(packed_lo[q - 1, pos]) >> (3 * t)) & 7
        else:
            s = (int(packed_hi[q - 1, pos]) >> (3 * t - 15)) & 7
        acts.append(t)
        di, dj, dk = OFFSETS[t]
        i, j, k, t = i - di, j - dj, k - dk, s
    return acts, (i, j, k)


def direct_traceback(
    a, b, c, scoring: Scoring = Scoring(), mode: str = "free",
    v0: Optional[np.ndarray] = None, end_state: Optional[int] = None,
    device="cuda",
) -> Tuple[int, List[Tuple[int, int, int]]]:
    """(score, columns) via the direct engine on ``device``.

    Columns (a_code|-1, b_code|-1, c_code|-1) oldest-first; semantics
    identical to hirschberg's cuboid walk, including the free-mode border
    stop and the unscored leading context."""
    a, b, c = (np.asarray(x, dtype=np.int32) for x in (a, b, c))
    la, lb, lc = len(a), len(b), len(c)
    final, packed_lo, packed_hi = _choices(a, b, c, scoring, mode, v0,
                                           device)
    final = final.cpu().numpy()
    t0 = int(end_state) if end_state is not None else int(np.argmax(final))
    score = int(final[t0])
    acts, (i, j, k) = _walk(packed_lo, packed_hi, t0, la, lb, lc, lc + 1,
                            mode)
    del packed_lo, packed_hi

    # Replay the walk's coordinates to emit columns (newest-first), then
    # the unscored leading context for free modes.
    cols: List[Tuple[int, int, int]] = []
    ii, jj, kk = la, lb, lc
    for t in acts:
        di, dj, dk = OFFSETS[t]
        cols.append((int(a[ii - 1]) if di else -1,
                     int(b[jj - 1]) if dj else -1,
                     int(c[kk - 1]) if dk else -1))
        ii, jj, kk = ii - di, jj - dj, kk - dk
    assert (ii, jj, kk) == (i, j, k)
    if mode != "pin":
        while i > 0 or j > 0 or k > 0:
            cols.append((int(a[i - 1]) if i > 0 else -1,
                         int(b[j - 1]) if j > 0 else -1,
                         int(c[k - 1]) if k > 0 else -1))
            i, j, k = max(i - 1, 0), max(j - 1, 0), max(k - 1, 0)
    cols.reverse()
    return score, cols
