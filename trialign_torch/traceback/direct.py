"""The direct traceback engine: one choice-capture sweep and one walk.

Port of ``trialign/traceback/direct.py``.  Below the Hirschberg cap
(hirschberg.DIRECT_CELLS) a subproblem needs no recursion:

* :func:`choices` sweeps the cuboid plane by plane and records, per cell and
  per matrix, WHICH source matrix achieved the max: 7 matrices x 3 bits = 21
  bits, packed into an int16 entry (matrices 0-4, bits 0-14) and a uint8
  entry (matrices 5-6, bits 15-20 shifted down), 3 B a cell, in
  (|A|+|B|+|C|, (|B|+1)(|C|+1)) buffers from ``torch.empty``: row q - 1 holds
  plane q, whose (j, k) entry is cell (i = q-j-k, j, k).  Only cuboid slots
  (0 <= i <= |A|) are written, 9.7 GB at 1024^3.  On a CUDA device it is one
  persistent launch of the choice-capture kernel (``kernels/slab.py``
  ``choice_sweep``: ``csrc/slab.cu`` ``choices_persistent``, a whole-grid
  sweep on a plane ring in shared memory, step ``cell_step_choices``), the
  port of the JAX package's
  ``_choices_seg`` (XLA: a jitted ``lax.scan`` a segment of planes, not a
  ``pallas_call``).  On the CPU it is its plain version :func:`_choices`, a
  torch sweep a plane at a time.
* :func:`walk` chases the pointers from the final cell and emits the
  consuming-matrix index of each alignment column, newest first: on a CUDA
  device one thread of ``csrc/walk.cu`` (the port of ``_walk_device``, an
  XLA ``while_loop``) into a small buffer that the host copies once; on the
  CPU its plain version :func:`walk_ref`, the same loop in torch operations,
  which the tests hold the kernel and the JAX engine's walk against.

Every argmax breaks ties to the lowest source index, as ``jnp.argmax`` and
``torch.max`` do.  A field whose target has no predecessor in the cuboid (j <
dj or k < dk, ``plane_math.SHIFTS``) is 0 here; the JAX engine writes the
argmax of its fill values there.  The walk never reads such a field, so the
alignments agree (``tests/test_torch_direct_choices.py`` pins both).  The JAX
engine pads shapes to buckets for its compile cache; this one sweeps the exact
shapes, and keeps the bucketed ``direct_shapes`` / ``direct_memory_bytes`` as
the footprint model that routes a problem (an overestimate here), so that
every size takes the JAX package's route.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from trialign_torch import _build
from trialign_torch.config import NUM_MATRICES, OFFSETS, Scoring
from trialign_torch.kernels import slab as sk
from trialign_torch.kernels.plane_math import PLANE_DELTA, SHIFTS
from trialign_torch.metrics import span
from trialign_torch.traceback.engine import NEG
from trialign_torch.traceback.torch_engine import _Grid, init_planes

MODES = sk.CHOICE_MODES

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
    """Plain torch version of the choice kernel, any device: (final (7,)
    int32, packed_lo (qmax, hb*wc) int16, packed_hi (qmax, hb*wc) uint8),
    qmax = |A|+|B|+|C|, hb = |B|+1, wc = |C|+1; row q-1 holds plane q.
    Every entry of a plane is written, the cuboid's slots and the rest."""
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


def choices(a, b, c, scoring: Scoring, mode: str, v0, device):
    """The choice-capture sweep on ``device``: (final (7,), packed_lo,
    packed_hi) as :func:`_choices` gives them, equal on every cuboid slot
    (0 <= q-j-k <= |A|); the other entries are left as ``torch.empty`` gave
    them.  On a CPU device this is :func:`_choices`; on a CUDA device the
    choice kernel, ``kernels/slab.choice_sweep`` (one persistent launch,
    counted on ``choice_sweep.launches``, which raises if it is refused and
    never falls back).  ``mode`` "free" / "free_jk" / "pin" (the origin
    holds ``v0``, which the other modes ignore)."""
    dev = torch.device(device)
    if mode not in MODES or (mode == "pin" and v0 is None):
        raise ValueError(f"mode must be one of {MODES}, 'pin' with v0, not "
                         f"{mode!r}")
    if dev.type == "cpu":
        return _choices(a, b, c, scoring, mode, v0, dev)
    if dev.type != "cuda":
        raise ValueError(f"no choice kernel for device {dev}")
    a, b, c = (np.asarray(x, dtype=np.int32) for x in (a, b, c))
    la, lb, lc = len(a), len(b), len(c)
    if la + lb + lc < 1:
        raise ValueError("the choice kernel needs at least one symbol")
    with span("choices.pack"):
        dims = sk._plan(la, lb, lc)
        ev = np.asarray(v0, np.int32) if mode == "pin" else \
            np.zeros(NUM_MATRICES, np.int32)
        shape = (la + lb + lc, (lb + 1) * (lc + 1))
        packed_lo = torch.empty(shape, dtype=torch.int16, device=dev)
        packed_hi = torch.empty(shape, dtype=torch.uint8, device=dev)
        arrs = sk.prep_blocked(a, b, c, dims, dev)
    final = sk.choice_sweep(*arrs, la, lb, lc, dims, mode, ev, scoring,
                            packed_lo, packed_hi)
    return final, packed_lo, packed_hi


def cuboid_slots(la: int, lb: int, lc: int, q0: int = 0,
                 q1: Optional[int] = None, device="cpu") -> torch.Tensor:
    """Which entries of rows q0 .. q1 - 1 (planes q0 + 1 .. q1) of the packed
    buffers hold a cell of the cuboid, 0 <= q-j-k <= |A|: a bool tensor of
    (q1 - q0, (|B|+1)(|C|+1)), the entries :func:`choices` writes."""
    q1 = la + lb + lc if q1 is None else q1
    dev = torch.device(device)
    q = torch.arange(q0 + 1, q1 + 1, dtype=torch.int32, device=dev)
    jk = (torch.arange(lb + 1, dtype=torch.int32, device=dev).view(-1, 1)
          + torch.arange(lc + 1, dtype=torch.int32, device=dev)).view(1, -1)
    i = q.view(-1, 1) - jk
    return (i >= 0) & (i <= la)


def walk_ref(packed_lo, packed_hi, t0: int, la: int, lb: int, lc: int,
             mode: str) -> torch.Tensor:
    """Plain torch version of the walk kernel, on the buffers' device, with
    ``_walk_device``'s semantics: a (4 + |A|+|B|+|C|,) int32 tensor whose
    entry 0 is the count n of steps, entries 1-3 the (i, j, k) the walk
    stopped at and entries 4 .. 3 + n the states, newest first (-1 past
    them)."""
    dev = packed_lo.device
    i64 = dict(dtype=torch.int64, device=dev)
    offs = torch.tensor(OFFSETS, **i64)
    res = torch.full((4 + la + lb + lc,), -1, dtype=torch.int32, device=dev)
    i, j, k, t = (torch.tensor(v, **i64) for v in (la, lb, lc, t0))
    n = 0
    while bool((i > 0) & (j > 0) & (k > 0) if mode != "pin"
               else (i > 0) | (j > 0) | (k > 0)):
        q, pos = i + j + k, j * (lc + 1) + k
        lo = packed_lo[q - 1, pos].to(torch.int64)
        hi = packed_hi[q - 1, pos].to(torch.int64)
        word = torch.where(t < 5, lo, hi)
        s = (word >> torch.where(t < 5, 3 * t, 3 * t - 15)) & 7
        res[4 + n] = t
        i, j, k = i - offs[t, 0], j - offs[t, 1], k - offs[t, 2]
        t, n = s, n + 1
    res[0] = n
    res[1:4] = torch.stack([i, j, k])
    return res


def walk(packed_lo, packed_hi, t0: int, la: int, lb: int, lc: int,
         mode: str) -> torch.Tensor:
    """The pointer chase from (|A|, |B|, |C|) in state ``t0`` over the
    buffers of :func:`choices`, on their device: the result of
    :func:`walk_ref` (entries past the last state unspecified; a count of -1
    if a choice was no state or the walk left the cuboid).  On a CPU device
    this is :func:`walk_ref`; on a CUDA device one launch of the walk kernel
    (``csrc/walk.cu``, one thread), counted on ``walk.launches``, which
    raises if it is refused and never falls back.  "free" and "free_jk"
    stop at the first border, "pin" at the origin."""
    dev = packed_lo.device
    shape = (la + lb + lc, (lb + 1) * (lc + 1))
    if mode not in MODES or not 0 <= t0 < NUM_MATRICES or \
            packed_lo.dtype != torch.int16 or \
            packed_hi.dtype != torch.uint8 or packed_lo.shape != shape or \
            packed_hi.shape != shape or packed_hi.device != dev or \
            not packed_lo.is_contiguous() or not packed_hi.is_contiguous():
        raise ValueError("walk takes the packed buffers of choices() for "
                         f"|A|, |B|, |C| = {la}, {lb}, {lc}, a state in "
                         f"0..6 and a mode of {MODES}")
    if dev.type == "cpu":
        return walk_ref(packed_lo, packed_hi, t0, la, lb, lc, mode)
    if dev.type != "cuda":
        raise ValueError(f"no walk kernel for device {dev}")
    res = torch.empty(4 + la + lb + lc, dtype=torch.int32, device=dev)
    lib = _build.load("walk")
    with torch.cuda.device(dev), span("walk.launch"):
        code = lib.trialign_walk(
            packed_lo.data_ptr(), packed_hi.data_ptr(), la, lb, lc, t0,
            int(mode == "pin"), res.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, code, "walk kernel launch")
        walk.launches += 1
    return res


# Launches of the walk kernel since the count was last set to 0 (the choice
# kernel counts on kernels/slab.choice_sweep.launches).
walk.launches = 0


def direct_traceback(
    a, b, c, scoring: Scoring = Scoring(), mode: str = "free",
    v0: Optional[np.ndarray] = None, end_state: Optional[int] = None,
    device="cuda",
) -> Tuple[int, List[Tuple[int, int, int]]]:
    """(score, columns) via the direct engine on ``device``: :func:`choices`
    and :func:`walk`, one launch each on a CUDA device.

    Columns (a_code|-1, b_code|-1, c_code|-1) oldest-first; semantics
    identical to hirschberg's cuboid walk, including the free-mode border
    stop and the unscored leading context."""
    a, b, c = (np.asarray(x, dtype=np.int32) for x in (a, b, c))
    la, lb, lc = len(a), len(b), len(c)
    final, packed_lo, packed_hi = choices(a, b, c, scoring, mode, v0,
                                          device)
    with span("wait"):
        final = final.cpu().numpy()
    t0 = int(end_state) if end_state is not None else int(np.argmax(final))
    score = int(final[t0])
    res = walk(packed_lo, packed_hi, t0, la, lb, lc, mode)
    with span("wait"):
        res = res.cpu().numpy()
    del packed_lo, packed_hi
    n = int(res[0])
    if n < 0:
        raise RuntimeError("the direct engine's walk read a choice that is "
                           "no state, or left the cuboid")
    acts, (i, j, k) = res[4:4 + n], (int(v) for v in res[1:4])

    # Replay the walk's coordinates to emit columns (newest-first), then
    # the unscored leading context for free modes.
    cols: List[Tuple[int, int, int]] = []
    ii, jj, kk = la, lb, lc
    for t in acts:
        di, dj, dk = OFFSETS[int(t)]
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
