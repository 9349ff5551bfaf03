"""Hirschberg-style divide-and-conquer alignment recovery.

Port of ``trialign/traceback/hirschberg.py``: full three-way alignments in
O(n^2) memory instead of an O(n^3) action cuboid.  Split on the middle
A-plane i = m: F[s, j, k] is the best prefix-path score ending at (m, j, k) in
state s (forward sweep, honoring the subproblem's start mode); G[s, j, k] the
best suffix-path score from there to the end (backward sweep).  max(F + G)
over (s, j, k) recovers the optimal crossing, whose state is pinned into both
half problems; the recursion bottoms out in a small cuboid DP with an
explicit argmax walk, or in the direct engine (traceback/direct.py).

Every size takes the JAX package's route: the routing constants keep its
values (tests and callers may set the module attributes; the environment
variables of the reference are read as it reads them).  On a CUDA device the
slabs of the biggest nodes run on the slab kernel K5 (kernels/slab.py), the
2 Mi-256 Mi cell slabs on the torch engine, smaller ones on the NumPy
engine.  Every function takes the device explicitly.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from trialign_torch.config import CONSUMES, NUM_MATRICES, OFFSETS, Scoring
from trialign_torch.traceback.engine import NEG, backward_slab, forward_sweep

# Base-case cuboid cell budget (7 matrices x 4 B each: ~29 MB at the cap).
BASE_CELLS = 1 << 20

# Above this many cells, slab sweeps run on the device through the torch
# engine (traceback/torch_engine.py); below, the NumPy engine.  The
# reference's value (its crossover on the v5e); not re-measured here.
XLA_CELLS = 1 << 21

# Between BASE_CELLS and this cap, subproblems go to the direct engine
# (traceback/direct.py): one choice-capture sweep and one walk instead of
# recursing.  Paired with the byte gate _direct_fits.  The reference's value;
# re-tuning it for an 80 GB card is a measured later change.  Override with
# TRIALIGN_DIRECT_CELLS.
DIRECT_CELLS = int(os.environ.get("TRIALIGN_DIRECT_CELLS", 1400 * 2**20))

# Below this many cells a failure to allocate the direct engine's buffers
# is a real bug, not a capacity miss: the out-of-memory fallback in _solve
# re-raises instead of splitting.
_DIRECT_SAFE_CELLS = 192 * 2**20

# Fraction of the device budget the direct engine may plan to use; the rest
# absorbs allocator fragmentation and resident tensors the model cannot see.
_DIRECT_FIT_FRACTION = 0.90

# Above this many cells, slab sweeps on a CUDA device run on the slab kernel
# K5 (kernels/slab.py) instead of the torch engine: only the splits above the
# direct engine's cap sweep at this size (2k^3 and up), pin-mode nodes
# included.  The reference's SLAB_PALLAS_CELLS; override with
# TRIALIGN_SLAB_KERNEL_CELLS.  TRIALIGN_SLAB_FORCE=1 routes every eligible
# sweep there, on any device (tests; the CPU runs the kernel's plain version).
SLAB_KERNEL_CELLS = int(
    os.environ.get("TRIALIGN_SLAB_KERNEL_CELLS", 256 * 2**20)
)

Column = Tuple[int, int, int]


def _direct_fits(la: int, lb: int, lc: int, device) -> bool:
    """Proactive byte gate: route to the split when the direct engine's
    modelled footprint would not fit the device."""
    from trialign_torch.traceback import direct

    return direct.direct_memory_bytes(la, lb, lc) <= (
        _DIRECT_FIT_FRACTION * direct.device_memory_budget(device)
    )


def _is_oom(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _use_slab_kernel(la: int, lb: int, lc: int, scoring: Scoring,
                     device) -> bool:
    """The reference's _use_pallas_slab, with "the device is CUDA" for "the
    backend is a TPU".  K5 takes every scoring Scoring accepts, submatrices
    of up to 16 symbols included."""
    if min(la, lb, lc) < 1:
        return False
    if os.environ.get("TRIALIGN_SLAB_FORCE") == "1":
        return True
    if (la + 1) * (lb + 1) * (lc + 1) < SLAB_KERNEL_CELLS:
        return False
    return torch.device(device).type == "cuda"


def _fwd_slab_async(a, b, c, scoring, mode, v0, capture_m, device):
    """forward_sweep dispatch by size; returns a zero-arg fetch function, so
    that a node's sweeps are all enqueued before any result is pulled."""
    if (
        mode in ("free", "free_jk")
        and v0 is None
        and (capture_m is None or capture_m == len(a))
        and _use_slab_kernel(len(a), len(b), len(c), scoring, device)
    ):
        from trialign_torch.kernels.slab import forward_slab_blocked_async

        return forward_slab_blocked_async(
            a, b, c, scoring, mode=mode, want_slab=capture_m is not None,
            device=device,
        )
    if (len(a) + 1) * (len(b) + 1) * (len(c) + 1) >= XLA_CELLS:
        from trialign_torch.traceback.torch_engine import (
            forward_sweep_torch_async,
        )

        return forward_sweep_torch_async(
            a, b, c, scoring, mode=mode, v0=v0, capture_m=capture_m,
            device=device,
        )
    final, slab, _ = forward_sweep(
        a, b, c, scoring, mode=mode, v0=v0, capture_m=capture_m
    )
    return lambda: (final, slab)


def _bwd_slab_async(a_suffix, b, c, scoring, end_v, device):
    # K5 never runs here: a node that passes the slab-kernel gate sweeps
    # through split_point_blocked_async, and a half of a node that failed
    # the gate fails it too.
    if (len(a_suffix) + 1) * (len(b) + 1) * (len(c) + 1) >= XLA_CELLS:
        from trialign_torch.traceback.torch_engine import (
            backward_slab_torch_async,
        )

        return backward_slab_torch_async(a_suffix, b, c, scoring,
                                         end_v=end_v, device=device)
    slab = backward_slab(a_suffix, b, c, scoring, end_v=end_v)
    return lambda: slab


def _sub_at(scoring: Scoring, t: int, a, b, c, i: int, j: int, k: int) -> int:
    ca, cb, cc = CONSUMES[t]
    if ca and cb and cc:
        return int(scoring.triple_score(a[i - 1], b[j - 1], c[k - 1]))
    if ca and cb:
        return int(scoring.pair_score(a[i - 1], b[j - 1]))
    if cb and cc:
        return int(scoring.pair_score(b[j - 1], c[k - 1]))
    if ca and cc:
        return int(scoring.pair_score(a[i - 1], c[k - 1]))
    return 0


def _context(a, b, c, i: int, j: int, k: int) -> List[Column]:
    """The unscored leading columns from (i, j, k) back to the origin,
    newest-first, as the free borders emit them."""
    cols = []
    while i > 0 or j > 0 or k > 0:
        cols.append((int(a[i - 1]) if i > 0 else -1,
                     int(b[j - 1]) if j > 0 else -1,
                     int(c[k - 1]) if k > 0 else -1))
        i, j, k = max(i - 1, 0), max(j - 1, 0), max(k - 1, 0)
    return cols


def _walk(
    d: np.ndarray, a, b, c, scoring: Scoring, mode: str,
    end_state: Optional[int],
) -> Tuple[int, List[Column]]:
    """Argmax walk over a full cuboid; returns (score, columns oldest-first)."""
    w = scoring.weight_matrix().astype(np.int64)
    la, lb, lc = len(a), len(b), len(c)
    i, j, k = la, lb, lc
    t = int(np.argmax(d[:, i, j, k])) if end_state is None else end_state
    score = int(d[t, i, j, k])
    cols: List[Column] = []

    freeish = mode != "pin"
    while (i, j, k) != (0, 0, 0):
        if freeish and (i == 0 or j == 0 or k == 0):
            break
        di, dj, dk = OFFSETS[t]
        target = int(d[t, i, j, k]) - _sub_at(scoring, t, a, b, c, i, j, k)
        pi, pj, pk = i - di, j - dj, k - dk
        pred = d[:, pi, pj, pk].astype(np.int64) + w[t]
        hits = np.flatnonzero(pred == target)
        assert hits.size, (i, j, k, t, target, d[:, pi, pj, pk], w[t])
        cols.append((int(a[i - 1]) if di else -1,
                     int(b[j - 1]) if dj else -1,
                     int(c[k - 1]) if dk else -1))
        i, j, k = pi, pj, pk
        if freeish and (i == 0 or j == 0 or k == 0):
            break
        t = int(hits[0])

    if freeish:
        cols += _context(a, b, c, i, j, k)
    cols.reverse()
    return score, cols


def _solve(
    a, b, c, scoring: Scoring, mode: str, s0: Optional[int],
    end_state: Optional[int], device,
) -> Tuple[int, List[Column]]:
    if os.environ.get("TRIALIGN_TB_TRACE") == "1":
        # Per-node wall-clock attribution: prints mode, shape, route and
        # seconds on exit.
        import time

        t0 = time.perf_counter()
        route = ["?"]
        try:
            return _solve_traced(a, b, c, scoring, mode, s0, end_state,
                                 device, route)
        finally:
            print(
                f"[tb-trace] ({len(a)},{len(b)},{len(c)}) mode={mode} "
                f"route={route[0]} {time.perf_counter() - t0:.2f}s",
                file=sys.stderr, flush=True,
            )
    return _solve_traced(a, b, c, scoring, mode, s0, end_state, device,
                         None)


def _onehot(state: Optional[int], rest: int) -> np.ndarray:
    """A per-state vector: 0 at ``state``, ``rest`` elsewhere (all 0 when
    ``state`` is None)."""
    v = np.full(NUM_MATRICES, rest if state is not None else 0, np.int32)
    if state is not None:
        v[state] = 0
    return v


def _solve_traced(
    a, b, c, scoring, mode, s0, end_state, device, route
) -> Tuple[int, List[Column]]:
    la, lb, lc = len(a), len(b), len(c)
    cells = (la + 1) * (lb + 1) * (lc + 1)
    freeish = mode != "pin"
    v0 = _onehot(s0, NEG) if mode == "pin" else None

    if la <= 1 or cells <= BASE_CELLS:
        _, _, cuboid = forward_sweep(
            a, b, c, scoring, mode=mode, v0=v0, return_cuboid=True
        )
        if route is not None:
            route[0] = "walk"
        return _walk(cuboid, a, b, c, scoring, mode, end_state)

    if cells <= DIRECT_CELLS and _direct_fits(la, lb, lc, device):
        # One choice-capture sweep and one walk, no recursion below this
        # point.  _direct_fits models the footprint and routes oversize
        # problems to the split; the catch is a backstop for model misses.
        from trialign_torch.traceback import direct

        try:
            if route is not None:
                route[0] = "direct"
            return direct.direct_traceback(a, b, c, scoring, mode, v0,
                                           end_state, device)
        except Exception as e:  # noqa: BLE001
            if cells <= _DIRECT_SAFE_CELLS or not _is_oom(e):
                raise
            # The buffers did not fit: recurse (each half's buffers are
            # half the size).

    m = la // 2
    end_v = _onehot(end_state, NEG)
    # Enqueue every sweep this node needs before fetching any result.
    if _use_slab_kernel(la, lb, lc, scoring, device):
        # Slab kernel sweeps with the F + G argmax on the device: only the
        # crossing's coordinates come back to the host.
        from trialign_torch.kernels.slab import split_point_blocked_async

        sp_fetch = split_point_blocked_async(
            a, b, c, m, scoring, mode=mode, end_v=end_v, v0=v0, device=device,
        )
        h_fetch = (
            _fwd_slab_async(a[m:], b, c, scoring, "free_jk", None, None,
                            device)
            if freeish else None
        )
        sstar, jstar, kstar, score = sp_fetch()
        h_final = h_fetch()[0] if freeish else None
    else:
        f_fetch = _fwd_slab_async(a[:m], b, c, scoring, mode, v0, m, device)
        g_fetch = _bwd_slab_async(a[m:], b, c, scoring, end_v, device)
        h_fetch = (
            _fwd_slab_async(a[m:], b, c, scoring, "free_jk", None, None,
                            device)
            if freeish else None
        )
        _, f_slab = f_fetch()
        g_slab = g_fetch()
        total = f_slab.astype(np.int64) + g_slab.astype(np.int64)
        flat = int(np.argmax(total))
        sstar, jstar, kstar = (int(x) for x in
                               np.unravel_index(flat, total.shape))
        score = int(total[sstar, jstar, kstar])
        h_final = h_fetch()[0] if freeish else None

    # Free j/k borders admit paths that start at i0 > m on a border face and
    # never cross the i = m slab by real DP steps.  Those live entirely in
    # the right half, whose own i = 0 face is NOT a border (it is the
    # interior plane i = m of this problem): hence free_jk.
    if h_final is not None:
        h_val = (int(h_final[end_state]) if end_state is not None
                 else int(h_final.max()))
        if h_val > score:
            r_score, r_cols = _solve(a[m:], b, c, scoring, "free_jk", None,
                                     end_state, device)
            if route is not None:
                route[0] = "restart-right"
            return r_score, [(int(a[i]), -1, -1) for i in range(m)] + r_cols

    # The two half problems are independent.  The reference solves them on
    # two threads; here they run one after the other: the engines below
    # spend half or more of their time in the host's op dispatch, which two
    # threads share, and on the card two threads measured slower than one
    # (PERF.md, PR 2).
    left_score, left_cols = _solve(a[:m], b[:jstar], c[:kstar], scoring,
                                   mode, s0, sstar, device)
    right_score, right_cols = _solve(a[m:], b[jstar:], c[kstar:], scoring,
                                     "pin", sstar, end_state, device)
    assert left_score + right_score == score, (left_score, right_score, score)
    if route is not None:
        route[0] = "split"
    return score, left_cols + right_cols


def hirschberg_align(
    a, b, c, scoring: Scoring = Scoring(), device="cuda"
) -> Tuple[int, List[List[int]]]:
    """Optimal score plus one optimal alignment (3 rows of codes, -1 = gap),
    with the device sweeps on ``device``.

    Semantics match the golden model's traceback: zero-border free start,
    max-over-states end at (|A|, |B|, |C|)."""
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    if min(len(a), len(b), len(c)) == 0:
        # The final cell sits on a zero border: score 0, all context.
        cols = _context(a, b, c, len(a), len(b), len(c))
        cols.reverse()
        rows = [list(r) for r in zip(*cols)] if cols else [[], [], []]
        return 0, rows
    score, cols = _solve(a, b, c, scoring, "free", None, None,
                         torch.device(device))
    return score, [list(r) for r in zip(*cols)]


# Action codes: the consuming-matrix index of each alignment column (the
# canonical matrix index 0..6 of config.MATRIX_NAMES).
def alignment_actions(rows: List[List[int]]) -> List[int]:
    """Map alignment columns to matrix indices (0=M .. 6=Ixz): the consume
    pattern of a column (which sequences place a symbol, which gap)
    identifies the DP matrix that produced it (config.CONSUMES)."""
    consume_to_t = {tuple(cv): t for t, cv in enumerate(CONSUMES)}
    acts = []
    for col in zip(*rows):
        pattern = tuple(int(v != -1) for v in col)
        if pattern == (0, 0, 0):
            raise ValueError("alignment column with all gaps")
        acts.append(consume_to_t[pattern])
    return acts
