"""Shared plane-update math for the wavefront sweep.

The port's own copy of the host algebra it uses from
``trialign/kernels/plane_math.py`` (same names, same semantics), with the
batch routing gate :func:`hetero_sub_ok`.  The hetero ring's byte packing
(``hetero_sub_planes``) is not ported: K4 reads the submatrix from its
shared-memory table.

Every compute backend (XLA reference, Pallas single-block kernel, Pallas
blocked kernel) performs the same per-plane update: for each of the 7 DP
matrices, a max over the 7 source matrices at one shifted position of an
earlier plane, plus a substitution bonus.  This module holds the
backend-agnostic pieces:

* :func:`transition_groups` -- folds the 7x7 weight matrix into per-target
  groups of sources sharing a weight, cutting the op count from
  49 adds + 42 maxes (the reference PE's datapath, src/PE_1cyc.v:163-218 and
  its MAX7 trees at :139-145) to ~31 adds/maxes-in-group + ~21 combine ops,
  exploiting that each target has at most 3 distinct gap charges.

* :func:`target_update` -- applies one target's grouped max-plus update to a
  stacked (7, ...) predecessor array.  Works on NumPy and jax.numpy alike.

Plane coordinate convention (all backends): plane q is a (|B|+1, |C|+1)
array over (j, k); position (j, k) holds cell (i = q-j-k, j, k).  The
predecessor of matrix t lives in plane q - sum(offset(t)) at position
(j - dj, k - dk).  This is the same skew the PE array realizes with its
diagonal delay registers (reference: src/PE_1cyc.v:80-109).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from trialign_torch.config import NUM_MATRICES, OFFSETS, Scoring

# For target t: which earlier plane (1, 2 or 3 steps back) and which (dj, dk)
# shift its predecessor stack needs.  plane_delta = di + dj + dk.
PLANE_DELTA: Tuple[int, ...] = tuple(sum(o) for o in OFFSETS)
SHIFTS: Tuple[Tuple[int, int], ...] = tuple((o[1], o[2]) for o in OFFSETS)

# Substitution selector per target: which pair/triple bonus it receives.
# 0 -> S3, 1 -> none, 2 -> S(a,b), 3 -> S(b,c), 4 -> S(a,c)
SUB_KIND: Tuple[int, ...] = (0, 1, 1, 1, 2, 3, 4)


def transition_groups(
    w: np.ndarray,
) -> List[List[Tuple[int, Tuple[int, ...]]]]:
    """Group each target's sources by shared transition weight.

    Returns groups[t] = [(weight, (source indices...)), ...] sorted by
    weight descending so the cheapest (most likely maximal) group comes
    first.
    """
    groups: List[List[Tuple[int, Tuple[int, ...]]]] = []
    for t in range(NUM_MATRICES):
        by_weight = {}
        for s in range(NUM_MATRICES):
            by_weight.setdefault(int(w[t, s]), []).append(s)
        groups.append(
            [(wt, tuple(srcs)) for wt, srcs in sorted(by_weight.items(), reverse=True)]
        )
    return groups


def target_update(pred_stack, groups_t, maximum):
    """Grouped max-plus update for one target.

    ``pred_stack`` is a (7, ...) array of the target's shifted predecessors;
    ``groups_t`` the target's weight groups; ``maximum`` the elementwise max
    (np.maximum or jnp.maximum).  Returns max_s(pred_stack[s] + W[t, s]).
    """
    acc = None
    for weight, idxs in groups_t:
        g = pred_stack[idxs[0]]
        for s in idxs[1:]:
            g = maximum(g, pred_stack[s])
        term = g if weight == 0 else g + weight
        acc = term if acc is None else maximum(acc, term)
    return acc


def target_update_raw(pred_stack, groups_t, maximum):
    """Like :func:`target_update` but also returns the per-group raw maxes
    (pre-weight), whose overall max is the 7-way plane max -- every target's
    groups partition all 7 sources."""
    acc = None
    raws = []
    for weight, idxs in groups_t:
        g = pred_stack[idxs[0]]
        for s in idxs[1:]:
            g = maximum(g, pred_stack[s])
        raws.append(g)
        term = g if weight == 0 else g + weight
        acc = term if acc is None else maximum(acc, term)
    return acc, raws


def fused_plane_update_m7(p1, p2, m7p3, subs, groups, maximum, roll):
    """All-target update with the M-matrix's predecessor plane carried as a
    single 7-way max.

    M's transition weights are identically zero (it consumes every axis, so
    no gap charge; config.Scoring.weight_matrix row 0), hence
    M(q) = shift(max7(plane q-3)) + S3.  Carrying max7 instead of the seven
    raw generation-3 planes cuts the loop carry from 21 planes to 16 and
    M's combine from 6 maxes to 0; the running max7 of the youngest
    generation comes nearly free as the per-group raw maxes of any
    generation-1 target already partition all 7 sources.

    Returns (new_planes, m7_of_p1).
    """
    planes = (None, p1, p2)
    new = []
    m7p1 = None
    for t in range(NUM_MATRICES):
        if PLANE_DELTA[t] == 3:
            cand = m7p3
        elif PLANE_DELTA[t] == 1 and m7p1 is None:
            cand, raws = target_update_raw(planes[1], groups[t], maximum)
            m7p1 = raws[0]
            for g in raws[1:]:
                m7p1 = maximum(m7p1, g)
        else:
            cand = target_update(planes[PLANE_DELTA[t]], groups[t], maximum)
        dj, dk = SHIFTS[t]
        if dj:
            cand = roll(cand, 0)
        if dk:
            cand = roll(cand, 1)
        s = subs[t]
        if not (isinstance(s, int) and s == 0):
            cand = cand + s
        new.append(cand)
    return new, m7p1


def submatrix_tables(bp, cp, submatrix, dtype, where):
    """Gather-free substitution-plane tables for a runtime score matrix.

    TPU-native realization of the testbench's planned 4x4 score-matrix
    ports (reference: src/TriAlign_tb.sv:220-224,280-290): XLA gathers are
    ~ms-slow on TPU, so the pairwise lookups become short select chains
    over the (static) B/C symbol planes, built ONCE per sweep:

    * ``sb[v][j,k] = S(v, B_j)`` and ``sc[v][j,k] = S(v, C_k)`` -- one
      plane per A-symbol value, each an nsym-term constant-select chain;
    * ``s_bc[j,k] = S(B_j, C_k)`` -- an nsym-term select over the sb/sc
      stacks.

    Any symbol outside [0, nsym) -- sequence pads, border sentinels --
    falls through every select to ``floor`` = min(matrix minimum, -1),
    matching Scoring.sub_lookup()'s clamped-pad semantics exactly.

    Returns (sb, sc, s_bc, floor).  ``where`` is np.where or jnp.where;
    ``dtype`` the plane scalar type.
    """
    nsym = len(submatrix)
    floor = dtype(min(min(min(r) for r in submatrix), -1))
    sb, sc = [], []
    for v in range(nsym):
        accb = None
        accc = None
        for u in range(nsym):
            cu = dtype(submatrix[v][u])
            accb = where(bp == u, cu, floor if accb is None else accb)
            accc = where(cp == u, cu, floor if accc is None else accc)
        sb.append(accb)
        sc.append(accc)
    s_bc = None
    for v in range(nsym):
        s_bc = where(bp == v, sc[v], floor if s_bc is None else s_bc)
    return sb, sc, s_bc, floor


def hetero_sub_ok(submatrix) -> bool:
    """True when a runtime submatrix fits the hetero ring's byte packing
    (nsym <= 4 symbols, every entry and the clamped floor biasable into
    one byte).  The reference's gate between the mosaic/hetero route and
    the padded one; the port keeps it so that every batch takes the same
    route as in the reference."""
    if submatrix is None or len(submatrix) > 4:
        return False
    lo = min(min(min(r) for r in submatrix), -1)
    hi = max(max(r) for r in submatrix)
    return -128 <= lo and hi <= 127


def submatrix_pair(ap, stack, floor, where):
    """Per-step pairwise score plane S(A_i, X) for the moving symbol plane
    ``ap`` against a per-symbol table ``stack`` from submatrix_tables:
    an nsym-select chain (nsym compares + selects per plane step)."""
    acc = where(ap == 0, stack[0], floor)
    for v in range(1, len(stack)):
        acc = where(ap == v, stack[v], acc)
    return acc


def op_count(scoring: Scoring = Scoring()) -> int:
    """Vector ops per cell of the grouped update (for cost models)."""
    groups = transition_groups(scoring.weight_matrix())
    ops = 0
    for t in range(NUM_MATRICES):
        for _, idxs in groups[t]:
            ops += len(idxs) - 1  # in-group maxes
            ops += 1  # + weight
        ops += len(groups[t]) - 1  # cross-group maxes
        ops += 1  # + substitution
    return ops
