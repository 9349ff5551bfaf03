"""Golden CPU models of the three-sequence affine-gap DP.

The port's own copy of ``trialign/golden/numpy_model.py`` (same names, same
semantics): the oracle the port is validated against, with no import of the
JAX package.  Two independent
implementations are provided:

* :func:`align_bruteforce` -- a direct triple-loop transcription of the
  recurrence (reference: src/PE_1cyc.v:163-218).  Obviously correct, O(343 n^3)
  Python; use for n <~ 48 and as the spec of record.

* :func:`align_planes_numpy` -- a vectorized anti-diagonal plane sweep in the
  exact (j, k)-plane formulation the TPU kernels use (the software analogue of
  the PE array's wavefront, reference: pic/3DDP.png, src/TriAlign_1cyc.v:276-347).
  Cross-validated against the brute force; fast enough for 256^3.

Both use zero borders on the i=0 / j=0 / k=0 faces, matching the RTL
(reference: src/TriAlign_1cyc.v:157-181).  Score of the alignment is
max over the 7 matrices at (|A|, |B|, |C|) (reference: src/TriAlign_1cyc.v:141-142).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from trialign_torch.config import (
    CONSUMES,
    NUM_MATRICES,
    OFFSETS,
    Scoring,
)

NEG_INF = np.int32(-(2**30))  # effectively -infinity; safe from int32 wrap


def _as_codes(seq) -> np.ndarray:
    arr = np.asarray(seq)
    if arr.dtype.kind not in "iu":
        raise TypeError("sequences must be integer-encoded; use trialign_torch.config.encode")
    return arr.astype(np.int32)


def align_bruteforce(a, b, c, scoring: Scoring = Scoring(), return_cuboid: bool = False):
    """Direct triple-loop DP.  Returns the optimal score (int), and optionally
    the full (7, |A|+1, |B|+1, |C|+1) cuboid for traceback/testing."""
    a, b, c = _as_codes(a), _as_codes(b), _as_codes(c)
    la, lb, lc = len(a), len(b), len(c)
    w = scoring.weight_matrix().astype(np.int64)
    d = np.zeros((NUM_MATRICES, la + 1, lb + 1, lc + 1), dtype=np.int64)

    def sub(t, i, j, k):
        # Substitution bonus for matrix t at (i, j, k); 1-based i/j/k.
        ca, cb, cc = CONSUMES[t]
        s = 0
        if ca and cb and cc:
            return int(scoring.triple_score(a[i - 1], b[j - 1], c[k - 1]))
        if ca and cb:
            s = int(scoring.pair_score(a[i - 1], b[j - 1]))
        elif cb and cc:
            s = int(scoring.pair_score(b[j - 1], c[k - 1]))
        elif ca and cc:
            s = int(scoring.pair_score(a[i - 1], c[k - 1]))
        return s

    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            for k in range(1, lc + 1):
                for t in range(NUM_MATRICES):
                    di, dj, dk = OFFSETS[t]
                    pred = d[:, i - di, j - dj, k - dk]
                    d[t, i, j, k] = int(np.max(pred + w[t])) + sub(t, i, j, k)

    score = int(np.max(d[:, la, lb, lc]))
    if return_cuboid:
        return score, d.astype(np.int32)
    return score


def align_planes_numpy(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    return_cuboid: bool = False,
    score_bits: int = 0,
):
    """Vectorized anti-diagonal plane sweep.

    Plane q holds, at position (j, k), the cell (i=q-j-k, j, k) for all seven
    matrices.  The predecessors of plane q live in planes q-1, q-2, q-3 at
    fixed (j, k) shifts, so each step is a handful of shifted adds and maxes
    over a (|B|+1, |C|+1) array -- the same dataflow the PE array realizes
    with its diagonal delay registers (reference: src/PE_1cyc.v:80-109).

    ``score_bits``: if nonzero, wrap every stored value to a signed
    ``score_bits``-wide integer, reproducing the RTL's unsaturated
    SCORE_BITS=12 registers (reference: src/TriAlign_1cyc.v:6; SURVEY.md
    section 0.3 quirk 3).  0 (default) keeps full int32 range -- the
    clean-model semantics every TPU backend implements.
    """
    a, b, c = _as_codes(a), _as_codes(b), _as_codes(c)
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) == 0:
        # The final cell sits on a zero-border face.
        if return_cuboid:
            cuboid = np.zeros(
                (NUM_MATRICES, la + 1, lb + 1, lc + 1), dtype=np.int32
            )
            return 0, cuboid
        return 0
    w = scoring.weight_matrix().astype(np.int32)

    hb, wc = lb + 1, lc + 1
    j_grid = np.arange(hb, dtype=np.int32)[:, None]
    k_grid = np.arange(wc, dtype=np.int32)[None, :]

    # s_bc is constant across planes (B, C fixed per cell position).
    bj = np.full((hb, 1), -1, dtype=np.int32)
    bj[1:, 0] = b
    ck = np.full((1, wc), -2, dtype=np.int32)
    ck[0, 1:] = c
    s_bc = scoring.pair_score(np.broadcast_to(bj, (hb, wc)), np.broadcast_to(ck, (hb, wc)))

    planes = np.zeros((4, NUM_MATRICES, hb, wc), dtype=np.int32)  # q, q-1, q-2, q-3 ring
    cuboid = None
    if return_cuboid:
        cuboid = np.zeros((NUM_MATRICES, la + 1, lb + 1, lc + 1), dtype=np.int32)

    def shifted(stack: np.ndarray, dj: int, dk: int) -> np.ndarray:
        """Stack shifted so out[., j, k] = stack[., j-dj, k-dk], zeros outside."""
        out = np.zeros_like(stack)
        out[:, dj:, dk:] = stack[:, : hb - dj if dj else hb, : wc - dk if dk else wc]
        return out

    qmax = la + lb + lc
    final = None
    for q in range(1, qmax + 1):
        p1 = planes[(q - 1) % 4]
        p2 = planes[(q - 2) % 4] if q >= 2 else np.zeros_like(p1)
        p3 = planes[(q - 3) % 4] if q >= 3 else np.zeros_like(p1)

        i_grid = q - j_grid - k_grid  # (hb, wc)
        ai = a[np.clip(i_grid - 1, 0, la - 1)]
        s_ab = scoring.pair_score(ai, np.broadcast_to(bj, (hb, wc)))
        s_ac = scoring.pair_score(ai, np.broadcast_to(ck, (hb, wc)))
        if scoring.s3_mode == "sop":
            s3 = s_ab + s_ac + s_bc
        else:
            s3 = scoring.triple_score(
                ai, np.broadcast_to(bj, (hb, wc)), np.broadcast_to(ck, (hb, wc))
            )

        subs = [s3, 0, 0, 0, s_ab, s_bc, s_ac]
        preds = [
            shifted(p3, 1, 1),  # M
            p1,  # Ix
            shifted(p1, 1, 0),  # Iy
            shifted(p1, 0, 1),  # Iz
            shifted(p2, 1, 0),  # Ixy
            shifted(p2, 1, 1),  # Iyz
            shifted(p2, 0, 1),  # Ixz
        ]

        new = np.empty((NUM_MATRICES, hb, wc), dtype=np.int32)
        for t in range(NUM_MATRICES):
            cand = np.max(preds[t] + w[t][:, None, None], axis=0) + subs[t]
            new[t] = cand
        if score_bits:
            # Emulate an unsaturated score_bits-wide signed register: keep
            # the low bits, sign-extend (two's-complement wraparound).
            m = np.int32(1 << score_bits)
            new = ((new + (m >> 1)) % m) - (m >> 1)

        # Zero borders: any position with i<=0, j==0 or k==0 is a border cell
        # of value 0; positions with i>la are unreachable, zero them for hygiene.
        valid = (i_grid >= 1) & (i_grid <= la) & (j_grid >= 1) & (k_grid >= 1)
        new = np.where(valid[None], new, 0)
        planes[q % 4] = new

        if return_cuboid:
            ii = i_grid
            sel = (ii >= 0) & (ii <= la)
            jj, kk = np.nonzero(sel)
            cuboid[:, ii[sel], jj, kk] = new[:, jj, kk]

        if q == qmax:
            final = new[:, lb, lc].copy()

    score = int(final.max()) if final is not None else 0
    if return_cuboid:
        return score, cuboid
    return score


# ----------------------------------------------------------------------
# Traceback (the capability the RTL stubbed out: its `act` outputs and
# dat/action.dat include are commented at src/PE_1cyc.v:12-14,30).
# ----------------------------------------------------------------------
def traceback_from_cuboid(
    a, b, c, cuboid: np.ndarray, scoring: Scoring = Scoring()
) -> Tuple[int, List[str]]:
    """Recover one optimal alignment from a full DP cuboid by argmax walking.

    Returns (score, [aligned_a, aligned_b, aligned_c]) where the aligned
    strings are lists of symbol codes with -1 denoting a gap.
    """
    a, b, c = _as_codes(a), _as_codes(b), _as_codes(c)
    la, lb, lc = len(a), len(b), len(c)
    w = scoring.weight_matrix().astype(np.int64)
    d = cuboid.astype(np.int64)

    def sub(t, i, j, k):
        ca, cb, cc = CONSUMES[t]
        if ca and cb and cc:
            return int(scoring.triple_score(a[i - 1], b[j - 1], c[k - 1]))
        if ca and cb:
            return scoring.match if a[i - 1] == b[j - 1] else scoring.mismatch
        if cb and cc:
            return scoring.match if b[j - 1] == c[k - 1] else scoring.mismatch
        if ca and cc:
            return scoring.match if a[i - 1] == c[k - 1] else scoring.mismatch
        return 0

    i, j, k = la, lb, lc
    t = int(np.argmax(d[:, i, j, k]))
    score = int(d[t, i, j, k])
    out_a: List[int] = []
    out_b: List[int] = []
    out_c: List[int] = []

    while i > 0 and j > 0 and k > 0:
        di, dj, dk = OFFSETS[t]
        val = d[t, i, j, k]
        target = val - sub(t, i, j, k)
        pred = d[:, i - di, j - dj, k - dk] + w[t]
        # Border semantics: if the predecessor cell is on a zero-border face,
        # its stored value is already 0, which the cuboid holds explicitly.
        s = int(np.flatnonzero(pred == target)[0])
        out_a.append(int(a[i - 1]) if di else -1)
        out_b.append(int(b[j - 1]) if dj else -1)
        out_c.append(int(c[k - 1]) if dk else -1)
        i, j, k = i - di, j - dj, k - dk
        if i == 0 or j == 0 or k == 0:
            break
        t = s

    # Free leading gaps: the RTL's zero borders mean alignment effectively
    # starts once all three prefixes are entered; emit remaining prefixes
    # as unscored leading columns for completeness.
    while i > 0 or j > 0 or k > 0:
        out_a.append(int(a[i - 1]) if i > 0 else -1)
        out_b.append(int(b[j - 1]) if j > 0 else -1)
        out_c.append(int(c[k - 1]) if k > 0 else -1)
        i, j, k = max(i - 1, 0), max(j - 1, 0), max(k - 1, 0)

    out_a.reverse()
    out_b.reverse()
    out_c.reverse()
    return score, [out_a, out_b, out_c]


def rescore_alignment(
    aligned: List[List[int]], scoring: Scoring = Scoring()
) -> int:
    """Independently score an explicit alignment (columns of 3 symbols, -1=gap).

    Used to validate tracebacks: the rescored value of a reported optimal
    alignment must equal the DP score.  Charges affine gaps per axis exactly
    as the recurrence does and treats leading free-border columns (where some
    sequence has not started) as unscored, matching zero-border semantics.
    """
    cols = list(zip(*aligned))
    score = 0
    # Zero-border semantics: at the first scored column, the DP's max over
    # source matrices at a zero-valued border predecessor always admits a
    # source whose gap set covers the target's (the target itself), so the
    # first gap on each axis is charged as an *extension*.  Model that by
    # starting with all axes "already gapped".
    prev_gaps = (True, True, True)
    # Find the first column at which all three sequences have started.
    started = [False, False, False]
    first_full = 0
    for idx, col in enumerate(cols):
        for ax in range(3):
            if col[ax] != -1:
                started[ax] = True
        if all(started):
            first_full = idx
            break

    for idx in range(first_full, len(cols)):
        col = cols[idx]
        gaps = tuple(v == -1 for v in col)
        present = [v for v in col if v != -1]
        # substitution: sum of pairs over present symbols
        if len(present) == 3:
            score += int(scoring.triple_score(col[0], col[1], col[2]))
        elif len(present) == 2:
            score += int(scoring.pair_score(present[0], present[1]))
        # gap charges
        for ax in range(3):
            if gaps[ax]:
                score -= scoring.gap_extend if prev_gaps[ax] else scoring.gap_open
        prev_gaps = gaps
    return score
