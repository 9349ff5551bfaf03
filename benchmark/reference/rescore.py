"""Score of one alignment, column by column, under the DP's rules.

An alignment is three rows of equal length, each the codes of one sequence
with -1 for a gap.  A column's matrix is the set of rows that place a
symbol in it.  The path starts free: every cell with i, j or k equal to 0
holds 0, so the columns up to the last point where some sequence has not
yet placed a symbol cost nothing, and the first column after it takes the
cheapest charge any matrix could have handed it.  Every later column pays
the charge of moving from the previous column's matrix into its own, plus
its pair scores (``dp`` holds the rules).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from benchmark.reference.dp import CONSUMES, pair, triple, weights


def spells(rows: Sequence[Sequence[int]], seqs: Sequence) -> bool:
    """Whether the rows, without their gaps, are the three sequences, and no
    column is all gaps."""
    if len(rows) != 3 or len({len(r) for r in rows}) != 1:
        return False
    arr = np.asarray(rows, np.int64).reshape(3, -1)
    if (arr < 0).all(axis=0).any():
        return False
    return all(np.array_equal(r[r >= 0], np.asarray(s, np.int64))
               for r, s in zip(arr, seqs))


def rescore(rows: Sequence[Sequence[int]], seqs: Sequence,
            scoring: dict) -> Optional[int]:
    """The alignment's score, or None if it does not spell ``seqs``."""
    if not spells(rows, seqs):
        return None
    arr = np.asarray(rows, np.int64).reshape(3, -1)
    placed = arr >= 0
    counts = np.cumsum(placed, axis=1)
    border = np.flatnonzero(counts.min(axis=0) == 0)
    # Columns [0, start) lead to the last border cell on the path.
    start = int(border[-1]) + 1 if len(border) else 0
    if start == arr.shape[1]:
        return 0
    of_pattern = np.zeros(8, np.int64)
    for t, (ca, cb, cc) in enumerate(CONSUMES):
        of_pattern[4 * ca + 2 * cb + cc] = t
    bits = placed[:, start:].astype(np.int64)
    states = of_pattern[4 * bits[0] + 2 * bits[1] + bits[2]]
    # Gaps read as symbol 0 here; a column's matrix never reads them.
    a, b, c = np.maximum(arr[:, start:], 0)
    zero = np.zeros_like(a)
    subs = np.stack([triple(scoring, a, b, c), zero, zero, zero,
                     pair(scoring, a, b), pair(scoring, b, c),
                     pair(scoring, a, c)])
    w = weights(scoring)
    return int(w[states[0]].max() + w[states[1:], states[:-1]].sum()
               + subs[states, np.arange(len(states))].sum())
