"""The 7-matrix affine-gap DP of three sequences, in plain PyTorch.

The semantics, from the configuration's ``scoring`` alone:

- Seven matrices, each consuming one subset of the three sequences (A on
  the i axis, B on j, C on k): M (A, B, C), Ix (A), Iy (B), Iz (C),
  Ixy (A, B), Iyz (B, C), Ixz (A, C).  Matrix t at cell (i, j, k) extends a
  path that ends at (i, j, k) minus its consume vector.
- Moving from matrix s into matrix t charges, for each axis that t leaves
  out, ``gap_extend`` if s left that axis out too and ``gap_open`` if not.
- Matrix t then adds the pair scores of the symbols it consumes: S(a, b)
  for Ixy, S(b, c) for Iyz, S(a, c) for Ixz, nothing for one symbol, and
  S3(a, b, c) for M: the sum of the three pairs ("sop"), or the RTL's
  function ("rtl": 3 match if a = b = c, 2 (match + mismatch) if only
  a = b, 3 mismatch otherwise).  S is ``match`` / ``mismatch``, or the
  entry of ``submatrix``.
- Every cell with i, j or k equal to 0 holds 0 in all seven matrices; the
  score is the largest of the seven at (|A|, |B|, |C|).

The sweep visits the anti-diagonal planes q = i + j + k in order; plane q
is an array over (j, k), cropped to the rows and columns where 0 <= i <=
|A| is possible, and its predecessors lie 1, 2 or 3 planes back.  A batch
of triplets is padded to its longest lengths: a cell depends only on cells
with smaller indices, so each triplet's score is read off at its own corner
as its plane passes.  ``wrap_bits`` keeps every stored value in a signed
register of that many bits (two's-complement wraparound), the narrower
registers of the control.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

# consume vector (A, B, C) of each matrix: M, Ix, Iy, Iz, Ixy, Iyz, Ixz
CONSUMES = ((1, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
            (0, 1, 1), (1, 0, 1))
# Cells of a padded block of triplets (batch x |B| x |C|) one sweep holds.
BLOCK_CELLS = 1 << 25


def check_scoring(scoring: dict) -> None:
    """Raise ValueError for a scoring this reference does not define."""
    if scoring.get("s3", "sop") not in ("sop", "rtl"):
        raise ValueError(f"s3 must be 'sop' or 'rtl': {scoring!r}")
    if scoring.get("submatrix") is not None and scoring.get("s3") == "rtl":
        raise ValueError("a submatrix takes s3 'sop'")


def weights(scoring: dict) -> np.ndarray:
    """(7, 7) int64: W[t, s], the charge of moving from matrix s into t."""
    w = np.zeros((7, 7), np.int64)
    for t in range(7):
        for s in range(7):
            for axis in range(3):
                if not CONSUMES[t][axis]:
                    w[t, s] -= (scoring["gap_extend"] if not CONSUMES[s][axis]
                                else scoring["gap_open"])
    return w


def pair(scoring: dict, x, y):
    """S(x, y), elementwise on numpy arrays or torch tensors of codes."""
    sub = scoring.get("submatrix")
    if sub is not None:
        if isinstance(x, torch.Tensor):
            table = torch.tensor(sub, dtype=torch.int32, device=x.device)
            return table[x.long(), y.long()]
        return np.asarray(sub, np.int64)[np.asarray(x), np.asarray(y)]
    if isinstance(x, torch.Tensor):
        return torch.where(x == y, _const(scoring["match"], x),
                           _const(scoring["mismatch"], x))
    return np.where(np.asarray(x) == np.asarray(y), scoring["match"],
                    scoring["mismatch"])


def triple(scoring: dict, a, b, c):
    """S3(a, b, c), elementwise."""
    if scoring.get("s3", "sop") == "sop":
        return pair(scoring, a, b) + pair(scoring, b, c) + pair(scoring, a, c)
    m, x = scoring["match"], scoring["mismatch"]
    if isinstance(a, torch.Tensor):
        return torch.where(a == b, torch.where(b == c, _const(3 * m, a),
                                               _const(2 * (m + x), a)),
                           _const(3 * x, a))
    return np.where(np.asarray(a) == np.asarray(b),
                    np.where(np.asarray(b) == np.asarray(c), 3 * m,
                             2 * (m + x)), 3 * x)


def _const(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=like.device)


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    half = 1 << (bits - 1)
    return torch.remainder(x + half, 2 * half) - half


def _padded(seqs: Sequence[np.ndarray], device) -> torch.Tensor:
    """(n, max length + 1) int32: row p holds sequence p from column 1."""
    out = np.zeros((len(seqs), max(len(s) for s in seqs) + 1), np.int32)
    for p, s in enumerate(seqs):
        out[p, 1:len(s) + 1] = s
    return torch.from_numpy(out).to(device)


def _sweep(block: Sequence, scoring: dict, device,
           wrap_bits: int) -> List[int]:
    lens = np.array([[len(x) for x in t] for t in block], np.int64)
    la, lb, lc = (int(v) for v in lens.max(axis=0))
    n = len(block)
    seq_a, seq_b, seq_c = (_padded([t[x] for t in block], device)
                           for x in range(3))
    w = torch.from_numpy(weights(scoring)).to(device=device,
                                              dtype=torch.int32)
    s_bc = pair(scoring, seq_b[:, :, None], seq_c[:, None, :])
    # Four planes in a ring, each with a zero row and column in front, so
    # that a shifted predecessor is a view.
    ring = torch.zeros((4, 7, n, lb + 2, lc + 2), dtype=torch.int32,
                       device=device)
    ends = lens.sum(axis=1)
    final = torch.zeros((n, 7), dtype=torch.int32, device=device)
    jj = torch.arange(lb + 1, device=device)
    kk = torch.arange(lc + 1, device=device)
    corner = torch.from_numpy(lens[:, 1:]).to(device)
    for q in range(1, la + lb + lc + 1):
        j0, j1 = max(0, q - la - lc), min(lb, q)
        k0, k1 = max(0, q - la - lb), min(lc, q)
        j = jj[j0:j1 + 1, None]
        k = kk[None, k0:k1 + 1]
        i = q - j - k
        valid = (i >= 1) & (i <= la) & (j >= 1) & (k >= 1)
        ai = seq_a[:, i.clamp(0, la)]
        bj = seq_b[:, j0:j1 + 1, None]
        ck = seq_c[:, None, k0:k1 + 1]
        s_ab, s_ac = pair(scoring, ai, bj), pair(scoring, ai, ck)
        subs = (triple(scoring, ai, bj, ck), None, None, None, s_ab,
                s_bc[:, j0:j1 + 1, k0:k1 + 1], s_ac)
        new = torch.empty((7, n) + valid.shape, dtype=torch.int32,
                          device=device)
        for t, (di, dj, dk) in enumerate(CONSUMES):
            src = ring[(q - di - dj - dk) % 4][
                :, :, 1 + j0 - dj:2 + j1 - dj, 1 + k0 - dk:2 + k1 - dk]
            best = (src + w[t].view(7, 1, 1, 1)).amax(dim=0)
            new[t] = best if subs[t] is None else best + subs[t]
        if wrap_bits:
            new = _wrap(new, wrap_bits)
        ring[q % 4][:, :, 1 + j0:2 + j1, 1 + k0:2 + k1] = torch.where(
            valid, new, 0)
        done = np.flatnonzero(ends == q)
        if len(done):
            done = torch.from_numpy(done).to(device)
            final[done] = ring[q % 4][:, done, 1 + corner[done, 0],
                                      1 + corner[done, 1]].T
    return [int(v) for v in final.max(dim=1).values.tolist()]


def scores(triplets: Sequence, scoring: dict, device="cpu",
           wrap_bits: int = 0,
           block_cells: Optional[int] = None) -> List[int]:
    """The optimal score of each (a, b, c) triplet of code arrays, in order;
    a triplet with an empty sequence scores 0.  The triplets are swept in
    blocks of similar size, each at most ``block_cells`` padded cells a
    plane (``BLOCK_CELLS`` by default)."""
    check_scoring(scoring)
    cap = block_cells or BLOCK_CELLS
    trips = [tuple(np.asarray(x, np.int32) for x in t) for t in triplets]
    out = [0] * len(trips)
    order = sorted((p for p, t in enumerate(trips)
                    if min(len(x) for x in t) > 0),
                   key=lambda p: [len(x) for x in trips[p]])
    block: List[int] = []

    def flush():
        if block:
            got = _sweep([trips[p] for p in block], scoring, device,
                         wrap_bits)
            for p, s in zip(block, got):
                out[p] = s
            block.clear()

    for p in order:
        lb = max([len(trips[x][1]) for x in block + [p]])
        lc = max([len(trips[x][2]) for x in block + [p]])
        if block and (len(block) + 1) * (lb + 2) * (lc + 2) > cap:
            flush()
        block.append(p)
    flush()
    return out
