"""The one traffic generator: a cell's pool of distinct requests.

A configuration (``configs/<name>.json``) says how one triplet's sequences
are drawn (``sequences``); a traffic mix (``traffic/<name>.json``) says
what a request is (``entry``, ``alignment``, ``batch``), how many distinct
requests the pool holds (``pool``), and, where the configuration leaves
them open, the sequences' lengths (``lengths``).

Every seed gets the same set of shapes: the lengths are drawn once from the
mix's ``shape_seed``, so each run does the same work.  The run's seed
shuffles the order of the shapes within each request and draws every
symbol and mutation.

Sequence kinds:

- ``uniform``: each symbol uniform over ``symbols`` codes; the mix gives
  the lengths, ``independent`` (each of the three uniform over ``range`` on
  its own) or ``cube`` (one length uniform over ``range`` for all three).
- ``mutated_root``: a root of length uniform over ``root_length`` (drawn
  from the mix's ``shape_seed``), and three copies of it, each with
  ``substitution`` of its sites changed to another symbol and ``indel`` of
  its sites deleted or inserted, as many of each, so that every copy keeps
  the root's length.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Triplet = Tuple[np.ndarray, np.ndarray, np.ndarray]


def rng_of(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed, negative or past 64 bits."""
    return np.random.default_rng(int(seed) % (1 << 64))


def _shapes(config: dict, mix: dict, count: int) -> np.ndarray:
    """(count, 3) lengths, the same for every run seed."""
    rng = rng_of(mix["shape_seed"])
    seqs = config["sequences"]
    if seqs["kind"] == "mutated_root":
        if mix.get("lengths"):
            raise ValueError("a mutated_root configuration sets its lengths")
        lo, hi = seqs["root_length"]
        return np.repeat(rng.integers(lo, hi + 1, size=(count, 1)), 3, axis=1)
    if seqs["kind"] != "uniform":
        raise ValueError(f"unknown sequence kind {seqs['kind']!r}")
    lengths = mix.get("lengths")
    if not lengths:
        raise ValueError("a uniform configuration takes its lengths from "
                         "the traffic mix")
    lo, hi = lengths["range"]
    if lengths["kind"] == "independent":
        return rng.integers(lo, hi + 1, size=(count, 3))
    if lengths["kind"] == "cube":
        return np.repeat(rng.integers(lo, hi + 1, size=(count, 1)), 3, axis=1)
    raise ValueError(f"unknown lengths kind {lengths['kind']!r}")


def _mutate(rng: np.random.Generator, root: np.ndarray, symbols: int,
            substitution: float, indel: float) -> np.ndarray:
    n = len(root)
    seq = root.copy()
    sites = rng.choice(n, size=int(round(substitution * n)), replace=False)
    seq[sites] = (seq[sites] + rng.integers(1, symbols, size=len(sites))) \
        % symbols
    events = int(round(indel * n / 2))
    seq = np.delete(seq, rng.choice(n, size=events, replace=False))
    where = np.sort(rng.integers(0, len(seq) + 1, size=events))
    return np.insert(seq, where, rng.integers(0, symbols, size=events)) \
        .astype(np.uint8)


def _triplet(rng: np.random.Generator, config: dict, shape) -> Triplet:
    seqs = config["sequences"]
    k = seqs["symbols"]
    if seqs["kind"] == "uniform":
        return tuple(rng.integers(0, k, size=int(n)).astype(np.uint8)
                     for n in shape)
    root = rng.integers(0, k, size=int(shape[0])).astype(np.uint8)
    return tuple(_mutate(rng, root, k, seqs["substitution"], seqs["indel"])
                 for _ in range(3))


def pool(config: dict, mix: dict, seed: int) -> List:
    """The mix's ``pool`` distinct requests for ``seed``: each a triplet, or
    for a mix with ``batch`` a list of that many triplets."""
    per = int(mix.get("batch", 1))
    n = int(mix["pool"])
    shapes = _shapes(config, mix, n * per).reshape(n, per, 3)
    rng = rng_of(seed)
    out = []
    for group in shapes:
        trips = [_triplet(rng, config, s) for s in group[rng.permutation(per)]]
        out.append(trips if "batch" in mix else trips[0])
    return [out[i] for i in rng.permutation(n)]


def triplets(request) -> List[Triplet]:
    """The triplets of one request."""
    return list(request) if isinstance(request, list) else [request]


def cells(request) -> int:
    """DP cells (|A| |B| |C|) of one request."""
    return sum(len(a) * len(b) * len(c) for a, b, c in triplets(request))
