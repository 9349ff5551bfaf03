"""Batched alignment of independent triplets on one device.

Port of the one-device half of ``trialign/dist/batch.py``: ``prep_padded``,
``align_batch_padded``, ``_blocked_group`` and ``align_batch_bucketed``.  On
the TPU a padded bucket is the wavefront kernel vmapped over the batch, and
buckets are keyed by compile-friendly shapes.  The port's K2 takes each
problem's lengths at run time, one thread block a problem, so every triplet
inside K2's caps goes into one stacked bucket and one launch; longer ones
run K3 one after another on one stream and are read once at the end.
``_sweep_padded`` (the XLA twin of the vmapped kernel) is not ported: the
plain version of K2 is ``ref.sweep``.  ``align_batch_multihost`` and
``align_batch_sharded`` wait for the multi-device slice.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from trialign_torch.config import Scoring
from trialign_torch.kernels import wavefront as wf
from trialign_torch.kernels.blocked import align_blocked_async
from trialign_torch.kernels.ref import PAD_A, PAD_B, PAD_C, align_ref


def prep_padded(triplets: Sequence, device):
    """Stack triplets into one K2 bucket: (a, b, c, lens), where a is an
    (n, max|A| + 1) int32 tensor with problem p's A at row p, indices
    1..|A|, and the reference's sentinels elsewhere (b, c likewise), and
    lens the (n, 3) host lengths."""
    lens = np.array([[len(x) for x in t] for t in triplets], np.int64)
    arrs = []
    for x, pad in enumerate((PAD_A, PAD_B, PAD_C)):
        arr = np.full((len(triplets), int(lens[:, x].max()) + 1), pad,
                      np.int32)
        for p, t in enumerate(triplets):
            arr[p, 1:len(t[x]) + 1] = np.asarray(t[x], dtype=np.int32)
        arrs.append(torch.from_numpy(arr).to(device))
    return (*arrs, lens)


def align_batch_padded(triplets: Sequence, scoring: Scoring = Scoring(),
                       device="cuda") -> List[int]:
    """Scores of a batch on ``device``, in input order.  Triplets with an
    empty sequence score 0; a batch with a triplet past K2's caps goes
    through :func:`align_batch_bucketed`; the rest is one K2 launch (its
    plain version on the CPU).  A submatrix past the table of K2 and K3
    runs the plain sweep per triplet."""
    if not triplets:
        return []
    empty = {i for i, t in enumerate(triplets) if min(map(len, t)) == 0}
    if empty:
        keep = [i for i in range(len(triplets)) if i not in empty]
        sub = align_batch_padded([triplets[i] for i in keep], scoring, device)
        out = [0] * len(triplets)
        for i, s in zip(keep, sub):
            out[i] = s
        return out
    if (scoring.submatrix is not None
            and len(scoring.submatrix) > wf.SUBMATRIX_NSYM_CAP):
        return [align_ref(*t, scoring, 0, device) for t in triplets]
    if not all(wf.fits(*map(len, t)) for t in triplets):
        return align_batch_bucketed(triplets, scoring, device)
    vals = wf.final_values(*prep_padded(triplets, device), scoring)
    return [int(s) for s in vals.max(dim=1).values.tolist()]


def _blocked_group(triplets: Sequence, scoring: Scoring,
                   device) -> List[int]:
    """Scores of triplets past K2's caps: K3 once per triplet, all queued
    on one stream, read once at the end; an empty sequence scores 0."""
    scores = [align_blocked_async(*t, scoring, device=device)
              for t in triplets]
    return [int(s) for s in torch.stack(scores).tolist()] if scores else []


def align_batch_bucketed(triplets: Sequence, scoring: Scoring = Scoring(),
                         device="cuda") -> List[int]:
    """Score a mixed-length batch: one K2 bucket for the triplets inside its
    caps, K3 for the rest; scores in input order, 0 for an empty
    sequence."""
    out = [0] * len(triplets)
    small, large = [], []
    for i, t in enumerate(triplets):
        if min(map(len, t)) == 0:
            continue
        (small if wf.fits(*map(len, t)) else large).append(i)
    for idx, fn in ((small, align_batch_padded), (large, _blocked_group)):
        if idx:
            for i, s in zip(idx, fn([triplets[i] for i in idx], scoring,
                                    device)):
                out[i] = s
    return out
