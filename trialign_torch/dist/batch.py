"""Batched alignment of independent triplets, on one device or a mesh.

Port of ``trialign/dist/batch.py``: ``prep_padded``, ``align_batch_padded``,
``_blocked_group``, ``align_batch_bucketed``, ``align_batch_sharded`` and
``align_batch_multihost``.  On the TPU a padded bucket is the wavefront
kernel vmapped over the batch, and buckets are keyed by compile-friendly
shapes.  The port's K2 takes each problem's lengths at run time and sweeps
every problem's tiles in one persistent launch, so every triplet inside
K2's caps goes into one stacked bucket and one launch; longer ones run K3
one after another on one stream and are read once at the end.  ``_sweep_padded`` (the XLA twin of the
vmapped kernel) is not ported: the plain version of K2 is ``ref.sweep``.

Over a mesh (``dist/mesh.py``) each data slot scores a contiguous share of
the batch on its own device and CUDA stream; across processes each process
scores its slots' shares and the scores are all-gathered (host data, the
``gloo`` backend by default).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from trialign_torch.config import Scoring
from trialign_torch.dist import mesh as dmesh
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


def _padded_on_slots(chunks: Sequence, devices: Sequence,
                     scoring: Scoring) -> List[List[int]]:
    """Scores of each chunk of non-empty triplets inside K2's caps: chunk k
    in one K2 launch on ``devices[k]``, each slot on a stream of its own,
    all read once at the end.  A submatrix past K2's table runs
    :func:`align_batch_padded` (the plain sweep) chunk by chunk."""
    if (scoring.submatrix is not None
            and len(scoring.submatrix) > wf.SUBMATRIX_NSYM_CAP):
        return [align_batch_padded(ch, scoring, dev)
                for ch, dev in zip(chunks, devices)]
    streams = dmesh.SlotStreams(devices)
    pending = []
    for k, (chunk, dev) in enumerate(zip(chunks, streams.devices)):
        with streams.on(k):
            pending.append(wf.final_values(*prep_padded(chunk, dev), scoring)
                           .max(dim=1).values if chunk else None)
    streams.join()
    return [[int(v) for v in p.tolist()] if p is not None else []
            for p in pending]


def _split_padded(triplets: Sequence, ndata: int):
    """The triplets padded to a multiple of ``ndata`` with copies of the
    first, in ``ndata`` contiguous chunks of equal size."""
    padded = list(triplets)
    while len(padded) % ndata:
        padded.append(padded[0])
    size = len(padded) // ndata
    return [padded[k * size:(k + 1) * size] for k in range(ndata)]


def _long_or_empty(t) -> bool:
    return min(map(len, t)) == 0 or not wf.fits(*map(len, t))


def align_batch_sharded(triplets: Sequence, scoring: Scoring = Scoring(),
                        mesh: Optional[dmesh.Mesh] = None) -> List[int]:
    """Scores of a batch spread over the 'data' slots of ``mesh`` (this
    process's devices on the data axis by default), in input order.

    As the reference: a batch the mosaic gate admits (``api.batch_routes``:
    at least 64 triplets with rotated |A| <= 1024, on the card or with
    TRIALIGN_FORCE_MOSAIC=1) goes through ``align_batch_mosaic`` over the
    mesh; of the rest, the triplets inside K2's caps are padded to a
    multiple of the data axis and each slot scores its contiguous share in
    one K2 launch, and the longer ones run K3, dealt to the slots in turn.
    An empty sequence scores 0.  The reference's ``engine`` argument (XLA
    or Pallas) has no counterpart: the slots' devices choose the kernels or
    their plain versions."""
    from trialign_torch.api import batch_routes
    from trialign_torch.kernels.mosaic import align_batch_mosaic, data_devices

    if not triplets:
        return []
    mesh = mesh if mesh is not None else dmesh.default_mesh()
    devices = data_devices(mesh)
    n = len(triplets)
    out = [0] * n
    open_ = any(d.type == "cuda" for d in devices) or \
        os.environ.get("TRIALIGN_FORCE_MOSAIC") == "1"
    routes = batch_routes([[len(x) for x in t] for t in triplets], scoring,
                          open_)
    idx = [i for i in range(n) if routes[i] == "mosaic"]
    if idx:
        for i, s in zip(idx, align_batch_mosaic([triplets[i] for i in idx],
                                                scoring, mesh=mesh)):
            out[i] = s
    for i in range(n):
        if routes[i] == "torch" and min(map(len, triplets[i])) > 0:
            out[i] = align_ref(*triplets[i], scoring, 0, devices[0])
    rest = [i for i in range(n) if routes[i] == "padded"]
    short = [i for i in rest if not _long_or_empty(triplets[i])]
    if short:
        chunks = _split_padded([triplets[i] for i in short], len(devices))
        scores = [s for part in _padded_on_slots(chunks, devices, scoring)
                  for s in part]
        for i, s in zip(short, scores):
            out[i] = s
    long_ = [i for i in rest if min(map(len, triplets[i])) > 0
             and not wf.fits(*map(len, triplets[i]))]
    if long_:
        streams = dmesh.SlotStreams(devices)
        pending = []
        for r, i in enumerate(long_):
            k = r % len(devices)
            with streams.on(k):
                pending.append(align_blocked_async(
                    *triplets[i], scoring, device=streams.devices[k]))
        streams.join()
        for i, s in zip(long_, pending):
            out[i] = int(s)
    return out


def align_batch_multihost(triplets: Sequence, scoring: Scoring = Scoring(),
                          mesh: Optional[dmesh.Mesh] = None) -> List[int]:
    """Scores of a batch over the data axis of a mesh that spans processes
    (``dist.mesh.multihost_mesh()`` by default), in every process.

    Every process calls it with the same triplets.  With one process it is
    :func:`align_batch_sharded`.  With several, the triplets inside K2's
    caps are padded to a multiple of the data axis, each process scores the
    shares of its own data slots (one K2 launch a slot), and the scores are
    all-gathered; the longer triplets, and those with an empty sequence,
    are scored by every process on its first device, as in the reference."""
    if not triplets:
        return []
    if dmesh.world_size() == 1:
        return align_batch_sharded(triplets, scoring, mesh)
    mesh = mesh if mesh is not None else dmesh.multihost_mesh()
    slots = [row[0] for row in mesh.slots]
    mine = [k for k, s in enumerate(slots) if s.rank == dmesh.rank()]
    if not mine:
        raise ValueError(f"process {dmesh.rank()} owns no data slot")
    first = dmesh.normalize(slots[mine[0]].device)
    n = len(triplets)
    out = [0] * n
    long_ = [i for i in range(n) if _long_or_empty(triplets[i])]
    if long_:
        for i, s in zip(long_, align_batch_bucketed(
                [triplets[i] for i in long_], scoring, first)):
            out[i] = s
    short = [i for i in range(n) if not _long_or_empty(triplets[i])]
    if short:
        chunks = _split_padded([triplets[i] for i in short], len(slots))
        got = _padded_on_slots([chunks[k] for k in mine],
                               [slots[k].device for k in mine], scoring)
        everyone: List = [None] * dmesh.world_size()
        dist.all_gather_object(everyone, dict(zip(mine, got)))
        by_slot = {k: v for part in everyone for k, v in part.items()}
        scores = [s for k in range(len(slots)) for s in by_slot[k]]
        for i, s in zip(short, scores):
            out[i] = s
    return out
