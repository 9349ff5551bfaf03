"""One long triplet over several devices: stripes of tile columns with
column-face handoff (the halo).

Port of ``trialign/dist/halo.py``.  The tile grid of the blocked sweep
(``kernels/blocked.py``) is cut into stripes of whole tile columns, one per
slot of the mesh's 'model' axis: stripe d owns columns [kb0, kb1).  Row
faces stay in their column and never leave a stripe.  A column face crosses
at each stripe boundary: after its tile (jb, kb1 - 1), stripe d hands
``cf[jb]`` (nrows x 7 x hb int32, about 1 MB at 1024^3 with 33 x 33 tiles)
to stripe d + 1, which needs it for its tile (jb, kb1).

What the reference does differently, and why:

* Its device d sweeps one block row a step, one block a call (halo.py:
  228-261).  On the card that would be one launch a tile.  Here each stripe
  sweeps its own tiles by global tile anti-diagonal, one launch a diagonal,
  through K3's per-tile form (``blocked.sweep_tiles``): any contiguous run
  of one diagonal's tiles is a legal launch, with global tile indices, so
  borders, symbols and the target tile are the whole sweep's.
* Its stripes pad the tile columns to a multiple of the stripe count
  (halo.py:193-199).  Here columns split unevenly, and a stripe may get
  none when there are more stripes than columns.
* Its ``psum`` gathers the final vector, which only the stripe holding the
  last tile writes.  Here that stripe's vector is the result, broadcast to
  the other processes when the axis spans several.

Each stripe keeps a full-size state on its own device (the face slabs of
every column and row, of which it writes its own) and runs on a CUDA stream
of its own, waiting on one event per face it is handed.  ``overlap`` picks
the schedule: True copies a face on a copy stream while the stripe sweeps
its next diagonal, False copies it on the stripe's own stream.  Both give
the same score.  The copy is made even when both stripes share a card, so
that one card runs the handoff as several would.  A stripe whose neighbour
lives in another process sends the face through a pinned host buffer
(``gloo``; ``dist/mesh.py`` says why not ``nccl``).

Nothing falls back: a failed launch, copy or collective raises.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.dist import mesh as dmesh
from trialign_torch.kernels import blocked as bk

# K3's time a tile-plane step at its 33 x 33 tile plane: 155.07 ms at 1024^3
# over 63 launches of 1088 planes (PERF.md section 6, chip_smoke.py timings,
# NVIDIA H100 80GB HBM3 at 700 W).  One launch takes its tiles' planes in
# turn, whatever the number of tiles up to the SMs.
STEP_S = 155.07e-3 / (63 * 1088)
# Tiles one card runs at once in the model: one a streaming multiprocessor.
SMS = 132
# Device-to-device bytes a second of one face handoff (a 1.0 MB column face
# at 1024^3, copied on one card): chip_smoke.py's halo phase measured
# 5.87e10 to 1.13e11 in three runs on an NVIDIA H100 80GB HBM3 at 700 W,
# bound by the host's launch rate.  A copy between cards over NVLink was
# not measured.
FACE_COPY_BYTES_PER_S = 7.96e10


def scaling_efficiency(n_jb: int, ndev: int, overlap: bool = False) -> float:
    """Pipeline efficiency of a row-pipelined grid on ``ndev`` devices: the
    reference's arithmetic (n_jb rows in n_jb + D - 1 steps, or n_jb +
    2(D - 1) in the overlapped schedule)."""
    ramp = 2 * (ndev - 1) if overlap else (ndev - 1)
    return n_jb / (n_jb + ramp)


def stripe_columns(n_kb: int, ndev: int) -> List[Tuple[int, int]]:
    """Tile columns [kb0, kb1) of each of ``ndev`` stripes: contiguous,
    within one column of each other in width, empty past the n_kb-th."""
    return [(d * n_kb // ndev, (d + 1) * n_kb // ndev) for d in range(ndev)]


def choose_halo_shape(la: int, lb: int, lc: int,
                      ndev: int) -> Tuple[int, int]:
    """The tile plane (hb, wc) of a halo over ``ndev`` stripes: K3's tile
    plane, its width cut where |C| has fewer tile columns than stripes, so
    that every stripe holds one.  The reference's v5e VMEM budget, lane
    table and link rates are not ported."""
    hb, wc = bk.choose_block_shape(la, lb, lc)
    if ndev > 1 and -(-lc // (wc - 1)) < ndev:
        wc = max(2, -(-lc // ndev) + 1)
    return hb, wc


def _diag_tiles(n_jb: int, t: int, kb0: int, kb1: int) -> int:
    return max(0, min(n_jb - 1, t - kb0) - max(0, t - (kb1 - 1)) + 1)


def halo_efficiency(la: int, lb: int, lc: int, ndev: int,
                    block_shape: Optional[Tuple[int, int]] = None,
                    overlap: Optional[bool] = None,
                    copy_bytes_per_s: Optional[float] = None) -> dict:
    """Model of a halo over ``ndev`` stripes, each on a card of its own, as
    :func:`align_sharded_triplet` runs it: uneven columns, one launch a
    stripe and diagonal, a face handed at each boundary.

    A launch of n tiles takes ceil(n / SMS) x nq x STEP_S; a handoff
    moves nrows x 7 x hb int32 at ``copy_bytes_per_s``
    (``FACE_COPY_BYTES_PER_S`` by default).  Returns {'pipeline': one
    card's modelled time over ndev times the stripes' compute, 'j_fill',
    'k_fill': real over swept cells, 'transfer': compute over compute and
    the handoffs the schedule does not hide, 'overlap', 'seconds', 'total':
    the product of the four shares}.  ``overlap`` None models both
    schedules and returns the better."""
    if overlap is None:
        return max((halo_efficiency(la, lb, lc, ndev, block_shape, ov,
                                    copy_bytes_per_s) for ov in (True, False)),
                   key=lambda e: e["total"])
    hb, wc = block_shape or choose_halo_shape(la, lb, lc, ndev)
    dims = bk.plan_dims(max(la, 1), max(lb, 1), max(lc, 1), hb, wc)
    n_jb, n_kb, nq = dims.n_jb, dims.n_kb, dims.nq
    rate = copy_bytes_per_s or FACE_COPY_BYTES_PER_S
    xfer = dims.nrows * NUM_MATRICES * hb * 4 / rate
    cols = [c for c in stripe_columns(n_kb, ndev) if c[1] > c[0]]
    one = compute = wall = 0.0
    for t in range(n_jb + n_kb - 1):
        launch = -(-_diag_tiles(n_jb, t, 0, n_kb) // SMS) * nq * STEP_S
        step = max(-(-_diag_tiles(n_jb, t, k0, k1) // SMS)
                   for k0, k1 in cols) * nq * STEP_S
        # A face crosses a boundary kb1 on diagonal t if row t - (kb1 - 1)
        # exists.
        moves = any(0 <= t - (k1 - 1) < n_jb for _, k1 in cols[:-1])
        one += launch
        compute += step
        wall += max(step, xfer) if overlap and moves else \
            step + (xfer if moves else 0.0)
    pipeline = one / (ndev * compute)
    transfer = compute / wall
    j_fill = lb / (n_jb * (hb - 1))
    k_fill = lc / (n_kb * (wc - 1))
    return {"pipeline": pipeline, "j_fill": j_fill, "k_fill": k_fill,
            "transfer": transfer, "overlap": overlap, "seconds": wall,
            "total": pipeline * j_fill * k_fill * transfer}


# ------------------------------------------------------------- the stripes


class Stripe:
    """One stripe of a halo: its tile columns, its slot and, in the process
    that owns it, its stream, symbol arrays and state."""

    def __init__(self, index: int, kb0: int, kb1: int, slot: dmesh.Slot):
        self.index, self.kb0, self.kb1 = index, kb0, kb1
        self.rank = slot.rank
        self.local = self.rank == dmesh.rank()
        self.device = dmesh.normalize(slot.device) if self.local else slot.device
        self.cuda = self.local and self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.copy_stream = None
        self.arrs = self.state = None

    def on_stream(self, stream=None):
        """A context that makes ``stream`` (the stripe's own by default)
        current on its device; nothing on the CPU."""
        stream = stream or self.stream
        return torch.cuda.stream(stream) if stream is not None else \
            nullcontext()


def model_row(mesh: dmesh.Mesh) -> List[dmesh.Slot]:
    """The slots of the model axis this process runs: the first data row
    that holds one of its slots.  A row that spans processes must hold
    every process, so that each one takes part in the same halo."""
    me = dmesh.rank()
    for row in mesh.slots:
        if any(s.rank == me for s in row):
            ranks = {s.rank for s in row}
            if len(ranks) > 1 and len(ranks) != dmesh.world_size():
                raise ValueError("a model axis across processes must hold "
                                 "every process")
            return row
    raise ValueError(f"process {me} owns no slot of {mesh}")


def _send(t: torch.Tensor, stripe: Stripe, dst: int, tag: int, works: list,
          keep: list) -> None:
    """Send ``t`` (on ``stripe``'s device) to process ``dst`` through a
    pinned host buffer."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=stripe.cuda)
    with stripe.on_stream():
        host.copy_(t, non_blocking=stripe.cuda)
    if stripe.cuda:
        stripe.stream.synchronize()
    works.append(dist.isend(host, dst, tag=tag))
    keep.append(host)


def _recv(t: torch.Tensor, stripe: Stripe, src: int, tag: int) -> None:
    """Receive into ``t`` (on ``stripe``'s device) from process ``src``
    through a host buffer."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=stripe.cuda)
    dist.recv(host, src, tag=tag)
    with stripe.on_stream():
        t.copy_(host, non_blocking=stripe.cuda)


def run_stripes(dims: bk.Dims, row: Sequence[dmesh.Slot], overlap: bool,
                start: Callable, sweep: Callable) -> List[Stripe]:
    """Sweep the tile grid of ``dims`` in stripes over the slots ``row``
    (one stripe a slot, columns by :func:`stripe_columns`).

    ``start(device)`` returns (symbol arrays, state) on a device, the state
    a NamedTuple with a ``cf`` field (n_jb, nrows, 7, hb);
    ``sweep(arrs, state, idx0, count)`` runs tiles idx0 .. idx0 + count - 1
    of ``blocked.tile_table`` (a per-tile form).  Returns the stripes that
    hold columns, in order; those of this process carry their state.  On
    return the current stream of every local device has waited for every
    stripe and copy, so results read there are complete."""
    cols = stripe_columns(dims.n_kb, len(row))
    stripes = [Stripe(d, k0, k1, row[d]) for d, (k0, k1) in enumerate(cols)
               if k1 > k0]
    mine = [s for s in stripes if s.local]
    for s in mine:
        # The state is allocated on the caller's stream, which each stripe
        # waits on first and which waits on each stripe last: the allocator
        # hands out none of its memory while a stripe may still use it.
        s.arrs, s.state = start(s.device)
        if s.cuda:
            s.stream.wait_stream(torch.cuda.current_stream(s.device))
            if overlap:
                s.copy_stream = torch.cuda.Stream(s.device)
    ready = {}          # (receiving stripe, jb) -> event or None (done)
    works, keep = [], []
    for t in range(dims.n_jb + dims.n_kb - 1):
        for pos, s in enumerate(stripes):
            if not s.local:
                continue
            lo, hi = max(0, t - (s.kb1 - 1)), min(dims.n_jb - 1, t - s.kb0)
            if lo > hi:
                continue
            left = stripes[pos - 1] if pos > 0 else None
            right = stripes[pos + 1] if pos + 1 < len(stripes) else None
            jb_in = t - s.kb0
            if left is not None and lo <= jb_in <= hi:
                if left.local:
                    event = ready.pop((s.index, jb_in))
                    if event is not None:
                        s.stream.wait_event(event)
                else:
                    _recv(s.state.cf[jb_in], s, left.rank,
                          left.index * dims.n_jb + jb_in)
            with s.on_stream():
                sweep(s.arrs, s.state, bk.tile_index(dims, t, lo),
                      hi - lo + 1)
            jb_out = t - (s.kb1 - 1)
            if right is None or not lo <= jb_out <= hi:
                continue
            face = s.state.cf[jb_out]
            if not right.local:
                _send(face, s, right.rank, s.index * dims.n_jb + jb_out,
                      works, keep)
                continue
            dst = right.state.cf[jb_out]
            if not s.cuda:
                dst.copy_(face)
                ready[(right.index, jb_out)] = None
                continue
            copier = s.copy_stream or s.stream
            if copier is not s.stream:
                copier.wait_stream(s.stream)
            with s.on_stream(copier):
                dst.copy_(face, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copier)
            ready[(right.index, jb_out)] = event
    for s in mine:
        if s.cuda:
            here = torch.cuda.current_stream(s.device)
            here.wait_stream(s.stream)
            if s.copy_stream is not None:
                here.wait_stream(s.copy_stream)
    for w in works:
        w.wait()
    return stripes


def from_owner(stripes: Sequence[Stripe], owner: Stripe, value: Callable,
               shape: tuple = (NUM_MATRICES,)) -> torch.Tensor:
    """``value(owner.state)``, an int32 tensor of ``shape``, as a CPU tensor
    in every process: read where the owner lives and broadcast from there
    when the stripes span processes."""
    out = value(owner.state).cpu() if owner.local else \
        torch.empty(shape, dtype=torch.int32)
    if len({s.rank for s in stripes}) > 1:
        dist.broadcast(out, owner.rank)
    return out


# --------------------------------------------------------------- the score


def sweep_stripes(a, b, c, scoring: Scoring, row: Sequence[dmesh.Slot],
                  block_shape: Optional[Tuple[int, int]] = None,
                  overlap: Optional[bool] = None):
    """Sweep one triplet (|A|, |B|, |C| >= 1) in stripes over the slots
    ``row`` on K3's per-tile form; (dims, stripes), the stripes of this
    process carrying their ``blocked.BlockedState``."""
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) < 1:
        raise ValueError("the halo needs |A|, |B|, |C| >= 1")
    hb, wc = block_shape or choose_halo_shape(la, lb, lc, len(row))
    if overlap is None:
        overlap = bool(halo_efficiency(la, lb, lc, len(row),
                                       (hb, wc))["overlap"])
    dims = bk.plan_dims(la, lb, lc, hb, wc)

    def start(device):
        return (bk.prep_blocked(a, b, c, dims, device),
                bk.new_state(dims, device))

    def sweep(arrs, state, idx0, count):
        bk.sweep_tiles(*arrs, la, lb, lc, dims, state, idx0, count, scoring)

    return dims, run_stripes(dims, row, overlap, start, sweep)


def halo_values(a, b, c, scoring: Scoring = Scoring(),
                mesh: Optional[dmesh.Mesh] = None,
                block_shape: Optional[Tuple[int, int]] = None,
                overlap: Optional[bool] = None) -> torch.Tensor:
    """The seven final values of one triplet (|A|, |B|, |C| >= 1) swept in
    stripes over the mesh's model axis, a (7,) int32 CPU tensor in every
    process, equal to ``blocked.final_values``'s at the same tile plane."""
    row = model_row(mesh if mesh is not None else _default_mesh())
    _, stripes = sweep_stripes(a, b, c, scoring, row, block_shape, overlap)
    return from_owner(stripes, stripes[-1], lambda st: st.out[0])


def _default_mesh() -> dmesh.Mesh:
    """The reference's default: every device on the model axis."""
    return dmesh.make_mesh(data=1,
                           model=max(1, len(dmesh.global_devices())))


def align_sharded_triplet(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    mesh: Optional[dmesh.Mesh] = None,
    block_shape: Optional[Tuple[int, int]] = None,
    overlap: Optional[bool] = None,
    return_alignment: bool = False,
):
    """Optimal score of one triplet with its tile grid split into stripes
    over the mesh's 'model' axis, column faces handed from stripe to
    stripe.

    ``mesh`` defaults to every device on the model axis; ``block_shape`` is
    the tile plane (hb, wc), :func:`choose_halo_shape`'s by default;
    ``overlap`` True copies a handed face on a copy stream under the next
    diagonal, False on the stripe's own stream, None lets
    :func:`halo_efficiency` choose.  ``return_alignment`` True returns
    (score, rows) from ``dist.halo_tb.hirschberg_align_sharded`` on the same
    mesh, tile plane and schedule (the reference drops the last two,
    halo.py:349-354).  There is no ``interpret``: the mesh's devices say
    where the stripes run, and a CPU device runs the kernels' plain
    versions."""
    if return_alignment:
        from trialign_torch.dist.halo_tb import hirschberg_align_sharded

        return hirschberg_align_sharded(a, b, c, scoring, mesh=mesh,
                                        block_shape=block_shape,
                                        overlap=overlap)
    if min(len(a), len(b), len(c)) == 0:
        return 0
    return int(halo_values(a, b, c, scoring, mesh, block_shape,
                           overlap).max())
