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

* Its device d sweeps one block row a step, one block a call, and passes
  the row's column face on (halo.py:228-261).  Here a step is a band of R
  tile rows: stripe d sweeps rows [r R, (r + 1) R) of its columns in one
  persistent launch of K3's per-tile form (``blocked.sweep_run``, global
  tile indices, so borders, symbols and the target tile are the whole
  sweep's), then hands the band's R column faces on at once.  Band r of
  stripe d starts after its band r - 1 (stream order) and after stripe
  d - 1 handed it band r's faces (an event, or a message from another
  process); neither neighbour is waited on inside a kernel.  Each band
  ends with a whole pillar, so R trades the pipeline's fill against those
  drains: :func:`halo_efficiency` picks it.  One stripe is one band.
* Its stripes pad the tile columns to a multiple of the stripe count
  (halo.py:193-199).  Here columns split unevenly, and a stripe may get
  none when there are more stripes than columns.
* Its ``psum`` gathers the final vector, which only the stripe holding the
  last tile writes.  Here that stripe's vector is the result, broadcast to
  the other processes when the axis spans several.

Each stripe keeps a full-size state on its own device (the face slabs of
every column and row, of which it writes its own) and runs on a CUDA stream
of its own, waiting on one event per band of faces it is handed.
``overlap`` picks the schedule: True copies the faces on a copy stream
while the stripe sweeps its next band, False copies them on the stripe's
own stream.  Both give the same score.  The copy is made even when both
stripes share a card, so that one card runs the handoff as several would;
each launch sizes its grid to the whole card all the same.  A stripe whose
neighbour lives in another process
sends the faces through a pinned host buffer (``gloo``; ``dist/mesh.py``
says why not ``nccl``).

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

# The persistent schedule's tile-plane step on a full card: K3 on its
# earlier shared-memory pillar, since deleted, swept 1024^3 (1024 tiles of
# 1088 planes) in 23.16703987121582 ms with RESIDENT blocks at once
# (PERF.md section 6, chip_smoke.py timings, NVIDIA H100 80GB HBM3 at
# 700 W).  K3 and K5 now sweep on the register step, K3 1024^3 in 12.29
# ms: the stripes of both share this model, not refitted (PERF.md section
# 7).
RESIDENT = 264  # two blocks of the 33 x 33 plane on each of 132 SMs
STEP_S = 23.16703987121582e-3 * RESIDENT / (1024 * 1088)
# Planes a tile trails its upper or left neighbour: fitted to K3 at 512^3
# (256 tiles, all resident: 576 planes and 30 diagonals of lag in
# 7.86243200302124 ms, the same run).
LAG = (7.86243200302124e-3 / STEP_S - 576) / 30
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


def bands(n_jb: int, band_rows: int) -> List[Tuple[int, int]]:
    """Tile rows [r0, r1) of each band of ``band_rows`` rows (the last one
    may be shorter)."""
    return [(r0, min(r0 + band_rows, n_jb))
            for r0 in range(0, n_jb, band_rows)]


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


def launch_seconds(rows: int, cols: int, nq: int) -> float:
    """The model's time of one persistent launch over a rectangle of
    ``rows`` x ``cols`` tiles of ``nq`` planes on a card of its own: the
    last tile's pillar after rows + cols - 2 lags, or the card's step rate
    when more tiles than it holds at once keep it full."""
    return max(nq + (rows + cols - 2) * LAG,
               rows * cols * nq / RESIDENT) * STEP_S


def _pipeline_seconds(n_jb: int, cols, nq: int, band_rows: int,
                      face_s: float, overlap: bool) -> float:
    """The model's wall time of the stripes ``cols``, each on a card of its
    own, in bands: a band starts after the stripe's band before it (and, in
    the tight schedule, that band's handoff) and after the left stripe's
    faces for it arrive; handoffs on one copy stream go one after another."""
    handed = [0.0] * len(bands(n_jb, band_rows))
    wall = 0.0
    for pos, (k0, k1) in enumerate(cols):
        last = pos == len(cols) - 1
        free = copier = 0.0
        arrive = []
        for r, (r0, r1) in enumerate(bands(n_jb, band_rows)):
            end = max(free, handed[r]) + launch_seconds(r1 - r0, k1 - k0, nq)
            free = end
            if not last:
                copier = max(copier, end) + (r1 - r0) * face_s
                arrive.append(copier)
                if not overlap:
                    free = copier
        handed = arrive
        wall = max(wall, free)
    return wall


def halo_efficiency(la: int, lb: int, lc: int, ndev: int,
                    block_shape: Optional[Tuple[int, int]] = None,
                    overlap: Optional[bool] = None,
                    copy_bytes_per_s: Optional[float] = None,
                    band_rows: Optional[int] = None) -> dict:
    """Model of a halo over ``ndev`` stripes, each on a card of its own, as
    :func:`align_sharded_triplet` runs it: uneven columns, one launch a
    stripe and band (:func:`launch_seconds`), a band's faces handed at each
    boundary at ``copy_bytes_per_s`` (``FACE_COPY_BYTES_PER_S`` by default,
    nrows x 7 x hb int32 a face).

    Returns {'pipeline': one card's modelled time over ndev times the
    stripes' time without handoffs, 'j_fill', 'k_fill': real over swept
    cells, 'transfer': the time without handoffs over the time with them,
    'overlap', 'band': the band's tile rows, 'seconds', 'total': the product
    of the four shares}.  ``band_rows`` None takes the band with the least
    modelled time (the larger one of equal times; all rows for one stripe);
    ``overlap`` None models both schedules and returns the better."""
    if overlap is None:
        return max((halo_efficiency(la, lb, lc, ndev, block_shape, ov,
                                    copy_bytes_per_s, band_rows)
                    for ov in (True, False)),
                   key=lambda e: e["total"])
    hb, wc = block_shape or choose_halo_shape(la, lb, lc, ndev)
    dims = bk.grid_dims(max(la, 1), max(lb, 1), max(lc, 1), hb, wc)
    n_jb, n_kb, nq = dims.n_jb, dims.n_kb, dims.nq
    face_s = dims.nrows * NUM_MATRICES * hb * 4 / (copy_bytes_per_s or
                                                   FACE_COPY_BYTES_PER_S)
    cols = [c for c in stripe_columns(n_kb, ndev) if c[1] > c[0]]
    if band_rows is None:
        band_rows = n_jb if len(cols) == 1 else min(
            range(n_jb, 0, -1), key=lambda r: _pipeline_seconds(
                n_jb, cols, nq, r, face_s, overlap))
    wall = _pipeline_seconds(n_jb, cols, nq, band_rows, face_s, overlap)
    compute = _pipeline_seconds(n_jb, cols, nq, band_rows, 0.0, overlap)
    pipeline = launch_seconds(n_jb, n_kb, nq) / (ndev * compute)
    transfer = compute / wall
    j_fill = lb / (n_jb * (hb - 1))
    k_fill = lc / (n_kb * (wc - 1))
    return {"pipeline": pipeline, "j_fill": j_fill, "k_fill": k_fill,
            "transfer": transfer, "overlap": overlap, "band": band_rows,
            "seconds": wall, "total": pipeline * j_fill * k_fill * transfer}


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
                start: Callable, sweep: Callable,
                band_rows: Optional[int] = None) -> List[Stripe]:
    """Sweep the tile grid of ``dims`` in stripes over the slots ``row``
    (one stripe a slot, columns by :func:`stripe_columns`), each in bands of
    ``band_rows`` tile rows (all rows by default).

    ``start(device)`` returns (symbol arrays, state) on a device, the state
    a NamedTuple with a ``cf`` field (n_jb, nrows, 7, hb);
    ``sweep(arrs, state, tiles)`` runs the list ``tiles`` of (jb, kb), a
    band of the stripe in ``blocked.rect_tiles`` order, with a per-tile
    form (``sweep_run``).  Returns the stripes that hold
    columns, in order; those of this process carry their state.  On return
    the current stream of every local device has waited for every stripe
    and copy, so results read there are complete."""
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
    rows = bands(dims.n_jb, band_rows or dims.n_jb)
    ready = {}          # (receiving stripe, band) -> event or None (done)
    works, keep = [], []
    for r, (r0, r1) in enumerate(rows):
        for pos, s in enumerate(stripes):
            if not s.local:
                continue
            left = stripes[pos - 1] if pos > 0 else None
            right = stripes[pos + 1] if pos + 1 < len(stripes) else None
            if left is not None:
                if left.local:
                    event = ready.pop((s.index, r))
                    if event is not None:
                        s.stream.wait_event(event)
                else:
                    _recv(s.state.cf[r0:r1], s, left.rank,
                          left.index * len(rows) + r)
            with s.on_stream():
                sweep(s.arrs, s.state, bk.rect_tiles((r0, r1),
                                                     (s.kb0, s.kb1)))
            if right is None:
                continue
            faces = s.state.cf[r0:r1]
            if not right.local:
                _send(faces, s, right.rank, s.index * len(rows) + r, works,
                      keep)
                continue
            dst = right.state.cf[r0:r1]
            if not s.cuda:
                dst.copy_(faces)
                ready[(right.index, r)] = None
                continue
            copier = s.copy_stream or s.stream
            if copier is not s.stream:
                copier.wait_stream(s.stream)
            with s.on_stream(copier):
                dst.copy_(faces, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copier)
            ready[(right.index, r)] = event
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
                  overlap: Optional[bool] = None,
                  band_rows: Optional[int] = None):
    """Sweep one triplet (|A|, |B|, |C| >= 1) in stripes over the slots
    ``row`` on K3's per-tile form, in bands of ``band_rows`` tile rows;
    (dims, stripes), the stripes of this process carrying their
    ``blocked.BlockedState``.  ``overlap`` and ``band_rows`` None take
    :func:`halo_efficiency`'s."""
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) < 1:
        raise ValueError("the halo needs |A|, |B|, |C| >= 1")
    hb, wc = block_shape or choose_halo_shape(la, lb, lc, len(row))
    if overlap is None or band_rows is None:
        model = halo_efficiency(la, lb, lc, len(row), (hb, wc), overlap,
                                band_rows=band_rows)
        overlap, band_rows = model["overlap"], model["band"]
    dims = bk.plan_dims(la, lb, lc, hb, wc)

    def start(device):
        return (bk.prep_blocked(a, b, c, dims, device),
                bk.new_state(dims, device))

    def sweep(arrs, state, tiles):
        bk.sweep_run(*arrs, la, lb, lc, dims, state, tiles, scoring)

    return dims, run_stripes(dims, row, overlap, start, sweep, band_rows)


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
    ``overlap`` True copies a band's handed faces on a copy stream under the
    next band, False on the stripe's own stream, None lets
    :func:`halo_efficiency` choose, as it chooses the band's rows.
    ``return_alignment`` True returns (score, rows) from
    ``dist.halo_tb.hirschberg_align_sharded`` on the same mesh, tile plane
    and schedule (the reference drops the last two, halo.py:349-354).
    There is no ``interpret``: the mesh's devices say where the stripes
    run, and a CPU device runs the kernels' plain versions."""
    if return_alignment:
        from trialign_torch.dist.halo_tb import hirschberg_align_sharded

        return hirschberg_align_sharded(a, b, c, scoring, mesh=mesh,
                                        block_shape=block_shape,
                                        overlap=overlap)
    if min(len(a), len(b), len(c)) == 0:
        return 0
    return int(halo_values(a, b, c, scoring, mesh, block_shape,
                           overlap).max())
