"""The slab sweep (K5): the blocked sweep with capture of the plane i = |A|.

Port of ``trialign/kernels/slab.py``.  Above the direct engine's cap the
Hirschberg top split needs three full-cuboid sweeps (traceback/hirschberg.py):
a forward sweep that captures the 7-state plane i = m, a backward sweep that
gives the matching suffix slab, and a ``free_jk`` guard sweep.  The TPU ran
them in ``make_slab_grid_call`` (``_slab_sweep``); here they run in
``csrc/slab.cu``, K3's tiled sweep plus the capture, the whole grid in one
persistent launch (``blocked.planes_needed`` says when a tile may go on).
Variants, as in the reference:

* ``free``: zero borders, the score sweep's semantics;
* ``free_jk``: zero j = 0 / k = 0 faces, a NEG wall at i = 0;
* ``pin``: the origin holds the start vector v0, every face is a NEG wall
  and face cells are computed;
* ``bwd``: the backward sweep over reversed inputs, keyed by source state,
  with the end vector at the (reversed) origin.

Every captured cell equals the NumPy engine (traceback/engine.py) bit for
bit.  The host side is the reference's: :func:`_plan`, ``prep_blocked`` (from
kernels/blocked.py), :func:`_scal_table`, :func:`_assemble`,
:func:`_combine_caps` (the F + G argmax on the device, in torch),
:func:`forward_slab_blocked_async`, :func:`backward_slab_blocked_async` and
:func:`split_point_blocked_async`; each ``*_async`` function enqueues its work
on ``device`` and returns a fetch closure.  On a CUDA tensor
:func:`slab_sweep` launches K5; on a CPU tensor it runs :func:`slab_ref`,
the plain torch version of the same tiles, faces and capture in the run's
order.

The sweep state (:class:`SlabState`) stays on the device between launches,
so :func:`sweep_tiles` runs any run of the tile table with global tile
indices, and :func:`sweep_run` any list of tiles whose neighbours come first
(a band of a stripe's rows): K5's per-tile form, the port of
``make_slab_block_call``, on which the stripes of ``dist/halo_tb.py`` run,
one persistent launch a call as K3's (``kernels/blocked.py``).
:func:`slab_sweep` computes the same state over the whole table in one
launch.  :func:`sweep_diagonals` keeps the per-tile form's earlier design,
one launch a run of one anti-diagonal, for ``chip_smoke.py`` to compare.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from trialign_torch import _build
from trialign_torch.config import CONSUMES, NUM_MATRICES, Scoring
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels.blocked import Dims, prep_blocked
from trialign_torch.kernels.plane_math import (
    PLANE_DELTA, SHIFTS, target_update, transition_groups,
)
from trialign_torch.kernels.ref import pair_fn, substitution
from trialign_torch.metrics import span
from trialign_torch.traceback.engine import NEG

VARIANTS = {"free": 0, "free_jk": 1, "pin": 2, "bwd": 3}
# Largest submatrix K5 takes (csrc/slab.cu kSlabMaxSym): every alphabet
# Scoring accepts, as the reference's slab kernel takes any of them.
SUBMATRIX_NSYM_CAP = 16
# Columns of one row of the per-block scalar table (csrc/slab.cu kScalCols).
SCAL_COLS = 16
# A face or capture entry the sweep never wrote; large, so that a read of
# one shows in a max.
_UNWRITTEN = 1 << 28


def shared_bytes(hb: int, wc: int) -> int:
    """Shared memory a tile's thread block takes, as csrc/slab.cu counts it:
    25 ring planes with a guard row and column, the tile's B and C symbols
    and the 17 x 17 submatrix table."""
    return 4 * (25 * (hb + 1) * (wc + 1) + hb + wc
                + (SUBMATRIX_NSYM_CAP + 1) ** 2)


def _plan(la: int, lb: int, lc: int,
          block_shape: Optional[Tuple[int, int]] = None) -> Dims:
    """Tile geometry of one slab sweep: K3's tile plane (or ``block_shape``,
    (hb, wc)); raises ValueError for a tile the card cannot hold."""
    hb, wc = block_shape or bk.choose_block_shape(la, lb, lc)
    if shared_bytes(hb, wc) > bk.SMEM_CAP:
        raise ValueError(
            f"slab tile plane {hb}x{wc} needs {shared_bytes(hb, wc)} bytes "
            f"of shared memory; a block has {bk.SMEM_CAP}"
        )
    return bk.plan_dims(la, lb, lc, hb, wc)


def _scal_table(la: int, lb: int, lc: int, ev, dims: Dims) -> np.ndarray:
    """(n_blocks, 16) int32 rows (la, jb, kb, qstar, jlstar, klstar,
    ev[0..6], row-face slab, column-face slab, pad), row jb * n_kb + kb.
    The final-vector target is the tile holding (lb, lc) (which may be 0,
    as in the direct engine's sweeps); qstar, jlstar and klstar are -1
    elsewhere."""
    tb, tc = dims.hb - 1, dims.wc - 1
    n_blocks = dims.n_jb * dims.n_kb
    jbstar, kbstar = max(lb - 1, 0) // tb, max(lc - 1, 0) // tc
    jlstar, klstar = lb - jbstar * tb, lc - kbstar * tc
    idx = np.arange(n_blocks)
    jbs, kbs = idx // dims.n_kb, idx % dims.n_kb
    is_t = idx == jbstar * dims.n_kb + kbstar
    scal = np.zeros((n_blocks, SCAL_COLS), np.int32)
    scal[:, 0] = la
    scal[:, 1] = jbs
    scal[:, 2] = kbs
    scal[:, 3] = np.where(is_t, la + jlstar + klstar, -1)
    scal[:, 4] = np.where(is_t, jlstar, -1)
    scal[:, 5] = np.where(is_t, klstar, -1)
    scal[:, 6:13] = np.asarray(ev, np.int32)[None, :]
    scal[:, 13] = kbs  # row-face slab: the tile column
    scal[:, 14] = jbs  # column-face slab: the tile row
    return scal


def _shifted(x: torch.Tensor, dj: int, dk: int, hb: int, wc: int):
    """The (hb, wc) view of a guarded plane whose (jl, kl) entry is the
    plane's value at (jl - dj, kl - dk); the guard row and column hold the
    value outside the tile's first row or column."""
    return x[..., 1 - dj : 1 - dj + hb, 1 - dk : 1 - dk + wc]


class SlabState(NamedTuple):
    """What a slab sweep carries from tile to tile, on its device: the face
    slabs, the final vector, every tile's capture and the per-tile scalar
    table the kernel reads (:func:`_scal_table`, which holds ``ev``).
    Entries that no tile has written hold ``_UNWRITTEN``."""

    rf: torch.Tensor    # (n_kb, nrows, 7, wc) int32 row faces
    cf: torch.Tensor    # (n_jb, nrows, 7, hb) int32 column faces
    out: torch.Tensor   # (7,) int32 final vector (forward variants)
    cap: torch.Tensor   # (n_jb * n_kb, 7, hb, wc) int32 capture at i = |A|
    scal: torch.Tensor  # (n_jb * n_kb, SCAL_COLS) int32


def new_state(la: int, lb: int, lc: int, dims: Dims, ev,
              device) -> SlabState:
    """A fresh slab sweep state on ``device``; ``ev`` is the origin vector
    of "pin" and "bwd" (ignored by "free" and "free_jk")."""
    i32 = dict(dtype=torch.int32, device=device)
    n_blocks = dims.n_jb * dims.n_kb
    return SlabState(
        torch.full((dims.n_kb, dims.nrows, NUM_MATRICES, dims.wc), _UNWRITTEN,
                   **i32),
        torch.full((dims.n_jb, dims.nrows, NUM_MATRICES, dims.hb), _UNWRITTEN,
                   **i32),
        torch.full((NUM_MATRICES,), _UNWRITTEN, **i32),
        torch.full((n_blocks, NUM_MATRICES, dims.hb, dims.wc), _UNWRITTEN,
                   **i32),
        torch.from_numpy(_scal_table(la, lb, lc, ev, dims)).to(device),
    )


def pillar_steps(a_ext, b_ext, c_ext, la: int, dims: Dims, variant: str,
                 state: SlabState, blks: np.ndarray,
                 scoring: Scoring = Scoring()) -> Iterator[int]:
    """The pillars of tiles ``blks`` (rows jb * n_kb + kb of the scalar
    table) swept together on ``state`` in place, as the kernel sweeps one
    tile: a generator that runs each local plane q from the variant's first
    (0 for "pin" and "bwd", else 1) to ``dims.nq`` and yields q after it.
    The tiles' faces must be ready for each plane before it runs
    (``blocked.planes_needed``)."""
    dev = a_ext.device
    rf, cf, out, cap, scal_t = state
    scal = scal_t.cpu().numpy()
    hb, wc = dims.hb, dims.wc
    tb, tc = hb - 1, wc - 1
    fwd = variant != "bwd"
    walls = variant in ("pin", "bwd")
    w = scoring.weight_matrix()
    groups = transition_groups(w if fwd else np.ascontiguousarray(w.T))
    pair = pair_fn(scoring, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    negt = torch.tensor(NEG, **i32)
    zero = torch.tensor(0, **i32)
    jl = torch.arange(hb, device=dev).view(hb, 1)
    kl = torch.arange(wc, device=dev).view(1, wc)
    jk = jl + kl
    ilo = 0 if walls else 1
    nq = la + tb + tc

    n = len(blks)
    jbs = torch.from_numpy(blks // dims.n_kb).to(dev)
    kbs = torch.from_numpy(blks % dims.n_kb).to(dev)
    blk_t = torch.from_numpy(blks).to(dev)
    # The face slabs each tile reads and writes (scal columns 13, 14).
    rsl = torch.from_numpy(scal[blks, 13].astype(np.int64)).to(dev)
    csl = torch.from_numpy(scal[blks, 14].astype(np.int64)).to(dev)
    ev_t = torch.from_numpy(scal[blks, 6:13]).to(dev).view(
        n, NUM_MATRICES, 1, 1)
    jbv, kbv = jbs.view(n, 1, 1), kbs.view(n, 1, 1)
    bsym = b_ext[jbs.view(n, 1) * tb + jl.view(1, hb)].view(n, hb, 1)
    csym = c_ext[kbs.view(n, 1) * tc + kl.view(1, wc)].view(n, 1, wc)
    s_bc = pair(bsym, csym)
    gj, gk = jbv * tb + jl, kbv * tc + kl
    border = (gj == 0) | (gk == 0)
    row_face = (jl == 0) & (jbv > 0)
    col_face = ~row_face & (kl == 0) & (kbv > 0)
    zero_face = ((jl == 0) | (kl == 0)) & ~row_face & ~col_face & \
        (not walls)
    origin = (jl == 0) & (kl == 0) & (jbv == 0) & (kbv == 0) & walls
    tgt = [p for p in range(n) if scal[blks[p], 3] >= 0]

    # Guarded ring: 3 slots of 7 planes and 4 slots of one plane (max7
    # forward, the M row backward), all at the value below plane 1.
    if variant == "free":
        init = torch.zeros((n, hb, wc), **i32)
    elif variant == "free_jk":
        init = torch.where(border, zero, negt)
    else:
        init = torch.full((n, hb, wc), NEG, **i32)
    ring = torch.full((3, n, NUM_MATRICES, hb + 1, wc + 1), NEG, **i32)
    ring[:, :, :, 1:, 1:] = init[None, :, None]
    m4 = torch.full((4, n, hb + 1, wc + 1), NEG, **i32)
    m4[:, :, 1:, 1:] = init[None]

    for q in range(ilo, nq + 1):
        i = q - jk
        active = (i >= ilo) & (i <= la)
        if not bool(active.any()):
            yield q
            continue
        ai = a_ext[i.clamp(0, la)]
        subs = substitution(ai, bsym, csym, s_bc, scoring, pair)
        p1, p2 = ring[(q - 1) % 3], ring[(q - 2) % 3]
        m3 = m4[(q - 3) % 4]
        if fwd:
            cands = []
            for t in range(NUM_MATRICES):
                dj, dk = SHIFTS[t]
                if PLANE_DELTA[t] == 3:
                    cand = _shifted(m3, dj, dk, hb, wc)
                else:
                    src = (p1, p2)[PLANE_DELTA[t] - 1]
                    preds = [_shifted(src[:, s], dj, dk, hb, wc)
                             for s in range(NUM_MATRICES)]
                    cand = target_update(preds, groups[t], torch.maximum)
                cands.append(cand + subs[t])
            new = torch.maximum(torch.stack(cands, 1), negt)
            if variant == "pin":
                for t, (ca, cb, cc) in enumerate(CONSUMES):
                    ok = (i >= ca) & (gj >= cb) & (gk >= cc)
                    new[:, t] = torch.where(ok, new[:, t], negt)
        else:
            s3, _, _, _, s_ab, s_bc_, s_ac = subs
            e = [
                _shifted(m3, 1, 1, hb, wc) + s3,
                _shifted(p1[:, 1], 0, 0, hb, wc),
                _shifted(p1[:, 2], 1, 0, hb, wc),
                _shifted(p1[:, 3], 0, 1, hb, wc),
                _shifted(p2[:, 4], 1, 0, hb, wc) + s_ab,
                _shifted(p2[:, 5], 1, 1, hb, wc) + s_bc_,
                _shifted(p2[:, 6], 0, 1, hb, wc) + s_ac,
            ]
            new = torch.maximum(torch.stack(
                [target_update(e, groups[t], torch.maximum)
                 for t in range(NUM_MATRICES)], 1), negt)

        rowv = rf[rsl, q].view(n, NUM_MATRICES, 1, wc)
        colv = cf[csl, q].view(n, NUM_MATRICES, hb, 1)
        new = torch.where(row_face[:, None], rowv, new)
        new = torch.where(col_face[:, None], colv, new)
        new = torch.where(zero_face[:, None], zero, new)
        new = torch.where((origin & (i == 0))[:, None], ev_t, new)

        on = active.view(1, 1, hb, wc)
        cur = ring[q % 3][:, :, 1:, 1:]
        cur.copy_(torch.where(on, new, cur))
        m = new.max(1).values if fwd else new[:, 0]
        mcur = m4[q % 4][:, 1:, 1:]
        mcur.copy_(torch.where(active, m, mcur))
        if q - tb >= 0:
            old = rf[rsl, q - tb]
            rf[rsl, q - tb] = torch.where(active[tb].view(1, 1, wc),
                                          new[:, :, tb, :], old)
        if q - tc >= 0:
            old = cf[csl, q - tc]
            cf[csl, q - tc] = torch.where(active[:, tc].view(1, 1, hb),
                                          new[:, :, :, tc], old)
        hit = (i == la).view(1, 1, hb, wc)
        cap[blk_t] = torch.where(hit, new, cap[blk_t])
        for p in tgt:
            if fwd and q == int(scal[blks[p], 3]):
                out.copy_(new[p, :, int(scal[blks[p], 4]),
                              int(scal[blks[p], 5])])
        yield q


def slab_ref(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
             variant: str, ev, scoring: Scoring = Scoring(),
             state: Optional[SlabState] = None, idx0: int = 0,
             count: Optional[int] = None, tiles=None):
    """Plain torch version of K5: sweeps tiles idx0 .. idx0 + count - 1 of
    ``blocked.tile_table`` (all by default), or the list ``tiles`` in its
    order (each tile's neighbours swept before it), from ``state`` (a fresh
    one with origin vector ``ev`` by default; ``ev`` is ignored when a state
    is given), updating it in place, and returns its (final (7,), cap
    (n_blocks, 7, hb, wc)), both int32 on the inputs' device.

    The same tile schedule, guarded plane ring, face slabs, categories of
    position (row face, column face, zero face, origin, step) and capture
    as the kernel, read from the same scalar table; consecutive tiles of one
    anti-diagonal go as one batch (:func:`pillar_steps`).  Tile indices are
    global, so a run may be any part of the grid (a stripe's band of tile
    rows, a segment that ends mid-diagonal)."""
    dev = a_ext.device
    if state is None:
        state = new_state(la, lb, lc, dims, ev, dev)
    if tiles is None:
        tiles = bk.table_run(dims, idx0, bk.n_tiles(dims) - idx0
                             if count is None else count)
    for group in bk.diagonal_groups(tiles):
        blks = np.array([jb * dims.n_kb + kb for jb, kb in group])
        for _ in pillar_steps(a_ext, b_ext, c_ext, la, dims, variant, state,
                              blks, scoring):
            pass
    return state.out, state.cap


def _check(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
           variant: str, variants=VARIANTS, least: int = 1) -> None:
    """Raises ValueError unless the inputs are ``prep_blocked``'s for
    ``dims``, planned for |A|, |B|, |C| >= ``least`` (and one symbol at
    least), under one of ``variants``."""
    if variant not in variants:
        raise ValueError(f"variant must be one of {tuple(variants)}")
    if min(la, lb, lc) < least or la + lb + lc < 1:
        raise ValueError(f"the slab sweep needs |A|, |B|, |C| >= {least}")
    if dims != bk.plan_dims(la, lb, lc, dims.hb, dims.wc):
        raise ValueError(f"dims {dims} were not planned for {la, lb, lc}")
    if shared_bytes(dims.hb, dims.wc) > bk.SMEM_CAP:
        raise ValueError(f"tile plane {dims.hb}x{dims.wc} is too large")
    tb, tc = dims.hb - 1, dims.wc - 1
    for t, n in ((a_ext, la + 1), (b_ext, dims.n_jb * tb + 1),
                 (c_ext, dims.n_kb * tc + 1)):
        if t.dtype != torch.int32 or t.shape != (n,) or \
                not t.is_contiguous() or t.device != a_ext.device:
            raise ValueError(
                "a, b, c must be contiguous int32 vectors on one device, "
                "shaped as prep_blocked makes them"
            )


def _check_state(state: SlabState, dims: Dims, device) -> None:
    n_blocks = dims.n_jb * dims.n_kb
    shapes = ((dims.n_kb, dims.nrows, NUM_MATRICES, dims.wc),
              (dims.n_jb, dims.nrows, NUM_MATRICES, dims.hb),
              (NUM_MATRICES,), (n_blocks, NUM_MATRICES, dims.hb, dims.wc),
              (n_blocks, SCAL_COLS))
    for t, shape in zip(state, shapes):
        if t.dtype != torch.int32 or t.shape != shape or \
                not t.is_contiguous() or t.device != device:
            raise ValueError("the state must be new_state(dims)'s, on the "
                             "device of the symbol arrays")


def _persistent(counter, a_ext, b_ext, c_ext, la, lb, lc, dims, variant,
                state, tiles, scoring, chunk, blocks) -> SlabState:
    """``tiles`` (None: the whole table) on ``state``: slab_ref on a CPU
    tensor; on a CUDA tensor one persistent launch of K5, counted on
    ``counter``, which raises if refused and never falls back."""
    bk.check_schedule(chunk, blocks)
    dev = a_ext.device
    _check_state(state, dims, dev)
    run = None if tiles is None else bk.run_table(dims, tiles)
    if run is not None and not len(run):
        return state
    if dev.type == "cpu":
        slab_ref(a_ext, b_ext, c_ext, la, lb, lc, dims, variant, None,
                 scoring, state, tiles=tiles)
        return state
    if dev.type != "cuda":
        raise ValueError(f"no slab kernel for device {dev}")
    _launch(counter, "k5", run_cells(la, lb, lc, dims, run), dims, run,
            scoring, dev, lambda lib, step, table, work, stream:
            lib.trialign_slab_sweep(
                a_ext.data_ptr(), b_ext.data_ptr(), c_ext.data_ptr(),
                _geom(dims, la, variant), work.run, work.ntiles,
                state.scal.data_ptr(), table.data_ptr(), step,
                state.rf.data_ptr(), state.cf.data_ptr(),
                state.out.data_ptr(), state.cap.data_ptr(), chunk,
                blocks or 0, work.next_tile, work.done, stream))
    return state


def run_cells(la: int, lb: int, lc: int, dims: Dims, run) -> int:
    """The cells (|A| times the (j, k) columns) that a sweep of ``run``
    (a :func:`blocked.run_table`; None: the whole tile table) computes."""
    if run is None:
        return la * lb * lc
    tb, tc = dims.hb - 1, dims.wc - 1
    jb, kb = run[:, 0].astype(np.int64), run[:, 1].astype(np.int64)
    return la * int((np.minimum(tb, lb - jb * tb)
                     * np.minimum(tc, lc - kb * tc)).sum())


def _launch(counter, kernel: str, cells: int, dims: Dims, run,
            scoring: Scoring, device, call) -> None:
    """One persistent launch of csrc/slab.cu on ``device`` over ``run``
    (None: the whole tile table): ``call(lib, step, table, work, stream)``
    makes it and returns its code; a refused launch raises, and nothing
    falls back.  Counted on ``counter``: one launch and its ``cells``.
    ``kernel`` names its spans ("k5" or "choices")."""
    with torch.cuda.device(device):
        with span(kernel + ".pack"):
            lib = _build.load("slab")
            step, table = _build.kernel_scoring(scoring, 0, device,
                                                SUBMATRIX_NSYM_CAP)
            work = bk.launch_work(dims, run, device)
        with span(kernel + ".launch"):
            code = call(lib, step, table, work,
                        torch.cuda.current_stream().cuda_stream)
        _build.check(lib, code, f"{kernel} kernel launch")
        counter.launches += 1
        counter.cells += cells


def _geom(dims: Dims, la: int, variant: str):
    return _build.SlabGeom(la, dims.hb, dims.wc, dims.n_jb, dims.n_kb,
                           dims.nrows, VARIANTS[variant])


def sweep_tiles(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
                variant: str, state: SlabState, idx0: int, count: int,
                scoring: Scoring = Scoring(), chunk: int = bk.CHUNK,
                blocks: Optional[int] = None) -> SlabState:
    """The per-tile form (slab.py make_slab_block_call): runs tiles idx0 ..
    idx0 + count - 1 of ``blocked.tile_table`` on ``state`` (from
    :func:`new_state`) in place and returns it.  A run may end in the
    middle of an anti-diagonal; tile indices stay global.
    :func:`sweep_run` of those tiles: on a CUDA tensor one persistent launch
    of K5 (``chunk`` and ``blocks`` as :func:`slab_sweep`), which never
    falls back.  Nothing waits for the card."""
    return sweep_run(a_ext, b_ext, c_ext, la, lb, lc, dims, variant, state,
                     bk.table_run(dims, idx0, count), scoring, chunk, blocks)


def sweep_run(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
              variant: str, state: SlabState, tiles, scoring: Scoring =
              Scoring(), chunk: int = bk.CHUNK,
              blocks: Optional[int] = None) -> SlabState:
    """The per-tile form over the list ``tiles`` of (jb, kb), as
    ``blocked.sweep_run``: each tile's neighbours in the list come before
    it, every other neighbour was swept on ``state`` by work the current
    stream has waited for.  On a CPU tensor this is :func:`slab_ref` in the
    list's order; on a CUDA tensor one persistent launch of K5, counted on
    ``sweep_tiles.launches``, which raises if refused and never falls back.
    An empty list launches nothing."""
    _check(a_ext, b_ext, c_ext, la, lb, lc, dims, variant)
    return _persistent(sweep_tiles, a_ext, b_ext, c_ext, la, lb, lc, dims,
                       variant, state, list(tiles), scoring, chunk, blocks)


def sweep_diagonals(a_ext, b_ext, c_ext, la: int, lb: int, lc: int,
                    dims: Dims, variant: str, state: SlabState, idx0: int,
                    count: int, scoring: Scoring = Scoring()) -> SlabState:
    """K5's per-tile form as it was, on a CUDA tensor: one launch a run of
    one tile anti-diagonal, a thread block a tile, stream order carrying the
    faces (``csrc/slab.cu`` slab_kernel).  The same state as
    :func:`sweep_tiles`; ``chip_smoke.py`` holds the two equal and times
    them in turns.  No entry point of the package calls it."""
    _check(a_ext, b_ext, c_ext, la, lb, lc, dims, variant)
    dev = a_ext.device
    _check_state(state, dims, dev)
    if dev.type != "cuda":
        raise ValueError("sweep_diagonals runs on a CUDA device")
    lib = _build.load("slab")
    step, table = _build.kernel_scoring(scoring, 0, dev, SUBMATRIX_NSYM_CAP)
    geom = _geom(dims, la, variant)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for group in bk.diagonal_groups(bk.table_run(dims, idx0, count)):
            jb_lo, kb = group[0]
            code = lib.trialign_slab_tiles(
                a_ext.data_ptr(), b_ext.data_ptr(), c_ext.data_ptr(), geom,
                jb_lo + kb, jb_lo, len(group), state.scal.data_ptr(),
                table.data_ptr(), step, state.rf.data_ptr(),
                state.cf.data_ptr(), state.out.data_ptr(),
                state.cap.data_ptr(), stream,
            )
            _build.check(lib, code, f"slab kernel launch (diagonal "
                         f"{jb_lo + kb})")
            sweep_diagonals.launches += 1
    return state


def blocks_per_sm(dims: Dims) -> int:
    """Thread blocks of K5's persistent sweep that one SM of the current
    card holds at ``dims``'s tile plane."""
    lib = _build.load("slab")
    per_sm = ctypes.c_int(0)
    _build.check(lib, lib.trialign_slab_blocks_per_sm(
        dims.hb, dims.wc, ctypes.byref(per_sm)), "slab occupancy query")
    return per_sm.value


def slab_sweep(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
               variant: str, ev, scoring: Scoring = Scoring(),
               chunk: int = bk.CHUNK, blocks: Optional[int] = None):
    """(final (7,), cap (n_blocks, 7, hb, wc)) int32 of one slab sweep with
    |A|, |B|, |C| >= 1, from the arrays of ``prep_blocked``; ``ev`` is the
    origin vector of "pin" and "bwd" (ignored by "free" and "free_jk").  On a
    CPU tensor this is :func:`slab_ref`; on a CUDA tensor it is one
    persistent launch of K5 (tiles advance ``chunk`` planes at a time;
    ``blocks`` caps the grid, the SMs' occupancy by default) and never falls
    back.  ``final`` is meaningful for the forward variants only."""
    _check(a_ext, b_ext, c_ext, la, lb, lc, dims, variant)
    if len(ev) != NUM_MATRICES:
        raise ValueError("ev holds one value per matrix")
    with span("k5.pack"):
        state = new_state(la, lb, lc, dims, ev, a_ext.device)
    _persistent(slab_sweep, a_ext, b_ext, c_ext, la, lb, lc, dims, variant,
                state, None, scoring, chunk, blocks)
    return state.out, state.cap


CHOICE_MODES = ("free", "free_jk", "pin")


def choice_sweep(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
                 mode: str, ev, scoring: Scoring, packed_lo, packed_hi):
    """The direct engine's choice-capture sweep (csrc/slab.cu, CHOICES) on
    a CUDA tensor: one persistent launch over the whole tile table, counted
    on ``choice_sweep.launches``, which raises if refused and never falls
    back.  |A|, |B|, |C| >= 0 with one symbol at least, arrays from
    ``prep_blocked``; ``mode`` "free", "free_jk" or "pin" (the origin holds
    ``ev``).  Writes every cuboid slot (0 <= q-j-k <= |A|) of ``packed_lo``
    (int16) and ``packed_hi`` (uint8), (|A|+|B|+|C|, (|B|+1)(|C|+1)) each,
    as ``traceback/direct.py`` lays them out, and leaves the other entries
    as they were; returns the final (7,) int32 at (|A|, |B|, |C|).  Its
    plain version is ``traceback/direct._choices``, which
    ``direct.choices`` runs on the CPU."""
    _check(a_ext, b_ext, c_ext, la, lb, lc, dims, mode, CHOICE_MODES, 0)
    dev = a_ext.device
    if dev.type != "cuda":
        raise ValueError("the choice sweep runs on a CUDA device")
    if len(ev) != NUM_MATRICES:
        raise ValueError("ev holds one value per matrix")
    shape = (la + lb + lc, (lb + 1) * (lc + 1))
    for t, dtype in ((packed_lo, torch.int16), (packed_hi, torch.uint8)):
        if t.dtype != dtype or t.shape != shape or not t.is_contiguous() or \
                t.device != dev:
            raise ValueError(f"the packed buffers are contiguous {shape} "
                             "int16 and uint8 tensors on the device of the "
                             "symbol arrays")
    i32 = dict(dtype=torch.int32, device=dev)
    with span("choices.pack"):
        # The faces' rows are written before they are read (csrc/slab.cu).
        rf = torch.empty((dims.n_kb, dims.nrows, NUM_MATRICES, dims.wc),
                         **i32)
        cf = torch.empty((dims.n_jb, dims.nrows, NUM_MATRICES, dims.hb),
                         **i32)
        out = torch.empty(NUM_MATRICES, **i32)
        scal = torch.from_numpy(_scal_table(la, lb, lc, ev, dims)).to(dev)
    _launch(choice_sweep, "choices", la * lb * lc, dims, None, scoring, dev,
            lambda lib, step, table, work, stream: lib.trialign_slab_choices(
                a_ext.data_ptr(), b_ext.data_ptr(), c_ext.data_ptr(),
                _geom(dims, la, mode), scal.data_ptr(), table.data_ptr(),
                step, rf.data_ptr(), cf.data_ptr(), out.data_ptr(),
                packed_lo.data_ptr(), packed_hi.data_ptr(), lb, lc, bk.CHUNK,
                work.next_tile, work.done, stream))
    return out


# Launches of the CUDA kernel since the count was last set to 0, for each
# entry point: the whole-grid sweep (slab_sweep), the per-tile form
# (sweep_tiles and sweep_run), its earlier design (sweep_diagonals) and the
# direct engine's choice-capture sweep (choice_sweep); and the cells those
# launches swept (:func:`run_cells`), set to 0 with them.
slab_sweep.launches = slab_sweep.cells = 0
sweep_tiles.launches = sweep_tiles.cells = 0
sweep_diagonals.launches = 0
choice_sweep.launches = choice_sweep.cells = 0


def _assemble(cap: torch.Tensor, dims: Dims, lb: int, lc: int):
    """Stitch per-block capture planes into the (7, lb+1, lc+1) slab on
    their device: every tile's own cells, plus the halo row and column of
    the first tile row and column (the j = 0 and k = 0 faces); cells past
    lb / lc are dropped."""
    hb, wc, n_jb, n_kb = dims.hb, dims.wc, dims.n_jb, dims.n_kb
    tb, tc = hb - 1, wc - 1
    c = cap.view(n_jb, n_kb, NUM_MATRICES, hb, wc)
    slab = cap.new_empty((NUM_MATRICES, n_jb * tb + 1, n_kb * tc + 1))
    slab[:, 1:, 1:] = c[:, :, :, 1:, 1:].permute(2, 0, 3, 1, 4).reshape(
        NUM_MATRICES, n_jb * tb, n_kb * tc)
    slab[:, 0, 1:] = c[0, :, :, 0, 1:].permute(1, 0, 2).reshape(
        NUM_MATRICES, n_kb * tc)
    slab[:, 1:, 0] = c[:, 0, :, 1:, 0].permute(1, 0, 2).reshape(
        NUM_MATRICES, n_jb * tb)
    slab[:, 0, 0] = c[0, 0, :, 0, 0]
    return slab[:, : lb + 1, : lc + 1]


def _combine_caps(fcap, gcap, fdims: Dims, gdims: Dims, lb: int, lc: int):
    """total = F + G on the device; returns (argmax flat index, its value)
    as device scalars.  Ties go to the first flat index, as ``jnp.argmax``
    and ``np.argmax`` break them."""
    f = _assemble(fcap, fdims, lb, lc)
    g = _assemble(gcap, gdims, lb, lc).flip(1, 2)
    total = (f + g).reshape(-1)
    flat = torch.argmax(total)
    # Indexing with a device scalar reads it to the host: the host waits
    # here for both sweeps.
    with span("wait"):
        return flat, total[flat]


def _sweep(a, b, c, scoring, variant, ev, block_shape, device):
    """Plan, prepare and enqueue one slab sweep; (final, cap, dims)."""
    la, lb, lc = len(a), len(b), len(c)
    with span("k5.pack"):
        dims = _plan(la, lb, lc, block_shape)
        # Pageable copies: the host waits here for the sweeps queued before
        # this one (a split's backward sweep and guard follow its forward
        # sweep on the stream).
        with span("wait"):
            arrs = prep_blocked(a, b, c, dims, torch.device(device))
    final, cap = slab_sweep(*arrs, la, lb, lc, dims, variant, ev, scoring)
    return final, cap, dims


def _ev(v) -> np.ndarray:
    return (np.zeros(NUM_MATRICES, np.int32) if v is None
            else np.asarray(v, np.int32))


def forward_slab_blocked_async(
    a, b, c, scoring: Scoring = Scoring(), mode: str = "free",
    want_slab: bool = True, block_shape: Optional[Tuple[int, int]] = None,
    device="cuda",
):
    """Enqueue a forward slab sweep; returns a zero-arg fetch producing
    (final (7,), slab (7, lb+1, lc+1) at i = |A| or None), NumPy int32.

    Same contract as ``traceback.torch_engine.forward_sweep_torch_async``
    with capture_m = |A|.  Modes "free" / "free_jk"."""
    assert mode in ("free", "free_jk"), mode
    a, b, c = (np.asarray(x, dtype=np.int32) for x in (a, b, c))
    assert min(len(a), len(b), len(c)) >= 1, (len(a), len(b), len(c))
    final, cap, dims = _sweep(a, b, c, scoring, mode, _ev(None), block_shape,
                              device)

    def fetch():
        f = final.cpu().numpy()
        if not want_slab:
            return f, None
        return f, _assemble(cap, dims, len(b), len(c)).cpu().numpy()

    return fetch


def backward_slab_blocked_async(
    a_suffix, b, c, scoring: Scoring = Scoring(),
    end_v: Optional[np.ndarray] = None,
    block_shape: Optional[Tuple[int, int]] = None, device="cuda",
):
    """Enqueue a backward slab sweep; returns a zero-arg fetch producing G
    (7, |B|+1, |C|+1): the best suffix-path score from (m, j, k) in each
    state to the final cell (engine.backward_slab)."""
    ra, rb, rc = (np.asarray(x, dtype=np.int32)[::-1].copy()
                  for x in (a_suffix, b, c))
    assert min(len(ra), len(rb), len(rc)) >= 1, (len(ra), len(rb), len(rc))
    _, cap, dims = _sweep(ra, rb, rc, scoring, "bwd", _ev(end_v),
                          block_shape, device)

    def fetch():
        g = _assemble(cap, dims, len(rb), len(rc)).flip(1, 2)
        return g.cpu().numpy()

    return fetch


def split_point_blocked_async(
    a, b, c, m: int, scoring: Scoring = Scoring(), mode: str = "free",
    end_v: Optional[np.ndarray] = None, v0: Optional[np.ndarray] = None,
    block_shape: Optional[Tuple[int, int]] = None, device="cuda",
):
    """The Hirschberg split at i = m on the device: enqueue the forward slab
    of (a[:m], b, c), the backward slab of (a[m:], b, c) and the argmax of
    their sum; returns a zero-arg fetch producing (sstar, jstar, kstar,
    score), the optimal crossing of plane i = m (traceback/hirschberg.py
    _solve).  ``mode`` "free" / "free_jk" / "pin"; "pin" needs ``v0``."""
    a, b, c = (np.asarray(x, dtype=np.int32) for x in (a, b, c))
    la, lb, lc = len(a), len(b), len(c)
    assert 1 <= m < la, (m, la)
    assert (mode == "pin") == (v0 is not None), (mode, v0)
    _, fcap, fdims = _sweep(a[:m], b, c, scoring, mode, _ev(v0), block_shape,
                            device)
    _, gcap, gdims = _sweep(a[m:][::-1].copy(), b[::-1].copy(),
                            c[::-1].copy(), scoring, "bwd", _ev(end_v),
                            block_shape, device)
    flat, val = _combine_caps(fcap, gcap, fdims, gdims, lb, lc)

    def fetch():
        fl, score = int(flat), int(val)
        sstar, jstar, kstar = np.unravel_index(
            fl, (NUM_MATRICES, lb + 1, lc + 1))
        return int(sstar), int(jstar), int(kstar), score

    return fetch
