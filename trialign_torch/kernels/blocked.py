"""The blocked (sliced) sweep (K3), its per-tile form and its chain mode.

Port of ``trialign/kernels/blocked.py``: ``_block_sweep`` as launched by
``make_grid_call`` (chain mode included) and by ``make_block_call`` (the
per-block form that ``checkpoint.py`` drives), and the host side
``plan_dims``, ``plan_dims_packed``, ``choose_block_shape``,
``prep_blocked``, ``prep_chain``, ``align_blocked``, ``align_blocked_async``
and ``align_blocked_chain``.

The (j, k) plane is cut into tiles of tb x tc cells.  A tile's plane is
(hb, wc) = (tb + 1, tc + 1): a halo row and column that come from the faces
of its upper and left neighbours, then its own cells.  Each tile sweeps all
of its local planes q = 1 .. L + tb + tc (cell (jl, kl) of local plane q
holds global i = q - jl - kl, L the swept |A|).  Faces live in skewed slabs:
the bottom row of local plane q goes to row q - tb of the row-face slab of
its tile column, the right column to row q - tc of the column-face slab of
its tile row (blocked.py:6-12).

A problem's tiles form a table in anti-diagonal order: d ascending, then jb
ascending.  Every sweep on the card is one persistent launch in which each
tile advances, a chunk of planes at a time, as soon as its neighbours have
finished the planes whose faces the chunk reads (:func:`planes_needed`):
over the whole table on a fresh state (:func:`final_values`,
:func:`chain_values`), or over a run of tiles on a sweep state
(:class:`BlockedState`: the face slabs and the output rows) that stays on
the device from launch to launch (the per-tile form: :func:`sweep_tiles`
for any run of the table, so that a sweep may stop and resume between any
two tiles; :func:`sweep_run` for any list of tiles whose neighbours come
first, such as a band of a stripe's rows).  A neighbour outside the run was
swept by an earlier launch and counts as finished.  All give the same
state.  :func:`sweep_diagonals` keeps the per-tile form's earlier design,
one launch a run of one anti-diagonal, for ``chip_smoke.py`` to compare.

Chain mode (:func:`plan_dims_packed`): ``npack`` problems of equal |A|
stacked along i at pitch d = |A| + 1, sharing B and C, swept as one problem
of |A| = npack * d - 1 whose cells with i = 0 (mod d) are zero borders; the
last tile captures slot m's seven values into output row m.

On a CUDA tensor the wrappers launch ``csrc/blocked.cu``, once a call.  On
a CPU tensor they run :func:`blocked_ref`, the plain torch version of the
same tile table, face layout and state, in the run's order.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.kernels.plane_math import (
    fused_plane_update_m7, transition_groups,
)
from trialign_torch import _build
from trialign_torch.kernels.ref import (
    PAD_A, PAD_B, PAD_C, extend, pair_fn, roll1, substitution, wrap,
)

# Default tile plane (hb, wc) = (tb + 1, tc + 1) and threads per tile: the
# fastest of chip_smoke.py's "tuning" candidates at 1024^3 on the H100
# (PERF.md).
DEF_HB, DEF_WC = 33, 33
THREADS = 512
# Local planes a tile of the persistent sweeps (K3 and K5) sweeps between two
# handshakes with its neighbours (chip_smoke.py "tuning", PERF.md).
CHUNK = 8
# Shared memory one thread block may take on sm_90 (227 KB).
SMEM_CAP = 232448


class Dims(NamedTuple):
    """Static geometry of one blocked sweep."""

    hb: int      # tile plane rows: halo row + tb cells
    wc: int      # tile plane columns: halo column + tc cells
    n_jb: int    # tile rows, ceil(|B| / tb)
    n_kb: int    # tile columns, ceil(|C| / tc)
    nq: int      # local planes a tile sweeps, L + tb + tc (L the swept |A|)
    nrows: int   # rows of each face slab (local planes 0 .. nq)
    d: int = 0       # chain mode: slot pitch |A| + 1; 0 for one problem
    npack: int = 1   # chain mode: slots stacked along i


class BlockedState(NamedTuple):
    """What a sweep carries from tile to tile, on its device: the face slabs
    and the final values of each slot.  Entries no tile has written hold
    ``UNWRITTEN``; ``out`` starts at zero."""

    rf: torch.Tensor   # (n_kb, nrows, 7, wc) int32 row faces
    cf: torch.Tensor   # (n_jb, nrows, 7, hb) int32 column faces
    out: torch.Tensor  # (npack, 7) int32


# A face entry the sweep never wrote.  Large and positive, so that a read of
# one would win a max and show up in the score.
UNWRITTEN = 1 << 28


def shared_bytes(hb: int, wc: int) -> int:
    """Shared memory a tile's thread block takes, as csrc/pillar.cuh
    pillar_shared_bytes counts it: 25 ring planes (3 generations of 7
    matrices, 4 of max7), the tile's B and C symbols and the 9 x 9 submatrix
    table."""
    return 4 * (25 * hb * wc + hb + wc + 81)


def choose_block_shape(la: int, lb: int, lc: int) -> Tuple[int, int]:
    """The tile plane (hb, wc).  A fixed default measured on the H100; the
    v5e cost model of the reference (VMEM budget, lane efficiency) does not
    apply to shared memory."""
    return DEF_HB, DEF_WC


def _check_tile(hb: int, wc: int) -> None:
    if hb < 2 or wc < 2:
        raise ValueError(f"tile plane {hb}x{wc} needs at least one cell")
    if shared_bytes(hb, wc) > SMEM_CAP:
        raise ValueError(
            f"tile plane {hb}x{wc} needs {shared_bytes(hb, wc)} bytes of "
            f"shared memory; a block has {SMEM_CAP}"
        )


def plan_dims(la: int, lb: int, lc: int, hb: int = DEF_HB,
              wc: int = DEF_WC) -> Dims:
    """Geometry for a blocked sweep of |A|, |B|, |C| >= 1 at tile plane
    (hb, wc); raises ValueError for a tile the card cannot hold."""
    _check_tile(hb, wc)
    tb, tc = hb - 1, wc - 1
    n_jb = max(1, -(-lb // tb))
    n_kb = max(1, -(-lc // tc))
    nq = la + tb + tc
    return Dims(hb, wc, n_jb, n_kb, nq, nq + 1)


def plan_dims_packed(la: int, lb: int, lc: int, npack: int,
                     hb: int = DEF_HB, wc: int = DEF_WC) -> Dims:
    """:func:`plan_dims` for a chain of ``npack`` problems of equal shape
    (la, lb, lc), stacked at pitch d = la + 1 along the A axis inside one
    sweep of |A| = npack * d - 1 (blocked.py plan_dims_packed).  Slot m's
    symbols sit at i = m*d + 1 .. m*d + la, its zero border at i = m*d."""
    if npack < 1:
        raise ValueError(f"a chain needs npack >= 1, not {npack}")
    d = la + 1
    return plan_dims(npack * d - 1, lb, lc, hb, wc)._replace(d=d, npack=npack)


def swept_length(dims: Dims) -> int:
    """The |A| the tiles sweep: npack * d - 1 in chain mode."""
    return dims.nq - (dims.hb - 1) - (dims.wc - 1)


def n_tiles(dims: Dims) -> int:
    return dims.n_jb * dims.n_kb


def prep_blocked(a, b, c, dims: Dims, device):
    """Symbol arrays for one problem under ``dims``: A_i at index i of
    a (|A|+1), B_j at index j of b (n_jb * tb + 1), C_k likewise, with the
    reference's sentinels at index 0 and past each end."""
    tb, tc = dims.hb - 1, dims.wc - 1
    return (
        extend(a, len(a) + 1, PAD_A, device),
        extend(b, dims.n_jb * tb + 1, PAD_B, device),
        extend(c, dims.n_kb * tc + 1, PAD_C, device),
    )


def prep_chain(a_list: Sequence, b, c, dims: Dims, device):
    """Symbol arrays for a chain (blocked.py prep_chain): the stacked A
    (slot m's symbols at i = m*d + 1 .. m*d + |A|, the sentinel at every
    border i = m*d) and the shared B and C arrays of :func:`prep_blocked`."""
    tb, tc = dims.hb - 1, dims.wc - 1
    a_ext = np.full(dims.npack * dims.d, PAD_A, dtype=np.int32)
    for m, a in enumerate(a_list):
        a_ext[m * dims.d + 1:m * dims.d + 1 + len(a)] = np.asarray(a)
    return (
        torch.from_numpy(a_ext).to(device),
        extend(b, dims.n_jb * tb + 1, PAD_B, device),
        extend(c, dims.n_kb * tc + 1, PAD_C, device),
    )


def new_state(dims: Dims, device) -> BlockedState:
    """A fresh sweep state on ``device``."""
    return BlockedState(
        torch.full((dims.n_kb, dims.nrows, NUM_MATRICES, dims.wc), UNWRITTEN,
                   dtype=torch.int32, device=device),
        torch.full((dims.n_jb, dims.nrows, NUM_MATRICES, dims.hb), UNWRITTEN,
                   dtype=torch.int32, device=device),
        torch.zeros((dims.npack, NUM_MATRICES), dtype=torch.int32,
                    device=device),
    )


def _target(lb: int, lc: int, dims: Dims):
    """Local (jl, kl) of the final cell (|B|, |C|) in the last tile
    (blocked.py:1174-1179: jbstar = (lb - 1) // tb = n_jb - 1)."""
    tb, tc = dims.hb - 1, dims.wc - 1
    return lb - (dims.n_jb - 1) * tb, lc - (dims.n_kb - 1) * tc


def _diagonal(d: int, dims: Dims):
    """Tile rows jb of anti-diagonal d (tile columns are d - jb)."""
    return range(max(0, d - dims.n_kb + 1), min(d, dims.n_jb - 1) + 1)


def tile_table(dims: Dims) -> List[Tuple[int, int]]:
    """Every tile (jb, kb) of the grid in sweep order: anti-diagonals d
    ascending, jb ascending within one."""
    return [(jb, d - jb) for d in range(dims.n_jb + dims.n_kb - 1)
            for jb in _diagonal(d, dims)]


def tile_index(dims: Dims, d: int, jb: int) -> int:
    """Index of tile (jb, d - jb) in :func:`tile_table`."""
    return sum(len(_diagonal(e, dims)) for e in range(d)) + \
        jb - _diagonal(d, dims).start


def planes_needed(q1: int, dims: Dims) -> Tuple[int, int]:
    """The readiness rule of the persistent sweeps (csrc/schedule.cuh
    PlaneWait, which K3 and K5 follow): before a tile sweeps its local planes
    up to q1 - 1, its upper neighbour (jb - 1, kb) must have finished plane
    ``up`` and its left neighbour (jb, kb - 1) plane ``left``; returns
    (up, left).  A tile reads row q of its row-face slab at plane q, which
    the upper neighbour writes at its plane q + tb (the column face likewise
    with tc); the neighbours' last plane is ``dims.nq``."""
    return (min(q1 - 1 + dims.hb - 1, dims.nq),
            min(q1 - 1 + dims.wc - 1, dims.nq))


def table_run(dims: Dims, idx0: int, count: int) -> List[Tuple[int, int]]:
    """Tiles idx0 .. idx0 + count - 1 of :func:`tile_table`; raises
    ValueError for a range past the table."""
    if idx0 < 0 or count < 0 or idx0 + count > n_tiles(dims):
        raise ValueError(f"tiles {idx0} .. {idx0 + count - 1} are not in a "
                         f"grid of {n_tiles(dims)}")
    return tile_table(dims)[idx0:idx0 + count]


def rect_tiles(rows: Tuple[int, int],
               cols: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The tiles of rows [r0, r1) and columns [k0, k1) in anti-diagonal
    order (jb + kb ascending, then jb), in which each tile's neighbours in
    the rectangle come first: a band of a stripe (dist/halo.py)."""
    return sorted(((jb, kb) for jb in range(*rows) for kb in range(*cols)),
                  key=lambda t: (t[0] + t[1], t[0]))


# Columns of a run's table (csrc/blocked.cu RunEntry): the tile, then the
# entries of its upper and left neighbours within the run, -1 outside it.
RUN_FIELDS = ("jb", "kb", "up", "left")


def run_table(dims: Dims, tiles: Sequence[Tuple[int, int]]) -> np.ndarray:
    """The (len(tiles), 4) int32 table of a run (:data:`RUN_FIELDS`).
    Raises ValueError for a tile outside the grid, a tile listed twice or a
    neighbour listed after its tile."""
    index = {}
    table = np.empty((len(tiles), len(RUN_FIELDS)), np.int32)
    for e, (jb, kb) in enumerate(tiles):
        if not (0 <= jb < dims.n_jb and 0 <= kb < dims.n_kb) or \
                (jb, kb) in index:
            raise ValueError(f"tile {(jb, kb)} is outside a grid of "
                             f"{dims.n_jb} x {dims.n_kb} or listed twice")
        index[jb, kb] = e
        table[e] = jb, kb, index.get((jb - 1, kb), -1), \
            index.get((jb, kb - 1), -1)
    for (jb, kb), e in index.items():
        for nb in ((jb + 1, kb), (jb, kb + 1)):
            if index.get(nb, e) < e:
                raise ValueError(f"tile {(jb, kb)} comes after {nb}, which "
                                 "it feeds")
    return table


def diagonal_groups(tiles: Sequence[Tuple[int, int]]) -> Iterator[list]:
    """Consecutive tiles of one anti-diagonal, which do not feed each
    other, as lists."""
    group: list = []
    for t in tiles:
        if group and sum(group[0]) != sum(t):
            yield group
            group = []
        group.append(t)
    if group:
        yield group


def pillar_steps(a_ext, b_ext, c_ext, lb: int, lc: int, dims: Dims,
                 state: BlockedState, jbs: torch.Tensor, kbs: torch.Tensor,
                 scoring: Scoring = Scoring(),
                 score_bits: int = 0) -> Iterator[int]:
    """The pillars of tiles (jbs[p], kbs[p]) swept together on ``state`` in
    place, as the kernel sweeps one tile: a generator that runs local plane
    q = 1, 2, .. ``dims.nq`` and yields q after each.  The tiles' faces must
    be ready for each plane before it runs (:func:`planes_needed`)."""
    dev = a_ext.device
    rf, cf, out = state
    hb, wc = dims.hb, dims.wc
    tb, tc = hb - 1, wc - 1
    n = len(jbs)
    sweep_la = swept_length(dims)
    pitch = dims.d or sweep_la + 1
    groups = transition_groups(scoring.weight_matrix())
    pair = pair_fn(scoring, dev)
    jl = torch.arange(hb, device=dev)
    kl = torch.arange(wc, device=dev)
    jk = jl.view(hb, 1) + kl.view(1, wc)
    edge = (jl.view(hb, 1) >= 1) & (kl.view(1, wc) >= 1)
    jlstar, klstar = _target(lb, lc, dims)

    def inside(i):
        """Cells the kernel writes: 1 <= i <= L."""
        return (i >= 1) & (i <= sweep_la)

    bsym = b_ext[jbs.view(n, 1) * tb + jl.view(1, hb)].view(n, hb, 1)
    csym = c_ext[kbs.view(n, 1) * tc + kl.view(1, wc)].view(n, 1, wc)
    s_bc = pair(bsym, csym)
    has_row = (jbs > 0).view(1, n, 1)
    has_col = (kbs > 0).view(1, n, 1)
    # The last tile holds the final cell.
    target = [p for p in range(n) if int(jbs[p]) == dims.n_jb - 1
              and int(kbs[p]) == dims.n_kb - 1]

    zeros = torch.zeros((7, n, hb, wc), dtype=torch.int32, device=dev)
    p1, p2 = zeros, zeros
    m7p2, m7p3 = zeros[0], zeros[0]
    for q in range(1, dims.nq + 1):
        i = q - jk
        valid = edge & inside(i) & (i % pitch != 0)
        ai = a_ext[i.clamp(0, sweep_la)]
        subs = substitution(ai, bsym, csym, s_bc, scoring, pair)
        cands, m7p1 = fused_plane_update_m7(
            p1, p2, m7p3, subs, groups, torch.maximum, roll1
        )
        # Invalid cells, chain borders i = 0 (mod d) included, are 0.
        new = torch.where(valid, wrap(torch.stack(cands), score_bits), 0)
        # Halo: column 0 from the column face, then row 0 from the row
        # face, which wins at the corner.  A halo cell outside
        # 1 <= i <= L, or on a border, is 0 and its face row is not read.
        icol, irow = q - jl, q - kl
        col_ok = has_col & (inside(icol) & (icol % pitch != 0)).view(
            1, 1, hb)
        row_ok = has_row & (inside(irow) & (irow % pitch != 0)).view(
            1, 1, wc)
        new[:, :, :, 0] = torch.where(
            col_ok, cf[jbs, q].permute(1, 0, 2), 0)
        new[:, :, 0, :] = torch.where(
            row_ok, rf[kbs, q].permute(1, 0, 2), 0)
        # Faces, corners included: bottom row to row q - tb of the row
        # slab, right column to row q - tc of the column slab; only the
        # entries whose cell has 1 <= i <= L, as the kernel writes them.
        if q - tb >= 0:
            w = inside(q - tb - kl).view(1, 1, wc)
            rf[kbs, q - tb] = torch.where(
                w, new[:, :, tb, :].permute(1, 0, 2), rf[kbs, q - tb])
        if q - tc >= 0:
            w = inside(q - tc - jl).view(1, 1, hb)
            cf[jbs, q - tc] = torch.where(
                w, new[:, :, :, tc].permute(1, 0, 2), cf[jbs, q - tc])
        # Slot m's final cell: i = m * d + d - 1 at (jl*, kl*).
        it = q - jlstar - klstar
        if target and 1 <= it <= sweep_la and (it + 1) % pitch == 0:
            out[(it + 1) // pitch - 1] = new[:, target[0], jlstar, klstar]
        p1, p2, m7p2, m7p3 = new, p1, m7p1, m7p2
        yield q


def blocked_ref(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
                scoring: Scoring = Scoring(), score_bits: int = 0,
                state: Optional[BlockedState] = None, idx0: int = 0,
                count: Optional[int] = None, tiles=None) -> torch.Tensor:
    """Plain torch version of K3: sweeps tiles idx0 .. idx0 + count - 1 of
    :func:`tile_table` (all by default), or the list ``tiles`` in its order
    (each tile's neighbours swept before it), from ``state`` (a fresh one by
    default), updating it in place, and returns its final values: (7,) for
    one problem, (npack, 7) for a chain.

    Same tile table, face slabs, halo install order, face entries written
    and capture as the kernel; consecutive tiles of one anti-diagonal run as
    one batch (:func:`pillar_steps`).  ``la`` is the problem's |A| (a
    slot's in chain mode)."""
    dev = a_ext.device
    if state is None:
        state = new_state(dims, dev)
    if tiles is None:
        tiles = table_run(dims, idx0, n_tiles(dims) - idx0 if count is None
                          else count)
    for group in diagonal_groups(tiles):
        jbs, kbs = torch.tensor(group, device=dev).view(-1, 2).unbind(1)
        for _ in pillar_steps(a_ext, b_ext, c_ext, lb, lc, dims, state, jbs,
                              kbs, scoring, score_bits):
            pass
    return state.out if dims.d else state.out[0]


def _check(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
           scoring: Scoring) -> None:
    _build.check_submatrix(scoring)
    if min(la, lb, lc) < 1:
        raise ValueError("the blocked sweep needs |A|, |B|, |C| >= 1")
    hb, wc = dims.hb, dims.wc
    want = (plan_dims_packed(la, lb, lc, dims.npack, hb, wc) if dims.d
            else plan_dims(la, lb, lc, hb, wc))
    if dims != want:
        raise ValueError(f"dims {dims} were not planned for {la, lb, lc}")
    tb, tc = hb - 1, wc - 1
    for t, n in ((a_ext, swept_length(dims) + 1), (b_ext, dims.n_jb * tb + 1),
                 (c_ext, dims.n_kb * tc + 1)):
        if t.dtype != torch.int32 or t.shape != (n,) or \
                not t.is_contiguous() or t.device != a_ext.device:
            raise ValueError(
                "a, b, c must be contiguous int32 vectors on one device, "
                "shaped as prep_blocked (prep_chain) makes them"
            )


def _check_state(state: BlockedState, dims: Dims, device) -> None:
    shapes = ((dims.n_kb, dims.nrows, NUM_MATRICES, dims.wc),
              (dims.n_jb, dims.nrows, NUM_MATRICES, dims.hb),
              (dims.npack, NUM_MATRICES))
    for t, shape in zip(state, shapes):
        if t.dtype != torch.int32 or t.shape != shape or \
                not t.is_contiguous() or t.device != device:
            raise ValueError("the state must be new_state(dims)'s, on the "
                             "device of the symbol arrays")


def _geom(lb: int, lc: int, dims: Dims):
    jlstar, klstar = _target(lb, lc, dims)
    sweep_la = swept_length(dims)
    return _build.BlockedGeom(sweep_la, dims.hb, dims.wc, dims.n_jb,
                              dims.n_kb, dims.nrows, jlstar, klstar,
                              dims.d or sweep_la + 1, dims.npack)


def check_schedule(chunk: int, blocks: Optional[int]) -> None:
    """Raise ValueError for a chunk or a grid cap the persistent sweeps do
    not take."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1 plane, not {chunk}")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be >= 1 or None, not {blocks}")


class Work(NamedTuple):
    """What one persistent launch of K3 or K5 reads beside the sweep, in one
    int32 tensor on the device: the run's table (:data:`RUN_FIELDS` rows;
    none for the whole grid), the hand-out counter (0) and one progress word
    a tile (-1)."""

    buf: torch.Tensor
    run: Optional[int]  # address of the table, None for the whole grid
    ntiles: int
    next_tile: int      # address of the counter
    done: int           # address of the progress words


def launch_work(dims: Dims, table: Optional[np.ndarray], device) -> Work:
    """The :class:`Work` of a launch over a run's ``table`` (None: the whole
    grid), copied to ``device`` from pinned memory on the current stream, so
    that the host never waits for the card."""
    n = n_tiles(dims) if table is None else len(table)
    rows = 0 if table is None else table.size
    host = torch.empty(rows + 1 + n, dtype=torch.int32, pin_memory=True)
    h = host.numpy()
    if table is not None:
        h[:rows] = table.reshape(-1)
    h[rows] = 0
    h[rows + 1:] = -1
    buf = host.to(device, non_blocking=True)
    ptr = buf.data_ptr()
    return Work(buf, None if table is None else ptr, n, ptr + 4 * rows,
                ptr + 4 * (rows + 1))


def _persistent(counter, a_ext, b_ext, c_ext, la, lb, lc, dims, state,
                tiles, scoring, score_bits, threads, chunk,
                blocks) -> BlockedState:
    """``tiles`` (None: the whole table) on ``state``: blocked_ref on a CPU
    tensor; on a CUDA tensor one persistent launch of K3, counted on
    ``counter``, which raises if refused and never falls back."""
    check_schedule(chunk, blocks)
    dev = a_ext.device
    _check_state(state, dims, dev)
    run = None if tiles is None else run_table(dims, tiles)
    if run is not None and not len(run):
        return state
    if dev.type == "cpu":
        blocked_ref(a_ext, b_ext, c_ext, la, lb, lc, dims, scoring,
                    score_bits, state, tiles=tiles)
        return state
    if dev.type != "cuda":
        raise ValueError(f"no blocked kernel for device {dev}")
    lib = _build.load("blocked")
    step, table = _build.kernel_scoring(scoring, score_bits, dev)
    with torch.cuda.device(dev):
        work = launch_work(dims, run, dev)
        code = lib.trialign_blocked_sweep(
            a_ext.data_ptr(), b_ext.data_ptr(), c_ext.data_ptr(),
            _geom(lb, lc, dims), work.run, work.ntiles, table.data_ptr(),
            step, state.rf.data_ptr(), state.cf.data_ptr(),
            state.out.data_ptr(), threads, chunk, blocks or 0,
            work.next_tile, work.done,
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(lib, code, "blocked kernel launch (persistent sweep)")
        counter.launches += 1
    return state


def blocks_per_sm(dims: Dims, threads: int = THREADS) -> int:
    """Thread blocks of K3's persistent sweep that one SM of the current
    card holds at ``dims``'s tile plane (the grid is that times the SMs)."""
    lib = _build.load("blocked")
    per_sm = ctypes.c_int(0)
    _build.check(lib, lib.trialign_blocked_blocks_per_sm(
        dims.hb, dims.wc, threads, int(bool(dims.d)), ctypes.byref(per_sm)),
        "blocked occupancy query")
    return per_sm.value


def sweep_tiles(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
                state: BlockedState, idx0: int, count: int,
                scoring: Scoring = Scoring(), score_bits: int = 0,
                threads: int = THREADS, chunk: int = CHUNK,
                blocks: Optional[int] = None) -> BlockedState:
    """The per-tile form (blocked.py make_block_call): runs tiles idx0 ..
    idx0 + count - 1 of :func:`tile_table` on ``state`` in place and returns
    it; ``state.out`` holds the final values once the last tile has run.  A
    run may end in the middle of an anti-diagonal.  :func:`sweep_run` of
    those tiles: on a CUDA tensor one persistent launch of K3 (``chunk`` and
    ``blocks`` as :func:`final_values`), which never falls back.  Nothing
    waits for the card."""
    return sweep_run(a_ext, b_ext, c_ext, la, lb, lc, dims, state,
                     table_run(dims, idx0, count), scoring, score_bits,
                     threads, chunk, blocks)


def sweep_run(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
              state: BlockedState, tiles: Sequence[Tuple[int, int]],
              scoring: Scoring = Scoring(), score_bits: int = 0,
              threads: int = THREADS, chunk: int = CHUNK,
              blocks: Optional[int] = None) -> BlockedState:
    """The per-tile form over the list ``tiles`` of (jb, kb): each tile's
    neighbours in the list come before it (ValueError otherwise), and every
    other neighbour must have been swept on ``state`` before, by work that
    the current stream has waited for (the earlier bands of a stripe, or the
    faces another stripe handed over; dist/halo.py).  On a CPU tensor this
    is :func:`blocked_ref` in the list's order; on a CUDA tensor one
    persistent launch of K3, counted on ``sweep_tiles.launches``, which
    raises if refused and never falls back.  An empty list launches
    nothing."""
    _check(a_ext, b_ext, c_ext, la, lb, lc, dims, scoring)
    return _persistent(sweep_tiles, a_ext, b_ext, c_ext, la, lb, lc, dims,
                       state, list(tiles), scoring, score_bits, threads,
                       chunk, blocks)


def sweep_diagonals(a_ext, b_ext, c_ext, la: int, lb: int, lc: int,
                    dims: Dims, state: BlockedState, idx0: int, count: int,
                    scoring: Scoring = Scoring(), score_bits: int = 0,
                    threads: int = THREADS) -> BlockedState:
    """K3's per-tile form as it was, on a CUDA tensor: one launch a run of
    one tile anti-diagonal, a thread block a tile, stream order carrying the
    faces (``csrc/blocked.cu`` blocked_kernel).  The same state as
    :func:`sweep_tiles`; ``chip_smoke.py`` holds the two equal and times
    them in turns.  No entry point of the package calls it."""
    _check(a_ext, b_ext, c_ext, la, lb, lc, dims, scoring)
    dev = a_ext.device
    _check_state(state, dims, dev)
    if dev.type != "cuda":
        raise ValueError("sweep_diagonals runs on a CUDA device")
    lib = _build.load("blocked")
    step, table = _build.kernel_scoring(scoring, score_bits, dev)
    geom = _geom(lb, lc, dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for group in diagonal_groups(table_run(dims, idx0, count)):
            jb_lo, kb = group[0]
            code = lib.trialign_blocked_tiles(
                a_ext.data_ptr(), b_ext.data_ptr(), c_ext.data_ptr(), geom,
                jb_lo + kb, jb_lo, len(group), table.data_ptr(), step,
                state.rf.data_ptr(), state.cf.data_ptr(),
                state.out.data_ptr(), threads, stream,
            )
            _build.check(lib, code, f"blocked kernel launch (diagonal "
                         f"{jb_lo + kb})")
            sweep_diagonals.launches += 1
    return state


def final_values(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
                 scoring: Scoring = Scoring(), score_bits: int = 0,
                 threads: int = THREADS, chunk: int = CHUNK,
                 blocks: Optional[int] = None) -> torch.Tensor:
    """The seven final-cell values (int32, (7,)) of one problem with
    |A|, |B|, |C| >= 1, from the arrays of :func:`prep_blocked`.  On a CPU
    tensor this is :func:`blocked_ref`; on a CUDA tensor it is one persistent
    launch of K3 (tiles advance ``chunk`` planes at a time; ``blocks`` caps
    the grid, the SMs' occupancy by default) and never falls back.  Nothing
    waits for the card."""
    _check(a_ext, b_ext, c_ext, la, lb, lc, dims, scoring)
    if dims.d:
        raise ValueError("chain dims: use chain_values")
    return _persistent(final_values, a_ext, b_ext, c_ext, la, lb, lc, dims,
                       new_state(dims, a_ext.device), None, scoring,
                       score_bits, threads, chunk, blocks).out[0]


def chain_values(a_ext, b_ext, c_ext, la: int, lb: int, lc: int, dims: Dims,
                 scoring: Scoring = Scoring(), score_bits: int = 0,
                 threads: int = THREADS, chunk: int = CHUNK,
                 blocks: Optional[int] = None) -> torch.Tensor:
    """Chain mode: the seven final values of every slot, (npack, 7) int32,
    from the arrays of :func:`prep_chain` under
    :func:`plan_dims_packed`'s ``dims``; ``la`` is one slot's |A|.  On a CPU
    tensor this is :func:`blocked_ref`; on a CUDA tensor it is one persistent
    launch of K3 in chain mode (``chunk`` and ``blocks`` as
    :func:`final_values`) and never falls back."""
    _check(a_ext, b_ext, c_ext, la, lb, lc, dims, scoring)
    if not dims.d:
        raise ValueError("chain_values needs plan_dims_packed's dims")
    return _persistent(chain_values, a_ext, b_ext, c_ext, la, lb, lc, dims,
                       new_state(dims, a_ext.device), None, scoring,
                       score_bits, threads, chunk, blocks).out


# Launches of the CUDA kernel since the count was last set to 0, for each
# entry point: the whole-grid sweep (final_values), the per-tile form
# (sweep_tiles and sweep_run), chain mode (chain_values) and the per-tile
# form's earlier design (sweep_diagonals).
final_values.launches = 0
sweep_tiles.launches = 0
chain_values.launches = 0
sweep_diagonals.launches = 0


def align_blocked_async(a, b, c, scoring: Scoring = Scoring(),
                        block_shape: Optional[Tuple[int, int]] = None,
                        score_bits: int = 0, device="cuda") -> torch.Tensor:
    """Like :func:`align_blocked`, but the score is a 0-d int32 tensor on
    ``device`` and nothing waits for the card: callers queue many problems
    and read all scores at the end."""
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) == 0:
        return torch.zeros((), dtype=torch.int32, device=device)
    hb, wc = block_shape or choose_block_shape(la, lb, lc)
    dims = plan_dims(la, lb, lc, hb, wc)
    return final_values(*prep_blocked(a, b, c, dims, device), la, lb, lc,
                        dims, scoring, score_bits).max()


def align_blocked(a, b, c, scoring: Scoring = Scoring(),
                  block_shape: Optional[Tuple[int, int]] = None,
                  score_bits: int = 0, device="cuda") -> int:
    """Optimal 3-sequence alignment score via the blocked kernel (its plain
    version on ``device="cpu"``).  ``block_shape`` is the tile plane
    (hb, wc), as in the reference; the default is :func:`choose_block_shape`."""
    return int(align_blocked_async(a, b, c, scoring, block_shape, score_bits,
                                   device))


def align_blocked_chain(a_list: Sequence, b, c, scoring: Scoring = Scoring(),
                        block_shape: Optional[Tuple[int, int]] = None,
                        score_bits: int = 0, device="cuda") -> List[int]:
    """Scores of a chain of equal-length A sequences against shared B and C
    in one sweep (blocked.py align_blocked_chain): the problems stack along
    the A axis at pitch |A| + 1, so the tile ramp (tb + tc planes) and every
    launch amortise over the chain.  One exact score per A, in order.

    ``score_bits`` nonzero wraps stored values as signed registers of that
    width, and a slot's score is the max of its seven wrapped values, as the
    reference's capture of the carried max7.  ``block_shape`` is the tile
    plane (hb, wc); there is no ``interpret``: ``device="cpu"`` runs the
    plain version.  Raises ValueError for A's of unequal length; an empty
    list gives [], an empty sequence a score of 0 for every slot."""
    a_list = [np.asarray(a) for a in a_list]
    b, c = np.asarray(b), np.asarray(c)
    if not a_list:
        return []
    la = len(a_list[0])
    if any(len(a) != la for a in a_list):
        raise ValueError("align_blocked_chain requires equal-length A's")
    lb, lc = len(b), len(c)
    if min(la, lb, lc) == 0:
        return [0] * len(a_list)
    hb, wc = block_shape or choose_block_shape(la, lb, lc)
    dims = plan_dims_packed(la, lb, lc, len(a_list), hb, wc)
    out = chain_values(*prep_chain(a_list, b, c, dims, device), la, lb, lc,
                       dims, scoring, score_bits)
    return [int(s) for s in out.max(dim=1).values.tolist()]
