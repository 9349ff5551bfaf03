"""The wavefront sweep (K2) for triplets with |B|, |C| <= 255.

Port of ``trialign/kernels/wavefront.py`` (``_make_kernel`` as launched by
``_run``/``_run_compact``, host side ``prepare_compact`` and
``align_wavefront``): the seven final-cell values of each of a call's
problems, every problem with its own lengths.

On a CUDA tensor :func:`final_values` makes one persistent launch of
``csrc/wavefront.cu`` over the tiles of every problem: each problem's (j, k)
plane is cut into tiles of at most 32 x 32 cells (the tile plane ``TILE``),
:func:`plan_tiles` lists them from the host lengths in one table in diagonal
order (``kernels/hetero.py`` ``GEOM_FIELDS`` / ``TABLE_FIELDS``), and blocks
over the whole card sweep the tiles on K4's register step, each starting a
chunk of planes as its neighbours' progress words allow.  The symbols stay
in the caller's arrays.  On a CPU tensor it runs the kernel's plain version,
the whole-plane torch sweep of ``ref.py``; :func:`tiles_ref` sweeps the same
table of tiles with K3's plain version ``blocked_ref``, which the tests hold
to both.  :func:`final_values_earlier` is the design K2 had before (one
thread block a problem), kept so that ``chip_smoke.py`` and the cuda tests
can hold the two equal and time them in turns; no entry point of the
package reaches it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch import _build
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import hetero
from trialign_torch.kernels.ref import PAD_A, PAD_B, PAD_C, extend, sweep

SUBMATRIX_NSYM_CAP = _build.SUBMATRIX_NSYM_CAP
# The Pallas kernel's caps (wavefront.bucket_dims), kept so that align()
# routes every size to the same kernel as the reference.
MAX_A = 4096
MAX_BC = 255
# The tile plane (hb, wc) = (tb + 1, tc + 1) and the planes a tile sweeps
# between two handshakes with its neighbours: the fastest of 17 x 17,
# 33 x 17 and 33 x 33 with chunks 2, 4 and 8 at 255^3 on the H100
# (chip_smoke.py "tuning", PERF.md).  A tile is one sub-tile of the register step, so the
# plane is at most (SUB_ROWS + 1) x (STRIP * MAX_STRIPS + 1).
TILE = (33, 17)
CHUNK = 4
MAX_TILE = (hetero.SUB_ROWS + 1, hetero.STRIP * hetero.MAX_STRIPS + 1)
# The ints of one problem's row of the kernel's output: its seven final
# values and a spare.
OUT_STRIDE = 8
# A call whose face slabs take at most this share of the card's memory is
# one launch; past it, launches of consecutive problems within
# hetero.default_budget.
ONE_LAUNCH_SHARE = 0.125

_G = {name: col for col, name in enumerate(hetero.GEOM_FIELDS)}


def fits(la: int, lb: int, lc: int) -> bool:
    """Whether the kernel takes a triplet of these lengths."""
    return lb <= MAX_BC and lc <= MAX_BC and la <= MAX_A


def check_dims(la: int, lb: int, lc: int) -> None:
    """Raise ValueError past the kernel's caps."""
    if not fits(la, lb, lc):
        raise ValueError(
            f"wavefront kernel supports |B|,|C| <= {MAX_BC} and |A| <= "
            f"{MAX_A}; got {la}/{lb}/{lc}. Use the blocked backend."
        )


def prep(a, b, c, device):
    """Kernel inputs for one triplet: (a, b, c) as (1, len+1) int32 tensors
    with the reference's sentinels (PAD_SYMBOL for A, 254 for B, 253 for C)
    at index 0 and past the end, and lens (1, 3)."""
    la, lb, lc = len(a), len(b), len(c)
    check_dims(la, lb, lc)
    tensors = (
        extend(a, la + 1, PAD_A, device)[None],
        extend(b, lb + 1, PAD_B, device)[None],
        extend(c, lc + 1, PAD_C, device)[None],
    )
    return (*tensors, np.array([[la, lb, lc]], dtype=np.int32))


class TilePlan(NamedTuple):
    """A call's tiles, as :func:`plan_tiles` lists them."""

    geom: np.ndarray   # (n, len(GEOM_FIELDS)) int64; a_off etc. by stride
    table: np.ndarray  # (ntiles, len(TABLE_FIELDS)) int32, diagonal order
    rf_ints: int       # ints of all row face slabs
    cf_ints: int       # ints of all column face slabs
    hb: int
    wc: int


def check_tile(hb: int, wc: int) -> None:
    """Raise ValueError for a tile plane K2 does not take: at least one
    cell, at most one sub-tile of the register step."""
    if not (2 <= hb <= MAX_TILE[0] and 2 <= wc <= MAX_TILE[1]):
        raise ValueError(f"K2 takes tile planes from 2 x 2 to {MAX_TILE[0]} "
                         f"x {MAX_TILE[1]}, not {hb} x {wc}")


def _grid(lens: np.ndarray, block: Tuple[int, int]):
    """Each problem's tile rows, tile columns, face rows and face ints at
    tile plane ``block`` (no tiles and no faces with an empty sequence)."""
    hb, wc = block
    check_tile(hb, wc)
    tb, tc = hb - 1, wc - 1
    la, lb, lc = lens.T
    live = (lens > 0).all(axis=1)
    n_jb = np.where(live, (lb + tb - 1) // tb, 0)
    n_kb = np.where(live, (lc + tc - 1) // tc, 0)
    nrows = la + tb + tc + 1
    rf = n_kb * nrows * (NUM_MATRICES * wc)
    cf = n_jb * nrows * (NUM_MATRICES * hb)
    return n_jb, n_kb, nrows, rf, cf


def plan_tiles(lens, strides: Tuple[int, int, int],
               block: Tuple[int, int] = TILE) -> TilePlan:
    """The geometry and table of tiles of problems of lengths ``lens`` ((n,
    3) host integers) at tile plane ``block``, whose symbols lie in (n, *)
    arrays of row ``strides`` (A, B, C): problem p's row of each at p times
    its stride.  Tiles go in global tile anti-diagonal order, the longest
    |A| first within a diagonal (its pillar is the longest), then by problem
    and tile row; a problem with an empty sequence has none.  Each
    problem's face slabs take K3's layout at their offsets in two buffers of
    ``rf_ints`` and ``cf_ints`` ints."""
    lens = np.asarray(lens, dtype=np.int64).reshape(-1, 3)
    n_jb, n_kb, nrows, rf, cf = _grid(lens, block)
    tb, tc = block[0] - 1, block[1] - 1
    n = len(lens)
    la, lb, lc = lens.T
    geom = np.empty((n, len(hetero.GEOM_FIELDS)), np.int64)
    geom[:, _G["la"]] = la
    geom[:, _G["n_jb"]] = n_jb
    geom[:, _G["n_kb"]] = n_kb
    geom[:, _G["nrows"]] = nrows
    geom[:, _G["jlstar"]] = lb - np.maximum(n_jb - 1, 0) * tb
    geom[:, _G["klstar"]] = lc - np.maximum(n_kb - 1, 0) * tc
    geom[:, _G["a_off"]:_G["c_off"] + 1] = np.outer(np.arange(n), strides)
    geom[:, _G["rf_off"]] = np.cumsum(rf) - rf
    geom[:, _G["cf_off"]] = np.cumsum(cf) - cf
    # One problem's table depends on its tile counts alone.
    table = _one_table(int(n_jb[0]), int(n_kb[0])) if n == 1 else \
        _table(n_jb, n_kb, la)
    return TilePlan(geom, table, int(rf.sum()), int(cf.sum()), *block)


def _table(n_jb: np.ndarray, n_kb: np.ndarray, la: np.ndarray) -> np.ndarray:
    """The table of tiles (``TABLE_FIELDS``) of problems of these tile
    counts and |A|, in :func:`plan_tiles`' order."""
    # Each problem's tiles row by row (entry f), then sorted; a tile's
    # neighbours are f - n_kb and f - 1 before the sort.
    counts = n_jb * n_kb
    p = np.repeat(np.arange(len(counts)), counts)
    f = np.arange(len(p))
    nk = n_kb[p]
    t = f - (np.cumsum(counts) - counts)[p]
    jb = t // nk
    kb = t - jb * nk
    order = np.lexsort((jb, p, -la[p], jb + kb))
    at = np.empty_like(order)
    at[order] = np.arange(len(order))
    return np.stack([p, jb, kb,
                     np.where(jb > 0, at[np.maximum(f - nk, 0)], -1),
                     np.where(kb > 0, at[np.maximum(f - 1, 0)], -1)],
                    axis=1)[order].astype(np.int32)


@functools.lru_cache(maxsize=1024)
def _one_table(n_jb: int, n_kb: int) -> np.ndarray:
    """:func:`_table` of one problem (read-only; a call's host work is a
    good share of a small triplet's time)."""
    table = _table(np.array([n_jb]), np.array([n_kb]), np.zeros(1, np.int64))
    table.flags.writeable = False
    return table


def tiles_ref(a, b, c, lens, scoring: Scoring = Scoring(),
              score_bits: int = 0,
              block: Tuple[int, int] = TILE) -> torch.Tensor:
    """K2's tile table swept by K3's plain version, an (n, 7) int32 tensor
    of final values on the arrays' device (zeros for a problem with an
    empty sequence): :func:`plan_tiles` of ``lens``, each run of one
    problem's entries of the table swept in table order by ``blocked_ref``
    at the plan's tile plane, on the plan's face offsets, with each
    problem's symbols read as the kernel reads them (a row or column past
    |B| or |C| takes the last symbol).  The tests hold it to the whole-plane
    sweep and the reference's kernel."""
    lens = np.asarray(lens, dtype=np.int64).reshape(-1, 3)
    plan = plan_tiles(lens, (a.shape[1], b.shape[1], c.shape[1]), block)
    dev = a.device
    tb, tc = plan.hb - 1, plan.wc - 1
    rf = torch.full((max(plan.rf_ints, 1),), bk.UNWRITTEN, dtype=torch.int32,
                    device=dev)
    cf = torch.full((max(plan.cf_ints, 1),), bk.UNWRITTEN, dtype=torch.int32,
                    device=dev)
    out = torch.zeros((len(lens), NUM_MATRICES), dtype=torch.int32,
                      device=dev)

    def problem(p):
        la, lb, lc = (int(x) for x in lens[p])
        g = plan.geom[p]
        n_jb, n_kb, nrows = (int(g[_G[k]]) for k in ("n_jb", "n_kb",
                                                      "nrows"))
        dims = bk.Dims(plan.hb, plan.wc, n_jb, n_kb, la + tb + tc, nrows)
        rows = torch.arange(n_jb * tb + 1, device=dev).clamp(max=lb)
        cols = torch.arange(n_kb * tc + 1, device=dev).clamp(max=lc)
        r0, c0 = int(g[_G["rf_off"]]), int(g[_G["cf_off"]])
        state = bk.BlockedState(
            rf[r0:r0 + n_kb * nrows * NUM_MATRICES * plan.wc].view(
                n_kb, nrows, NUM_MATRICES, plan.wc),
            cf[c0:c0 + n_jb * nrows * NUM_MATRICES * plan.hb].view(
                n_jb, nrows, NUM_MATRICES, plan.hb),
            out[p:p + 1])
        return (a[p], b[p][rows], c[p][cols], la, lb, lc, dims), state

    # Runs of entries of one problem on one diagonal, which do not feed
    # each other.
    key = plan.table[:, 0] * (MAX_A + 2 * MAX_BC) + plan.table[:, 1] + \
        plan.table[:, 2]
    starts = [0] + [e for e in range(1, len(key)) if key[e] != key[e - 1]]
    table = plan.table
    for lo, hi in zip(starts, starts[1:] + [len(table)]):
        args, state = problem(int(table[lo, 0]))
        bk.blocked_ref(*args, scoring, score_bits, state,
                       tiles=[tuple(int(x) for x in r)
                              for r in table[lo:hi, 1:3]])
    return out


def _check_inputs(a, b, c, lens) -> np.ndarray:
    lens = np.asarray(lens, dtype=np.int64).reshape(-1, 3)
    n = lens.shape[0]
    for t in (a, b, c):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n or \
                not t.is_contiguous() or t.device != a.device:
            raise ValueError(
                "a, b, c must be contiguous (n, length) int32 tensors on one "
                "device"
            )
    bad = (lens < 0).any(axis=1) | (lens[:, 0] > MAX_A) | \
        (lens[:, 1:] > MAX_BC).any(axis=1) | (lens[:, 0] >= a.shape[1]) | \
        (lens[:, 1] >= b.shape[1]) | (lens[:, 2] >= c.shape[1])
    for la, lb, lc in lens[bad][:1].tolist():
        check_dims(la, lb, lc)
        raise ValueError(f"lens {la, lb, lc} exceed the symbol arrays")
    return lens


def plan_launches(lens, block: Tuple[int, int],
                  budget_bytes: Optional[int]) -> List[Tuple[int, int]]:
    """The problems of ``lens`` as runs [p0, p1) in input order, one
    launch each, whose face slabs take at most ``budget_bytes`` together (a
    problem above it runs alone; None is no limit)."""
    lens = np.asarray(lens, dtype=np.int64).reshape(-1, 3)
    _, _, _, rf, cf = _grid(lens, block)
    need = 4 * (rf + cf)
    if budget_bytes is None or need.sum() <= budget_bytes:
        return [(0, len(lens))]
    runs, used = [], 0
    for p, x in enumerate(need.tolist()):
        if not runs or used + x > budget_bytes:
            runs.append([p, p])
            used = 0
        runs[-1][1] = p + 1
        used += x
    return [tuple(r) for r in runs]


def _mode(scoring: Scoring, score_bits: int) -> int:
    """csrc/wavefront.cu's step mode: K4's (bit 0 rtl, bit 1 a submatrix),
    bit 2 score_bits."""
    return hetero._mode(scoring) | 4 * int(bool(score_bits))


def final_values(a, b, c, lens, scoring: Scoring = Scoring(),
                 score_bits: int = 0, block: Tuple[int, int] = TILE,
                 chunk: int = CHUNK,
                 blocks: Optional[int] = None) -> torch.Tensor:
    """The seven final-cell values of each problem, an (n, 7) int32 tensor
    (all 0 for a problem with an empty sequence).

    ``a``, ``b``, ``c``: (n, *) int32 tensors on one device, symbol i of a
    problem's sequence at index i; ``lens``: (n, 3) host integers.  On a CPU
    tensor this is the plain ``ref.sweep``; on a CUDA tensor it launches K2
    and never falls back: one persistent launch over every problem's tiles
    at tile plane ``block``, ``chunk`` planes between handshakes (at most
    ``hetero.MAX_CHUNK``), the grid the card's occupancy or ``blocks``.  A
    call whose face slabs pass ``ONE_LAUNCH_SHARE`` of the card's memory is
    cut into launches of consecutive problems at ``hetero.default_budget``.
    Nothing waits for the card."""
    _build.check_submatrix(scoring)
    lens = _check_inputs(a, b, c, lens)
    n = lens.shape[0]
    if a.device.type == "cpu":
        out = torch.zeros((n, 7), dtype=torch.int32)
        for p, (la, lb, lc) in enumerate(lens.tolist()):
            if min(la, lb, lc):
                out[p] = sweep(a[p], b[p], c[p], la, lb, lc, scoring,
                               score_bits)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {a.device}")
    hetero._check_step(chunk, blocks)
    dev = a.device
    lib = _build.load("wavefront")
    step, sub = _build.step_scoring(scoring, score_bits)
    rows = [t.shape[1] for t in (a, b, c)]
    plan = plan_tiles(lens, rows, block)
    runs = [(0, n, plan)]
    if 4 * (plan.rf_ints + plan.cf_ints) > ONE_LAUNCH_SHARE * \
            _card_bytes(dev.index or 0):
        runs = [(p0, p1, plan_tiles(lens[p0:p1], rows, block)) for p0, p1
                in plan_launches(lens, block, hetero.default_budget(dev))]
    out = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for p0, p1, plan in runs:
            work = _work(plan, sub, 0 if out is not None else n, dev)
            if out is None:
                out = work.out
            if not len(plan.table):
                continue
            faces = torch.empty(plan.rf_ints + plan.cf_ints,
                                dtype=torch.int32, device=dev)
            code = lib.trialign_wavefront(
                *(t.data_ptr() + 4 * p0 * w for t, w in zip((a, b, c), rows)),
                work.geom, work.table, len(plan.table), plan.hb, plan.wc,
                work.sub, step, faces.data_ptr(),
                faces.data_ptr() + 4 * plan.rf_ints,
                out.data_ptr() + 4 * p0 * OUT_STRIDE, work.done,
                work.next_entry, chunk, blocks or 0, stream,
            )
            _build.check(lib, code, "wavefront kernel launch")
            final_values.launches += 1
    return out[:, :NUM_MATRICES]


@functools.lru_cache(maxsize=None)
def _card_bytes(index: int) -> int:
    """Device memory of card ``index``."""
    return torch.cuda.get_device_properties(index).total_memory


class _Work(NamedTuple):
    """What one launch reads and writes beside the symbols and faces, in one
    int32 tensor on the device: the geometry (int64), the table, the
    hand-out counter (0), a progress word for each strip of each entry
    (-1), the call's out rows (zeros; only in its first launch's) and the
    submatrix table."""

    buf: torch.Tensor
    out: Optional[torch.Tensor]  # (n, OUT_STRIDE) view of buf
    geom: int        # addresses of each part
    table: int
    next_entry: int
    done: int
    sub: int         # the geometry's address without a submatrix


def _work(plan: TilePlan, sub: Optional[np.ndarray], out_rows: int,
          device) -> _Work:
    """The :class:`_Work` of a launch, copied to ``device`` from pinned
    memory on the current stream in one copy, so that the host never
    waits."""
    sizes = (2 * plan.geom.size, plan.table.size, 1,
             len(plan.table) * hetero.MAX_STRIPS, out_rows * OUT_STRIDE,
             0 if sub is None else sub.size)
    at = np.cumsum((0,) + sizes)
    host = torch.empty(int(at[-1]), dtype=torch.int32, pin_memory=True)
    h = host.numpy()
    h[:at[1]].view(np.int64)[:] = plan.geom.reshape(-1)
    h[at[1]:at[2]] = plan.table.reshape(-1)
    h[at[2]] = 0
    h[at[3]:at[4]] = -1
    h[at[4]:at[5]] = 0
    if sub is not None:
        h[at[5]:] = sub.reshape(-1)
    buf = host.to(device, non_blocking=True)
    ptr = buf.data_ptr()
    out = buf[at[4]:at[5]].view(out_rows, OUT_STRIDE) if out_rows else None
    return _Work(buf, out, ptr, ptr + 4 * int(at[1]), ptr + 4 * int(at[2]),
                 ptr + 4 * int(at[3]),
                 ptr + 4 * int(at[5]) if sub is not None else ptr)


def final_values_earlier(a, b, c, lens, scoring: Scoring = Scoring(),
                         score_bits: int = 0) -> torch.Tensor:
    """K2 as it was before its tiles, on a CUDA tensor: one launch of one
    1024-thread block a problem, the plane ring in global scratch; the same
    inputs and result as :func:`final_values`.
    ``chip_smoke.py`` and the cuda tests hold the two equal and time them
    in turns; no entry point of the package calls it."""
    _build.check_submatrix(scoring)
    lens = _check_inputs(a, b, c, lens)
    if a.device.type != "cuda":
        raise ValueError("final_values_earlier runs on a CUDA device")
    if b.shape[1] > MAX_BC + 1 or c.shape[1] > MAX_BC + 1:
        raise ValueError("b and c hold at most 256 symbols a problem")
    n = lens.shape[0]
    lib = _build.load("wavefront")
    hb, wc = b.shape[1], c.shape[1]
    step, table = _build.kernel_scoring(scoring, score_bits, a.device)
    lens_d = torch.from_numpy(lens.astype(np.int32)).to(a.device)
    scratch = torch.empty(
        n * lib.trialign_wavefront_scratch_ints(hb, wc), dtype=torch.int32,
        device=a.device,
    )
    out = torch.empty((n, OUT_STRIDE), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.trialign_wavefront_earlier(
            a.data_ptr(), a.shape[1], b.data_ptr(), c.data_ptr(),
            lens_d.data_ptr(), n, hb, wc, table.data_ptr(), step,
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    _build.check(lib, code, "wavefront kernel launch (earlier design)")
    final_values_earlier.launches += 1
    return out[:, :NUM_MATRICES]


def step_resources(block: Tuple[int, int] = TILE,
                   scoring: Scoring = Scoring(), score_bits: int = 0,
                   chunk: int = CHUNK) -> dict:
    """What K2's persistent kernel of this scoring mode takes on the current
    card at tile plane ``block``: registers a thread, local-memory (spill)
    bytes a thread, threads and shared bytes a block, and blocks an SM."""
    check_tile(*block)
    hetero._check_step(chunk, None)
    lib = _build.load("wavefront")
    vals = (ctypes.c_int * 5)()
    _build.check(lib, lib.trialign_wavefront_resources(
        *block, chunk, _mode(scoring, score_bits), vals),
        "wavefront resource query")
    return dict(zip(("registers", "local_bytes", "threads", "shared_bytes",
                     "blocks_per_sm"), list(vals)))


# Launches of the CUDA kernel since the count was last set to 0: the tiled
# sweep (final_values) and the earlier design (final_values_earlier).
final_values.launches = 0
final_values_earlier.launches = 0


def align_wavefront(a, b, c, scoring: Scoring = Scoring(), score_bits: int = 0,
                    device="cuda") -> int:
    """Optimal 3-sequence alignment score via the wavefront kernel (its plain
    version on ``device="cpu"``)."""
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    if min(len(a), len(b), len(c)) == 0:
        return 0
    return int(final_values(*prep(a, b, c, device), scoring,
                            score_bits).max())
