"""Sharded alignment recovery: the Hirschberg splits' slab sweeps in stripes.

Port of ``trialign/dist/halo_tb.py``.  The split at i = m needs the F slab
(the forward sweep of a[:m], captured at i = m), the G slab (the backward
sweep of a[m:]) and the argmax of their sum.  Both sweeps run here as the
halo runs the score (``dist/halo.py``): stripes of tile columns over the
mesh's 'model' axis, in bands of tile rows, each band one launch of K5's
per-tile form (``kernels/slab.sweep_run``) with global tile indices, so that
the variant's fill (zero faces for "free", NEG walls for "pin" and "bwd")
lands on the global borders only and a stripe that starts past column 0
reads the faces it was handed.

The argmax: G sweeps reversed sequences, so its stripes hold other cells
than F's, and a per-stripe argmax would also break ties by stripe rather
than by flat index.  Each stripe's captured tile columns are gathered onto
the first stripe's device, where ``kernels/slab._combine_caps`` takes the
single-device argmax (the first flat index of (7, |B|+1, |C|+1) among equal
values); the crossing goes to every process.

Recursion as the reference: nodes within ``single_cells`` (the direct
engine's gate by default) go to the single-device solver
``traceback/hirschberg._solve`` on this process's first device of the
model axis, larger ones split in stripes again; the halves run one after
the other.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from trialign_torch.config import NUM_MATRICES, Scoring
from trialign_torch.dist import halo as dh
from trialign_torch.dist import mesh as dmesh
from trialign_torch.kernels import blocked as bk
from trialign_torch.kernels import slab as sk
from trialign_torch.traceback import hirschberg as hb
from trialign_torch.traceback.engine import NEG

Column = Tuple[int, int, int]


def _sharded_sweep(a, b, c, scoring: Scoring, row, variant: str, ev,
                   block_shape, overlap, band_rows=None):
    """One slab sweep in stripes over ``row``, in bands of ``band_rows``
    tile rows (``overlap`` and ``band_rows`` None: the halo model's);
    (dims, stripes), the local stripes carrying their SlabState."""
    la, lb, lc = len(a), len(b), len(c)
    hb_, wc = block_shape or dh.choose_halo_shape(la, lb, lc, len(row))
    dims = sk._plan(la, lb, lc, (hb_, wc))
    if overlap is None or band_rows is None:
        model = dh.halo_efficiency(la, lb, lc, len(row), (hb_, wc), overlap,
                                   band_rows=band_rows)
        overlap, band_rows = model["overlap"], model["band"]
    ev = sk._ev(ev)

    def start(device):
        return (sk.prep_blocked(a, b, c, dims, device),
                sk.new_state(la, lb, lc, dims, ev, device))

    def sweep(arrs, state, tiles):
        sk.sweep_run(*arrs, la, lb, lc, dims, variant, state, tiles, scoring)

    return dims, dh.run_stripes(dims, row, overlap, start, sweep, band_rows)


# Message tags of the capture gather: past every face tag of a halo.
_GATHER_TAG = 1 << 24


def _gather_caps(dims: bk.Dims, stripes, root: dh.Stripe, tag0: int):
    """Every stripe's tile columns of the capture, in the root's process on
    its device: (n_jb * n_kb, 7, hb, wc).  Other processes return None."""
    shape = (dims.n_jb, dims.n_kb, NUM_MATRICES, dims.hb, dims.wc)
    if root.local:
        full = torch.empty(shape, dtype=torch.int32, device=root.device)
    for s in stripes:
        if s.rank == root.rank and s.local:
            part = s.state.cap.view(shape)[:, s.kb0:s.kb1]
            full[:, s.kb0:s.kb1] = part.to(root.device)
        elif s.local:
            part = s.state.cap.view(shape)[:, s.kb0:s.kb1].contiguous()
            dist.send(part.cpu(), root.rank,
                      tag=_GATHER_TAG + tag0 + s.index)
        elif root.local:
            host = torch.empty((dims.n_jb, s.kb1 - s.kb0) + shape[2:],
                               dtype=torch.int32)
            dist.recv(host, s.rank, tag=_GATHER_TAG + tag0 + s.index)
            full[:, s.kb0:s.kb1] = host.to(root.device)
    return full.view(-1, *shape[2:]) if root.local else None


def sharded_split_point(
    a, b, c, m: int, scoring: Scoring, mesh: dmesh.Mesh, mode: str = "free",
    end_v: Optional[np.ndarray] = None, v0: Optional[np.ndarray] = None,
    block_shape: Optional[Tuple[int, int]] = None,
    overlap: Optional[bool] = None,
) -> Tuple[int, int, int, int]:
    """The Hirschberg split at i = m with both slab sweeps in stripes over
    the mesh's model axis; (sstar, jstar, kstar, score), the optimal
    crossing of plane i = m, in every process.  The twin of
    ``kernels.slab.split_point_blocked_async``, with the same tie-break."""
    a, b, c = (np.asarray(x, dtype=np.int32) for x in (a, b, c))
    la, lb, lc = len(a), len(b), len(c)
    assert 1 <= m < la, (m, la)
    assert (mode == "pin") == (v0 is not None), (mode, v0)
    row = dh.model_row(mesh)
    fdims, fst = _sharded_sweep(a[:m], b, c, scoring, row, mode, v0,
                                block_shape, overlap)
    gdims, gst = _sharded_sweep(a[m:][::-1].copy(), b[::-1].copy(),
                                c[::-1].copy(), scoring, row, "bwd", end_v,
                                block_shape, overlap)
    root = fst[0]
    fcap = _gather_caps(fdims, fst, root, 0)
    gcap = _gather_caps(gdims, gst, root, len(row))
    res = torch.empty(2, dtype=torch.int64)
    if root.local:
        flat, val = sk._combine_caps(fcap, gcap, fdims, gdims, lb, lc)
        res = torch.stack([flat.long(), val.long()]).cpu()
    if len({s.rank for s in fst + gst}) > 1:
        dist.broadcast(res, root.rank)
    fl, score = int(res[0]), int(res[1])
    sstar, jstar, kstar = np.unravel_index(fl, (NUM_MATRICES, lb + 1, lc + 1))
    return int(sstar), int(jstar), int(kstar), score


def _sharded_final_vector(a, b, c, scoring: Scoring, mesh: dmesh.Mesh,
                          mode: str, ev, block_shape=None,
                          overlap=None) -> np.ndarray:
    """The final (7,) vector of a forward slab sweep in stripes: the
    ``free_jk`` guard of a split (traceback/hirschberg.py _solve)."""
    a, b, c = (np.asarray(x, np.int32) for x in (a, b, c))
    _, stripes = _sharded_sweep(a, b, c, scoring, dh.model_row(mesh), mode,
                                ev, block_shape, overlap)
    return dh.from_owner(stripes, stripes[-1], lambda st: st.out).numpy()


def _local_device(mesh: dmesh.Mesh) -> torch.device:
    """This process's first device on the model axis it runs."""
    me = dmesh.rank()
    return dmesh.normalize(next(s.device for s in dh.model_row(mesh)
                         if s.rank == me))


def _solve_sharded(
    a, b, c, scoring: Scoring, mode: str, s0: Optional[int],
    end_state: Optional[int], mesh: dmesh.Mesh, ndev: int,
    single_cells: Optional[int],
    block_shape: Optional[Tuple[int, int]] = None,
    overlap: Optional[bool] = None,
) -> Tuple[int, List[Column]]:
    la, lb, lc = len(a), len(b), len(c)
    cells = (la + 1) * (lb + 1) * (lc + 1)
    device = _local_device(mesh)
    if single_cells is not None:
        small = cells <= single_cells
    else:
        # Once the direct engine takes the node in one device-resident call,
        # one device is the fastest executor.
        small = cells <= hb.DIRECT_CELLS and hb._direct_fits(la, lb, lc,
                                                             device)
    if small or la <= 1 or min(lb, lc) < 1:
        return hb._solve(a, b, c, scoring, mode, s0, end_state, device)

    freeish = mode != "pin"
    m = la // 2
    v0 = None
    if mode == "pin":
        v0 = np.full(NUM_MATRICES, NEG, dtype=np.int32)
        v0[s0] = 0
    end_v = np.zeros(NUM_MATRICES, dtype=np.int32)
    if end_state is not None:
        end_v[:] = NEG
        end_v[end_state] = 0

    sstar, jstar, kstar, score = sharded_split_point(
        a, b, c, m, scoring, mesh, mode=mode, end_v=end_v, v0=v0,
        block_shape=block_shape, overlap=overlap,
    )
    if freeish:
        # Free j/k borders admit paths that start at i0 > m and never cross
        # the plane i = m; they live in the right half with its i = 0 face
        # walled (free_jk), as in the single-device _solve.
        h_final = _sharded_final_vector(a[m:], b, c, scoring, mesh,
                                        "free_jk", None, block_shape, overlap)
        h_val = (int(h_final[end_state]) if end_state is not None
                 else int(h_final.max()))
        if h_val > score:
            r_score, r_cols = _solve_sharded(
                a[m:], b, c, scoring, "free_jk", None, end_state, mesh, ndev,
                single_cells, block_shape, overlap,
            )
            return r_score, [(int(a[i]), -1, -1) for i in range(m)] + r_cols

    # The halves run one after the other on the one mesh.
    left_score, left_cols = _solve_sharded(
        a[:m], b[:jstar], c[:kstar], scoring, mode, s0, sstar, mesh, ndev,
        single_cells, block_shape, overlap,
    )
    right_score, right_cols = _solve_sharded(
        a[m:], b[jstar:], c[kstar:], scoring, "pin", sstar, end_state, mesh,
        ndev, single_cells, block_shape, overlap,
    )
    assert left_score + right_score == score, (left_score, right_score,
                                               score)
    return score, left_cols + right_cols


def hirschberg_align_sharded(
    a, b, c, scoring: Scoring = Scoring(),
    mesh: Optional[dmesh.Mesh] = None, single_cells: Optional[int] = None,
    block_shape: Optional[Tuple[int, int]] = None,
    overlap: Optional[bool] = None,
) -> Tuple[int, List[List[int]]]:
    """Optimal score plus one optimal alignment (3 rows of codes, -1 = gap),
    every split above the single-device gate swept in stripes over the
    mesh's 'model' axis.  Semantics are ``hirschberg_align``'s.

    ``single_cells`` is the node size (cells) handed to the single-device
    solver; None is the direct engine's gate, and tests lower it to split
    small problems on the stripes.  ``block_shape`` (hb, wc) and
    ``overlap`` are the stripes' tile plane and schedule
    (:func:`dist.halo.align_sharded_triplet`)."""
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    mesh = mesh if mesh is not None else dh._default_mesh()
    if min(len(a), len(b), len(c)) == 0:
        return hb.hirschberg_align(a, b, c, scoring, _local_device(mesh))
    row = dh.model_row(mesh)
    score, cols = _solve_sharded(a, b, c, scoring, "free", None, None, mesh,
                                 len(row), single_cells, block_shape, overlap)
    return score, [list(r) for r in zip(*cols)]
