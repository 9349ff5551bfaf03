"""One process of a multi-process run of the port's multi-device paths.

Run one of these per rank, all with the same arguments but the rank::

    python -m trialign_torch.dist.worker tcp://localhost:PORT NPROCS RANK \\
        [--device cuda|cpu] [--slots 2] [--halo 8,30,508] \\
        [--block 17,33] [--single-cells 3000]

Every process joins a ``gloo`` process group (``dist.mesh.init_distributed``)
and, on a mesh of ``--slots`` slots of ``--device`` a process (the card by
default; without one the worker raises unless ``--device cpu`` is given):

1. scores a seeded batch of 7 triplets (not a multiple of the data axis)
   with ``align_batch_multihost``, the data axis across processes;
2. sweeps one triplet of lengths ``--halo`` in stripes over a model axis
   that spans every process (``dist.halo.halo_values``), handing column
   faces from process to process;
3. recovers its alignment with ``dist.halo_tb.hirschberg_align_sharded`` on
   that model axis, with splits above ``--single-cells`` swept across the
   processes.

Each process prints one JSON line with what it got; every process must
print the same, and that must equal the one-process run of the same
functions (:func:`inputs` gives the inputs).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def inputs(halo_shape=(8, 30, 508)):
    """The batch (7 triplets, lengths in [5, 20)) and the halo triplet,
    from seed 123."""
    rng = np.random.default_rng(123)
    trips = [tuple(rng.integers(0, 4, size=int(rng.integers(5, 20)))
                   .astype(np.uint8) for _ in range(3)) for _ in range(7)]
    halo = tuple(rng.integers(0, 4, size=n).astype(np.uint8)
                 for n in halo_shape)
    return trips, halo


def _ints(text: str):
    return tuple(int(v) for v in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("init_method", help="tcp://host:port of rank 0")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="the one device of this process's slots (the card "
                    "unless cpu is asked for)")
    ap.add_argument("--slots", type=int, default=2,
                    help="mesh slots a process, all on its one device")
    ap.add_argument("--halo", type=_ints, default=(8, 30, 508),
                    help="lengths of the striped triplet")
    ap.add_argument("--block", type=_ints, default=(17, 33),
                    help="tile plane (hb, wc) of the stripes, at most "
                    "33,33 (one sub-tile of K3's register step)")
    ap.add_argument("--single-cells", type=int, default=3000,
                    help="nodes up to this many cells go to one device")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "kernels' plain versions")

    from trialign_torch.dist import mesh as dmesh
    from trialign_torch.dist.batch import align_batch_multihost
    from trialign_torch.dist.halo import halo_values
    from trialign_torch.dist.halo_tb import hirschberg_align_sharded
    from trialign_torch.golden import rescore_alignment

    if not dmesh.init_distributed(args.init_method, args.nprocs, args.rank):
        raise RuntimeError("no process group")
    try:
        local = [torch.device(args.device)] * args.slots
        mesh = dmesh.multihost_mesh(local=local)
        if mesh.shape["data"] != args.slots * args.nprocs:
            raise RuntimeError(f"multihost mesh {mesh.shape}")
        trips, (a, b, c) = inputs(args.halo)
        scores = align_batch_multihost(trips, mesh=mesh)

        # The model axis across every process: one slot a process.
        row = dmesh.make_mesh(1, args.nprocs, devices=[
            s for s in dmesh.global_devices(local[:1])])
        values = halo_values(a, b, c, mesh=row, block_shape=args.block)
        score, rows = hirschberg_align_sharded(
            a, b, c, mesh=row, single_cells=args.single_cells,
            block_shape=args.block)
        print(json.dumps({"rank": args.rank, "scores": scores,
                          "halo_values": [int(v) for v in values],
                          "tb_score": int(score),
                          "tb_rescore": int(rescore_alignment(rows)),
                          "tb_rows": rows}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
