"""Two processes with ``gloo`` on the CPU: the port's twin of
tests/test_multihost.py.

Two ``python -m trialign_torch.dist.worker`` processes join one process
group; each scores a seeded batch with ``align_batch_multihost`` (the data
axis across both), sweeps one triplet in stripes over a model axis that
spans both (column faces handed from process to process) and recovers its
alignment with the splits swept across both.  Both must report the same,
equal to the one-process run of the same functions, the golden model and
the JAX package's ``align_batch_sharded``.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from trialign.dist.batch import align_batch_sharded as jax_sharded
from trialign.dist.mesh import make_mesh as jax_make_mesh
from trialign.golden import align_planes_numpy, rescore_alignment
from trialign_torch.dist import halo_tb, mesh, worker
from trialign_torch.dist.batch import align_batch_multihost
from trialign_torch.dist.halo import halo_values
from trialign_torch.dist.worker import inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_worker_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        worker.main(["tcp://localhost:1", "1", "0"])


def test_two_process_gloo_run():
    init = f"tcp://localhost:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "trialign_torch.dist.worker", init, "2",
         str(rank), "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env) for rank in range(2)]
    try:
        # The one-process run, while the workers run.
        trips, (a, b, c) = inputs()
        want = [align_planes_numpy(*t) for t in trips]
        assert jax_sharded(trips, mesh=jax_make_mesh(data=2, model=1)) == \
            want
        one = mesh.make_mesh(1, 1, devices=[CPU])
        values = [int(v) for v in halo_values(a, b, c, mesh=one,
                                              block_shape=(17, 33))]
        score, rows = halo_tb.hirschberg_align_sharded(
            a, b, c, mesh=one, single_cells=3000, block_shape=(17, 33))
        assert align_batch_multihost(
            trips, mesh=mesh.make_mesh(4, 1, devices=[CPU] * 4)) == want
        assert max(values) == score == align_planes_numpy(a, b, c)
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(
                [ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            p.kill()
    for rank, rec in enumerate(outs):
        assert rec["rank"] == rank
        assert rec["scores"] == want
        assert rec["halo_values"] == values
        assert rec["tb_score"] == rec["tb_rescore"] == score
        assert rec["tb_rows"] == rows
    assert rescore_alignment(rows) == score
