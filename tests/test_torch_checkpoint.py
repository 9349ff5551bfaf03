"""The port's checkpointed and resilient alignment against the reference.

``trialign_torch.checkpoint`` runs K3's per-tile form (its plain version
``blocked_ref`` on the CPU) in segments of tiles taken in anti-diagonal
order; the JAX package's aligner runs row-major blocks in interpret mode.
The scores must be equal as integers, and equal to the golden model.
"""

import functools

import numpy as np
import pytest
import torch

from tests.conftest import random_triplet
from trialign.checkpoint import CheckpointedAligner as JaxAligner
from trialign.golden import align_planes_numpy
from trialign_torch import checkpoint as ck
from trialign_torch import resilience
from trialign_torch.checkpoint import (
    CheckpointedAligner, align_blocked_checkpointed,
)
from trialign_torch.kernels import blocked as bk
from trialign_torch.resilience import (
    AlignmentFailed, align_batch_resilient, align_resilient,
)

torch.set_num_threads(1)

# 3 x 4 tiles of 8 x 8 cells.
GRID = (6, 24, 30)
GRID_BLOCK = (9, 9)


def advance(runner, count):
    """One segment of ``count`` tiles, then a save, as run() does."""
    state = ck._segment(runner.arrs, runner.lens, runner.dims,
                        bk.BlockedState(runner.rf, runner.cf, runner.out),
                        runner.next_idx, count, runner.scoring)
    runner.rf, runner.cf, runner.out = state
    runner.next_idx += count
    runner.save()


def test_resume_parity_with_the_reference(rng, tmp_path):
    """The reference's case: run half the grid, "crash", resume in a new
    runner; the score equals the JAX aligner's and golden."""
    a, b, c = random_triplet(rng, 8, 35, 150)
    want = align_planes_numpy(a, b, c)
    jax_runner = JaxAligner(a, b, c, ckpt_path=str(tmp_path / "jax.npz"),
                            every=4, block_shape=(16, 128), interpret=True)
    assert jax_runner.run(checkpoint=False) == want

    path = str(tmp_path / "ck.npz")
    r1 = CheckpointedAligner(a, b, c, ckpt_path=path, every=2, device="cpu",
                             block_shape=(9, 17))
    assert r1.n_blocks == 5 * 10
    while r1.next_idx < r1.n_blocks // 2:
        advance(r1, min(r1.every, r1.n_blocks // 2 - r1.next_idx))
    r2 = CheckpointedAligner(a, b, c, ckpt_path=path, every=3, device="cpu",
                             block_shape=(9, 17))
    assert r2.resume()
    assert r2.next_idx == r1.next_idx
    assert r2.run() == want


@pytest.mark.parametrize("k", range(13))
def test_resume_from_every_tile(rng, tmp_path, k):
    """Stop after k tiles of a 3 x 4 grid (k = 0 .. 12, many of them in the
    middle of an anti-diagonal), resume in a new runner: the resumed state
    equals the one saved, and the score golden's."""
    a, b, c = random_triplet(rng, *GRID)
    path = str(tmp_path / "ck.npz")
    r1 = CheckpointedAligner(a, b, c, ckpt_path=path, device="cpu",
                             block_shape=GRID_BLOCK)
    assert r1.n_blocks == 12
    if k:
        advance(r1, k)
    else:
        r1.save()
    r2 = CheckpointedAligner(a, b, c, ckpt_path=path, every=5, device="cpu",
                             block_shape=GRID_BLOCK)
    assert r2.resume() and r2.next_idx == k
    for got, want in zip((r2.rf, r2.cf, r2.out), (r1.rf, r1.cf, r1.out)):
        assert torch.equal(got, want)
    assert r2.run() == align_planes_numpy(a, b, c)


def test_segments_equal_the_whole_sweep(rng):
    """Any segmentation gives the whole-grid sweep's state."""
    a, b, c = random_triplet(rng, *GRID)
    runner = CheckpointedAligner(a, b, c, device="cpu",
                                 block_shape=GRID_BLOCK)
    for count in (1, 4, 2, 5):
        advance_no_save = ck._segment(
            runner.arrs, runner.lens, runner.dims,
            bk.BlockedState(runner.rf, runner.cf, runner.out),
            runner.next_idx, count, runner.scoring)
        runner.rf, runner.cf, runner.out = advance_no_save
        runner.next_idx += count
    whole = bk.new_state(runner.dims, "cpu")
    bk.blocked_ref(*runner.arrs, *runner.lens, runner.dims, state=whole)
    for got, want in zip((runner.rf, runner.cf, runner.out), whole):
        assert torch.equal(got, want)


def test_refuses_a_file_of_the_jax_aligner(rng, tmp_path):
    a, b, c = random_triplet(rng, 8, 35, 150)
    path = str(tmp_path / "ck.npz")
    JaxAligner(a, b, c, ckpt_path=path, every=2, block_shape=(16, 128),
               interpret=True).save()
    runner = CheckpointedAligner(a, b, c, ckpt_path=path, device="cpu")
    assert not runner.resume()
    assert runner.next_idx == 0


def test_refuses_incompatible_checkpoints(rng, tmp_path):
    a, b, c = random_triplet(rng, 8, 35, 150)
    path = str(tmp_path / "ck.npz")
    r1 = CheckpointedAligner(a, b, c, ckpt_path=path, device="cpu",
                             block_shape=(9, 17))
    advance(r1, 3)
    a2, b2, c2 = random_triplet(rng, 8, 35, 290)
    for other in (
            CheckpointedAligner(a2, b2, c2, ckpt_path=path, device="cpu",
                                block_shape=(9, 17)),
            CheckpointedAligner(a, b, c, ckpt_path=path, device="cpu",
                                block_shape=(17, 9)),
            CheckpointedAligner(a, b, c, ck.Scoring(s3_mode="rtl"),
                                ckpt_path=path, device="cpu",
                                block_shape=(9, 17))):
        assert not other.resume()
    assert not CheckpointedAligner(
        a, b, c, ckpt_path=str(tmp_path / "none.npz"), device="cpu").resume()


def test_default_every_is_an_eighth_of_the_grid(rng):
    a, b, c = random_triplet(rng, 4, 1024, 1024)
    runner = CheckpointedAligner(a, b, c, device="cpu")
    assert (runner.n_blocks, runner.every) == (1024, 128)
    small = CheckpointedAligner(*random_triplet(rng, *GRID), device="cpu",
                                block_shape=GRID_BLOCK)
    assert small.every == 1
    assert CheckpointedAligner(a, b, c, every=8, device="cpu").every == 8


def test_convenience_wrapper_removes_its_file(rng, tmp_path):
    a, b, c = random_triplet(rng, 7, 30, 25)
    path = tmp_path / "ck.npz"
    got = align_blocked_checkpointed(a, b, c, ckpt_path=str(path), every=3,
                                     device="cpu", block_shape=(9, 9))
    assert got == align_planes_numpy(a, b, c)
    assert not path.exists()


def test_needs_a_card_unless_asked_for_the_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointedAligner(*random_triplet(rng, 5, 5, 5))


def test_align_resilient_recovers_from_injected_failure(rng, tmp_path,
                                                        monkeypatch):
    """Two failures mid-grid; the supervisor resumes from the checkpoint
    and still gives the exact score."""
    a, b, c = random_triplet(rng, 10, 40, 50)
    want = align_planes_numpy(a, b, c)
    real_segment = ck._segment
    crashes = {"left": 2}
    calls = []

    def flaky_segment(*args, **kw):
        calls.append(args[4])
        out = real_segment(*args, **kw)
        if crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("injected device loss")
        return out

    monkeypatch.setattr(ck, "_segment", flaky_segment)
    got = align_resilient(a, b, c, ckpt_path=str(tmp_path / "ck.npz"),
                          every=4, max_retries=3, backoff_s=0.0,
                          device="cpu", block_shape=(9, 17))
    assert got == want
    assert crashes["left"] == 0
    # Each failed segment starts again from the last save (tile 0 here).
    assert calls[:3] == [0, 0, 0] and calls[3] == 4
    assert not (tmp_path / "ck.npz").exists()


def test_align_resilient_gives_up(rng, tmp_path, monkeypatch):
    a, b, c = random_triplet(rng, 6, 10, 10)

    def always_fail(*args, **kw):
        raise RuntimeError("permanent failure")

    monkeypatch.setattr(ck, "_segment", always_fail)
    with pytest.raises(AlignmentFailed):
        align_resilient(a, b, c, ckpt_path=str(tmp_path / "ck2.npz"),
                        max_retries=1, backoff_s=0.0, device="cpu",
                        block_shape=(9, 9))


def test_progress(rng):
    runner = CheckpointedAligner(*random_triplet(rng, *GRID), device="cpu",
                                 block_shape=GRID_BLOCK)
    assert resilience.progress(runner) == (0, 12)
    runner.run(checkpoint=False)
    assert resilience.progress(runner) == (12, 12)


def test_align_batch_resilient_retries_only_failed_chunk():
    """A batch failure after some problems drained re-dispatches only the
    unscored problems (the reference's supervisor logic)."""
    triplets = [("t%d" % i,) * 3 for i in range(7)]
    calls = []

    def flaky_batch(sub, scoring, mesh=None, on_scores=None):
        calls.append(list(sub))
        if len(calls) == 1:
            for li in range(4):
                on_scores(li, 100 + li)
            raise RuntimeError("injected device preemption")
        return [200 + li for li in range(len(sub))]

    out = align_batch_resilient(triplets, batch_fn=flaky_batch,
                                backoff_s=0.0, max_retries=2)
    assert out == [100, 101, 102, 103, 200, 201, 202]
    assert len(calls) == 2 and len(calls[0]) == 7
    assert calls[1] == [triplets[i] for i in (4, 5, 6)]


def test_align_batch_resilient_gives_up():
    def always_fail(sub, scoring, mesh=None, on_scores=None):
        raise RuntimeError("permanent failure")

    with pytest.raises(AlignmentFailed):
        align_batch_resilient([(np.zeros(3),) * 3], batch_fn=always_fail,
                              backoff_s=0.0, max_retries=1)


def test_align_batch_resilient_mosaic_end_to_end(rng, monkeypatch):
    """The port's align_batch_mosaic (K4's plain version), in dispatches of
    4: a failure as the second dispatch drains; the retry scores only the
    problems left, and every score equals golden."""
    from trialign_torch.kernels import hetero
    from trialign_torch.kernels.mosaic import align_batch_mosaic

    monkeypatch.setenv("TRIALIGN_FORCE_MOSAIC", "1")
    monkeypatch.setattr(hetero, "align_hetero", functools.partial(
        hetero.align_hetero, max_problems=4))
    trips = [random_triplet(rng, *rng.integers(3, 12, 3)) for _ in range(8)]
    want = [align_planes_numpy(*t) for t in trips]
    sizes, state = [], {"drained": 0, "armed": True}

    def batch_fn(sub, scoring, mesh=None, on_scores=None):
        sizes.append(len(sub))

        def record(i, s):
            on_scores(i, s)
            state["drained"] += 1
            if state["armed"] and state["drained"] == 5:
                state["armed"] = False
                raise RuntimeError("injected device loss at drain")

        return align_batch_mosaic(sub, scoring, mesh=mesh, on_scores=record,
                                  device="cpu")

    out = align_batch_resilient(trips, batch_fn=batch_fn, backoff_s=0.0,
                                max_retries=2)
    assert out == want
    assert sizes == [8, 3]
