"""Failure detection and recovery for long alignments and batches.

Port of ``trialign/resilience.py``.  The blocked sweep's face slabs are a
complete intermediate state between tiles, so the checkpointed aligner can
resume mid-grid; :func:`align_resilient` wraps it in a supervisor that
catches a failure, waits, rebuilds the aligner and resumes from the last
checkpoint.  :func:`align_batch_resilient` re-dispatches only the problems
of a batch whose scores had not drained when a dispatch failed.

What a retry can recover from, on the card: an exception that leaves the
process's CUDA context usable, such as a launch that CUDA refused, an
out-of-memory error, or an error raised by the host code.  A sticky CUDA
error (an illegal address, a kernel fault) poisons the context for the rest
of the process; every later call fails too, so the retries are spent and
:class:`AlignmentFailed` follows.  Recovering from that takes a new process,
which resumes from the checkpoint file that the failed one left behind.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Tuple

from trialign_torch.checkpoint import CheckpointedAligner
from trialign_torch.config import Scoring

log = logging.getLogger("trialign_torch.resilience")


class AlignmentFailed(RuntimeError):
    """Raised when an alignment keeps failing after max_retries recoveries."""


def align_resilient(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    ckpt_path: Optional[str] = None,
    every: Optional[int] = None,
    max_retries: int = 3,
    backoff_s: float = 1.0,
    cleanup: bool = True,
    **kw,
) -> int:
    """Blocked alignment that survives failures that leave the process's
    CUDA context usable (see the module's docstring for what a retry cannot
    recover from).

    Runs the checkpointed aligner; on an exception, waits ``backoff_s``
    times the attempt number, rebuilds the aligner (fresh device buffers)
    and resumes from the last checkpoint, re-running at most ``every``
    tiles.  ``kw`` goes to :class:`CheckpointedAligner` (``device``,
    ``block_shape``).  Raises :class:`AlignmentFailed` after ``max_retries``
    recoveries."""
    attempts = 0
    last_exc: Optional[BaseException] = None
    runner = CheckpointedAligner(
        a, b, c, scoring, ckpt_path=ckpt_path, every=every, **kw
    )
    ckpt = runner.ckpt_path
    # `max_retries` recoveries = 1 initial attempt + max_retries retries.
    while attempts <= max_retries:
        try:
            score = runner.run(checkpoint=True)
            if cleanup and os.path.exists(ckpt):
                os.remove(ckpt)
            return score
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            # Deliberate interruption/shutdown must not be retried.
            raise
        except Exception as e:  # noqa: BLE001 - device loss is broad
            attempts += 1
            last_exc = e
            log.warning(
                "alignment attempt %d failed at tile %d/%d: %s -- resuming "
                "from checkpoint",
                attempts, runner.next_idx, runner.n_blocks, e,
            )
            time.sleep(backoff_s * attempts)
            runner = CheckpointedAligner(
                a, b, c, scoring, ckpt_path=ckpt, every=every, **kw
            )
            runner.resume()
    raise AlignmentFailed(
        f"alignment failed after {max_retries} recoveries"
    ) from last_exc


def progress(runner: CheckpointedAligner) -> Tuple[int, int]:
    """(completed tiles, total tiles): the heartbeat a supervisor polls."""
    return runner.next_idx, runner.n_blocks


def align_batch_resilient(
    triplets,
    scoring: Scoring = Scoring(),
    mesh=None,
    max_retries: int = 3,
    backoff_s: float = 1.0,
    batch_fn=None,
    **kw,
):
    """Batch scoring that survives a failed dispatch mid-batch by
    re-dispatching only the problems whose scores had not drained.

    The batch executor (``batch_fn``, by default the port's
    ``kernels.mosaic.align_batch_mosaic``) reports each problem's score
    through ``on_scores`` as its K4 dispatch drains; a retry packs the
    unscored problems alone, so finished dispatches never run again.  The
    same limit as :func:`align_resilient` holds: a sticky CUDA error is not
    recovered in process.  ``kw`` goes to ``batch_fn`` (``device``)."""
    from trialign_torch.kernels.mosaic import align_batch_mosaic

    fn = batch_fn or align_batch_mosaic
    n = len(triplets)
    out = [None] * n
    attempts = 0
    last_exc: Optional[BaseException] = None
    while attempts <= max_retries:
        remaining = [i for i in range(n) if out[i] is None]
        if not remaining:
            break
        sub = [triplets[i] for i in remaining]

        def record(local_i, score, _remaining=remaining):
            out[_remaining[local_i]] = int(score)

        try:
            scores = fn(sub, scoring, mesh=mesh, on_scores=record, **kw)
            for li, i in enumerate(remaining):
                out[i] = int(scores[li])
            break
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            raise
        except Exception as e:  # noqa: BLE001 - device loss is broad
            attempts += 1
            last_exc = e
            done = n - sum(1 for v in out if v is None)
            log.warning(
                "batch attempt %d failed with %d/%d problems scored: %s -- "
                "re-dispatching only the remainder",
                attempts, done, n, e,
            )
            time.sleep(backoff_s * attempts)
    if any(v is None for v in out):
        raise AlignmentFailed(
            f"batch failed after {max_retries} recoveries"
        ) from last_exc
    return out
