"""Checkpoint / resume for long blocked alignments.

Port of ``trialign/checkpoint.py``.  The blocked sweep's face slabs are a
complete intermediate state between tiles (the reference RTL's y/z SRAMs
have the same property, src/TriAlign_1cyc.v:127-140): the row-face slabs,
the column-face slabs, the output rows and the next tile's index fully
determine the rest of the computation, so a long run can persist them every
few tiles and resume after preemption.

On the card the state stays in device memory between segments and goes to
the host only to be saved.  The segments run K3's per-tile form
(``kernels/blocked.sweep_tiles``), one persistent launch a segment; the
launch's progress words are its own, so the file holds only the faces, the
output rows and the next tile's index.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from trialign_torch.api import _device
from trialign_torch.config import Scoring
from trialign_torch.kernels import blocked as bk

# Names the slab layout of the files this module writes.  A file of another
# layout (the JAX package's aligner writes its own) has another fingerprint.
FORMAT = "trialign_torch.checkpoint/blocked-tiles-v1"
# Saves a whole run makes with the default ``every``.
DEFAULT_SAVES = 8


def _segment(arrs, lens, dims: bk.Dims, state: bk.BlockedState, idx0: int,
             count: int, scoring: Scoring) -> bk.BlockedState:
    """Run ``count`` consecutive tiles of ``bk.tile_table(dims)`` from
    ``idx0`` on ``state`` (in place; returned).  Module level so that tests
    can wrap it."""
    return bk.sweep_tiles(*arrs, *lens, dims, state, idx0, count, scoring)


class CheckpointedAligner:
    """Blocked alignment that persists its state every ``every`` tiles.

    Blocks are the tiles of K3's grid, run in anti-diagonal order (d
    ascending, then jb ascending), not the reference's row-major order,
    which on the card would run one tile at a time on one SM.  ``next_idx``
    counts tiles in that order, and a segment may end in the middle of an
    anti-diagonal; the score is the same.  ``every`` counts tiles as in the
    reference; its default is one save per eighth of the grid
    (``n_blocks // DEFAULT_SAVES``, at least 1), since the reference's 8 was
    sized for v5e's ~256 x 256 blocks and the port's 33 x 33 tiles are many
    more (1024 at 1024^3).  ``device`` replaces the reference's
    ``interpret``: "cuda" (the default, raising without a card) or "cpu"
    (K3's plain version).  |A|, |B|, |C| >= 1."""

    def __init__(
        self,
        a,
        b,
        c,
        scoring: Scoring = Scoring(),
        ckpt_path: Optional[str] = None,
        every: Optional[int] = None,
        device="cuda",
        block_shape: Optional[Tuple[int, int]] = None,
    ):
        self.a = np.asarray(a)
        self.b = np.asarray(b)
        self.c = np.asarray(c)
        self.scoring = scoring
        self.device = _device(device)
        self.ckpt_path = ckpt_path or os.path.join(
            tempfile.gettempdir(), "trialign_torch_ckpt.npz"
        )
        self.lens = (len(self.a), len(self.b), len(self.c))
        hb, wc = block_shape or bk.choose_block_shape(*self.lens)
        self.dims = bk.plan_dims(*self.lens, hb, wc)
        self.n_blocks = bk.n_tiles(self.dims)
        self.every = every or max(1, self.n_blocks // DEFAULT_SAVES)
        self.arrs = bk.prep_blocked(self.a, self.b, self.c, self.dims,
                                    self.device)
        self.next_idx = 0
        self.rf, self.cf, self.out = bk.new_state(self.dims, self.device)

    def _fingerprint(self) -> str:
        """Identity of this exact problem: sequences, scoring, geometry and
        the file format.  Resuming another problem's checkpoint would
        silently corrupt scores."""
        h = hashlib.sha256(FORMAT.encode())
        for arr in (self.a, self.b, self.c):
            h.update(np.ascontiguousarray(arr, dtype=np.uint8).tobytes())
            h.update(b"|")
        h.update(repr(self.scoring).encode())
        h.update(repr(self.dims).encode())
        return h.hexdigest()

    def save(self) -> None:
        """Write the state (waiting for the card) to ``ckpt_path``,
        atomically."""
        tmp = self.ckpt_path + ".tmp.npz"
        np.savez(
            tmp, next_idx=self.next_idx, rf=self.rf.cpu().numpy(),
            cf=self.cf.cpu().numpy(), out=self.out.cpu().numpy(),
            fingerprint=np.frombuffer(self._fingerprint().encode(),
                                      dtype=np.uint8),
        )
        os.replace(tmp, self.ckpt_path)

    def resume(self) -> bool:
        """Load the checkpoint if present and it belongs to this exact
        problem (sequences, scoring, geometry and format); returns True if
        resumed."""
        if not os.path.exists(self.ckpt_path):
            return False
        with np.load(self.ckpt_path) as data:
            keys = ("next_idx", "rf", "cf", "out", "fingerprint")
            if any(k not in data for k in keys) or \
                    data["fingerprint"].tobytes().decode() != \
                    self._fingerprint():
                return False
            state = [data[k] for k in ("rf", "cf", "out")]
            next_idx = int(data["next_idx"])
        if any(s.shape != tuple(t.shape) or s.dtype != np.int32
               for s, t in zip(state, (self.rf, self.cf, self.out))) or \
                not 0 <= next_idx <= self.n_blocks:
            return False
        self.rf, self.cf, self.out = (torch.from_numpy(s).to(self.device)
                                      for s in state)
        self.next_idx = next_idx
        return True

    def run(self, checkpoint: bool = True) -> int:
        """Run the remaining tiles (possibly after resume); returns the
        score."""
        while self.next_idx < self.n_blocks:
            count = min(self.every, self.n_blocks - self.next_idx)
            state = _segment(self.arrs, self.lens, self.dims,
                             bk.BlockedState(self.rf, self.cf, self.out),
                             self.next_idx, count, self.scoring)
            self.rf, self.cf, self.out = state
            self.next_idx += count
            if checkpoint:
                self.save()
        return int(self.out.max())


def align_blocked_checkpointed(
    a, b, c, scoring: Scoring = Scoring(), ckpt_path: Optional[str] = None,
    every: Optional[int] = None, resume: bool = True, **kw
) -> int:
    """Align with periodic checkpoints, resuming from an existing compatible
    checkpoint when present; the file is removed at the end.  ``kw`` goes
    to :class:`CheckpointedAligner` (``device``, ``block_shape``)."""
    runner = CheckpointedAligner(a, b, c, scoring, ckpt_path, every, **kw)
    if resume:
        runner.resume()
    score = runner.run()
    if runner.ckpt_path and os.path.exists(runner.ckpt_path):
        os.remove(runner.ckpt_path)
    return score
