"""TriAlign on PyTorch and CUDA: the port of the JAX package ``trialign``.

The score path of ``align(a, b, c)`` runs on an NVIDIA Hopper GPU through two
CUDA kernels written for ``sm_90a`` (``csrc/``): the wavefront sweep for
|B|, |C| <= 255 (a call's tiles over the whole card in one launch) and the
blocked, sliced sweep beyond.
``align_batch`` scores a large batch through the heterogeneous batch kernel,
many triplets a launch, and smaller ones through the first two.
``align(..., return_alignment=True)`` recovers an alignment through the
Hirschberg/direct engine (``traceback/``), whose biggest splits run on the
slab kernel.  ``align_resilient`` checkpoints a long blocked sweep and
resumes it after a failure; ``align_batch_resilient`` re-dispatches only the
unscored problems of a failed batch.  ``dist/`` spreads a batch over a
mesh of devices and processes (``align_batch_sharded``) and one long
triplet over stripes of its tile grid (``dist.halo``, ``dist.halo_tb``).
The package keeps its own copies of the scoring, encoding, golden models,
datasets and host C++ oracle (``config``, ``golden``, ``io``, ``native``):
it imports neither JAX nor the JAX package ``trialign``.
``python -m trialign_torch.cli`` is its command line.
"""

from trialign_torch.config import Scoring, decode, encode  # noqa: F401


def __getattr__(name):
    # Lazy, as in the reference: `import trialign_torch` stays cheap.
    if name in ("align", "align_batch", "AlignResult"):
        from trialign_torch import api

        return getattr(api, name)
    if name in ("align_resilient", "align_batch_resilient"):
        from trialign_torch import resilience

        return getattr(resilience, name)
    if name in ("align_batch_bucketed", "align_batch_sharded"):
        from trialign_torch.dist import batch

        return getattr(batch, name)
    raise AttributeError(f"module 'trialign_torch' has no attribute {name!r}")
