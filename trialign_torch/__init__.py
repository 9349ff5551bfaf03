"""TriAlign on PyTorch and CUDA: the port of the JAX package ``trialign``.

The score path of ``align(a, b, c)`` runs on an NVIDIA Hopper GPU through two
CUDA kernels written for ``sm_90a`` (``csrc/``): the single-block wavefront
sweep for |B|, |C| <= 255 and the blocked, sliced sweep beyond.  Scoring,
encoding and the host oracles are the reference's own JAX-free modules
(``trialign.config``, ``trialign.golden``, ``trialign.native``); this package
never imports JAX.
"""

from trialign.config import Scoring, decode, encode  # noqa: F401


def __getattr__(name):
    # Lazy, as in the reference: `import trialign_torch` stays cheap.
    if name in ("align", "AlignResult"):
        from trialign_torch import api

        return getattr(api, name)
    raise AttributeError(f"module 'trialign_torch' has no attribute {name!r}")
