"""Alignment recovery of the port (the counterpart of ``trialign.traceback``)."""

from trialign_torch.traceback.hirschberg import hirschberg_align  # noqa: F401
