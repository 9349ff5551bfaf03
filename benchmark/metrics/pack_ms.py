"""pack_ms: host milliseconds a batch spends in K4's host sides, planning
its dispatches (``hetero.plan_dispatches``) and packing them
(``hetero.prep_hetero``): the benchmark's own spans around those calls,
summed over the window and divided by its completed batches."""

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "host sides (kernels/hetero.py plan_dispatches, prep_hetero)"
MOVES = "batch_gcups"
MODULE = "trialign_torch.kernels.hetero"


def install(probe):
    probe.span("pack", MODULE, "plan_dispatches")
    probe.span("pack", MODULE, "prep_hetero")


def read(window):
    spans = [s for s in window.spans if s[0] == "pack"]
    if not spans or not window.done:
        return None
    return 1e3 * sum(end - start for _, start, end, _ in spans) / \
        len(window.done)
