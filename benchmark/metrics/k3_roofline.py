"""k3_roofline: the least time of the K3-routed requests' sweeps, at
OPS_PER_CELL int32 operations a cell and the frozen peak, as a share of the
device time of K3's kernel (``blocked_persistent``) in the traced window.
A request is K3's when the program's counter
``blocked.final_values.launches`` moved during it."""

from benchmark import stats

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K3 (csrc/blocked.cu)"
MOVES = "score_ms"
OPS_PER_CELL = 65
KERNELS = ("blocked_persistent",)


def install(probe):
    probe.counter("k3", "trialign_torch.kernels.blocked", "final_values")


def read(window):
    if window.trace is None:
        return None
    cells = sum(r.cells for r in window.done if r.counters.get("k3"))
    return stats.roofline_pct(OPS_PER_CELL * cells,
                              stats.peak(window.kind, "int32_ops_per_s"),
                              window.trace.kernel_s(*KERNELS))
