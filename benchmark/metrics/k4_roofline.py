"""k4_roofline: the least time of the K4-routed triplets' sweeps, at
OPS_PER_CELL int32 operations a cell and the frozen peak, as a share of the
device time of K4's kernel (``hetero_sweep``) in the traced window."""

from benchmark import stats

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K4 (csrc/hetero.cu)"
MOVES = "batch_gcups"
# The grouped 7-matrix update's operations a cell under the configurations'
# scoring (65 for the RTL's constants), frozen here.
OPS_PER_CELL = 65
KERNELS = ("hetero_sweep",)


def install(probe):
    probe.counter("k4", "trialign_torch.kernels.hetero", "final_values")


def read(window):
    if window.trace is None:
        return None
    cells = sum(r.cells for r in window.done if r.counters.get("k4"))
    return stats.roofline_pct(OPS_PER_CELL * cells,
                              stats.peak(window.kind, "int32_ops_per_s"),
                              window.trace.kernel_s(*KERNELS))
