"""k2_roofline: the least time of the K2-routed requests' sweeps, at
OPS_PER_CELL int32 operations a cell and the frozen peak, as a share of the
device time of K2's kernel (``wavefront_sweep``) in the traced window.  A
request is K2's when the program's counter
``wavefront.final_values.launches`` moved during it."""

from benchmark import stats

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K2 (csrc/wavefront.cu)"
MOVES = "score_ms"
OPS_PER_CELL = 65
KERNELS = ("wavefront_sweep",)


def install(probe):
    probe.counter("k2", "trialign_torch.kernels.wavefront", "final_values")


def read(window):
    if window.trace is None:
        return None
    cells = sum(r.cells for r in window.done if r.counters.get("k2"))
    return stats.roofline_pct(OPS_PER_CELL * cells,
                              stats.peak(window.kind, "int32_ops_per_s"),
                              window.trace.kernel_s(*KERNELS))
