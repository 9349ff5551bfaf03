"""choices_roofline: the least time of the cells the direct engine's
choice-capture sweep swept in the window (the program's counter
``choice_sweep.cells``, read just before the window and after it), at
OPS_PER_CELL int32 operations a cell and the frozen peak, as a share of the
device time of its kernel (``choices_persistent``) in the traced window."""

from benchmark import layers, stats

UNIT = "%"
SOURCE = "device_trace"
LAYER = "choice sweep (csrc/slab.cu choices_persistent)"
MOVES = "align_s"
# The choice-capture step's operations a cell (the 7-matrix update and the
# argmax of each target's sources; CHOICE_OPS of chip_smoke.py), frozen
# here.
OPS_PER_CELL = 88
KERNELS = ("choices_persistent",)
CELLS = layers.Cells(("choice_sweep",))


def install(probe):
    CELLS.install()


def read(window):
    cells = CELLS.moved()
    if window.trace is None or cells is None:
        return None
    return stats.roofline_pct(OPS_PER_CELL * cells,
                              stats.peak(window.kind, "int32_ops_per_s"),
                              window.trace.kernel_s(*KERNELS))
