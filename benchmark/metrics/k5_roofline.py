"""k5_roofline: the least time of the cells K5 swept in the window (the
program's counters ``slab_sweep.cells`` and ``sweep_tiles.cells``, read
just before the window and after it), at OPS_PER_CELL int32 operations a
cell and the frozen peak, as a share of the device time of K5's kernel
(``slab_persistent``) in the traced window."""

from benchmark import layers, stats

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K5 (csrc/slab.cu slab_persistent)"
MOVES = "align_s"
# The grouped 7-matrix update's operations a cell under the configurations'
# scoring (65 for the RTL's constants), frozen here.
OPS_PER_CELL = 65
KERNELS = ("slab_persistent",)
CELLS = layers.Cells(("slab_sweep", "sweep_tiles"))


def install(probe):
    CELLS.install()


def read(window):
    cells = CELLS.moved()
    if window.trace is None or cells is None:
        return None
    return stats.roofline_pct(OPS_PER_CELL * cells,
                              stats.peak(window.kind, "int32_ops_per_s"),
                              window.trace.kernel_s(*KERNELS))
