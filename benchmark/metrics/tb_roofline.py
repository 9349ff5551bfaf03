"""tb_roofline: the least time of one score sweep of each alignment's
cuboid, at OPS_PER_CELL int32 operations a cell and the frozen peak, as a
share of all kernel time in the traced window (K5's splits, the direct
engine's choice sweep and walk, and any other kernel the requests run).
An alignment needs at least one sweep of its cuboid, so a PR that
recomputes less gains."""

from benchmark import stats

UNIT = "%"
SOURCE = "device_trace"
LAYER = ("traceback (traceback/hirschberg.py, traceback/direct.py, "
         "csrc/slab.cu, csrc/walk.cu)")
MOVES = "align_s"
OPS_PER_CELL = 65


def read(window):
    if window.trace is None:
        return None
    cells = sum(r.cells for r in window.done)
    return stats.roofline_pct(OPS_PER_CELL * cells,
                              stats.peak(window.kind, "int32_ops_per_s"),
                              window.trace.kernel_s())
