"""tb_swept_ratio: the cells the traceback's sweeps (K5 and the direct
engine's choice-capture sweep; the program's counters ``slab_sweep``,
``sweep_tiles`` and ``choice_sweep``, ``.cells``, read just before the
window and after it) computed in the window, over the cells (|A| |B| |C|)
of the alignments completed in it: 1 would be one sweep of each cuboid,
and every recomputation adds to it."""

from benchmark import layers

UNIT = "x"
SOURCE = "program_counter"
LAYER = ("traceback (traceback/hirschberg.py, traceback/direct.py, "
         "csrc/slab.cu, csrc/walk.cu)")
MOVES = "align_s"
CELLS = layers.Cells(("slab_sweep", "sweep_tiles", "choice_sweep"))


def install(probe):
    CELLS.install()


def read(window):
    swept = CELLS.moved()
    cells = sum(r.cells for r in window.done)
    if swept is None or not cells:
        return None
    return swept / cells
