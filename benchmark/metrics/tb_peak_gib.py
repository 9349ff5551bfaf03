"""tb_peak_gib: the device memory an alignment takes at its peak,
``torch.cuda.max_memory_allocated()`` after a reset before each request,
the largest over the window's alignments, in GiB."""

UNIT = "GiB"
SOURCE = "program_counter"
LAYER = ("traceback (traceback/hirschberg.py, traceback/direct.py, "
         "csrc/slab.cu, csrc/walk.cu)")
MOVES = "align_s"


def install(probe):
    probe.peak_per_request()


def read(window):
    peaks = [r.peak_bytes for r in window.done if r.peak_bytes is not None]
    return max(peaks) / 2**30 if peaks else None
