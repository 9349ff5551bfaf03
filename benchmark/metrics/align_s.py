"""align_s: the window's seconds over the alignments (score and traceback)
completed in it (host clock)."""

from benchmark import stats

UNIT = "s"
SOURCE = "host_clock"


def read(window):
    return stats.per_request(window.seconds, len(window.done))
