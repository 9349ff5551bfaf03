"""batch_gcups: the DP cells (|A| |B| |C|) of every batch completed in the
window over the window's seconds, in 1e9 cells a second (host clock)."""

from benchmark import stats

UNIT = "Gcell/s"
SOURCE = "host_clock"


def read(window):
    done = window.done
    if not done:
        return None
    return stats.rate(sum(r.cells for r in done), window.seconds) / 1e9
