"""score_p95_ms: the 95th percentile (nearest rank) of the latencies of all
score requests in the window, in milliseconds (host clock)."""

from benchmark import stats

UNIT = "ms"
SOURCE = "host_clock"


def read(window):
    p = stats.percentile([r.seconds for r in window.records], 95)
    return None if p is None else 1e3 * p
