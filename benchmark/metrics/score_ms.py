"""score_ms: the window's milliseconds over the score requests completed in
it (host clock)."""

from benchmark import stats

UNIT = "ms"
SOURCE = "host_clock"


def read(window):
    s = stats.per_request(window.seconds, len(window.done))
    return None if s is None else 1e3 * s
