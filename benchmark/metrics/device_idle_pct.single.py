"""device_idle_pct: the share of the traced window in which no operation
ran on the device: one less the union of the device's operation intervals
over the window's length, in percent."""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device (the GPU's timeline)"
MOVES = "score_ms"


def read(window):
    tr = window.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
