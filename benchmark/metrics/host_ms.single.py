"""host_ms: host milliseconds a completed score request spends in the
program outside waiting for the card, from the program's own spans on the
profiler's clock: each outermost ``trialign.align`` span less the
``trialign.wait`` spans inside it, summed over the traced window and
divided by its completed requests."""

from benchmark import layers

UNIT = "ms"
SOURCE = "program_span"
LAYER = "host (api.py entry to each launch: route, plan, pack, launch)"
MOVES = "score_ms"


def read(window):
    return layers.host_ms(window, "trialign.align")
