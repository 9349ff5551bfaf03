"""k4_dispatches: K4 launches a batch, from the program's counter
``hetero.final_values.launches`` read around each request (one persistent
launch a dispatch)."""

UNIT = "count"
SOURCE = "program_counter"
LAYER = "routing (api.batch_routes, kernels/mosaic.py, hetero.plan_dispatches)"
MOVES = "batch_gcups"


def install(probe):
    probe.counter("k4", "trialign_torch.kernels.hetero", "final_values")


def read(window):
    done = window.done
    if not done:
        return None
    return sum(r.counters.get("k4", 0) for r in done) / len(done)
