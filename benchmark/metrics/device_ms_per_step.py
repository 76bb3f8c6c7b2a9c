"""Device time per step over the traced steps: the union of the card's
kernels, copies and fills. Unlike the idle share
it does not move with the profiler's cost on the host."""

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "device", "solves_per_s"


def read(run):
    tr = run["trace"]
    if tr is None or tr["busy_s"] <= 0.0:
        return None
    return tr["busy_s"] / tr["steps"] * 1e3
