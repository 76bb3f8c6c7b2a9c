"""Share of the traced window in which no operation runs on a card (the
union of its kernels, copies and fills)."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "solves_per_s"


def read(run):
    tr = run["trace"]
    if tr is None or tr["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
