"""Kernels the device ran per step over the traced steps (copies and fills not
counted)."""

UNIT, SOURCE, LAYER, MOVES = "kernels", "device_trace", "entry point", "solves_per_s"


def read(run):
    tr = run["trace"]
    if tr is None or tr["kernels"] == 0:
        return None
    return tr["kernels"] / tr["steps"]
