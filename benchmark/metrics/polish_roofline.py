"""The polish kernel's share of its roofline over the traced steps: the
least time of the configured polish candidates at the cell's shapes (frozen
``polish_work`` and ``bound``, launches from the configuration) over the
device time of the kernels named box_candidate_kernel."""

from benchmark.work import counts as W

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "solves_per_s"
NAMES = ("box_candidate_kernel",)


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    t = sum(v for k, v in tr["by_name"].items() if any(n in k for n in NAMES))
    if t <= 0.0:
        return None
    bound_ms = W.kernel_bounds_ms(run["shapes"], run["batch"])["polish"]
    return 100.0 * bound_ms * tr["steps"] / (t * 1e3)
