"""The host's cost of issuing one step: the host clock around the call into
the entry point until it returns, before any read, averaged over the
measured window (untraced)."""

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "entry point", "solves_per_s"


def read(run):
    w = run["window"]
    return sum(w.issue_s) / len(w.issue_s) * 1e3
