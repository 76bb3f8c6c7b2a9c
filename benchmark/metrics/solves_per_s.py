"""Scenario-steps completed in the measured window over the window's seconds:
all the work over all the time. Every cell reports it."""

UNIT, SOURCE, LAYER, MOVES = "solves/s", "host_clock", "end to end", None


def read(run):
    w = run["window"]
    return w.steps * run["batch"] / w.seconds
