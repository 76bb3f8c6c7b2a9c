"""The 95th percentile over every step of the measured window, each step
timed from handing its inputs to the entry point until its actions are on
the host."""

import numpy as np

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "end to end", None


def read(run):
    return float(np.percentile(run["window"].step_s, 95)) * 1e3
