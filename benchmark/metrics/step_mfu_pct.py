"""The whole step's share of the card's float32 peak: the float operations of
a scenario-step counted for the algorithm (``work.counts.step_flops``: the
selection, the encoder, the assembly products, the inverses, the ADMM
iterations, the polish), times the scenario-steps per second of the
measured window, over 67 TFLOP/s (float32 outside the tensor cores:
TF32 is off)."""

from benchmark.work import counts as W

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "device", "solves_per_s"


def read(run):
    w = run["window"]
    flops = sum(W.step_flops(run["shapes"]).values())
    return 100.0 * flops * w.steps * run["batch"] / w.seconds / W.PEAK_FLOPS
