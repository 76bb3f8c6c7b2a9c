"""Process start to the first timed step: imports, CUDA contexts, the kernel
build where the checkout has none yet, the checkpoint, the traffic's tables
and the warm-up steps."""

UNIT, SOURCE, LAYER, MOVES = "s", "host_clock", "end to end", None


def read(run):
    return run["setup_s"]
