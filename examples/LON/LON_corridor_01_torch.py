"""LON variant 01 on the PyTorch port (the counterpart of
``LON_corridor_01.py``): the same tuning loop as LON_corridor_torch.py,
started from the pre-tuned adjust parameters in planner_01.yaml.

    python examples/LON/LON_corridor_01_torch.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from LON_corridor_torch import (LONTuner, device_arg, make_planner, run_episode,  # noqa: E402
                                scenario_dir)

EPOCHS = int(os.environ.get("LON_EPOCHS", "3"))

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    planner = make_planner("corridor/diff", device_arg(),
                           planner_file=os.path.join(here, "planner_01.yaml"))
    tuner = LONTuner(planner.adjust, lr=5e-3)
    base = scenario_dir("corridor/diff")

    save = os.environ.get("LON_SAVE")
    for epoch in range(EPOCHS):
        losses, min_dists = run_episode(planner, tuner, base)
        adj = planner.adjust
        line = (f"epoch {epoch}: steps={len(losses)} "
                f"episode_loss={np.sum(losses) if losses else 0:.3f} "
                f"min_dist={np.min(min_dists) if min_dists else float('inf'):.3f} "
                f"p_u={float(adj.p_u):.4f} eta={float(adj.eta):.4f} "
                f"d_max={float(adj.d_max):.4f}")
        print(line, flush=True)
        if save:
            with open(save, "a") as f:
                print(line, file=f)
