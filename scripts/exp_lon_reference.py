"""The LON corridor reference as the two packages compute it today, on the CPU.

    PYTHONPATH=. python scripts/exp_lon_reference.py [--port-only]

``examples/LON/results_corridor.txt`` was recorded by an earlier version
of the JAX package. This script runs, on the CPU, the untuned evaluation
episode and one tuning episode (epoch 0: LON_MAX_STEPS ticks, threshold
LON_COLL, lr 5e-3, as ``LON_corridor.py`` runs them) of

* the JAX package (``examples/LON/LON_corridor.py``; it ranks points on
  the materialized flow off the TPU), unless ``--port-only``;
* the port on the same materialized path (``dune_kernel=False``);
* the port on its main path (the fused selection), which the card runs;

and prints for each the evaluation's result and the epoch's line with
the ticks that carried a nonzero loss. A few minutes in all.
"""

import argparse
import dataclasses
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "examples", "LON"))

import numpy as np  # noqa: E402

BASE = os.path.join(ROOT, "examples", "corridor", "diff")


def epoch_line(name, losses, min_dists, adjust):
    nonzero = [(i, round(float(v), 3)) for i, v in enumerate(losses) if v > 0]
    return (f"{name} epoch 0: steps={len(losses)} episode_loss={np.sum(losses):.3f} "
            f"min_dist={np.min(min_dists):.4f} p_u={float(adjust.p_u):.4f} "
            f"eta={float(adjust.eta):.4f} d_max={float(adjust.d_max):.4f} "
            f"nonzero-loss ticks {nonzero}")


def run_jax():
    from LON import LON_corridor as L

    from neupan_tpu.lon import LONTuner
    from neupan_tpu.planner import NeuPan

    planner = NeuPan.init_from_yaml(os.path.join(BASE, "planner.yaml"))
    print("jax baseline:", L.eval_episode(planner, BASE), flush=True)
    planner.stuck_enabled = False
    losses, dists = L.run_episode(planner, LONTuner(planner.adjust, lr=5e-3), BASE)
    print(epoch_line("jax", losses, dists, planner.adjust), flush=True)


def run_port(fused):
    import LON_corridor_torch as L

    name = "port " + ("fused" if fused else "materialized")
    planner = L.make_planner("corridor/diff", device="cpu")
    if not fused:
        planner.spec = dataclasses.replace(planner.spec, dune_kernel=False)
    print(f"{name} baseline:", L.eval_episode(planner, BASE), flush=True)
    losses, dists = L.run_episode(planner, L.LONTuner(planner.adjust, lr=5e-3), BASE)
    print(epoch_line(name, losses, dists, planner.adjust), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port-only", action="store_true", help="skip the JAX package")
    if not parser.parse_args().port_only:
        run_jax()
    run_port(fused=False)
    run_port(fused=True)
