"""LON variant 02 on the PyTorch port (the counterpart of
``LON_corridor_02.py``): composite loss (state MSE + speed MSE + distance
loss) with stuck detection, at a coarser control period (step_time 0.2,
planner_02.yaml).

The robot is "stuck" when its position moves less than STUCK_THRESHOLD
for more than STUCK_COUNT_THRESHOLD consecutive steps; the distance loss
then switches to the 50 + sum(d) branch, pushing the tuned parameters away
from over-conservative settings.

    python examples/LON/LON_corridor_02_torch.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from LON_corridor_torch import (LONTuner, device_arg, eval_episode, make_planner,  # noqa: E402
                                scenario_dir, step_inputs, tuning_step)
from neupan_torch.lon import distance_loss, tracking_losses  # noqa: E402
from neupan_torch.sim.env_loader import load_env  # noqa: E402

EPOCHS = int(os.environ.get("LON_EPOCHS", "3"))
MAX_STEPS = int(os.environ.get("LON_MAX_STEPS", "120"))
STUCK_THRESHOLD = 0.01
STUCK_COUNT_THRESHOLD = 5


def composite_loss(out, ref_s, ref_us, stuck):
    """State MSE + speed MSE + distance loss with the stuck branch, per
    scenario."""
    state_loss, speed_loss = tracking_losses(out, ref_s, ref_us)
    d_loss = distance_loss(out.opt_d, out.min_distance,
                           collision_threshold=0.5, stuck=stuck)
    return state_loss + speed_loss + d_loss


def run_episode(planner, tuner, base):
    env = load_env(os.path.join(base, "env.yaml"), planner.robot)
    planner.reset()
    losses = []
    stuck_count = 0
    for _ in range(MAX_STEPS):
        state = env.get_robot_state()
        points = planner.scan_to_point(state, env.get_lidar_scan())

        action, info = planner(state, points)
        if info["arrive"]:
            break

        pre_position = env.get_robot_state()[0:2]
        env.step(action)
        moved = float(np.linalg.norm(env.get_robot_state()[0:2] - pre_position))
        stuck_count = stuck_count + 1 if moved < STUCK_THRESHOLD else 0
        stuck = stuck_count > STUCK_COUNT_THRESHOLD

        if points is not None:
            loss, grads = tuning_step(planner, step_inputs(planner, state, points),
                                      loss_fn=composite_loss, stuck=stuck)
            planner.set_adjust_parameters(tuner.update(planner.adjust, grads))
            losses.append(float(loss))

        if env.collided or stuck:
            break
    return losses


def _composite_info_loss(info, planner):
    """The composite loss computed from planner outputs (no gradients), for
    the fixed-semantics before/after evaluation."""
    state_loss = float(torch.mean((info["state_tensor"] - info["ref_state_tensor"]) ** 2))
    speed_loss = float(torch.mean((info["vel_tensor"][0, :] - info["ref_speed_tensor"]) ** 2))
    d = info["distance_tensor"]
    d_loss = float(distance_loss(d, torch.tensor(planner.min_distance, device=d.device),
                                 collision_threshold=0.5))
    return state_loss + speed_loss + d_loss


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    planner = make_planner("corridor/diff", device_arg(),
                           planner_file=os.path.join(here, "planner_02.yaml"))
    tuner = LONTuner(planner.adjust, lr=5e-3)
    base = scenario_dir("corridor/diff")

    save = os.environ.get("LON_SAVE")

    def emit(line):
        print(line, flush=True)
        if save:
            with open(save, "a") as f:
                print(line, file=f)

    base_eval = eval_episode(planner, base, info_loss=_composite_info_loss)
    emit(f"BASELINE (untuned): {base_eval}")

    for epoch in range(EPOCHS):
        losses = run_episode(planner, tuner, base)
        adj = planner.adjust
        emit(f"epoch {epoch}: steps={len(losses)} "
             f"episode_loss={np.sum(losses) if losses else 0:.3f} "
             f"mean_loss={np.mean(losses) if losses else 0:.4f} "
             f"p_u={float(adj.p_u):.4f} eta={float(adj.eta):.4f} "
             f"d_max={float(adj.d_max):.4f}")

    final_eval = eval_episode(planner, base, info_loss=_composite_info_loss)
    emit(f"FINAL (tuned, frozen): {final_eval}")
    improved = (final_eval["mean_step_loss"] <= base_eval["mean_step_loss"]
                and not final_eval["collided"]
                and final_eval["steps_to_arrive"] is not None)
    emit(f"IMPROVED: {improved} (mean_step_loss "
         f"{base_eval['mean_step_loss']:.3f} -> "
         f"{final_eval['mean_step_loss']:.3f}, min_clearance "
         f"{base_eval['min_clearance']:.3f} -> "
         f"{final_eval['min_clearance']:.3f}, steps_to_arrive "
         f"{base_eval['steps_to_arrive']} -> "
         f"{final_eval['steps_to_arrive']})")
