"""LON example on the PyTorch port: tune the adjust parameters online
through the QP layer (the counterpart of ``LON_corridor.py``).

Runs closed-loop corridor episodes in the port's simulator
(``neupan_torch.sim``); per tick, differentiates the distance loss of the
planner step through the NRMP QP into [p_u, eta, d_max] and applies Adam
(``neupan_torch.lon``). Imports no JAX.

    python examples/LON/LON_corridor_torch.py [--device cpu]

The planner runs on the CUDA card unless ``--device`` (or the environment
variable NEUPAN_DEVICE) names another device. The same knobs as
``LON_corridor.py``: LON_EPOCHS, LON_MAX_STEPS, LON_EVAL_STEPS, LON_COLL,
LON_LR, LON_FIELDS, LON_SCENARIO, LON_SAVE.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from neupan_torch import NeuPan  # noqa: E402
from neupan_torch.lon import LONTuner, distance_loss, step_loss_and_grad  # noqa: E402
from neupan_torch.sim.env_loader import load_env  # noqa: E402

EPOCHS = int(os.environ.get("LON_EPOCHS", "3"))
MAX_STEPS = int(os.environ.get("LON_MAX_STEPS", "120"))
# evaluation episodes get enough budget to arrive (corridor/diff arrives in
# ~231 steps), so steps-to-arrive is a usable navigation metric
EVAL_STEPS = int(os.environ.get("LON_EVAL_STEPS", "300"))
# the tuning loss's near-collision threshold: it must sit close to the
# clearance the environment forces (the corridor squeeze passes at
# ~0.35 m); with 0.5 the zero-loss set and arriving exclude each other
# (examples/LON/results_corridor.txt)
COLLISION_THRESHOLD = float(os.environ.get("LON_COLL", "0.4"))


def scenario_dir(scenario):
    """examples/<scenario>, e.g. ``corridor/diff``."""
    return os.path.join(REPO, "examples", *scenario.split("/"))


def make_planner(scenario, device=None, planner_file=None):
    """The port's planner of ``scenario`` (or of ``planner_file``), with the
    deadlock escape off: LON owns the stuck behaviour through its loss,
    and the escape's temporary eta/d_max boost would leak into the tuned
    weights."""
    planner = NeuPan.init_from_yaml(
        planner_file or os.path.join(scenario_dir(scenario), "planner.yaml"), device=device)
    planner.stuck_enabled = False
    return planner


def step_inputs(planner, state, points, velocities=None):
    """The batched (B=1) inputs of ``planner``'s differentiated step after
    its tick at ``state``: the nominal and reference trajectories from the
    velocity plan the tick left, and the padded points."""
    nom_s, nom_u, ref_s, ref_us = planner.ipath.generate_nom_ref_state(
        state, planner.cur_vel_array, planner.ref_speed)
    pts, vels, mask = planner._pad_points(points, velocities)
    up = lambda a: planner._t(a)[None]
    return (up(nom_s), up(nom_u), up(ref_s), up(ref_us), up(pts), up(vels),
            torch.as_tensor(mask, device=planner.G.device)[None])


def tuning_step(planner, inputs, **kw):
    """(loss (1,), grads) of ``planner``'s step on ``inputs`` from its
    carried state and current weights."""
    return step_loss_and_grad(
        planner.spec, planner.encoder, planner.vertices, planner.G, planner.h,
        planner.adjust, *inputs, planner.pan_state,
        collision_threshold=COLLISION_THRESHOLD, **kw)[:2]


def _default_info_loss(info, planner):
    d = info["distance_tensor"]
    return float(distance_loss(d, torch.tensor(planner.min_distance, device=d.device),
                               COLLISION_THRESHOLD))


def eval_episode(planner, base, max_steps=None, info_loss=_default_info_loss):
    """Fixed-semantics evaluation: run the episode without tuning.

    Returns dict(steps_to_arrive (or None), collided, min_clearance,
    mean_clearance, mean_step_loss), the per-step loss ``info_loss(info,
    planner)`` defaulting to the distance loss the tuner optimizes. The
    tuning epochs' episode loss conflates loss level with episode length,
    so improvement is read from this evaluation. It runs the shipped
    planner behaviour: the deadlock escape is on.
    """
    max_steps = max_steps or EVAL_STEPS
    env = load_env(os.path.join(base, "env.yaml"), planner.robot)
    planner.reset()
    saved_stuck = planner.stuck_enabled
    planner.stuck_enabled = True
    arrived_at = None
    min_dists, losses = [], []
    for i in range(max_steps):
        state = env.get_robot_state()
        points = planner.scan_to_point(state, env.get_lidar_scan())
        action, info = planner(state, points)
        if info["arrive"]:
            arrived_at = i
            break
        if np.isfinite(planner.min_distance) and planner.min_distance < 1e8:
            # the no-points sentinel is 1e9: finite, but no clearance
            min_dists.append(float(planner.min_distance))
        if info.get("distance_tensor") is not None:
            losses.append(float(info_loss(info, planner)))
        env.step(action)
        if env.collided:
            break
    planner.stuck_enabled = saved_stuck
    planner.reset()
    return dict(
        steps_to_arrive=arrived_at,
        collided=bool(env.collided),
        min_clearance=float(np.min(min_dists)) if min_dists else float("inf"),
        mean_clearance=float(np.mean(min_dists)) if min_dists else float("inf"),
        mean_step_loss=float(np.mean(losses)) if losses else 0.0,
    )


def run_episode(planner, tuner, base, env=None, on_tick=None):
    """One closed-loop tuning episode of up to MAX_STEPS ticks; returns
    (losses, min_dists).

    Each tick runs the facade (inference, with the kernels), then
    differentiates the distance loss of the same step from the state the
    tick carried out and steps the weights where the loss is nonzero: the
    step runs twice per tick, and the facade's own step stays free of
    autograd. ``env`` replaces the scenario's env.yaml world;
    ``on_tick(inputs, state_in, adjust_in, loss, grads)`` sees each
    differentiated step.
    """
    env = env or load_env(os.path.join(base, "env.yaml"), planner.robot)
    planner.reset()
    losses = []
    min_dists = []
    for _ in range(MAX_STEPS):
        state = env.get_robot_state()
        points = planner.scan_to_point(state, env.get_lidar_scan())

        action, info = planner(state, points)
        if info["arrive"]:
            break
        if np.isfinite(planner.min_distance) and planner.min_distance < 1e8:
            min_dists.append(float(planner.min_distance))

        # differentiate the distance loss wrt the adjust parameters and step
        if points is not None:
            inputs = step_inputs(planner, state, points)
            state_in, adjust_in = planner.pan_state, planner.adjust
            loss, grads = tuning_step(planner, inputs)
            if float(loss) > 0:
                planner.set_adjust_parameters(tuner.update(planner.adjust, grads))
            losses.append(float(loss))
            if on_tick is not None:
                on_tick(inputs, state_in, adjust_in, loss, grads)

        env.step(action)
        if env.collided:
            break
    return losses, min_dists


def main(epochs=EPOCHS, save_path=None, scenario=None, device=None):
    """Run LON tuning epochs; returns (records, baseline eval, final eval,
    the early-stopped selection).

    With ``save_path``, appends one line per epoch (parameter trajectory and
    episode loss). ``scenario`` (or LON_SCENARIO) picks the environment;
    LON_dyna_obs_torch.py runs the second recorded one.
    """
    scenario = scenario or os.environ.get("LON_SCENARIO", "corridor/diff")
    base = scenario_dir(scenario)
    planner = make_planner(scenario, device)
    fields = tuple(os.environ.get("LON_FIELDS", "p_u,eta,d_max").split(","))
    tuner = LONTuner(planner.adjust,
                     lr=float(os.environ.get("LON_LR", "5e-3")),
                     train_fields=fields)

    def emit(line):
        print(line, flush=True)
        if save_path:
            with open(save_path, "a") as f:
                print(line, file=f)

    base_eval = eval_episode(planner, base)
    emit(f"BASELINE (untuned): {base_eval}")

    # validation-based selection: evaluate after every epoch and keep the
    # weights of the best epoch that still arrives. The distance loss has
    # a zero-loss basin that trades goal completion for clearance, so the
    # deployable result is the early-stopped selection.
    best = dict(metrics=base_eval, adjust=planner.adjust, epoch=-1)

    records = []
    for epoch in range(epochs):
        losses, min_dists = run_episode(planner, tuner, base)
        adj = planner.adjust
        rec = dict(epoch=epoch, steps=len(losses),
                   episode_loss=float(np.sum(losses)) if losses else 0.0,
                   mean_loss=float(np.mean(losses)) if losses else 0.0,
                   min_dist=float(np.min(min_dists)) if min_dists else float("inf"),
                   mean_dist=float(np.mean(min_dists)) if min_dists else float("inf"),
                   p_u=float(adj.p_u), eta=float(adj.eta),
                   d_max=float(adj.d_max))
        records.append(rec)
        emit(f"epoch {epoch}: steps={rec['steps']} "
             f"episode_loss={rec['episode_loss']:.3f} "
             f"mean_loss={rec['mean_loss']:.3f} "
             f"min_dist={rec['min_dist']:.3f} "
             f"mean_dist={rec['mean_dist']:.3f} "
             f"p_u={rec['p_u']:.4f} eta={rec['eta']:.4f} "
             f"d_max={rec['d_max']:.4f}")

        ev = eval_episode(planner, base)
        emit(f"  eval after epoch {epoch}: {ev}")
        bm = best["metrics"]
        if (ev["steps_to_arrive"] is not None and not ev["collided"]
                and ev["mean_step_loss"] <= bm["mean_step_loss"]
                and ev["min_clearance"] >= bm["min_clearance"]):
            best = dict(metrics=ev, adjust=planner.adjust, epoch=epoch)

    final_eval = eval_episode(planner, base)
    emit(f"FINAL (last epoch, frozen): {final_eval}")
    sel, sm = best["epoch"], best["metrics"]
    emit(f"SELECTED (early-stopped, epoch {sel}): {sm}")
    improved = (sel >= 0
                and sm["mean_step_loss"] <= base_eval["mean_step_loss"]
                and sm["min_clearance"] >= base_eval["min_clearance"]
                and not sm["collided"]
                and sm["steps_to_arrive"] is not None)
    trade = ""
    if (improved and base_eval["steps_to_arrive"] is not None
            and sm["steps_to_arrive"] > base_eval["steps_to_arrive"]):
        trade = (f" — TRADE: arrival is {sm['steps_to_arrive'] - base_eval['steps_to_arrive']}"
                 " steps slower (clearance-first parameters take a wider line)")
    emit(f"IMPROVED: {improved} (baseline -> selected: mean_step_loss "
         f"{base_eval['mean_step_loss']:.3f} -> {sm['mean_step_loss']:.3f}, "
         f"min_clearance {base_eval['min_clearance']:.3f} -> "
         f"{sm['min_clearance']:.3f}, steps_to_arrive "
         f"{base_eval['steps_to_arrive']} -> {sm['steps_to_arrive']})"
         f"{trade}")
    return records, base_eval, final_eval, best


def device_arg():
    """--device from the command line, else NEUPAN_DEVICE, else the card."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=os.environ.get("NEUPAN_DEVICE"),
                        help="torch device of the planner (default: the CUDA card)")
    return parser.parse_args().device


if __name__ == "__main__":
    main(save_path=os.environ.get("LON_SAVE"), device=device_arg())
