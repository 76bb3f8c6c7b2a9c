"""How the port's closed-loop actions part from the JAX goldens, with and
without the reference's carried state.

    PYTHONPATH=. python scripts/exp_loop_carry.py
    PYTHONPATH=. python scripts/exp_loop_carry.py --episode NAME [--device cpu]

For each closed-loop golden ``tests/golden/torch/loop_<scenario>.npz``
(``LOOP_SCENARIOS``: the JAX facade's closed loop,
``scripts/make_torch_goldens.py``), runs the port's facade on the CPU over
the recorded states and points twice: once installing, before each tick,
the PANState and velocity plan that the JAX facade carried into it, and
once carrying its own from tick to tick. Prints one JSON line per golden:
the largest action difference of each tick for both.

``--episode NAME``: ``tests/golden/torch/NAME.npz``, a whole episode of the
JAX facade (``episode_reverse_acker``: its selection on the materialized
point flow, the path off the TPU; ``episode_reverse_acker_fused``: the
fused selection kernel, the TPU's path), against the port's facade on
``--device`` (default: the card) taking the same selection path (the
flow-select kernel, or its plain version on the CPU; or the materialized
flow). Prints one JSON line for each of two runs: "given", every recorded
tick with the JAX facade's carried state installed (the action, min_distance
and carry-out differences of each tick); "own", the port's facade in the
port's simulator carrying its own state for up to 700 ticks (arrival, the
state difference from JAX's episode by tick and the first tick it exceeds
1e-3 m or rad). Reads only the goldens; imports no JAX.
"""

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from neupan_torch import NeuPan  # noqa: E402
from neupan_torch.ops.pan import PANState  # noqa: E402
from scripts.make_torch_goldens import (CARRY, LOOP_SCENARIOS, _golden_inputs,  # noqa: E402
                                        loop_overrides)


def replay(g, planner, point_vel, carry: bool):
    diffs = []
    for i in range(len(g["action"])):
        if carry:
            planner.pan_state = PANState(*(torch.as_tensor(g[f][i])[None] for f in CARRY))
            planner.cur_vel_array = g["cur_vel"][i].copy()
        action, _ = planner(*_golden_inputs(g, i, point_vel))
        diffs.append(float(np.abs(action - g["action"][i]).max()))
    return diffs


def _rel(d, b) -> float:
    return float(d) / (1.0 + float(np.abs(b).max()))


def episode(name, device) -> None:
    from neupan_torch.sim.env_loader import load_env

    with np.load(os.path.join(ROOT, "tests/golden/torch", f"{name}.npz")) as f:
        g = {k: f[k] for k in f.files}
    base = os.path.join(ROOT, "examples", str(g["example"]))

    def make():
        planner = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"), device=device)
        planner.spec = dataclasses.replace(planner.spec, dune_kernel=bool(g["fused"]))
        return planner

    planner, given = make(), {"action": [], "min_distance": [], "carry_out": []}
    for i in range(len(g["action"])):
        planner.pan_state = PANState(*(torch.as_tensor(g[f][i], device=planner._device)[None]
                                       for f in CARRY))
        planner.cur_vel_array = g["cur_vel"][i].copy()
        action, _ = planner(*_golden_inputs(g, i, False))
        given["action"].append(float(np.abs(action - g["action"][i]).max()))
        given["min_distance"].append(abs(planner.min_distance - float(g["min_distance"][i])))
        if i + 1 < len(g["action"]):
            own = {f: getattr(planner.pan_state, f)[0].double().cpu().numpy()
                   for f in ("prev_s", "prev_u", "x_warm", "y_warm")}
            own["cur_vel"] = planner.cur_vel_array
            nxt = {f: g["cur_vel" if f == "cur_vel" else f"carry_{f}"][i + 1] for f in own}
            given["carry_out"].append(max(_rel(np.abs(own[f] - nxt[f]).max(), nxt[f])
                                          for f in own))
    print(json.dumps({"episode": name, "run": "given", "device": str(device),
                      **given}), flush=True)

    planner = make()
    env = load_env(os.path.join(base, "env.yaml"), planner.robot)
    states, actions, min_d, arrived = [], [], [], None
    for i in range(700):
        state = env.get_robot_state()
        action, info = planner(state, planner.scan_to_point(state, env.get_lidar_scan()))
        states.append(state[:, 0].copy())
        actions.append(np.asarray(action)[:, 0].tolist())
        min_d.append(planner.min_distance)
        if info["arrive"]:
            arrived = i
            break
        env.step(action)
    n = min(len(states), len(g["state"]))
    d_state = [float(np.abs(states[i] - g["state"][i][:, 0]).max()) for i in range(n)]
    parts = next((i for i, d in enumerate(d_state) if d > 1e-3), None)
    print(json.dumps({"episode": name, "run": "own", "device": str(device),
                      "arrived_at": arrived,
                      "jax_arrived_at": len(g["action"]) - 1 if g["arrive"][-1] else None,
                      "ticks": len(states), "contacts": env.collision_count,
                      "state_vs_jax": d_state, "parts_at_tick": parts,
                      "action_vs_jax": [float(np.abs(np.array(actions[i])
                                                     - g["action"][i][:, 0]).max())
                                        for i in range(n)],
                      "min_distance_last": min_d[-1], "state_last": states[-1].tolist()}),
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--episode", metavar="NAME", default=None)
    parser.add_argument("--device", default=None, help="the episode's device (default: the card)")
    args = parser.parse_args()
    if args.episode:
        episode(args.episode, args.device)
        return
    for name in sorted(LOOP_SCENARIOS):
        with np.load(os.path.join(ROOT, "tests/golden/torch", f"{name}.npz")) as f:
            g = {k: f[k] for k in f.files}
        example, _, waypoints, receding, point_vel = LOOP_SCENARIOS[name]
        out = {"golden": name}
        for carry in (True, False):
            planner = NeuPan.init_from_yaml(
                os.path.join(ROOT, "examples", example, "planner.yaml"), device="cpu",
                **loop_overrides(example, waypoints, receding))
            planner.spec = dataclasses.replace(planner.spec, dune_kernel=False)
            out["given_jax_state" if carry else "own_state"] = replay(g, planner, point_vel,
                                                                      carry)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
