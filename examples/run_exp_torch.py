"""Closed-loop scenario runner for the PyTorch port (``neupan_torch``): the
counterpart of ``examples/run_exp.py``, with the port's planner and its own
copy of the built-in ``Sim2D``. Imports no JAX.

Usage:
    python examples/run_exp_torch.py -e corridor -d diff [-v] [-m 1000] [-q] [--device cpu]

The planner runs on the CUDA card unless ``--device`` names another
device; without a card and without ``--device cpu`` it raises.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neupan_torch import NeuPan  # noqa: E402
from neupan_torch.sim.env_loader import load_env  # noqa: E402


def main(env_file, planner_file, point_vel=False, max_steps=1000,
         reverse=False, quiet=False, save_animation=False, full=False,
         no_display=True, ani_name="animation", device=None):
    planner = NeuPan.init_from_yaml(planner_file, device=device)
    env = load_env(env_file, planner.robot)

    renderer = None
    if save_animation or not no_display:
        from neupan_torch.sim.render import Renderer
        renderer = Renderer(env, display=not no_display,
                            figsize=(12, 9) if full else (8, 6))

    result = run_loop(planner, env, point_vel, max_steps, reverse, quiet,
                      renderer)
    if renderer is not None:
        if save_animation:
            out = renderer.save_animation(
                os.path.join("animation", f"{ani_name}.gif"))
            if out and not quiet:
                print(f"animation saved to {out}")
        renderer.close()
    return result


def run_loop(planner, env, point_vel, max_steps, reverse=False, quiet=True,
             renderer=None):
    """Drive ``planner`` in ``env`` until it arrives, collides or runs out of
    steps (``examples/run_exp.py:_run_loop``); returns dict(arrived,
    collided, steps, contacts)."""
    for i in range(max_steps):
        robot_state = env.get_robot_state()
        lidar_scan = env.get_lidar_scan()

        if point_vel:
            points, point_velocities = planner.scan_to_point_velocity(
                robot_state, lidar_scan)
        else:
            points = planner.scan_to_point(robot_state, lidar_scan)
            point_velocities = None

        action, info = planner(robot_state, points, point_velocities)

        if renderer is not None:
            renderer.draw_frame(planner, planner.initial_path)

        if info["stop"] and not quiet:
            print("NeuPAN stops because of minimum distance")
        if info["arrive"]:
            if not quiet:
                print(f"NeuPAN arrives at the target in {i} steps")
            return dict(arrived=True, collided=env.collided, steps=i,
                        contacts=env.collision_count)

        env.step(action)
        if env.collided:
            if not quiet:
                print("collision detected")
            return dict(arrived=False, collided=True, steps=i,
                        contacts=env.collision_count)

        if i == 0 and reverse:
            for j in range(len(planner.initial_path)):
                planner.initial_path[j][-1, 0] = -1
                planner.initial_path[j][-2, 0] += 3.14

        if not quiet and i % 20 == 0:
            s = env.get_robot_state()
            print(f"step {i}: pos=({s[0,0]:.2f},{s[1,0]:.2f}) "
                  f"min_dist={planner.min_distance:.3f}")

    return dict(arrived=False, collided=env.collided, steps=max_steps,
                contacts=env.collision_count)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-e", "--example", type=str, default="corridor")
    parser.add_argument("-d", "--kinematics", type=str, default="diff")
    parser.add_argument("-v", "--point_vel", action="store_true")
    parser.add_argument("-m", "--max_steps", type=int, default=1000)
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("-a", "--save_animation", action="store_true",
                        help="save the run as animation/<scenario>.gif")
    parser.add_argument("-f", "--full", action="store_true",
                        help="larger figure (fullscreen equivalent)")
    parser.add_argument("-n", "--no_display", action="store_true",
                        help="headless rendering (Agg); default behavior "
                             "unless -a is given without -n")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the planner (default: the CUDA card)")
    args = parser.parse_args()

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        args.example, args.kinematics)
    reverse = args.example == "reverse" and args.kinematics == "diff"
    result = main(os.path.join(base, "env.yaml"),
                  os.path.join(base, "planner.yaml"),
                  args.point_vel, args.max_steps, reverse, args.quiet,
                  save_animation=args.save_animation, full=args.full,
                  no_display=args.no_display or args.save_animation,
                  ani_name=f"{args.example}_{args.kinematics}",
                  device=args.device)
    print(result)
