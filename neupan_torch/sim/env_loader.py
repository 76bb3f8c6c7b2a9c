"""Environment YAML loader for the built-in 2-D simulator (port of
``neupan_tpu/sim/env_loader.py``).

Reads a practical subset of the reference's IR-SIM ``env.yaml`` schema
(reference: example/corridor/diff/env.yaml — world / robot / obstacle
sections) so our scenario configs stay familiar, and builds a ``Sim2D``.

Supported obstacle features:
  * shapes: rectangle (length/width), circle (radius), polygon (vertices),
    random polygon (``random_shape: true`` + avg_radius_range/irregularity);
  * placement: explicit ``state`` list or ``distribution: {name: random,
    range_low, range_high}`` (deterministic via the group ``seed``);
  * motion: constant per-obstacle ``velocity`` or a ``behavior`` block
    ({name: rvo|dash|wander, range_low, range_high, vxmax/vymax, factor,
    wander}) for dynamic scenes (reference: example/dyna_obs/*/env.yaml).

``build_env`` takes the parsed YAML and draws its random numbers in the
JAX loader's order, so the same seed builds the same obstacles and
behaviours. ``load_env`` reads the file; it imports ``yaml`` inside, so a
machine without pyyaml can still build a world from a dict.
"""

from __future__ import annotations

from typing import List

import numpy as np

from neupan_torch.robot import Robot
from neupan_torch.sim import (
    Behavior,
    LidarSpec,
    Obstacle,
    Sim2D,
    circle_obstacle,
    polygon_obstacle,
    random_polygon_vertices,
    rectangle_obstacle,
)
from neupan_torch.utils import file_check


def _make_behavior(cfg, rng) -> Behavior:
    if isinstance(cfg, list):
        cfg = cfg[0] if cfg else {}
    name = cfg.get("name", "wander")
    vmax = max(abs(float(cfg.get("vxmax", 1.0))), abs(float(cfg.get("vymax", 1.0))))
    return Behavior(
        name=name,
        range_low=cfg.get("range_low", [0.0, 0.0]),
        range_high=cfg.get("range_high", [10.0, 10.0]),
        max_speed=vmax,
        factor=float(cfg.get("factor", 1.0)),
        rng=rng,
    )


def _obstacle_from_shape(shape, st, vel, rng) -> Obstacle:
    name = shape.get("name", "circle")
    if name == "rectangle":
        return rectangle_obstacle(
            st[0], st[1], st[2] if len(st) > 2 else 0.0,
            shape["length"], shape["width"], vel)
    if name == "circle":
        return circle_obstacle(st[0], st[1], shape.get("radius", 0.5),
                               velocity=vel)
    if name == "polygon":
        if shape.get("random_shape", False):
            irr = shape.get("irregularity_range", [0.9, 0.9])
            verts = random_polygon_vertices(
                rng,
                avg_radius_range=shape.get("avg_radius_range", [0.5, 1.5]),
                irregularity=float(np.mean(irr)))
        else:
            verts = np.asarray(shape["vertices"], dtype=np.float64)
            if verts.shape[0] != 2:
                verts = verts.T
        offset = np.asarray([[st[0]], [st[1]]])
        return polygon_obstacle(verts + offset, vel)
    raise ValueError(f"unknown obstacle shape: {name!r}")


def load_env(yaml_file: str, robot: Robot, seed: int = 7) -> Sim2D:
    """Build the ``Sim2D`` that an ``env.yaml`` describes (``build_env``)."""
    import yaml

    with open(file_check(yaml_file), "r") as f:
        cfg = yaml.safe_load(f) or {}
    return build_env(cfg, robot, seed)


def build_env(cfg: dict, robot: Robot, seed: int = 7) -> Sim2D:
    """Build a ``Sim2D`` from a parsed ``env.yaml`` (world / robot /
    obstacle sections); ``seed`` is used where the world names none."""
    world = cfg.get("world", {}) or {}
    step_time = world.get("step_time", robot.dt)
    rng = np.random.default_rng(world.get("seed", seed))

    rob_cfgs = cfg.get("robot", []) or []
    rob = rob_cfgs[0] if isinstance(rob_cfgs, list) else rob_cfgs
    start = np.asarray(rob.get("state", [0, 0, 0]), dtype=np.float64)[:3]
    goal = np.asarray(rob.get("goal", [10, 10, 0]), dtype=np.float64)[:3]
    goal_threshold = rob.get("goal_threshold", 0.3)

    lidar = LidarSpec()
    for sensor in rob.get("sensors", []) or []:
        if sensor.get("type") == "lidar2d":
            ar = sensor.get("angle_range", 2 * np.pi)
            lidar = LidarSpec(
                range_min=sensor.get("range_min", 0.0),
                range_max=sensor.get("range_max", 10.0),
                angle_min=-ar / 2 if "angle_range" in sensor else sensor.get("angle_min", -np.pi),
                angle_max=ar / 2 if "angle_range" in sensor else sensor.get("angle_max", np.pi),
                number=sensor.get("number", 100),
            )

    obstacles: List[Obstacle] = []
    for group in cfg.get("obstacle", []) or []:
        if not group:
            continue
        shapes = group.get("shape", [])
        if isinstance(shapes, dict):
            shapes = [shapes]
        states = group.get("state", [])
        if states and not isinstance(states[0], (list, tuple, np.ndarray)):
            states = [states]
        dist = group.get("distribution", {}) or {}
        n = group.get("number", len(states))
        if dist.get("name") == "random":
            low = np.asarray(dist.get("range_low", [0, 0, 0]), dtype=np.float64)
            high = np.asarray(dist.get("range_high", [10, 10, 0]), dtype=np.float64)
            states = [rng.uniform(low, high).tolist() for _ in range(n)]
        vels = group.get("velocity", [[0.0, 0.0]] * max(len(states), 1))
        behavior_cfg = group.get("behavior")
        for i in range(min(n, len(states))):
            shape = shapes[i % len(shapes)] if shapes else {"name": "circle", "radius": 0.5}
            st = states[i]
            vel = vels[i] if i < len(vels) else [0.0, 0.0]
            obs = _obstacle_from_shape(shape, st, vel, rng)
            if behavior_cfg:
                obs.behavior = _make_behavior(behavior_cfg, rng)
            obstacles.append(obs)

    return Sim2D(robot, start, goal, obstacles, lidar,
                 goal_threshold=goal_threshold, step_time=step_time,
                 collision_mode=world.get("collision_mode", "stop"))
