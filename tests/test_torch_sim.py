"""Port vs JAX: the closed-loop simulator (``neupan_torch.sim`` against
``neupan_tpu.sim``).

Both simulators are host-side numpy float64, so nothing here compiles a
JAX graph. The port's copy must build the same world from the same seed and
give the same states, scans, collisions and obstacle motions; the recorded
JAX closed loops (tests/golden/torch/loop_*.npz and episode_*.npz,
scripts/make_torch_goldens.py) replay through the port's ``Sim2D`` to the
same states and scans.
"""

import dataclasses
import glob
import os

import jax  # noqa: F401  (JAX and PyTorch share this process: both are imported up front)
import numpy as np
import pytest
import yaml

import neupan_torch.native as tnative
import neupan_tpu.native as jnative
from neupan_torch import sim as tsim
from neupan_torch.robot import Robot as TRobot
from neupan_torch.sim import env_loader as tenv
from neupan_tpu import sim as jsim
from neupan_tpu.robot import Robot as JRobot
from neupan_tpu.sim import env_loader as jenv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(os.path.relpath(os.path.dirname(p), os.path.join(ROOT, "examples"))
                  for p in glob.glob(os.path.join(ROOT, "examples/*/*/env.yaml")))
LOOP_GOLDENS = sorted(glob.glob(os.path.join(ROOT, "tests/golden/torch/loop_*.npz"))
                      + glob.glob(os.path.join(ROOT, "tests/golden/torch/episode_*.npz")))


def robots(example):
    with open(os.path.join(ROOT, "examples", example, "planner.yaml")) as f:
        cfg = yaml.safe_load(f)
    kw = dict(receding=cfg.get("receding", 10), step_time=cfg.get("step_time", 0.1),
              **cfg["robot"])
    return JRobot.create(**kw), TRobot.create(**kw)


def worlds(example, seed=7):
    jr, tr = robots(example)
    env_file = os.path.join(ROOT, "examples", example, "env.yaml")
    return jenv.load_env(env_file, jr, seed), tenv.load_env(env_file, tr, seed)


def assert_same_world(j, t):
    for name in ("state", "goal"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert dataclasses.asdict(t.lidar) == dataclasses.asdict(j.lidar)
    assert (t.goal_threshold, t.dt, t.collision_mode) == (j.goal_threshold, j.dt,
                                                           j.collision_mode)
    assert len(t.obstacles) == len(j.obstacles)
    for oj, ot in zip(j.obstacles, t.obstacles):
        np.testing.assert_array_equal(ot.vertices, oj.vertices)
        np.testing.assert_array_equal(ot.velocity, oj.velocity)
        assert (ot.behavior is None) == (oj.behavior is None)
        if oj.behavior is not None:
            bj, bt = oj.behavior, ot.behavior
            assert (bt.name, bt.max_speed, bt.factor, bt.goal_threshold, bt.tau) == (
                bj.name, bj.max_speed, bj.factor, bj.goal_threshold, bj.tau)
            for name in ("low", "high", "goal"):
                np.testing.assert_array_equal(getattr(bt, name), getattr(bj, name))
            assert bt.rng.bit_generator.state == bj.rng.bit_generator.state


@pytest.mark.parametrize("example", EXAMPLES)
def test_every_env_builds_the_jax_world(example):
    """Same seed, same obstacles, behaviours and random-number state, in the
    JAX loader's order of draws (26 shipped env.yaml files)."""
    assert_same_world(*worlds(example))


def test_build_env_from_a_dict_and_other_seeds():
    example = "dyna_non_obs/diff"       # random placement, random shapes, rvo behaviours
    jr, tr = robots(example)
    with open(os.path.join(ROOT, "examples", example, "env.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert_same_world(jenv.load_env(os.path.join(ROOT, "examples", example, "env.yaml"), jr),
                      tenv.build_env(cfg, tr))
    for seed in (0, 3):
        cfg_seed = dict(cfg, world=dict(cfg["world"], seed=seed))
        j, t = jenv.load_env(os.path.join(ROOT, "examples", example, "env.yaml"), jr, seed), \
            tenv.build_env(cfg_seed, tr)
        assert_same_world(j, t)
    a, b = tenv.build_env(cfg, tr, 0), tenv.build_env(dict(cfg, world=dict(cfg["world"], seed=1)),
                                                     tr)
    assert not np.array_equal(a.obstacles[0].vertices, b.obstacles[0].vertices)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_lidar_scans_match_jax(native, monkeypatch):
    if native and not (tnative.available() and jnative.available()):
        pytest.skip("the native host library is not built")
    if not native:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    rng = np.random.default_rng(1)
    for example in ("convex_obs/diff", "dyna_non_obs/omni", "corridor/acker"):
        j, t = worlds(example)
        for _ in range(8):
            s = np.array([[rng.uniform(0, 40)], [rng.uniform(-8, 25)], [rng.uniform(-3, 3)]])
            j.state, t.state = s.copy(), s.copy()
            sj, st = j.get_lidar_scan(), t.get_lidar_scan()
            assert set(st) == set(sj)
            np.testing.assert_array_equal(st["ranges"], sj["ranges"])
            np.testing.assert_array_equal(st["velocity"], sj["velocity"])
            for key in ("angle_min", "angle_max", "range_min", "range_max"):
                assert st[key] == sj[key]


def test_collisions_match_jax():
    rng = np.random.default_rng(2)
    hits = 0
    for example in ("convex_obs/diff", "polygon_robot/diff", "corridor/acker",
                    "non_obs/omni"):
        j, t = worlds(example)
        centres = [o.center[:, 0] for o in j.obstacles]
        for i in range(40):
            c = centres[i % len(centres)]
            s = np.array([[c[0] + rng.uniform(-3, 3)], [c[1] + rng.uniform(-3, 3)],
                          [rng.uniform(-3, 3)]])
            j.state, t.state = s.copy(), s.copy()
            hit = j._check_collision()
            assert t._check_collision() == hit
            hits += hit
    assert 10 < hits < 150        # both outcomes occur


@pytest.mark.parametrize("example", ["dyna_non_obs/diff", "dyna_non_obs/omni",
                                     "dyna_obs/acker"])
def test_orca_steps_match_jax(example):
    """40 steps with the same actions: the rvo agents (ORCA half-planes and
    the incremental LP against each other and the robot), their goal draws,
    the robot's state and the contact count stay equal."""
    j, t = worlds(example)
    assert any(o.behavior is not None for o in t.obstacles)
    rng = np.random.default_rng(4)
    for _ in range(40):
        a = np.array([[rng.uniform(0.5, 3.0)], [rng.uniform(-0.5, 0.5)]])
        j.step(a)
        t.step(a)
        np.testing.assert_array_equal(t.state, j.state)
        for oj, ot in zip(j.obstacles, t.obstacles):
            np.testing.assert_array_equal(ot.vertices, oj.vertices)
            np.testing.assert_array_equal(ot.velocity, oj.velocity)
            if oj.behavior is not None:
                np.testing.assert_array_equal(ot.behavior.goal, oj.behavior.goal)
        assert (t.collision_count, t.collided) == (j.collision_count, j.collided)


def test_orca_primitives_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        p_rel, v_rel = rng.normal(size=2) * 3, rng.normal(size=2)
        r, tau = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0)
        dj, uj = jsim._orca_line(p_rel, v_rel, r, tau, 0.1)
        dt, ut = tsim._orca_line(p_rel, v_rel, r, tau, 0.1)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(ut, uj)
    for _ in range(100):
        lines = [(rng.normal(size=2), (lambda d: d / np.linalg.norm(d))(rng.normal(size=2)))
                 for _ in range(int(rng.integers(1, 6)))]
        vpref = rng.normal(size=2) * 2
        np.testing.assert_array_equal(tsim._orca_velocity(lines, vpref, 1.5),
                                      jsim._orca_velocity(lines, vpref, 1.5))


def test_random_polygon_vertices_match_jax():
    for seed in range(5):
        kw = dict(avg_radius_range=(0.4, 1.3), irregularity=0.7, n=int(6 + seed))
        v_t = tsim.random_polygon_vertices(np.random.default_rng(seed), **kw)
        v_j = jsim.random_polygon_vertices(np.random.default_rng(seed), **kw)
        assert v_t.shape == (2, kw["n"])
        np.testing.assert_array_equal(v_t, v_j)


@pytest.mark.parametrize("golden", LOOP_GOLDENS, ids=os.path.basename)
def test_jax_closed_loop_replays_through_the_port_sim(golden):
    """The JAX facade's recorded actions, replayed through the port's Sim2D
    built from the same env.yaml and seed, from the golden's start: every
    tick's state and scan equal the recorded ones to 1e-9."""
    with np.load(golden) as g:
        g = {k: g[k] for k in g.files}
    example = str(g["example"])
    _, robot = robots(example)
    env = tenv.load_env(os.path.join(ROOT, "examples", example, "env.yaml"), robot)
    env.state = g["start"].reshape(3, 1).astype(np.float64)
    for i in range(len(g["action"])):
        np.testing.assert_allclose(env.get_robot_state(), g["state"][i], rtol=0, atol=1e-9)
        scan = env.get_lidar_scan()
        np.testing.assert_allclose(scan["ranges"], g["ranges"][i], rtol=0, atol=1e-9)
        np.testing.assert_allclose(scan["velocity"], g["scan_velocity"][i], rtol=0, atol=1e-9)
        env.step(g["action"][i])
    assert not env.collided


def test_renderer_draws_the_planner_and_saves_an_animation(tmp_path):
    """The port's Renderer (matplotlib, headless) over two ticks of a CPU
    planner in corridor/diff: a frame per draw, overlays included, and a GIF."""
    pytest.importorskip("matplotlib")
    from neupan_torch import NeuPan
    from neupan_torch.sim.render import Renderer

    base = os.path.join(ROOT, "examples", "corridor", "diff")
    planner = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"), device="cpu")
    env = tenv.load_env(os.path.join(base, "env.yaml"), planner.robot)
    renderer = Renderer(env, world_size=(-6, 70, 10, 30), figsize=(4, 3))
    renderer.draw_frame()
    for _ in range(2):
        state = env.get_robot_state()
        action, _ = planner(state, planner.scan_to_point(state, env.get_lidar_scan()))
        renderer.draw_frame(planner, planner.initial_path)
        env.step(action)
    assert len(renderer.frames) == 3 and renderer.frames[-1].ndim == 3
    assert not np.array_equal(renderer.frames[0], renderer.frames[-1])
    out = renderer.save_animation(str(tmp_path / "run.gif"), fps=5)
    renderer.close()
    assert out and os.path.getsize(out) > 0
