"""Write the JAX-package goldens that the PyTorch port's CPU tests hold it against.

    PYTHONPATH=. python scripts/make_torch_goldens.py [name ...]

Runs the JAX package on the CPU and writes the files under
``tests/golden/torch/`` (all of them but ``sharded_step``, which is written
alone, or the named ones: ``planner_step``,
``qp_solve``, ``planner_step_mlp``, ``planner_step_noobs``,
``facade_corridor``, the ``loop_*`` goldens and the LON goldens):

* ``qp_solve.npz`` — three realistic NRMP QPs at the flagship shapes
  (T=10, K=10, contact walls; ``tests/test_qp_condensed.py:
  make_flagship_instance`` seeds 0-2), the warm start each is solved from
  (an accurate solve of the same QP, perturbed — ``warm_start`` there),
  and the JAX solution of the default condensed solver from that start.
* ``planner_step.npz`` — two chained ``batched_planner_step`` calls at
  T=4, P=128, K=5, B=4 with the DUNE selection on the fused kernel path
  (``dune_pallas=True``, the Pallas select kernel in interpret mode), so
  that the slot order is the one the port produces. Inputs come from a
  numpy seed (``step_inputs``), which the test re-derives and compares.
* ``planner_step_mlp.npz`` — the same two chained calls with
  ``dune_select="mlp"``: the reference-parity ranking by the learned
  distance on the materialized point flow (no Pallas kernel on the CPU).
* ``planner_step_noobs.npz`` — the same two chained calls without obstacle
  slots (K=0): the tracking QP alone.
* ``facade_corridor.npz`` — 20 control ticks of the ``NeuPan`` facade built
  from ``examples/corridor/diff/planner.yaml``: the states it was fed (its
  own closed loop through the exact diff-drive kinematics), the seeded
  obstacle points of each tick (``facade_points``; one tick has more points
  than the planner's capacity), and the action, minimum distance and flags
  it returned. Off the TPU the JAX planner ranks on the materialized flow
  without the Pallas kernel, so the port is compared with its selection
  kernel switched off.
* ``loop_<example>.npz`` (``LOOP_SCENARIOS``: ``corridor/acker``,
  ``corridor/omni``, ``polygon_robot/diff``, ``corridor_long/diff`` at
  T=30 and, as ``..._t33``, at T=33, ``dyna_obs/diff`` with point
  velocities) — 15 closed-loop ticks of the JAX facade in the JAX
  simulator (``neupan_tpu.sim``), from a start a few metres before the
  obstacles: states, lidar scans, the points and velocities the facade
  made of them, the state it carried into each tick, and what it returned.
* ``qp_reverse_acker_warm.npz`` — the QP that the port's own closed loop on
  ``reverse/acker`` builds at tick 10, the warm start its planner carries
  there, and the JAX package's solution cold and from that warm start (the
  only golden written by running the port: it pins a solve that both
  packages stop short on from that start).
* ``qp_vjp.npz`` — the QP backward alone: the first PAN iteration's QP of
  the tests/test_lon.py setup and of a corridor/diff tick near the first
  obstacle with its elimination basis, JAX's solution (x, y), a seeded
  cotangent of x and JAX's ``_solve_bwd_impl`` cotangents of the QP's
  fields, with how close the
  duals sit to the ``eps_act`` threshold that picks the active set.
* ``lon_step.npz`` — ``neupan_tpu.lon.step_loss_and_grad`` on the
  test_lon.py setup (scalar and 3-vector q_s, iter_num 1 and 2) and on that
  corridor/diff tick with the near branch of the loss forced: inputs,
  carried state, weights, loss, grads and the loss's central difference in
  eta.
* ``lon_ticks_corridor_diff.npz`` — 8 ticks of JAX's
  ``examples/LON/LON_corridor.py:run_episode`` with the near branch forced:
  each tick's inputs, carried state, loss, grads and weights before and
  after the tuner's update (~5 min for the three LON goldens).
* ``dune_labels.npz`` — JAX's ``polygon_distance_labels`` on the diff,
  acker and trapezoid (``polygon_robot``) geometries, 4,096 seeded points
  each (inside, near each vertex, far out), and ``dual_ascent_labels`` on
  256 points of the diff geometry.
* ``dune_train.npz`` — JAX's ``DuneTrainer.start`` at 2,048 points, batch
  256, 4 epochs, the lr halved every 2 epochs, with ``adam_l2`` and with
  ``adamw``: every random draw (replayed from the trainer's key splits and
  held to its results.txt), the per-epoch loss terms and the weights
  (~1 min for both DUNE goldens).
* ``sharded_step.npz`` — JAX's ``sharded_planner_step`` on 8 virtual CPU
  devices (``make_mesh(8)``) at tests/test_parallel.py's ``small_spec()``
  (T=3, K=2, P=8, ``ADMMConfig(iters=40)``, one PAN iteration) with its
  ``batch_inputs`` at B=8 and B=16 (seed 0) and ``init_params(PRNGKey(0))``:
  two chained steps each, the second from the first's trajectory and its
  sharded state, on the points of ``batch_inputs(seed=1)``; the inputs,
  the weights, and each step's outputs and state (~1 min). It needs the 8
  devices, so it is written in a process of its own
  (``python scripts/make_torch_goldens.py sharded_step``).

Compiling the JAX step and the accurate warm-start solves takes a few
minutes on a CPU.
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "torch")
QP_SEEDS = (0, 1, 2)
STEP_SEED = 7
STEP_SHAPE = dict(T=4, P=128, K=5, B=4)


def diff_rollout(s0: np.ndarray, u: np.ndarray, dt: float) -> np.ndarray:
    """Exact diff-drive rollout in float64: s0 (B, 3), u (B, 2, T) -> (B, 3, T+1)."""
    s = [s0]
    for t in range(u.shape[-1]):
        x, y, phi = s[-1][:, 0], s[-1][:, 1], s[-1][:, 2]
        v, w = u[:, 0, t], u[:, 1, t]
        s.append(np.stack([x + dt * v * np.cos(phi), y + dt * v * np.sin(phi),
                           phi + dt * w], axis=1))
    return np.stack(s, axis=-1)


def _points(rng, B, P):
    """Obstacles ahead of and beside the robot, some within a few dm of it."""
    pts = np.stack([rng.uniform(1.2, 7.0, (B, P)), rng.uniform(-4.0, 4.0, (B, P))], axis=1)
    vels = rng.normal(scale=0.3, size=(B, 2, P)) * (np.arange(B) % 2)[:, None, None]
    mask = rng.uniform(size=(B, P)) < 0.9
    mask[-1] = np.arange(P) < 3          # fewer valid points than K
    return pts.astype(np.float32), vels.astype(np.float32), mask


def step_inputs(seed: int = STEP_SEED, T: int = 4, P: int = 128, K: int = 5,
                B: int = 4, dt: float = 0.1) -> dict:
    """The planner-step golden's inputs, from a numpy seed alone."""
    rng = np.random.default_rng(seed)
    s0 = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                   rng.uniform(-0.3, 0.3, B)], axis=1)
    nom_u = np.zeros((B, 2, T))
    nom_u[:, 0] = rng.uniform(0.5, 2.0, B)[:, None]
    nom_u[:, 1] = rng.uniform(-0.3, 0.3, B)[:, None]
    nom_s = diff_rollout(s0, nom_u, dt)
    goal = s0 + np.array([4.0, 0.0, 0.0])
    ref_s = np.linspace(s0, goal, T + 1, axis=-1)
    ref_us = np.full((B, T), 4.0)
    pts1, vels1, mask1 = _points(rng, B, P)
    pts2, vels2, mask2 = _points(rng, B, P)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(nom_s=f32(nom_s), nom_u=f32(nom_u), ref_s=f32(ref_s), ref_us=f32(ref_us),
                pts1=pts1, vels1=vels1, mask1=mask1, pts2=pts2, vels2=vels2, mask2=mask2)


def _jax_setup():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, ROOT)
    return jax


def write_qp_golden(path: str) -> None:
    jax = _jax_setup()
    from neupan_tpu.ops.qp import solve_qp
    from tests.test_qp_condensed import layout_cfg, make_flagship_instance, warm_start

    rec = {k: [] for k in ("P_diag", "q", "A", "l", "u", "soft", "Z", "xp",
                           "x0", "y0", "x", "y")}
    for seed in QP_SEEDS:
        spec, qp, elim, _ = make_flagship_instance(seed, contact=True)
        x0, y0 = warm_start(qp, spec, elim, seed=seed)
        with jax.default_matmul_precision("highest"):
            sol = solve_qp(qp, layout_cfg(spec), x0, y0, elim=elim)
        for name, val in (("P_diag", qp.P_diag), ("q", qp.q), ("A", qp.A), ("l", qp.l),
                          ("u", qp.u), ("soft", qp.soft), ("Z", elim[0]), ("xp", elim[1]),
                          ("x0", x0), ("y0", y0), ("x", sol.x), ("y", sol.y)):
            rec[name].append(np.asarray(val, np.float32))
    np.savez(path, seeds=np.asarray(QP_SEEDS), T=spec.T, K=spec.K,
             **{k: np.stack(v) for k, v in rec.items()})


FACADE_YAML = "examples/corridor/diff/planner.yaml"
FACADE_SEED = 11
FACADE_TICKS = 20
FACADE_PMAX = 160      # the widest tick; the planner's capacity is 100


def facade_points(seed: int = FACADE_SEED, ticks: int = FACADE_TICKS):
    """Seeded obstacle points of each tick: two ragged walls beside the
    corridor's centre line (y = 20) and a few loose points ahead, in world
    coordinates. Returns pts (ticks, 2, FACADE_PMAX) float32 and the count
    of real columns per tick; tick 3 exceeds the planner's capacity."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((ticks, 2, FACADE_PMAX), np.float32)
    counts = np.zeros((ticks,), np.int64)
    for i in range(ticks):
        n = FACADE_PMAX if i == 3 else int(rng.integers(40, 100))
        x = rng.uniform(0.0, 14.0, n)
        side = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)
        y = 20.0 + side * rng.uniform(1.6, 4.0, n)
        loose = rng.uniform(size=n) < 0.1
        x = np.where(loose, rng.uniform(6.0, 12.0, n), x)
        y = np.where(loose, 20.0 + rng.uniform(-1.2, 1.2, n), y)
        pts[i, :, :n] = np.stack([x, y])
        counts[i] = n
    return pts, counts


def write_facade_golden(path: str) -> None:
    _jax_setup()
    from neupan_tpu.planner import NeuPan

    planner = NeuPan.init_from_yaml(os.path.join(ROOT, FACADE_YAML))
    pts, counts = facade_points()
    state = np.array([[0.0], [20.0], [0.0]])
    rec = {k: [] for k in ("state", "action", "min_distance", "stop", "arrive", "collision")}
    for i in range(FACADE_TICKS):
        action, info = planner(state, pts[i, :, :counts[i]].astype(np.float64))
        rec["state"].append(state.copy())
        rec["action"].append(np.asarray(action, np.float64))
        rec["min_distance"].append(planner.min_distance)
        for flag in ("stop", "arrive", "collision"):
            rec[flag].append(bool(info[flag]))
        state = diff_rollout(state[:, 0][None], np.asarray(action)[None], planner.dt)[0, :, 1:2]
    np.savez(path, seed=FACADE_SEED, points=pts, counts=counts,
             **{k: np.asarray(v) for k, v in rec.items()})


# Closed-loop goldens: example, the robot's start (x, y, theta), the planner's
# waypoints from there (the path runs start -> waypoints), the horizon (None: the
# file's) and whether the points carry velocities from the scan. Each starts a few
# metres before the obstacles, so that its 15 ticks plan around them.
LOOP_SCENARIOS = {
    "loop_corridor_acker": ("corridor/acker", (2.0, 20.0, 0.0), [[60, 20, 0]], None, False),
    "loop_corridor_omni": ("corridor/omni", (4.0, 20.76, 0.188),
                           [[10, 21.9, 0], [17, 20.5, 0], [23, 17.3, 0], [30, 20, 0],
                            [36, 22, 0], [43, 20, 0], [50, 17.7, 0], [60, 20, 0]], None, False),
    "loop_polygon_robot_diff": ("polygon_robot/diff", (6.0, 0.0, 0.0), [[40, 0, 0]], None, False),
    "loop_corridor_long_diff": ("corridor_long/diff", (2.0, 20.0, 0.0), [[60, 20, 0]], None,
                                False),
    "loop_dyna_obs_diff": ("dyna_obs/diff", (8.0, 0.0, 0.0), [[40, 0, 0]], None, True),
    "loop_corridor_long_diff_t33": ("corridor_long/diff", (2.0, 20.0, 0.0), [[60, 20, 0]], 33,
                                    False),
}
LOOP_TICKS = 15
CARRY = tuple(f"carry_{f}" for f in ("prev_mu", "prev_lam", "prev_s", "prev_u", "prev_valid",
                                     "prev_has_points", "x_warm", "y_warm"))


def loop_overrides(example: str, waypoints, receding=None) -> dict:
    """``init_from_yaml`` overrides of a loop golden: the file's ipath section
    with the golden's waypoints, and the horizon where one is given."""
    import yaml

    with open(os.path.join(ROOT, "examples", example, "planner.yaml")) as f:
        ipath = yaml.safe_load(f)["ipath"]
    out = {"ipath": dict(ipath, waypoints=[list(w) for w in waypoints])}
    if receding is not None:
        out["receding"] = int(receding)
    return out


# Whole episodes of the JAX facade from the example's own start and path, up to
# arrival: example, the most ticks recorded, and whether the DUNE selection
# takes the fused Pallas kernel (the TPU's path; here in interpret mode) or the
# materialized point flow (the path off the TPU).
EPISODES = {"episode_reverse_acker": ("reverse/acker", 100, False),
            "episode_reverse_acker_fused": ("reverse/acker", 100, True)}


def write_loop_golden(path: str, name: str) -> None:
    """Closed-loop ticks of the JAX facade in ``neupan_tpu.sim``: LOOP_TICKS
    from a ``LOOP_SCENARIOS`` golden's start, or an ``EPISODES`` golden's
    whole episode up to arrival. Each tick's state, lidar scan, the points
    (and velocities) the facade made of it, what the facade carried into the
    tick (``CARRY``: its PANState; ``cur_vel``: its velocity plan), and the
    action, minimum distance and flags it returned; the simulator is stepped
    with that action, as ``examples/run_exp.py`` does."""
    jax = _jax_setup()
    import dataclasses
    import functools

    import neupan_tpu.ops.pallas.select as SEL
    from neupan_tpu.ops.pan import pan_forward
    from neupan_tpu.planner import NeuPan
    from neupan_tpu.sim.env_loader import load_env

    fused = False
    if name in EPISODES:
        (example, ticks, fused), start, receding, point_vel = EPISODES[name], None, None, False
        overrides = {}
    else:
        example, start, waypoints, receding, point_vel = LOOP_SCENARIOS[name]
        ticks, overrides = LOOP_TICKS, loop_overrides(example, waypoints, receding)
    base = os.path.join(ROOT, "examples", example)
    planner = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"), **overrides)
    if fused:
        SEL.select_topk_flow_pallas = functools.partial(SEL.select_topk_flow_pallas,
                                                        interpret=True)
        spec = planner.spec = dataclasses.replace(planner.spec, dune_pallas=True)
        planner._step = jax.jit(lambda *a: pan_forward(spec, *a))
    env = load_env(os.path.join(base, "env.yaml"), planner.robot)
    if start is not None:
        env.state = np.asarray(start, np.float64).reshape(3, 1)
    beams = env.lidar.number
    rec = {k: [] for k in ("state", "ranges", "scan_velocity", "points", "velocities",
                           "counts", "action", "min_distance", "stop", "arrive",
                           "collision", "cur_vel", *CARRY)}
    for _ in range(ticks):
        # what the facade carries into the tick: its PANState and velocity plan
        for field in CARRY:
            rec[field].append(np.asarray(getattr(planner.pan_state, field[len("carry_"):])))
        rec["cur_vel"].append(np.asarray(planner.cur_vel_array, np.float64))
        state = env.get_robot_state()
        scan = env.get_lidar_scan()
        if point_vel:
            pts, vels = planner.scan_to_point_velocity(state, scan)
        else:
            pts, vels = planner.scan_to_point(state, scan), None
        action, info = planner(state, pts, vels)
        n = 0 if pts is None else pts.shape[1]
        pad = lambda a: np.zeros((2, beams)) if a is None else np.pad(a, ((0, 0), (0, beams - n)))
        for key, val in (("state", state), ("ranges", scan["ranges"]),
                         ("scan_velocity", scan["velocity"]), ("points", pad(pts)),
                         ("velocities", pad(vels)), ("counts", n),
                         ("action", np.asarray(action, np.float64)),
                         ("min_distance", planner.min_distance)):
            rec[key].append(val)
        for flag in ("stop", "arrive", "collision"):
            rec[flag].append(bool(info[flag]))
        if info["arrive"] and name in EPISODES:
            break
        env.step(action)
    np.savez_compressed(path, name=name, example=example, receding=planner.T,
                        point_vel=point_vel, fused=fused, start=np.asarray(rec["state"][0][:, 0]),
                        **{k: np.asarray(v) for k, v in rec.items()})


PLAN_GOLDEN, PLAN_TICK = "loop_corridor_acker", 2


def _golden_inputs(g, i, point_vel):
    """State, points and velocities of tick ``i`` of a loop golden."""
    n = int(g["counts"][i])
    pts = g["points"][i, :, :n] if n else None
    return g["state"][i], pts, (g["velocities"][i, :, :n] if n and point_vel else None)


def write_plan_sensitivity_golden(path: str) -> None:
    """How far the JAX facade's action moves with its velocity plan: at tick
    ``PLAN_TICK`` of ``PLAN_GOLDEN``, the JAX facade given the carried
    PANState it recorded but the velocity plan that the port's facade
    carries there when it carries its own state from tick 0 (CPU, fed the
    golden's states and points)."""
    jax = _jax_setup()
    import dataclasses

    import jax.numpy as jnp
    import torch

    from neupan_torch import NeuPan as TNeuPan
    from neupan_tpu.planner import NeuPan

    with np.load(os.path.join(GOLDEN_DIR, f"{PLAN_GOLDEN}.npz")) as fh:
        g = {k: fh[k] for k in fh.files}
    example, _, waypoints, receding, point_vel = LOOP_SCENARIOS[PLAN_GOLDEN]
    yaml_file = os.path.join(ROOT, "examples", example, "planner.yaml")
    overrides = loop_overrides(example, waypoints, receding)
    port = TNeuPan.init_from_yaml(yaml_file, device="cpu", **overrides)
    port.spec = dataclasses.replace(port.spec, dune_kernel=False)
    with torch.no_grad():
        for i in range(PLAN_TICK):
            port(*_golden_inputs(g, i, point_vel))
    plan = np.asarray(port.cur_vel_array, np.float64)
    planner = NeuPan.init_from_yaml(yaml_file, **overrides)
    PANState = type(planner.pan_state)
    for i in range(PLAN_TICK + 1):
        planner.pan_state = PANState(*(jnp.asarray(g[f][i]) for f in CARRY))
        planner.cur_vel_array = plan.copy() if i == PLAN_TICK else g["cur_vel"][i].copy()
        action, _ = planner(*_golden_inputs(g, i, point_vel))
    action = np.asarray(action, np.float64)
    print(f"{PLAN_GOLDEN} tick {PLAN_TICK}: plan moved by "
          f"{np.abs(plan - g['cur_vel'][PLAN_TICK]).max():.3e}, JAX action by "
          f"{np.abs(action - g['action'][PLAN_TICK]).max():.3e}")
    np.savez(path, golden=PLAN_GOLDEN, tick=PLAN_TICK, cur_vel=plan, action=action)


WARM_EXAMPLE, WARM_TICK = "reverse/acker", 10


def write_warm_start_golden(path: str) -> None:
    """The JAX facade's own closed loop on ``WARM_EXAMPLE`` up to
    ``WARM_TICK``; there, the first PAN iteration's QP as the JAX planner
    builds it, the warm start that planner carries, and the JAX package's
    deployed (condensed) solution of that QP cold and warm-started. Prints
    its relative objective gaps against the float64 oracle of
    ``scripts/exp_control_accuracy_torch.py``."""
    jax = _jax_setup()
    import jax.numpy as jnp

    from neupan_tpu.ops import qp as jqp
    from neupan_tpu.ops.dune import dune_forward, generate_point_flow
    from neupan_tpu.ops.nrmp import build_qp, coefficients_from_dune, condensation
    from neupan_tpu.ops.pan import _admm_with_elim
    from neupan_tpu.planner import NeuPan
    from neupan_tpu.sim.env_loader import load_env
    from scripts.exp_control_accuracy_torch import qp_objective, scipy_soft_oracle

    base = os.path.join(ROOT, "examples", WARM_EXAMPLE)
    planner = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"))
    env = load_env(os.path.join(base, "env.yaml"), planner.robot)
    for _ in range(WARM_TICK):
        state = env.get_robot_state()
        action, _ = planner(state, planner.scan_to_point(state, env.get_lidar_scan()))
        env.step(action)
    state = env.get_robot_state()
    planner.ipath.check_arrive(state)   # the path's state advances here, as in the facade
    spec, cfg = planner.spec, _admm_with_elim(planner.spec)
    nom_s, nom_u, ref_s, ref_us = planner.ipath.generate_nom_ref_state(
        state, planner.cur_vel_array, planner.ref_speed)
    pts, vels, mask = planner._pad_points(
        planner.scan_to_point(state, env.get_lidar_scan()), None)
    f = lambda a: jnp.asarray(a, jnp.float32)
    pf, R_all, glob = generate_point_flow(f(nom_s), pts, vels, spec.robot.dt)
    vertices = f(spec.robot.vertices) if spec.dune_select == "exact" else None
    dune = dune_forward(planner.dune_params, planner.G, planner.h, pf, R_all, glob, mask,
                        spec.nrmp.K, select=spec.dune_select, vertices=vertices)
    fa, fb = coefficients_from_dune(spec.nrmp, dune.mu_k, dune.lam_k, dune.points_k,
                                    dune.valid_k, planner.h, jnp.any(mask))
    A_dyn, B_dyn, C_dyn = spec.robot.linearize(f(nom_s), f(nom_u))
    qp = build_qp(spec.nrmp, planner.adjust, f(nom_s), f(nom_u), f(ref_s), f(ref_us),
                  A_dyn, B_dyn, C_dyn, fa, fb)
    elim = condensation(spec.nrmp, A_dyn, B_dyn, C_dyn, f(nom_s)[:, 0])
    x_warm, y_warm = planner.pan_state.x_warm, planner.pan_state.y_warm
    with jax.default_matmul_precision("highest"):
        j_sols = [jqp.solve_qp(qp, cfg, jnp.zeros_like(x_warm), jnp.zeros_like(y_warm), elim=elim),
                  jqp.solve_qp(qp, cfg, x_warm, y_warm, elim=elim)]
    rec = {k: np.asarray(getattr(qp, k)) for k in ("P_diag", "q", "A", "l", "u", "soft")}
    rec.update(Z=np.asarray(elim[0]), xp=np.asarray(elim[1]), x_warm=np.asarray(x_warm),
               y_warm=np.asarray(y_warm), x_cold=np.asarray(j_sols[0].x),
               x_warm_solved=np.asarray(j_sols[1].x))
    P, q, A, l, u, soft = (rec[k].astype(np.float64)
                           for k in ("P_diag", "q", "A", "l", "u", "soft"))
    f_ref = qp_objective(P, q, A, l, soft, scipy_soft_oracle(P, q, A, l, u, soft))
    for start, key in (("cold", "x_cold"), ("warm", "x_warm_solved")):
        gap = (qp_objective(P, q, A, l, soft, rec[key].astype(np.float64)) - f_ref) / (
            1.0 + abs(f_ref))
        print(f"{WARM_EXAMPLE} tick {WARM_TICK}, {start}: JAX relative objective gap {gap:.3e}")
    np.savez(path, example=WARM_EXAMPLE, tick=WARM_TICK, T=spec.nrmp.T, K=spec.nrmp.K,
             elim_n_eq=cfg.elim_n_eq, elim_n_hard=cfg.elim_n_hard, elim_n_acc=cfg.elim_n_acc,
             kinematics=spec.nrmp.kinematics, **rec)


def write_step_golden(path: str, variant: str = "fused") -> None:
    """``variant``: "fused" (exact ranking, Pallas select in interpret mode),
    "mlp" (learned-distance ranking) or "noobs" (K=0)."""
    jax = _jax_setup()
    import functools

    import jax.numpy as jnp

    import neupan_tpu.ops.pallas.select as SEL
    from neupan_tpu.models import obs_point_net
    from neupan_tpu.ops.nrmp import AdjustParams, NRMPSpec
    from neupan_tpu.ops.pan import PANSpec
    from neupan_tpu.parallel import batched_init_state, batched_planner_step
    from neupan_tpu.robot import Robot

    T, P, K, B = (STEP_SHAPE[k] for k in ("T", "P", "K", "B"))
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    nrmp = NRMPSpec(T=T, K=0 if variant == "noobs" else K, kinematics="diff",
                    speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = {"fused": PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P, dune_pallas=True),
            "mlp": PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P, dune_select="mlp"),
            "noobs": PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P)}[variant]
    params = obs_point_net.load_checkpoint(
        os.path.join(ROOT, "examples/model/diff_robot_default/model.npz"))
    G = jnp.asarray(robot.G, jnp.float32)
    h = jnp.asarray(robot.h, jnp.float32)
    f = lambda v: jnp.asarray(v, jnp.float32)
    adjust = AdjustParams(q_s=f(1.0), p_u=f(1.0), eta=f(10.0), d_max=f(1.0), d_min=f(0.1))
    inp = step_inputs(STEP_SEED, T, P, K, B)

    orig = SEL.select_topk_flow_pallas
    SEL.select_topk_flow_pallas = functools.partial(orig, interpret=True)
    try:
        step = jax.jit(lambda *a: batched_planner_step(spec, params, G, h, adjust, *a))
        state = batched_init_state(spec, B)
        ref_s, ref_us = f(inp["ref_s"]), f(inp["ref_us"])
        out1 = step(f(inp["nom_s"]), f(inp["nom_u"]), ref_s, ref_us, f(inp["pts1"]),
                    f(inp["vels1"]), jnp.asarray(inp["mask1"]), state)
        out2 = step(out1.opt_s, out1.opt_u, ref_s, ref_us, f(inp["pts2"]), f(inp["vels2"]),
                    jnp.asarray(inp["mask2"]), out1.state)
    finally:
        SEL.select_topk_flow_pallas = orig

    res = {}
    for i, out in ((1, out1), (2, out2)):
        for name in ("opt_s", "opt_u", "opt_d", "min_distance", "nrmp_valid"):
            if getattr(out, name) is not None:      # opt_d is None without obstacle slots
                res[f"{name}_{i}"] = np.asarray(getattr(out, name))
    np.savez(path, seed=STEP_SEED, **STEP_SHAPE, **inp, **res)


LON_CORRIDOR = "corridor/diff"
LON_NEAR = 10.0         # a collision threshold that forces the near branch of distance_loss
LON_TICKS = 8
LON_SQUEEZE = 1.0       # the corridor case: the first tick with an obstacle this close
LON_STEP_CASES = ("lon_scalar_it1", "lon_scalar_it2", "lon_vec_it1", "lon_vec_it2", "corridor")
LON_INPUTS = ("nom_s", "nom_u", "ref_s", "ref_us", "pts", "vels", "mask")
LON_FD_EPS = 0.05       # tests/test_lon.py's central difference in eta
QP_FIELDS = ("P_diag", "q", "A", "l", "u", "soft")


def _lon_vec_loss(out, ref_s, ref_us, stuck):
    """tests/test_lon.py's vector-q_s loss: state + speed tracking MSE."""
    from neupan_tpu.lon import tracking_losses

    s_l, u_l = tracking_losses(out, ref_s, ref_us)
    return s_l + u_l


def _lon_cases():
    """The JAX inputs of each ``lon_step`` case: (spec, params, G, h, adjust,
    inputs (LON_INPUTS order), state, loss_fn, threshold, extra), the
    tests/test_lon.py setup with scalar and 3-vector q_s at iter_num 1 and
    2, and the corridor/diff tick of ``_lon_corridor_tick``."""
    import dataclasses

    import jax.numpy as jnp

    from neupan_tpu.ops.pan import init_state
    from tests.test_lon import setup

    spec, params, G, h, adj, inputs = setup()
    cases = {}
    for it in (1, 2):
        sp = dataclasses.replace(spec, iter_num=it)
        cases[f"lon_scalar_it{it}"] = (sp, params, G, h, adj, inputs, init_state(sp), None,
                                       LON_NEAR, {})
        adj3 = adj._replace(q_s=jnp.asarray([1.0, 1.0, 0.5], jnp.float32))
        cases[f"lon_vec_it{it}"] = (sp, params, G, h, adj3, inputs, init_state(sp),
                                    _lon_vec_loss, 0.3, {})
    cases["corridor"] = _lon_corridor_tick()
    return cases


def _lon_corridor_tick():
    """The JAX facade's closed loop on corridor/diff (tuning off, stuck
    escape off, as LON runs it) up to the first tick whose min_distance
    falls below LON_SQUEEZE; there, the inputs LON_corridor.run_episode
    differentiates."""
    import jax.numpy as jnp

    from neupan_tpu.planner import NeuPan
    from neupan_tpu.sim.env_loader import load_env

    base = os.path.join(ROOT, "examples", *LON_CORRIDOR.split("/"))
    planner = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"))
    planner.stuck_enabled = False
    env = load_env(os.path.join(base, "env.yaml"), planner.robot)
    for tick in range(200):
        state = env.get_robot_state()
        points = planner.scan_to_point(state, env.get_lidar_scan())
        action, _ = planner(state, points)
        if points is not None and planner.min_distance < LON_SQUEEZE:
            break
        env.step(action)
    f = lambda a: jnp.asarray(a, jnp.float32)
    nom = planner.ipath.generate_nom_ref_state(state, planner.cur_vel_array, planner.ref_speed)
    inputs = (*(f(a) for a in nom), *planner._pad_points(points, None))
    return (planner.spec, planner.dune_params, planner.G, planner.h, planner.adjust, inputs,
            planner.pan_state, None, LON_NEAR,
            dict(tick=tick, min_distance=planner.min_distance, robot_state=state))


def _first_qp(spec, params, G, h, adjust, inputs, state):
    """The QP of the first PAN iteration of a JAX step, as ``pan_forward``
    builds it on the CPU (materialized flow), with its config, elimination
    basis and warm start."""
    import jax.numpy as jnp

    from neupan_tpu.ops.dune import dune_forward, generate_point_flow
    from neupan_tpu.ops.nrmp import build_qp, coefficients_from_dune, condensation
    from neupan_tpu.ops.pan import _admm_with_elim

    nom_s, nom_u, ref_s, ref_us, pts, vels, mask = inputs
    pf, R_all, glob = generate_point_flow(nom_s, pts, vels, spec.robot.dt)
    vertices = jnp.asarray(spec.robot.vertices, jnp.float32)
    dune = dune_forward(params, G, h, pf, R_all, glob, mask, spec.nrmp.K, select="exact",
                        vertices=vertices)
    fa, fb = coefficients_from_dune(spec.nrmp, dune.mu_k, dune.lam_k, dune.points_k,
                                    dune.valid_k, h, jnp.any(mask))
    A_dyn, B_dyn, C_dyn = spec.robot.linearize(nom_s, nom_u)
    qp = build_qp(spec.nrmp, adjust, nom_s, nom_u, ref_s, ref_us, A_dyn, B_dyn, C_dyn, fa, fb)
    elim = condensation(spec.nrmp, A_dyn, B_dyn, C_dyn, nom_s[:, 0])
    return qp, _admm_with_elim(spec), elim, state.x_warm, state.y_warm


def write_qp_vjp_golden(path: str) -> None:
    """The QP backward alone: for the tests/test_lon.py setup and the
    corridor/diff tick, the first PAN iteration's QP and its elimination
    basis, JAX's solution (x, y),
    a seeded cotangent g of x and JAX's ``_solve_bwd_impl`` cotangents of
    the QP's fields. Prints each case's smallest | |y_i| - eps_act |: the
    active set is chosen by that threshold."""
    jax = _jax_setup()
    from types import SimpleNamespace

    from neupan_tpu.ops import qp as jqp

    cases = _lon_cases()
    rec = {}
    for i, name in enumerate(("lon_scalar_it1", "corridor")):
        spec, params, G, h, adj, inputs, state, _, _, _ = cases[name]
        qp, cfg, elim, x0, y0 = _first_qp(spec, params, G, h, adj, inputs, state)
        with jax.default_matmul_precision("highest"):
            sol = jqp.solve_qp(qp, cfg, x0, y0, elim=elim)
            g = np.random.default_rng(i).normal(size=sol.x.shape).astype(np.float32)
            dqp, _, _ = jqp._solve_bwd_impl(cfg, qp, sol.x, sol.y, SimpleNamespace(x=g))
        y = np.asarray(sol.y)
        margin = float(np.min(np.abs(np.abs(y) - cfg.eps_act)))
        near = int(np.sum((np.abs(y) > 0.1 * cfg.eps_act) & (np.abs(y) < 10 * cfg.eps_act)))
        print(f"qp_vjp {name}: n={sol.x.shape[0]} m={y.shape[0]}, smallest | |y| - eps_act | "
              f"{margin:.3e}, rows with |y| within 10x of eps_act {near}, largest |y| "
              f"{np.abs(y).max():.3e}")
        for k in QP_FIELDS:
            rec[f"{name}__{k}"] = np.asarray(getattr(qp, k))
            rec[f"{name}__d{k}"] = np.asarray(getattr(dqp, k))
        rec.update({f"{name}__x": np.asarray(sol.x), f"{name}__y": y, f"{name}__g": g,
                    f"{name}__Z": np.asarray(elim[0]), f"{name}__xp": np.asarray(elim[1]),
                    f"{name}__eps_margin": margin, f"{name}__eps_near_rows": near,
                    f"{name}__eps_act": cfg.eps_act,
                    f"{name}__polish_delta": cfg.polish_delta})
    np.savez_compressed(path, cases=np.asarray(["lon_scalar_it1", "corridor"]), **rec)


def write_lon_step_golden(path: str) -> None:
    """``neupan_tpu.lon.step_loss_and_grad`` on each of LON_STEP_CASES: its
    inputs, carried state, adjust weights, loss and grads, and the central
    difference of the loss in eta (``LON_FD_EPS``, as tests/test_lon.py
    takes it). The test_lon.py encoder's random weights are stored too."""
    _jax_setup()
    import jax.numpy as jnp

    from neupan_tpu.lon import step_loss_and_grad

    cases = _lon_cases()
    rec = {f"enc_{k}": np.asarray(v) for k, v in cases["lon_scalar_it1"][1].items()}
    for name in LON_STEP_CASES:
        spec, params, G, h, adj, inputs, state, loss_fn, thr, extra = cases[name]
        run = lambda a: step_loss_and_grad(spec, params, G, h, a, *inputs, state,
                                           loss_fn=loss_fn, collision_threshold=thr)
        loss, grads, out = run(adj)
        fd = [float(run(adj._replace(eta=jnp.asarray(float(adj.eta) + s * LON_FD_EPS,
                                                      jnp.float32)))[0]) for s in (1, -1)]
        fd_eta = (fd[0] - fd[1]) / (2 * LON_FD_EPS)
        print(f"lon_step {name}: loss {float(loss):.6g}, grads "
              f"{[np.asarray(g).tolist() for g in grads]}, eta central difference {fd_eta:.6g}")
        rec.update({f"{name}__{k}": np.asarray(v) for k, v in zip(LON_INPUTS, inputs)})
        rec.update({f"{name}__carry_{k}": np.asarray(v) for k, v in state._asdict().items()})
        rec.update({f"{name}__adjust_{k}": np.asarray(v) for k, v in adj._asdict().items()})
        rec.update({f"{name}__grad_{k}": np.asarray(v) for k, v in grads._asdict().items()})
        rec.update({f"{name}__{k}": np.asarray(v) for k, v in extra.items()})
        rec.update({f"{name}__loss": np.asarray(loss), f"{name}__fd_eta": fd_eta,
                    f"{name}__opt_u": np.asarray(out.opt_u), f"{name}__threshold": thr,
                    f"{name}__iter_num": spec.iter_num})
    np.savez_compressed(path, cases=np.asarray(LON_STEP_CASES), **rec)


def write_lon_ticks_golden(path: str) -> None:
    """LON_TICKS ticks of JAX's examples/LON/LON_corridor.py:run_episode on
    corridor/diff with the near branch forced (its COLLISION_THRESHOLD set
    to LON_NEAR): each tick's robot state, the inputs and carried state it
    differentiates, the loss, the grads, and the weights before and after
    the tuner's update."""
    _jax_setup()
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from LON import LON_corridor as LC

    from neupan_tpu.lon import LONTuner
    from neupan_tpu.planner import NeuPan

    rec = {k: [] for k in ("robot_state", *LON_INPUTS, *CARRY, "loss",
                           *(f"adjust_{f}" for f in ("q_s", "p_u", "eta", "d_max", "d_min")),
                           *(f"grad_{f}" for f in ("q_s", "p_u", "eta", "d_max", "d_min")),
                           *(f"adjust_after_{f}" for f in ("q_s", "p_u", "eta", "d_max",
                                                           "d_min")))}
    step = LC.step_loss_and_grad

    def recorded_step(spec, params, G, h, adjust, nom_s, nom_u, ref_s, ref_us, pts, vels,
                      mask, state, **kw):
        loss, grads, out = step(spec, params, G, h, adjust, nom_s, nom_u, ref_s, ref_us,
                                pts, vels, mask, state, **kw)
        for k, v in zip(LON_INPUTS, (nom_s, nom_u, ref_s, ref_us, pts, vels, mask)):
            rec[k].append(np.asarray(v))
        for k in CARRY:
            rec[k].append(np.asarray(getattr(state, k[len("carry_"):])))
        for f in adjust._fields:
            rec[f"adjust_{f}"].append(np.asarray(getattr(adjust, f)))
            rec[f"grad_{f}"].append(np.asarray(getattr(grads, f)))
        rec["loss"].append(np.asarray(loss))
        return loss, grads, out

    class RecordedTuner(LONTuner):
        def update(self, adjust, grads):
            new = super().update(adjust, grads)
            for f in new._fields:
                rec[f"adjust_after_{f}"].append(np.asarray(getattr(new, f)))
            return new

    base = os.path.join(ROOT, "examples", *LON_CORRIDOR.split("/"))
    planner = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"))
    planner.stuck_enabled = False
    env_get = LC.load_env

    def recorded_env(*a, **kw):
        env = env_get(*a, **kw)
        get_state = env.get_robot_state

        def state():
            s = get_state()
            if len(rec["robot_state"]) == len(rec["loss"]):
                rec["robot_state"].append(np.asarray(s, np.float64))
            return s

        env.get_robot_state = state
        return env

    saved = LC.step_loss_and_grad, LC.MAX_STEPS, LC.COLLISION_THRESHOLD, LC.load_env
    LC.step_loss_and_grad, LC.MAX_STEPS, LC.COLLISION_THRESHOLD, LC.load_env = (
        recorded_step, LON_TICKS, LON_NEAR, recorded_env)
    try:
        losses, _ = LC.run_episode(planner, RecordedTuner(planner.adjust, lr=5e-3), base)
    finally:
        LC.step_loss_and_grad, LC.MAX_STEPS, LC.COLLISION_THRESHOLD, LC.load_env = saved
    print(f"lon_ticks: losses {losses}")
    np.savez_compressed(path, ticks=len(losses), threshold=LON_NEAR, lr=5e-3,
                        **{k: np.stack(v) for k, v in rec.items()})


# -- DUNE training -------------------------------------------------------------

# scripts/train_dune_tpu.py's three geometries
DUNE_GEOMETRIES = {
    "diff": dict(kinematics="diff", length=1.6, width=2.0),
    "acker": dict(kinematics="acker", length=4.6, width=1.6, wheelbase=3.0),
    "polygon": dict(kinematics="diff", vertices=[[-0.8, -1.0], [-1.8, 1.0], [1.8, 1.0],
                                                 [0.8, -1.0]]),
}
DUNE_LABEL_POINTS, DUNE_LABEL_SEED = 4096, 11
DUAL_ASCENT_POINTS = 256
# the trainer golden: 2048 points, batch 256 (6 batches of the 1638 training
# points), 4 epochs, the lr halved every 2 epochs, validated every epoch
DUNE_TRAIN = dict(data_size=2048, batch_size=256, epoch=3, decay_freq=2, valid_freq=1,
                  save_freq=1, lr=1e-3, lr_decay=0.5, seed=0)
DUNE_OPTIMIZERS = ("adam_l2", "adamw")


def dune_label_points(vertices: np.ndarray, seed: int = DUNE_LABEL_SEED,
                      n: int = DUNE_LABEL_POINTS) -> np.ndarray:
    """(n, 2) float32 points for a polygon of ``vertices`` (2, V): a quarter
    inside (random convex combinations), half within 0.5 m of a vertex
    (spread over the vertices, inside and out), the rest uniform in
    [-25, 25]^2."""
    rng = np.random.default_rng(seed)
    V = vertices.shape[1]
    n_in, n_near = n // 4, n // 2
    inside = rng.dirichlet(np.ones(V), n_in) @ vertices.T
    r = rng.uniform(1e-3, 0.5, n_near)
    a = rng.uniform(0, 2 * np.pi, n_near)
    near = vertices.T[np.arange(n_near) % V] + np.stack([r * np.cos(a), r * np.sin(a)], 1)
    far = rng.uniform(-25, 25, (n - n_in - n_near, 2))
    return np.concatenate([inside, near, far]).astype(np.float32)


def write_dune_labels_golden(path: str) -> None:
    """JAX's ``polygon_distance_labels`` on each of DUNE_GEOMETRIES
    (``dune_label_points``) and ``dual_ascent_labels`` (its defaults, 200
    ascent steps) on DUAL_ASCENT_POINTS points of the diff geometry in
    [-5, 5]^2 (tests/test_training.py's range)."""
    _jax_setup()
    import jax.numpy as jnp

    from neupan_tpu.robot import Robot
    from neupan_tpu.training.labels import dual_ascent_labels, polygon_distance_labels

    rec = {}
    for name, kw in DUNE_GEOMETRIES.items():
        robot = Robot.create(**kw)
        G, h = np.asarray(robot.G, np.float32), np.asarray(robot.h, np.float32)
        pts = dune_label_points(robot.vertices)
        mu, d = polygon_distance_labels(G, h, jnp.asarray(pts))
        rec.update({f"{name}__G": G, f"{name}__h": h, f"{name}__points": pts,
                    f"{name}__mu": np.asarray(mu), f"{name}__d": np.asarray(d)})
    pts = np.random.default_rng(DUNE_LABEL_SEED + 1).uniform(
        -5, 5, (DUAL_ASCENT_POINTS, 2)).astype(np.float32)
    mu, d = dual_ascent_labels(rec["diff__G"], rec["diff__h"], jnp.asarray(pts))
    rec.update(dual__points=pts, dual__mu=np.asarray(mu), dual__d=np.asarray(d))
    np.savez_compressed(path, geometries=np.asarray(list(DUNE_GEOMETRIES)), **rec)


def _dune_replay(G, h, optimizer: str, cfg: dict):
    """``neupan_tpu/training/dune_train.py:DuneTrainer.start`` replayed with
    its key splits written out, so that every random draw can be recorded:
    the init, the data, and per epoch the permutation, the batches'
    rotations and the validation's rotation. Returns the draws, the
    per-epoch train and validation loss terms and the final parameters."""
    import jax
    import jax.numpy as jnp
    import optax

    from neupan_tpu.models import obs_point_net
    from neupan_tpu.training.dune_train import _loss_terms
    from neupan_tpu.training.labels import polygon_distance_labels

    bs, n = cfg["batch_size"], cfg["data_size"]
    key = jax.random.PRNGKey(cfg["seed"])
    key, pk = jax.random.split(key)
    params = obs_point_net.init_params(pk, 2, G.shape[0])
    init = {k: np.asarray(v) for k, v in params.items()}
    key, dk = jax.random.split(key)
    pts = jax.random.uniform(dk, (n, 2), jnp.float32, minval=jnp.asarray([-25.0, -25.0]),
                             maxval=jnp.asarray([25.0, 25.0]))
    mu, d = polygon_distance_labels(G, h, pts)
    n_train = int(n * 0.8)
    nb = max(n_train // bs, 1)
    sched = optax.exponential_decay(cfg["lr"], transition_steps=cfg["decay_freq"] * nb,
                                    decay_rate=cfg["lr_decay"], staircase=True)
    if optimizer == "adam_l2":
        tx = optax.chain(optax.add_decayed_weights(1e-4), optax.scale_by_adam(),
                         optax.scale_by_learning_rate(sched))
    else:
        tx = optax.adamw(sched, weight_decay=1e-4)
    opt_state = tx.init(params)
    rot = lambda t: jnp.array([[jnp.cos(t), -jnp.sin(t)], [jnp.sin(t), jnp.cos(t)]])

    @jax.jit
    def epoch_step(params, opt_state, pb, mb, db, thetas):
        def body(carry, xs):
            params, opt_state = carry
            bp, bmu, bd, theta = xs

            def loss_fn(p):
                terms = _loss_terms(p, bp, bmu, bd, G, h, rot(theta))
                return sum(terms), terms

            (_, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), jnp.stack(terms)

        (params, opt_state), losses = jax.lax.scan(body, (params, opt_state),
                                                   (pb, mb, db, thetas))
        return params, opt_state, jnp.mean(losses, axis=0)

    train = (pts[:n_train], mu[:n_train], d[:n_train])
    valid = (pts[n_train:], mu[n_train:], d[n_train:])
    rec = {k: [] for k in ("perm", "thetas", "theta_valid", "train_loss", "valid_loss")}
    for _ in range(cfg["epoch"] + 1):
        key, ek, vk = jax.random.split(key, 3)
        _, sk, rk = jax.random.split(ek, 3)
        perm = jax.random.permutation(sk, n_train)[: nb * bs]
        thetas = jax.random.uniform(rk, (nb,), maxval=2 * jnp.pi)
        theta_v = jax.random.uniform(vk, (), maxval=2 * jnp.pi)
        batches = [a[perm].reshape(nb, bs, -1) for a in train]
        params, opt_state, tr = epoch_step(params, opt_state, batches[0], batches[1],
                                           batches[2][..., 0], thetas)
        va = jnp.stack(_loss_terms(params, *valid, G, h, rot(theta_v)))
        for k, v in zip(rec, (perm, thetas, theta_v, tr, va)):
            rec[k].append(np.asarray(v))
    first = [a[rec["perm"][0][:bs]] for a in train]
    fixed = _loss_terms(init, *first, G, h, rot(rec["thetas"][0][0]))
    return dict(init=init, pts=np.asarray(pts), mu=np.asarray(mu), d=np.asarray(d),
                fixed_loss=np.asarray(jnp.stack(fixed)), final={k: np.asarray(v) for k, v in
                                                               params.items()},
                sched=np.asarray([sched(k) for k in range((cfg["epoch"] + 1) * nb)]),
                **{k: np.stack(v) for k, v in rec.items()})


def write_dune_train_golden(path: str) -> None:
    """JAX's ``DuneTrainer.start`` on the diff geometry at DUNE_TRAIN, once
    with each of DUNE_OPTIMIZERS: the init, the data and labels, every
    epoch's permutation and rotations, the per-epoch train and validation
    loss terms, the final weights, the learning rate of every update and
    the loss terms of the init on the first batch. The draws come from a
    replay of the trainer's key splits (``_dune_replay``), held here to the
    trainer's own results.txt lines and final weights."""
    import re
    import tempfile

    _jax_setup()
    from neupan_tpu.robot import Robot
    from neupan_tpu.training.dune_train import DuneTrainer

    robot = Robot.create(**DUNE_GEOMETRIES["diff"])
    G, h = np.asarray(robot.G, np.float32), np.asarray(robot.h, np.float32)
    rec = dict(G=G, h=h, **{k: np.asarray(v) for k, v in DUNE_TRAIN.items()})
    num = r"([0-9.]+e[-+][0-9]+)"
    line = re.compile(rf"Epoch (\d+)/\d+ lr {num} \| mu {num}/{num} dist {num}/{num} "
                      rf"fa {num}/{num} fb {num}/{num}")
    for opt in DUNE_OPTIMIZERS:
        with tempfile.TemporaryDirectory() as tmp:
            params, _ = DuneTrainer(G, h, tmp).start(optimizer=opt, **DUNE_TRAIN)
            with open(os.path.join(tmp, "results.txt")) as fh:
                logged = [m.groups() for m in map(line.search, fh) if m]
        rep = _dune_replay(G, h, opt, DUNE_TRAIN)
        # the replay is the trainer: its losses print as the trainer's lines, its
        # weights are the trainer's to float32 rounding of the jitted epochs
        assert len(logged) == DUNE_TRAIN["epoch"] + 1, logged
        for i, groups in enumerate(logged):
            tr, va = rep["train_loss"][i], rep["valid_loss"][i]
            want = [f"{x:.2e}" for pair in zip(tr, va) for x in pair]
            assert list(groups[2:]) == want, (opt, i, groups, want)
        for k, v in rep["final"].items():
            np.testing.assert_allclose(v, np.asarray(params[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{opt} {k}")
        for k, v in rep.items():
            if isinstance(v, dict):
                rec.update({f"{opt}__{k}__{n}": a for n, a in v.items()})
            else:
                rec[f"{opt}__{k}"] = v
        rec.update({f"{opt}__trainer_final__{k}": np.asarray(v) for k, v in params.items()})
        print(f"dune_train {opt}: train losses {rep['train_loss'].sum(1)}")
    np.savez_compressed(path, optimizers=np.asarray(DUNE_OPTIMIZERS), **rec)


# -- the solver paths off the main path ---------------------------------------

FULLSPACE_SEEDS = (0, 1, 2, 3, 4)
# the solves of each flagship instance: name -> ADMMConfig fields over the
# NRMP layout statics (layout_cfg); "nobasis" solves with no elimination basis
FULLSPACE_SOLVES = {
    "full": dict(condense_admm=False),
    "generic": dict(elim_n_acc=None),
    "full_nopolish": dict(condense_admm=False, polish=False),
    "cond_nopolish": dict(polish=False),
    "nobasis": None,
}
GENERIC_ITERS = 200        # tests/test_qp.py's CFG
GRAD_Q_THETA, GRAD_SOFT_THETA, GRAD_EPS = 0.7, 1.2, 1e-3


def generic_qp_cases() -> dict:
    """tests/test_qp.py's instances from their numpy seeds: case -> dict of
    float64 arrays (P_diag, q, A, l, u, optional soft) and ``iters``. Each
    QP is one scenario without a batch axis, except ``batch`` (B=4)."""
    cases = {}
    n = 8
    cases["unconstrained"] = dict(P_diag=np.linspace(1.0, 3.0, n), q=np.linspace(-1.0, 1.0, n),
                                  A=np.eye(n), l=-1e4 * np.ones(n), u=1e4 * np.ones(n))
    cases["box_clipped"] = dict(P_diag=np.array([1.0]), q=np.array([-3.0]), A=np.array([[1.0]]),
                                l=np.array([-1e4]), u=np.array([1.0]))
    cases["equality"] = dict(P_diag=np.ones(2), q=np.zeros(2), A=np.array([[1.0, 1.0]]),
                             l=np.array([2.0]), u=np.array([2.0]))
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        n, m = 12, 20
        P = rng.uniform(0.5, 2.0, n)
        q = rng.normal(size=n)
        A = rng.normal(size=(m, n))
        mid = A @ rng.normal(size=n) * 0.1
        width = rng.uniform(0.5, 2.0, m)
        l, u = mid - width, mid + width
        l[:2] = u[:2] = mid[:2]
        cases[f"random{seed}"] = dict(P_diag=P, q=q, A=A, l=l, u=u)
    rng = np.random.default_rng(5)
    n, m = 20, 30
    P = rng.uniform(0.1, 5.0, n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    l = A @ rng.normal(size=n) * 0.05 - 1.0
    cases["kkt_small"] = dict(P_diag=P, q=q, A=A, l=l, u=l + rng.uniform(0.1, 2.0, m),
                              iters=1000)
    rng = np.random.default_rng(7)
    B, n, m = 4, 10, 14
    P = rng.uniform(0.5, 2.0, (B, n))
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    mid = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.1)
    cases["batch"] = dict(P_diag=P, q=q, A=A, l=mid - 1.0, u=mid + 1.0)
    for w in (0.5, 2.0, 50.0):
        cases[f"soft_w{w:g}"] = dict(P_diag=np.array([1.0]), q=np.array([-3.0]),
                                     A=np.array([[1.0]]), l=np.array([5.0]),
                                     u=np.array([1e20]), soft=np.array([w]))
    cases["soft_inactive"] = dict(P_diag=np.array([1.0]), q=np.array([-3.0]),
                                  A=np.array([[1.0]]), l=np.array([1.0]), u=np.array([1e20]),
                                  soft=np.array([10.0]))
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        n, m_h, m_s = 10, 8, 6
        P = rng.uniform(0.5, 2.0, n)
        q = rng.normal(size=n)
        Ah = rng.normal(size=(m_h, n))
        mid = Ah @ rng.normal(size=n) * 0.1
        lh, uh = mid - 1.0, mid + 1.0
        lh[:2] = uh[:2] = mid[:2]
        As = rng.normal(size=(m_s, n))
        ls = As @ rng.normal(size=n) * 0.1 + rng.uniform(-0.5, 0.5, m_s)
        w = rng.uniform(5.0, 50.0, m_s)
        cases[f"soft_rows{seed}"] = dict(
            P_diag=P, q=q, A=np.vstack([Ah, As]), l=np.concatenate([lh, ls]),
            u=np.concatenate([uh, np.full(m_s, 1e20)]),
            soft=np.concatenate([np.zeros(m_h), w]))
        # the explicit-slack form: vars [x, z]; obj += 0.5 w z^2; As x + z >= ls, z >= 0
        A2 = np.zeros((m_h + 2 * m_s, n + m_s))
        A2[:m_h, :n] = Ah
        A2[m_h:m_h + m_s, :n] = As
        A2[m_h:m_h + m_s, n:] = np.eye(m_s)
        A2[m_h + m_s:, n:] = np.eye(m_s)
        cases[f"slack{seed}"] = dict(
            P_diag=np.concatenate([P, w]), q=np.concatenate([q, np.zeros(m_s)]), A=A2,
            l=np.concatenate([lh, ls, np.zeros(m_s)]),
            u=np.concatenate([uh, np.full(2 * m_s, 1e20)]))
    cases["warm"] = dict(P_diag=np.ones(2), q=-np.ones(2), A=np.eye(2), l=-10.0 * np.ones(2),
                         u=10.0 * np.ones(2))
    for c in cases.values():
        c.setdefault("iters", GENERIC_ITERS)
    return cases


def grad_q_qp(theta):
    """tests/test_qp.py's implicit-gradient QP: q = -2 theta target."""
    n = 6
    return dict(P_diag=np.full(n, 2.0), q=-2.0 * theta * np.linspace(-1, 1, n), A=np.eye(n),
                l=-0.5 * np.ones(n), u=0.5 * np.ones(n))


def grad_soft_qp(theta):
    """tests/test_qp.py's soft-row gradient QP: the soft row's target l is 6 theta."""
    n = 4
    return dict(P_diag=np.ones(n), q=np.zeros(n), A=np.vstack([np.eye(n), np.ones((1, n))]),
                l=np.concatenate([-10 * np.ones(n), [6.0 * theta]]),
                u=np.concatenate([10 * np.ones(n), [1e20]]),
                soft=np.concatenate([np.zeros(n), [20.0]]))


def write_qp_generic_golden(path: str) -> None:
    """JAX's ``solve_qp`` on tests/test_qp.py's instances (``generic_qp_cases``:
    no elimination basis, so the full-space ADMM and the full-space polish
    candidate), scipy's x on the random ones, ``solve_qp_batch`` on the batch,
    the warm-started solve, and the two gradients (``grad_q_qp``,
    ``grad_soft_qp``) with their central differences. ~1 min on a CPU."""
    jax = _jax_setup()
    import jax.numpy as jnp
    from neupan_tpu.ops.qp import ADMMConfig, QPData, solve_qp, solve_qp_batch
    from tests.test_qp import scipy_qp_oracle

    f = lambda a: jnp.asarray(a, jnp.float32)
    fields = ("P_diag", "q", "A", "l", "u")
    qp_of = lambda c: QPData(*(f(c[k]) for k in fields),
                             soft=f(c["soft"]) if "soft" in c else None)
    rec = {}
    with jax.default_matmul_precision("highest"):
        for name, c in generic_qp_cases().items():
            cfg = ADMMConfig(iters=c["iters"])
            rec.update({f"{name}__{k}": np.asarray(v) for k, v in c.items()})
            if name == "batch":
                sol = solve_qp_batch(qp_of(c), cfg)
                rec["batch__jax_x_single"] = np.stack([np.asarray(solve_qp(
                    QPData(*(f(c[k][b]) for k in fields)), cfg).x) for b in range(4)])
            else:
                sol = solve_qp(qp_of(c), cfg)
            for k in ("x", "y", "z", "r_prim", "r_dual"):
                rec[f"{name}__jax_{k}"] = np.asarray(getattr(sol, k))
            if name.startswith("random"):
                rec[f"{name}__scipy_x"] = scipy_qp_oracle(c["P_diag"], c["q"], c["A"], c["l"],
                                                          c["u"], c["P_diag"].shape[0])
            if name == "warm":
                rec["warm__jax_x_warm"] = np.asarray(
                    solve_qp(qp_of(c), ADMMConfig(iters=10), x0=sol.x, y0=sol.y).x)

        for name, make, theta0 in (("grad_q", grad_q_qp, GRAD_Q_THETA),
                                   ("grad_soft", grad_soft_qp, GRAD_SOFT_THETA)):
            base = qp_of(make(1.0))

            def loss(t, name=name, base=base):
                # theta enters q (grad_q) or the soft row's l (grad_soft) traced
                if name == "grad_q":
                    qp = base._replace(q=-2.0 * t * f(np.linspace(-1, 1, 6)))
                else:
                    qp = base._replace(l=jnp.concatenate([-10 * jnp.ones(4), 6.0 * t[None]]))
                return jnp.sum(solve_qp(qp, ADMMConfig(iters=GENERIC_ITERS)).x ** 2)

            t0 = jnp.asarray(theta0, jnp.float32)
            rec[f"{name}__loss"] = np.asarray(loss(t0))
            rec[f"{name}__jax_grad"] = np.asarray(jax.grad(loss)(t0))
            rec[f"{name}__jax_fd"] = np.asarray(
                (loss(t0 + GRAD_EPS) - loss(t0 - GRAD_EPS)) / (2 * GRAD_EPS))
    print("qp_generic: grads", {k: float(rec[f"{k}__jax_grad"]) for k in ("grad_q", "grad_soft")})
    np.savez_compressed(path, cases=np.asarray(list(generic_qp_cases())), **rec)


def write_qp_fullspace_golden(path: str) -> None:
    """The five flagship instances of tests/test_qp_condensed.py
    (``make_flagship_instance``, contact on even seeds) and their warm starts
    (``warm_start``), JAX's solution of each from that start under each of
    FULLSPACE_SOLVES (x, y, z, r_prim, r_dual) and the scipy float64 oracle's
    u. ~40 min on a CPU (the accurate warm-start solves, the five JAX solves
    of each instance and the oracle)."""
    import dataclasses

    jax = _jax_setup()
    from neupan_tpu.ops.qp import ADMMConfig, solve_qp
    from tests.test_nrmp import scipy_nrmp_oracle
    from tests.test_qp_condensed import layout_cfg, make_flagship_instance, warm_start

    rec = {}
    add = lambda k, v: rec.setdefault(k, []).append(np.asarray(v, np.float32))
    for seed in FULLSPACE_SEEDS:
        spec, qp, elim, oracle_args = make_flagship_instance(seed, seed % 2 == 0)
        x0, y0 = warm_start(qp, spec, elim, seed=seed)
        for name, val in (*zip(QP_FIELDS, qp), ("Z", elim[0]), ("xp", elim[1]),
                          ("x0", x0), ("y0", y0)):
            add(name, val)
        with jax.default_matmul_precision("highest"):
            for name, over in FULLSPACE_SOLVES.items():
                if over is None:
                    sol = solve_qp(qp, ADMMConfig(), x0, y0)
                else:
                    cfg = dataclasses.replace(layout_cfg(spec), **over)
                    sol = solve_qp(qp, cfg, x0, y0, elim=elim)
                for k in ("x", "y", "z", "r_prim", "r_dual"):
                    add(f"{name}_{k}", getattr(sol, k))
        add("u_oracle", scipy_nrmp_oracle(*oracle_args)[1])
        print(f"qp_fullspace seed {seed}: r_prim "
              + ", ".join(f"{k} {float(rec[k + '_r_prim'][-1]):.2e}" for k in FULLSPACE_SOLVES))
    np.savez_compressed(path, seeds=np.asarray(FULLSPACE_SEEDS), T=spec.T, K=spec.K,
                        **{k: np.stack(v) for k, v in rec.items()})


BANDED_TS = (4, 10, 30)


def write_qp_banded_golden(path: str) -> None:
    """tests/test_banded.py's real NRMP normal matrices (``make_M(T, seed=T)``
    for T in BANDED_TS, and T=6 for the block structure) with JAX's raw
    (refine=0) and refined btd inverses and its dense ``_spd_inverse``, and
    its T=30 end-to-end instance (seed 7, K=5) with the banded and the dense
    full-space solves. ~1 min on a CPU."""
    jax = _jax_setup()
    import jax.numpy as jnp
    from neupan_tpu.ops import banded
    from neupan_tpu.ops import qp as jqp
    from neupan_tpu.ops.nrmp import AdjustParams, NRMPSpec, build_qp
    from neupan_tpu.robot import Robot
    from tests.test_banded import make_M

    rec = {}
    with jax.default_matmul_precision("highest"):
        for T in (6, *BANDED_TS):
            M = make_M(T, seed=T)
            rec[f"M{T}"] = np.asarray(M)
            if T == 6:
                continue
            perm = jnp.asarray(banded.nrmp_permutation(T))
            rec[f"X{T}_raw"] = np.asarray(banded.btd_spd_inverse(M, perm, 6, refine=0))
            rec[f"X{T}"] = np.asarray(banded.btd_spd_inverse(M, perm, 6))
            rec[f"X{T}_dense"] = np.asarray(jqp._spd_inverse(M, jqp.ADMMConfig()))

        T = 30
        rng = np.random.default_rng(7)
        robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                             max_acce=[8, 3], length=1.6, width=2.0)
        spec = NRMPSpec(T=T, K=5, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                        acce_bound=tuple(robot.acce_bound[:, 0]))
        adjust = AdjustParams(q_s=jnp.asarray(1.0), p_u=jnp.asarray(1.0), eta=jnp.asarray(10.0),
                              d_max=jnp.asarray(1.0), d_min=jnp.asarray(0.1))
        nom_u = jnp.asarray(rng.uniform(-0.5, 0.5, (2, T)), jnp.float32)
        nom_s = robot.rollout(jnp.zeros(3), nom_u)
        A_dyn, B_dyn, C_dyn = robot.linearize(nom_s, nom_u)
        fa = jnp.asarray(rng.normal(size=(T, 5, 2)) * 0.3, jnp.float32)
        fb = jnp.asarray(rng.normal(size=(T, 5)) - 1.0, jnp.float32)
        qp = build_qp(spec, adjust, nom_s, nom_u, nom_s, jnp.ones((T,), jnp.float32),
                      A_dyn, B_dyn, C_dyn, fa, fb)
        perm = tuple(int(i) for i in banded.nrmp_permutation(T))
        for name, cfg in (("banded", jqp.ADMMConfig(condense_admm=False, inverse="banded",
                                                    banded_perm=perm)),
                          ("dense", jqp.ADMMConfig(condense_admm=False))):
            sol = jqp.solve_qp(qp, cfg)
            for k in ("x", "y", "r_prim", "r_dual"):
                rec[f"{name}_{k}"] = np.asarray(getattr(sol, k))
        rec.update({f"qp_{k}": np.asarray(v) for k, v in zip(QP_FIELDS, qp)})
    print("qp_banded_t30: r_prim banded", float(rec["banded_r_prim"]),
          "dense", float(rec["dense_r_prim"]))
    np.savez_compressed(path, T=T, Ts=np.asarray(BANDED_TS), **rec)


def write_qp_fullspace_f64_golden(path: str) -> None:
    """JAX's full-space ADMM (``neupan_tpu/ops/qp.py:_admm_core``, no polish)
    in float64 on the qp_fullspace instances from their warm starts (dense
    inverse) and on the qp_banded_t30 instance from zeros (dense and banded
    inverse): the port's float64 run must equal it, so that what parts the
    float32 runs is rounding. Reads the two goldens; ~20 s on a CPU."""
    jax = _jax_setup()
    import jax.numpy as jnp
    from neupan_tpu.ops import banded
    from neupan_tpu.ops import qp as jqp

    with np.load(os.path.join(GOLDEN_DIR, "qp_fullspace.npz")) as g:
        flag = {k: g[k] for k in g.files}
    with np.load(os.path.join(GOLDEN_DIR, "qp_banded_t30.npz")) as g:
        t30 = {k: g[k] for k in g.files}
    perm = tuple(int(i) for i in banded.nrmp_permutation(int(t30["T"])))
    rec = {}
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        f = lambda a: jnp.asarray(np.asarray(a, np.float64))
        for b in range(len(flag["seeds"])):
            qp = jqp.QPData(*(f(flag[k][b]) for k in QP_FIELDS))
            x, y, *_ = jqp._admm_core(qp, jqp.ADMMConfig(), f(flag["x0"][b]), f(flag["y0"][b]))
            rec.setdefault("flagship_x", []).append(np.asarray(x))
            rec.setdefault("flagship_y", []).append(np.asarray(y))
        qp = jqp.QPData(*(f(t30[f"qp_{k}"]) for k in QP_FIELDS))
        zeros = (jnp.zeros(qp.P_diag.shape[0]), jnp.zeros(qp.l.shape[0]))
        for name, cfg in (("t30_dense", jqp.ADMMConfig()),
                          ("t30_banded", jqp.ADMMConfig(inverse="banded", banded_perm=perm))):
            x, y, *_ = jqp._admm_core(qp, cfg, *zeros)
            rec[f"{name}_x"], rec[f"{name}_y"] = np.asarray(x), np.asarray(y)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in rec.items()})


FACADE_SOLVER_TICKS = 5
# name -> the corridor/diff planner's pan.admm setting of the facade_solvers golden
FACADE_SOLVERS = {"fullspace": {"condense_admm": False},
                  "banded": {"condense_admm": False, "inverse": "banded"},
                  "nopolish": {"polish": False}}


def write_facade_solvers_golden(path: str) -> None:
    """The facade golden's first FACADE_SOLVER_TICKS ticks (``facade_points``,
    the JAX facade's own loop through the exact kinematics) for each of
    FACADE_SOLVERS: the corridor/diff planner built from its YAML with
    ``pan.admm`` set; with the state it carried into each tick (``CARRY``,
    ``cur_vel``) and what it returned. ~2 min on a CPU."""
    _jax_setup()
    import yaml
    from neupan_tpu.planner import NeuPan

    with open(os.path.join(ROOT, FACADE_YAML)) as f:
        pan = yaml.safe_load(f)["pan"]
    pts, counts = facade_points()
    rec = {}
    for name, admm in FACADE_SOLVERS.items():
        planner = NeuPan.init_from_yaml(os.path.join(ROOT, FACADE_YAML), pan=dict(pan, admm=admm))
        state = np.array([[0.0], [20.0], [0.0]])
        for i in range(FACADE_SOLVER_TICKS):
            for field in CARRY:
                rec.setdefault(f"{name}_{field}", []).append(
                    np.asarray(getattr(planner.pan_state, field[len("carry_"):])))
            rec.setdefault(f"{name}_cur_vel", []).append(np.asarray(planner.cur_vel_array,
                                                                    np.float64))
            action, _ = planner(state, pts[i, :, :counts[i]].astype(np.float64))
            rec.setdefault(f"{name}_state", []).append(state.copy())
            rec.setdefault(f"{name}_action", []).append(np.asarray(action, np.float64))
            rec.setdefault(f"{name}_min_distance", []).append(planner.min_distance)
            state = diff_rollout(state[:, 0][None], np.asarray(action)[None],
                                 planner.dt)[0, :, 1:2]
        print(f"facade_solvers {name}: actions {np.stack(rec[name + '_action'])[:, :, 0].tolist()}")
    np.savez(path, **{k: np.asarray(v) for k, v in rec.items()})


SHARDED_BATCHES = (8, 16)
SHARDED_DEVICES = 8
PAN_STATE_FIELDS = ("prev_mu", "prev_lam", "prev_s", "prev_u", "prev_valid", "prev_has_points",
                    "x_warm", "y_warm")


def write_sharded_golden(path: str) -> None:
    """JAX's ``sharded_planner_step`` on the 8-device virtual CPU mesh at
    tests/test_parallel.py's shapes: two chained steps at each of
    SHARDED_BATCHES (module docstring)."""
    jax = _jax_setup()
    if len(jax.devices()) != SHARDED_DEVICES:
        sys.exit(f"sharded_step needs {SHARDED_DEVICES} virtual CPU devices, found "
                 f"{len(jax.devices())}: write it in a process of its own")
    import jax.numpy as jnp

    from neupan_tpu.parallel import batched_init_state, make_mesh, sharded_planner_step
    from tests.test_parallel import batch_inputs, shared, small_spec

    spec = small_spec()
    params, G, h, adj = shared(spec)
    mesh = make_mesh(SHARDED_DEVICES)
    step = jax.jit(lambda st, *a: sharded_planner_step(spec, mesh, params, G, h, adj, *a, st))
    rec = {f"param_{k}": np.asarray(v) for k, v in params.items()}
    rec.update({f"adjust_{k}": np.asarray(v) for k, v in adj._asdict().items()})
    names = ("nom_s", "nom_u", "ref_s", "ref_us", "pts", "vels", "mask")
    for B in SHARDED_BATCHES:
        args = batch_inputs(spec, B)
        pts2 = batch_inputs(spec, B, seed=1)[4]
        rec.update({f"B{B}_{n}": np.asarray(a) for n, a in zip(names, args)})
        rec[f"B{B}_pts2"] = np.asarray(pts2)
        out1 = step(batched_init_state(spec, B), *args)
        out2 = step(out1.state, out1.opt_s, out1.opt_u, *args[2:4], pts2, *args[5:])
        for i, out in ((1, out1), (2, out2)):
            assert len(out.opt_u.sharding.device_set) == SHARDED_DEVICES
            for name in ("opt_s", "opt_u", "opt_d", "min_distance", "nrmp_valid"):
                rec[f"B{B}_{name}_{i}"] = np.asarray(getattr(out, name))
            for name in PAN_STATE_FIELDS:
                rec[f"B{B}_state_{name}_{i}"] = np.asarray(getattr(out.state, name))
        print(f"sharded_step B={B}: opt_u[0] {np.asarray(out2.opt_u)[0].tolist()}")
    np.savez(path, T=spec.robot.T, K=spec.nrmp.K, P=spec.dune_max_num,
             devices=SHARDED_DEVICES, **rec)


WRITERS = {
    "planner_step": lambda p: write_step_golden(p, "fused"),
    "qp_solve": write_qp_golden,
    "planner_step_mlp": lambda p: write_step_golden(p, "mlp"),
    "planner_step_noobs": lambda p: write_step_golden(p, "noobs"),
    "facade_corridor": write_facade_golden,
    **{name: (lambda p, name=name: write_loop_golden(p, name))
       for name in (*LOOP_SCENARIOS, *EPISODES)},
    "qp_reverse_acker_warm": write_warm_start_golden,
    "plan_corridor_acker": write_plan_sensitivity_golden,
    "qp_vjp": write_qp_vjp_golden,
    "lon_step": write_lon_step_golden,
    "lon_ticks_corridor_diff": write_lon_ticks_golden,
    "dune_labels": write_dune_labels_golden,
    "dune_train": write_dune_train_golden,
    "qp_generic": write_qp_generic_golden,
    "qp_fullspace": write_qp_fullspace_golden,
    "qp_banded_t30": write_qp_banded_golden,
    "facade_solvers": write_facade_solvers_golden,
    "qp_fullspace_f64": write_qp_fullspace_f64_golden,
    "sharded_step": write_sharded_golden,
}


def main() -> None:
    names = sys.argv[1:] or [n for n in WRITERS if n != "sharded_step"]
    unknown = [n for n in names if n not in WRITERS]
    if unknown:
        sys.exit(f"unknown golden {unknown}; choose from {list(WRITERS)}")
    if "sharded_step" in names:
        if len(names) > 1:
            sys.exit("write sharded_step alone: its process has 8 virtual devices")
        # the virtual devices exist only if asked for before jax loads
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_"
                                   f"device_count={SHARDED_DEVICES}").strip()
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in names:
        WRITERS[name](os.path.join(GOLDEN_DIR, f"{name}.npz"))
        print("wrote", name)


if __name__ == "__main__":
    main()
