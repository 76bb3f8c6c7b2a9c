"""Port vs JAX: the closed loop, the long horizons and the planner settings
that ``chip_smoke.py`` carries as dicts.

tests/golden/torch/loop_*.npz (scripts/make_torch_goldens.py) hold 15
closed-loop ticks of the JAX facade in the JAX simulator for
``corridor/acker``, ``corridor/omni``, ``polygon_robot/diff``,
``corridor_long/diff`` (T=30, and T=33 where the condensed QP's inverses
exceed n=96), and ``dyna_obs/diff`` with point velocities, each from a
start a few metres before the obstacles. The port's facade is fed the
recorded states, points and velocities and, each tick, the state the JAX
facade carried into it. Off the TPU the JAX planner ranks the materialized point flow
without the Pallas kernel, so the port runs the same path: its spec's
``dune_kernel`` switched off.
"""

import dataclasses
import os
import subprocess
import sys

import jax  # noqa: F401  (JAX and PyTorch share this process: both are imported up front)
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from neupan_torch import NeuPan
from neupan_torch.ops import qp as tqp
from neupan_torch.ops.kernels import admm as AD
from neupan_torch.ops.kernels import polish as PO
from neupan_torch.ops.kernels import sweep as SW
from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
from neupan_torch.ops.pan import PANState, pan_forward
from neupan_torch.parallel import batched_init_state
from scripts.make_torch_goldens import (CARRY, LOOP_SCENARIOS, _golden_inputs,
                                        loop_overrides, step_inputs)
from tests.test_torch_pan import _setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "torch")


# Action bound by horizon. At T=10, bench.py's cross-backend bound on opt_u. At
# T>=30 the polish's tolerance-driven active set flips on float32 rounding in
# some ticks: given the same carried state, 2 of the 15 T=30 golden ticks and 1
# of the T=33 ones are above 5e-4 from JAX, the worst 1.04e-3 and 1.07e-3
# (scripts/exp_loop_carry.py), and card vs CPU steps of the port part the same
# way (PERF.md section 6). So at T>=30 every tick within 1.5e-3, and at
# most LONG_TICKS_ABOVE ticks above 5e-4.
ACTION_ATOL = {10: 5e-4, 30: 1.5e-3, 33: 1.5e-3}
LONG_TICKS_ABOVE = 2
# What the port carries out of a tick against what the JAX facade carried into
# the next one, relative to 1 + the largest reference entry: the DUNE columns
# (mu, lam) of each frame as a set (near-tied points may swap slots), the other
# fields entrywise. The goldens' worst: 4.0e-4 (columns), 4.6e-4 (y_warm at
# T=30), 4.0e-4 (the velocity plan at T=33); a carry that is shifted, stale or
# dropped parts by 1e-1 or more.
CARRY_RTOL = 2e-3


def _column_set_distance(a, b):
    """Per frame of (T+1, R, K) arrays, the Hausdorff distance between the K
    columns of ``a`` and of ``b``; the largest over the frames."""
    dist = np.linalg.norm(a[:, :, :, None] - b[:, :, None, :], axis=1)
    return max(dist.min(axis=2).max(), dist.min(axis=1).max())


def _carry_error(planner, g, i):
    """Relative differences between what ``planner`` carries out of golden
    tick ``i`` and what the JAX facade carried into tick ``i + 1``."""
    rel = lambda d, b: float(d) / (1.0 + float(np.abs(b).max()))
    nxt = {f[len("carry_"):]: g[f][i + 1] for f in CARRY}
    own = {f: getattr(planner.pan_state, f)[0].double().numpy() for f in nxt}
    for f in ("prev_valid", "prev_has_points"):
        assert bool(own[f]) == bool(nxt[f]), (i, f)
    cols = lambda d: np.concatenate([d["prev_mu"], d["prev_lam"]], axis=1).astype(np.float64)
    err = {"dune_columns": rel(_column_set_distance(cols(own), cols(nxt)), cols(nxt)),
           "cur_vel": rel(np.abs(planner.cur_vel_array - g["cur_vel"][i + 1]).max(),
                          g["cur_vel"][i + 1])}
    for f in ("prev_s", "prev_u", "x_warm", "y_warm"):
        err[f] = rel(np.abs(own[f] - nxt[f]).max(), nxt[f])
    return err


@pytest.mark.parametrize("name", sorted(LOOP_SCENARIOS))
def test_closed_loop_ticks_match_the_jax_facade(name):
    """Tick by tick, given what the JAX facade carried into the tick (its
    PANState and velocity plan), the state and the points: every action
    within ACTION_ATOL (at T>=30 at most LONG_TICKS_ABOVE of them above
    5e-4), min_distance to 1e-4, the stop/arrive/collision flags equal; and
    what the port carries out of each tick within CARRY_RTOL of what the JAX
    facade carried into the next. Carrying the port's own state instead,
    the acker loop parts by 3.7e-2 at tick 2: the JAX facade given the same
    1e-3 change of its velocity plan moves alike
    (test_acker_action_moves_with_the_velocity_plan_as_jax_does). The T=33
    golden runs the Cholesky inverses (n=99 and 102) and plain ADMM
    iterations (k=99, m=493), where the kernels do not admit the shapes."""
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as f:
        g = {k: f[k] for k in f.files}
    example, start, waypoints, receding, point_vel = LOOP_SCENARIOS[name]
    assert str(g["example"]) == example and bool(g["point_vel"]) == point_vel
    np.testing.assert_array_equal(g["start"], start)
    np.testing.assert_array_equal(g["state"][0][:, 0], start)
    planner = NeuPan.init_from_yaml(os.path.join(ROOT, "examples", example, "planner.yaml"),
                                    device="cpu", **loop_overrides(example, waypoints, receding))
    assert planner.T == int(g["receding"])
    planner.spec = dataclasses.replace(planner.spec, dune_kernel=False)
    atol, above = ACTION_ATOL[planner.T], 0
    for i in range(len(g["action"])):
        planner.pan_state = PANState(*(torch.as_tensor(g[f][i])[None] for f in CARRY))
        planner.cur_vel_array = g["cur_vel"][i].copy()
        action, info = planner(*_golden_inputs(g, i, point_vel))
        np.testing.assert_allclose(action, g["action"][i], rtol=0, atol=atol,
                                   err_msg=f"tick {i}")
        above += float(np.abs(action - g["action"][i]).max()) > 5e-4
        assert planner.min_distance == pytest.approx(float(g["min_distance"][i]), abs=1e-4), i
        for flag in ("stop", "arrive", "collision"):
            assert info[flag] == bool(g[flag][i]), (i, flag)
        if i + 1 < len(g["action"]):
            err = _carry_error(planner, g, i)
            assert max(err.values()) <= CARRY_RTOL, (i, err)
    assert above <= (LONG_TICKS_ABOVE if planner.T >= 30 else 0), above
    # the episode saw the obstacles, and they were near enough to shape the plan
    assert g["counts"].min() > 0 and g["min_distance"].min() < 3.0
    if point_vel:
        assert np.abs(g["velocities"]).max() > 0.1


def _nrmp(T, K):
    return NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=(8.0, 1.0), acce_bound=(0.8, 0.3))


def test_admission_predicates_route_the_qp_stages(monkeypatch):
    """The shapes of the NRMP layout against each kernel's one predicate;
    the QP's call site takes the plain version where the predicate refuses,
    and the wrappers go on refusing those shapes on either device."""
    shapes = {}
    for T, K in ((10, 10), (30, 10), (30, 12), (32, 10), (33, 10)):
        s = _nrmp(T, K)
        shapes[T, K] = (3 * T, s.m - s.r_acc, s.r_spd - s.r_acc)
    assert shapes[10, 10] == (30, 148, 18) and shapes[30, 12][1] == 508
    fits = {tk: AD.admm_fits(k, m) for tk, (k, m, _) in shapes.items()}
    assert fits == {(10, 10): True, (30, 10): True, (30, 12): False, (32, 10): False,
                    (33, 10): False}
    assert [PO.polish_fits(k, na) for k, _, na in shapes.values()] == [True] * 5
    s = _nrmp(40, 10)           # k=120, na=78: within 128, beyond one block's shared memory
    assert PO.polish_fits(120, 78) is False and (3 * 40, s.r_spd - s.r_acc) == (120, 78)
    assert PO.polish_fits(129, 10) is False and PO.polish_fits(128, 10) is True

    calls = []
    for name in ("admm_iterate", "admm_iterate_plain"):
        real = getattr(AD, name)
        monkeypatch.setattr(tqp, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append((_n, tuple(a[1].shape[1:]))), _f(*a, **kw))[1])
    rng = np.random.default_rng(0)
    cfg = tqp.ADMMConfig(iters=4)
    for k, m in ((30, 148), (90, 508)):
        As = torch.from_numpy(rng.normal(size=(1, m, k)).astype(np.float32)) / k
        H = torch.eye(k)[None] * 2.0
        ls, us = -torch.ones(1, m), torch.ones(1, m)
        w, z, y = tqp._admm_phases(cfg, H, torch.ones(1, k), As, ls, us, torch.zeros(1, m),
                                   torch.zeros(1, k), torch.zeros(1, m), SW.spd_inverse_any)
        assert bool(torch.isfinite(w).all() & torch.isfinite(y).all())
    assert calls == [("admm_iterate", (148, 30))] * 2 + [("admm_iterate_plain", (508, 90))] * 2

    big = [torch.zeros(s) for s in ((1, 90, 90), (1, 508, 90))]
    with pytest.raises(ValueError, match="shared memory"):
        AD.admm_iterate(big[0], big[1], torch.zeros(1, 90), *[torch.zeros(1, 508)] * 4,
                        torch.zeros(1, 90), torch.zeros(1, 508), torch.zeros(1, 508),
                        iters=1, sigma=1e-6, alpha=1.6)
    k, na = 120, 78
    with pytest.raises(ValueError, match="k, na <= 128"):
        PO.box_candidate(torch.eye(k)[None], torch.eye(k)[None], torch.zeros(1, na, k),
                         *[torch.zeros(1, k)] * 2, torch.zeros(1, na),
                         *[torch.zeros(1, k)] * 2, torch.ones(1, na), refine=1)
    # the plain version takes it, through the Cholesky route above 96
    w, yn = PO.box_candidate_plain(torch.eye(k)[None] * 2, torch.eye(k)[None] * 2,
                                   torch.zeros(1, na, k), torch.ones(1, k), torch.ones(1, k),
                                   torch.zeros(1, na), torch.zeros(1, k), torch.zeros(1, k),
                                   torch.zeros(1, na), refine=1)
    torch.testing.assert_close(w, torch.full((1, k), 0.5))
    # at k=99 (T=33) the wrapper takes the shape; on the CPU it is the plain version
    k, na = 99, 64
    args = (torch.eye(k)[None] * 2, torch.eye(k)[None] * 2, torch.zeros(1, na, k),
            torch.ones(1, k), torch.ones(1, k), torch.zeros(1, na), torch.zeros(1, k),
            torch.zeros(1, k), torch.zeros(1, na))
    for a, b in zip(PO.box_candidate(*args, refine=1), PO.box_candidate_plain(*args, refine=1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("K", [5, 0], ids=["obstacles", "no_obstacles"])
def test_pan_forward_refuses_gradients_it_would_drop(K):
    """With gradients recorded and an AdjustParams tensor requiring grad the
    step carries a gradient to it (through the QP's backward) instead of
    returning detached outputs; without a weight that requires grad, or
    under no_grad, it records no graph and returns bit for bit what it
    returns for weights that need no grad."""
    T, P, B = 4, 128, 4
    spec, enc, geom, adjust = _setup(T, P, K)
    inp = {k: torch.from_numpy(v) for k, v in step_inputs(7, T, P, max(K, 1), B).items()}
    args = (inp["nom_s"], inp["nom_u"], inp["ref_s"], inp["ref_us"], inp["pts1"],
            inp["vels1"], inp["mask1"], batched_init_state(spec, B, "cpu"))
    out = pan_forward(spec, enc, *geom, adjust, *args)
    assert not out.opt_u.requires_grad and out.opt_u.grad_fn is None
    tuned = AdjustParams(*(t.clone().requires_grad_(i == 1) for i, t in enumerate(adjust)))
    out_g = pan_forward(spec, enc, *geom, tuned, *args)
    assert out_g.opt_u.requires_grad
    (d_pu,) = torch.autograd.grad(out_g.opt_u[:, 0].sum(), [tuned.p_u])
    assert torch.isfinite(d_pu) and float(d_pu) != 0.0
    torch.testing.assert_close(out_g.opt_u.detach(), out.opt_u, rtol=0, atol=0)
    with torch.no_grad():
        out_ng = pan_forward(spec, enc, *geom, tuned, *args)
    for a, b in zip(out, out_ng):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and b.grad_fn is None
    for a, b in zip(out.state, out_ng.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(chip_smoke.CONFIGS))
def test_chip_smoke_settings_equal_their_yaml_files(name):
    """chip_smoke.py carries planner and env settings as dicts (the card's
    machine is not promised pyyaml); each must equal its file."""
    for kind in ("planner", "env"):
        with open(os.path.join(ROOT, "examples", name, f"{kind}.yaml")) as f:
            assert chip_smoke.CONFIGS[name][kind] == yaml.safe_load(f), kind
    start, waypoints = chip_smoke.PARITY_CONFIGS.get(name, (None, None))
    if start is not None:       # the card's parity ticks start where the goldens start
        golden = [v for v in LOOP_SCENARIOS.values() if v[0] == name and v[3] is None]
        assert golden and golden[0][1:3] == (start, waypoints)


def test_run_exp_torch_drives_the_closed_loop_without_jax():
    """examples/run_exp_torch.py, 12 ticks of corridor/diff on the CPU, in a
    process whose import of jax fails."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'neupan_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {os.path.join(ROOT, 'examples')!r})
import run_exp_torch
base = {os.path.join(ROOT, 'examples', 'corridor', 'diff')!r}
r = run_exp_torch.main(base + '/env.yaml', base + '/planner.yaml', max_steps=12, quiet=True,
                       device='cpu')
assert r == dict(arrived=False, collided=False, steps=12, contacts=0), r
assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'neupan_tpu')]
print('drove', r)
"""
    res = subprocess.run([sys.executable, "-I", "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "drove" in res.stdout


def test_warm_started_solve_matches_jax_where_both_stop_short():
    """tests/golden/torch/qp_reverse_acker_warm.npz: the QP that the JAX
    facade's own reverse/acker episode builds at tick 10 and the warm start
    it carries there. From a cold start both packages reach the float64
    oracle's objective; from that warm start JAX's deployed (condensed)
    solve stops 2.9e-3 short of it (scripts/make_torch_goldens.py prints the
    gaps), as the port's does on its own episode on the card. The port
    solves it as JAX does: first controls within 5e-4, objective gaps
    alike."""
    from scripts.exp_control_accuracy_torch import qp_objective, scipy_soft_oracle

    with np.load(os.path.join(GOLDEN_DIR, "qp_reverse_acker_warm.npz")) as f:
        g = {k: f[k] for k in f.files}
    T, K = int(g["T"]), int(g["K"])
    nrmp = NRMPSpec(T=T, K=K, kinematics=str(g["kinematics"]), speed_bound=(8.0, 1.0),
                    acce_bound=(0.8, 0.05))
    cfg = tqp.ADMMConfig(elim_n_eq=int(g["elim_n_eq"]), elim_n_hard=int(g["elim_n_hard"]),
                         elim_n_acc=int(g["elim_n_acc"]))
    t = lambda k: torch.from_numpy(g[k])[None]
    qp = tqp.QPData(*(t(k) for k in ("P_diag", "q", "A", "l", "u", "soft")))
    elim = (t("Z"), t("xp"))
    P, q, A, l, u, soft = (g[k].astype(np.float64) for k in ("P_diag", "q", "A", "l", "u", "soft"))
    f_ref = qp_objective(P, q, A, l, soft, scipy_soft_oracle(P, q, A, l, u, soft))
    gap = lambda x: (qp_objective(P, q, A, l, soft, np.asarray(x, np.float64)) - f_ref) / (
        1.0 + abs(f_ref))
    u0 = lambda x: np.asarray(x)[nrmp.off_u:nrmp.off_u + 2]
    for x0, y0, jax_x, short in ((torch.zeros_like(t("x_warm")), torch.zeros_like(t("y_warm")),
                                  g["x_cold"], False),
                                 (t("x_warm"), t("y_warm"), g["x_warm_solved"], True)):
        x = tqp.solve_qp(qp, cfg, x0, y0, elim).x[0].numpy()
        np.testing.assert_allclose(u0(x), u0(jax_x), rtol=0, atol=5e-4)
        g_port, g_jax = gap(x), gap(jax_x)
        if short:
            assert 1e-3 < g_jax < 1e-2 and abs(g_port - g_jax) <= 0.1 * g_jax, (g_port, g_jax)
        else:
            assert max(g_port, g_jax) <= 1e-5, (g_port, g_jax)


def test_acker_action_moves_with_the_velocity_plan_as_jax_does():
    """tests/golden/torch/plan_corridor_acker.npz: at tick 2 of the
    corridor/acker golden, the velocity plan that the port carries there
    when it carries its own state (1.0e-3 from the JAX facade's), given to
    the JAX facade with the rest of what it carried. JAX's action moves by
    3.7e-2 for it, and the port's, given the same, moves with it to 5e-4:
    the amplification is the planner's, in both packages."""
    with np.load(os.path.join(GOLDEN_DIR, "plan_corridor_acker.npz")) as f:
        plan = {k: f[k] for k in f.files}
    name, tick = str(plan["golden"]), int(plan["tick"])
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as f:
        g = {k: f[k] for k in f.files}
    example, _, waypoints, receding, point_vel = LOOP_SCENARIOS[name]
    planner = NeuPan.init_from_yaml(os.path.join(ROOT, "examples", example, "planner.yaml"),
                                    device="cpu", **loop_overrides(example, waypoints, receding))
    planner.spec = dataclasses.replace(planner.spec, dune_kernel=False)
    for i in range(tick + 1):
        planner.pan_state = PANState(*(torch.as_tensor(g[f][i])[None] for f in CARRY))
        planner.cur_vel_array = (plan["cur_vel"] if i == tick else g["cur_vel"][i]).copy()
        action, _ = planner(*_golden_inputs(g, i, point_vel))
    assert np.abs(plan["cur_vel"] - g["cur_vel"][tick]).max() < 2e-3
    assert np.abs(plan["action"] - g["action"][tick]).max() > 1e-2
    np.testing.assert_allclose(action, plan["action"], rtol=0, atol=5e-4)


# Ticks of each whole-episode golden that the port's own episode is held to: the
# materialized selection through the gear change from forward to reverse at tick
# 39; the fused selection on to tick 61, past where it parts from the
# materialized path (tick 35), up to where both near the parking bay's edge
# (from tick 62 the selected points differ: 2e-2 in the DUNE columns).
EPISODE_TICKS = {"episode_reverse_acker": 46, "episode_reverse_acker_fused": 62}
# Carrying its own state, the port's inputs part a little from JAX's; measured
# over those ticks: states 5.2e-5 (materialized) and 1.8e-5 (fused), the carry
# out of a tick 2.1e-3 (the velocity plan braking for the gear change at tick
# 38), against CARRY_RTOL's 4e-4.
EPISODE_STATE_ATOL, EPISODE_CARRY_RTOL = 1e-3, 1e-2


@pytest.mark.parametrize("name", sorted(EPISODE_TICKS))
def test_reverse_acker_episode_follows_jax_carrying_its_own_state(name):
    """tests/golden/torch/episode_reverse_acker*.npz: the JAX facade's whole
    reverse/acker episode in the JAX simulator, with its selection on the
    materialized point flow (the path off the TPU: it arrives at tick 69)
    or in the fused selection kernel (the TPU's path: it parts from the
    other at tick 35 and stops short of the bay, as the port's closed loop
    on the card does). The port's facade on the same selection path (the
    flow-select kernel's plain version, or the materialized flow) in the
    port's simulator, carrying its own state from tick to tick, follows
    it: over its EPISODE_TICKS every state within EPISODE_STATE_ATOL, the
    flags equal, and what it carries out of each tick within
    EPISODE_CARRY_RTOL of what JAX carried out of the same tick."""
    from neupan_torch.sim.env_loader import load_env

    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as f:
        g = {k: f[k] for k in f.files}
    base = os.path.join(ROOT, "examples", str(g["example"]))
    planner = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"), device="cpu")
    planner.spec = dataclasses.replace(planner.spec, dune_kernel=bool(g["fused"]))
    env = load_env(os.path.join(base, "env.yaml"), planner.robot)
    ticks = EPISODE_TICKS[name]
    assert g["action"][ticks - 1][0] < 0 < g["action"][0][0]
    assert bool(g["arrive"][-1]) == (not g["fused"]) and len(g["action"]) > ticks
    worst = worst_carry = 0.0
    for i in range(ticks):
        state = env.get_robot_state()
        worst = max(worst, float(np.abs(state - g["state"][i]).max()))
        assert worst <= EPISODE_STATE_ATOL, (i, worst)
        action, info = planner(state, planner.scan_to_point(state, env.get_lidar_scan()))
        for flag in ("stop", "arrive", "collision"):
            assert info[flag] == bool(g[flag][i]), (i, flag)
        err = _carry_error(planner, g, i)
        worst_carry = max(worst_carry, *err.values())
        assert worst_carry <= EPISODE_CARRY_RTOL, (i, err)
        env.step(action)
