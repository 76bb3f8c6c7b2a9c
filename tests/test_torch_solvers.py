"""Port vs JAX: the QP solver's paths off the main path, against JAX goldens.

* ``qp_generic.npz`` holds tests/test_qp.py's instances (analytic ones,
  random QPs with scipy's x, soft rows and their slack reformulation, a
  batch, a warm start, two gradients with their central differences) and
  the JAX package's solutions: no elimination basis, so the full-space
  ADMM and the full-space polish candidate.
* ``qp_fullspace.npz`` holds tests/test_qp_condensed.py's five flagship
  instances (T=10, K=10) with their warm starts, the JAX solutions with
  ``condense_admm=False``, with ``elim_n_acc=None`` (the generic condensed
  candidate), with ``polish=False``, with no basis, and the scipy float64
  oracle's u.
* ``facade_solvers.npz`` holds five corridor/diff facade ticks of the JAX
  facade under each ``pan.admm`` setting, with the state it carried into
  each; ``qp_fullspace_f64.npz`` JAX's full-space ADMM in float64.

All are written by scripts/make_torch_goldens.py; no JAX solve is
compiled here. The polished solutions are held to 5e-4 (x, or u over the
horizon), u0 to the oracle to 1e-3 as the JAX test holds JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from neupan_torch.ops import qp as tqp
from neupan_torch.ops.nrmp import NRMPSpec, unpack_solution
from neupan_torch.ops.pan import PANSpec, PANState, _admm_with_elim
from neupan_torch.robot import Robot
from scripts.make_torch_goldens import (CARRY, FACADE_SOLVER_TICKS, FACADE_SOLVERS, FULLSPACE_SOLVES,
                                        GRAD_EPS, GRAD_Q_THETA, GRAD_SOFT_THETA, facade_points,
                                        generic_qp_cases, grad_q_qp, grad_soft_qp)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch")
FIELDS = ("P_diag", "q", "A", "l", "u", "soft")
TOL = 5e-4          # polished x (generic QPs) and u (flagship) against JAX
# the unpolished ADMM iterate against JAX's, in x (measured on these
# instances: full space 3.3e-4, condensed 5.1e-5). The full-space normal
# matrix carries rho_eq_scale = 1e3 on its 33 equality rows: JAX on the CPU
# inverts it by Cholesky, the port by the sweep, and 240 iterations carry
# the difference; the condensed one (n=30) both invert by elimination.
NOPOLISH_TOL = {"full_nopolish": 1e-3, "cond_nopolish": 2e-4}
# facade actions against the JAX facade under the same setting, each tick from
# JAX's carried state. The condensed path (nopolish) holds the usual 5e-4
# (measured 1.2e-5). The full-space ADMM's float32 iterate is rounding-
# sensitive on these ticks, and so is which polish candidate wins: JAX
# against itself with its n=63 inverses by Gauss-Jordan instead of Cholesky
# parts by up to 4.8e-3 (scripts/exp_fullspace_spread.py); the port parts by
# 1.6e-3 (dense) and 6.7e-3 (banded, its block Cholesky by LAPACK), and in
# float64 it equals JAX's ADMM to 1e-9 (test_fullspace_admm_equals_jax_in_float64).
FACADE_TOL = {"nopolish": 5e-4, "fullspace": 1e-2, "banded": 1e-2}


def _f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.fixture(scope="module")
def generic():
    with np.load(os.path.join(GOLDEN, "qp_generic.npz")) as g:
        return {k: g[k] for k in g.files}


@pytest.fixture(scope="module")
def flagship():
    with np.load(os.path.join(GOLDEN, "qp_fullspace.npz")) as g:
        return {k: g[k] for k in g.files}


def _case(g, name):
    return {k.split("__", 1)[1]: v for k, v in g.items() if k.startswith(name + "__")}


def _qp(c, batched=False):
    ex = _f32 if batched else (lambda a: _f32(a)[None])
    return tqp.QPData(*(ex(c[k]) for k in FIELDS[:5]),
                      soft=ex(c["soft"]) if "soft" in c else None)


def _solve(c, **kw):
    return tqp.solve_qp(_qp(c), tqp.ADMMConfig(iters=int(c["iters"])), **kw)


# -- the configuration ------------------------------------------------------------

def test_admm_config_has_every_jax_field():
    from neupan_tpu.ops.qp import ADMMConfig as JaxConfig

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(tqp.ADMMConfig)}
    assert ours == jax_fields


def test_ops_package_exports_the_solver():
    import neupan_torch.ops as ops

    for name in ("ADMMConfig", "QPData", "QPSolution", "solve_qp", "solve_qp_batch"):
        assert getattr(ops, name) is getattr(tqp, name)


# -- generic QPs (tests/test_qp.py) -------------------------------------------------

def test_golden_cases_rebuild_from_their_seeds(generic):
    for name, c in generic_qp_cases().items():
        for k, v in c.items():
            np.testing.assert_array_equal(generic[f"{name}__{k}"], np.asarray(v), err_msg=name)


@pytest.mark.parametrize("name", [n for n in generic_qp_cases() if n != "batch"])
def test_generic_qp_matches_jax(generic, name):
    c = _case(generic, name)
    sol = _solve(c)
    np.testing.assert_allclose(sol.x[0].numpy(), c["jax_x"], atol=TOL, rtol=0)
    np.testing.assert_allclose(sol.y[0].numpy(), c["jax_y"], atol=1e-3, rtol=1e-3)
    if "scipy_x" in c:                      # test_random_qp_vs_scipy's bound
        np.testing.assert_allclose(sol.x[0].numpy(), c["scipy_x"], rtol=2e-3, atol=2e-4)


def test_analytic_solutions():
    cases = generic_qp_cases()
    x = _solve(cases["unconstrained"]).x[0].numpy()
    c = cases["unconstrained"]
    np.testing.assert_allclose(x, -c["q"] / c["P_diag"], rtol=1e-4, atol=1e-5)
    sol = _solve(cases["box_clipped"])
    assert float(sol.x[0, 0]) == pytest.approx(1.0, abs=1e-5)
    assert float(sol.y[0, 0]) == pytest.approx(2.0, abs=1e-4)
    np.testing.assert_allclose(_solve(cases["equality"]).x[0].numpy(), [1.0, 1.0], atol=1e-5)
    for w in (0.5, 2.0, 50.0):
        sol = _solve(cases[f"soft_w{w:g}"])
        want = (3 + 5 * w) / (1 + w)
        assert float(sol.x[0, 0]) == pytest.approx(want, abs=1e-4)
        assert float(sol.y[0, 0]) == pytest.approx(w * (want - 5), abs=1e-3)
    sol = _solve(cases["soft_inactive"])
    assert float(sol.x[0, 0]) == pytest.approx(3.0, abs=1e-4)
    assert float(sol.y[0, 0]) == pytest.approx(0.0, abs=1e-4)


def test_kkt_residuals_small():
    c = generic_qp_cases()["kkt_small"]
    sol = _solve(c)
    assert float(sol.r_prim) < 5e-4 and float(sol.r_dual) < 5e-4
    Ax = c["A"] @ sol.x[0].numpy().astype(np.float64)
    assert np.all(Ax >= c["l"] - 5e-4) and np.all(Ax <= c["u"] + 5e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soft_rows_match_slack_reformulation(seed):
    cases = generic_qp_cases()
    x1 = _solve(cases[f"soft_rows{seed}"]).x[0].numpy()
    x2 = _solve(cases[f"slack{seed}"]).x[0].numpy()
    np.testing.assert_allclose(x1, x2[:x1.shape[0]], rtol=1e-3, atol=2e-4)


def test_batch_matches_single_and_jax(generic):
    c = _case(generic, "batch")
    cfg = tqp.ADMMConfig(iters=int(c["iters"]))
    sol = tqp.solve_qp_batch(_qp(c, batched=True), cfg)
    np.testing.assert_allclose(sol.x.numpy(), c["jax_x"], atol=TOL, rtol=0)
    for b in range(c["P_diag"].shape[0]):
        one = tqp.solve_qp(tqp.QPData(*(_f32(c[k][b])[None] for k in FIELDS[:5])), cfg)
        np.testing.assert_allclose(sol.x[b].numpy(), one.x[0].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(one.x[0].numpy(), c["jax_x_single"][b], atol=TOL, rtol=0)


def test_batch_broadcasts_one_soft_vector():
    c = generic_qp_cases()["soft_rows0"]
    B = 3
    qp = tqp.QPData(*(_f32(c[k])[None].expand(B, *np.shape(c[k])).contiguous()
                      for k in FIELDS[:5]), soft=_f32(c["soft"]))
    sol = tqp.solve_qp_batch(qp, tqp.ADMMConfig(iters=int(c["iters"])))
    one = _solve(c)
    for b in range(B):
        np.testing.assert_allclose(sol.x[b].numpy(), one.x[0].numpy(), rtol=1e-5, atol=1e-6)


def test_warm_start_accepted(generic):
    c = _case(generic, "warm")
    sol0 = _solve(c)
    sol1 = tqp.solve_qp(_qp(c), tqp.ADMMConfig(iters=10), x0=sol0.x, y0=sol0.y)
    np.testing.assert_allclose(sol1.x.numpy(), sol0.x.numpy(), atol=1e-4)
    np.testing.assert_allclose(sol1.x[0].numpy(), c["jax_x_warm"], atol=TOL, rtol=0)


def _loss(make, theta, field):
    """sum(x^2) of the QP ``make`` builds, theta entering ``field`` as a tensor."""
    c = make(1.0)
    qp = _qp(c)
    t = theta if torch.is_tensor(theta) else torch.tensor(theta)
    if field == "q":
        qp = qp._replace(q=(-2.0 * t * _f32(np.linspace(-1, 1, 6)))[None])
    else:
        qp = qp._replace(l=torch.cat([-10 * torch.ones(4), 6.0 * t.reshape(1)])[None])
    return torch.sum(tqp.solve_qp(qp, tqp.ADMMConfig(iters=int(c.get("iters", 200)))).x ** 2)


@pytest.mark.parametrize("name,make,theta0,field", [
    ("grad_q", grad_q_qp, GRAD_Q_THETA, "q"),
    ("grad_soft", grad_soft_qp, GRAD_SOFT_THETA, "l")])
def test_implicit_gradient_matches_finite_difference(generic, name, make, theta0, field):
    """The backward through the generic solve (no basis): the port's grad
    against its own central difference (tests/test_qp.py's 5e-2) and JAX's
    grad; the soft-row case also against its closed form."""
    theta = torch.tensor(theta0, requires_grad=True)
    loss = _loss(make, theta, field)
    (g,) = torch.autograd.grad(loss, theta)
    fd = (float(_loss(make, theta0 + GRAD_EPS, field))
          - float(_loss(make, theta0 - GRAD_EPS, field))) / (2 * GRAD_EPS)
    assert float(loss.detach()) == pytest.approx(float(generic[f"{name}__loss"]), rel=1e-4)
    assert float(g) == pytest.approx(fd, rel=5e-2, abs=1e-4)
    assert float(g) == pytest.approx(float(generic[f"{name}__jax_grad"]), rel=1e-3)
    if name == "grad_soft":
        w, n = 20.0, 4
        c = 6 * w * theta0 / (1 + n * w)
        assert float(g) == pytest.approx(2 * n * c * (6 * w / (1 + n * w)), rel=1e-3)


def test_no_polish_returns_the_admm_iterate_unsnapped():
    """polish=False skips the polish and the bound snap: a box the ADMM
    iterate overshoots by a little stays overshot."""
    c = generic_qp_cases()["box_clipped"]
    cfg = tqp.ADMMConfig(iters=20, polish=False)
    sol = tqp.solve_qp(_qp(c), cfg)
    pol = tqp.solve_qp(_qp(c), dataclasses.replace(cfg, polish=True))
    assert float(pol.x[0, 0]) == 1.0                      # snapped onto the bound
    assert float(sol.x[0, 0]) != 1.0
    assert float(sol.r_prim[0]) == pytest.approx(max(float(sol.x[0, 0]) - 1.0, 0.0), abs=1e-7)


# -- flagship instances (tests/test_qp_condensed.py) --------------------------------

def _layout(g):
    T = int(g["T"])
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    nrmp = NRMPSpec(T=T, K=int(g["K"]), kinematics="diff",
                    speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    return nrmp, _admm_with_elim(PANSpec(robot=robot, nrmp=nrmp))


@pytest.fixture(scope="module")
def flagship_solves(flagship):
    """The port's solve of all five instances under each FULLSPACE_SOLVES
    config and the default (condensed, box) one, from the golden warm starts."""
    _, cfg = _layout(flagship)
    qp = tqp.QPData(*(torch.from_numpy(flagship[k]) for k in FIELDS))
    x0, y0 = torch.from_numpy(flagship["x0"]), torch.from_numpy(flagship["y0"])
    elim = (torch.from_numpy(flagship["Z"]), torch.from_numpy(flagship["xp"]))
    out = {"default": tqp.solve_qp(qp, cfg, x0, y0, elim)}
    for name, over in FULLSPACE_SOLVES.items():
        if over is None:
            out[name] = tqp.solve_qp(qp, tqp.ADMMConfig(), x0, y0)
        else:
            out[name] = tqp.solve_qp(qp, dataclasses.replace(cfg, **over), x0, y0, elim)
    return out


@pytest.mark.parametrize("name", ["full", "generic", "nobasis"])
def test_flagship_polished_paths_match_jax_and_oracle(flagship, flagship_solves, name):
    """Each polished path: u within 5e-4 of JAX's over the horizon, u0
    within 1e-3 of the scipy float64 oracle, hard rows within 2e-3."""
    nrmp, _ = _layout(flagship)
    sol = flagship_solves[name]
    u = unpack_solution(nrmp, sol.x)[1].numpy()
    u_jax = unpack_solution(nrmp, torch.from_numpy(flagship[f"{name}_x"]))[1].numpy()
    np.testing.assert_allclose(u, u_jax, atol=TOL, rtol=0)
    np.testing.assert_allclose(u[:, :, 0], flagship["u_oracle"][:, :, 0], atol=1e-3)
    assert (sol.r_prim.numpy() < 2e-3).all(), sol.r_prim


def test_condensed_matches_fullspace(flagship_solves, flagship):
    """tests/test_qp_condensed.py's check on the port: the condensed and the
    full-space ADMM land on the same polished optimum (u0 to 3e-4 + 1e-3
    relative, the horizon to 1e-3), and so do the box-eliminating and the
    generic dual-Schur candidates."""
    nrmp, _ = _layout(flagship)
    u = {k: unpack_solution(nrmp, flagship_solves[k].x)[1].numpy()
         for k in ("default", "full", "generic")}
    for other in ("full", "generic"):
        np.testing.assert_allclose(u["default"][:, :, 0], u[other][:, :, 0], rtol=1e-3, atol=3e-4)
        np.testing.assert_allclose(u["default"], u[other], atol=1e-3)


@pytest.mark.parametrize("name", sorted(NOPOLISH_TOL))
def test_flagship_unpolished_admm_matches_jax(flagship, flagship_solves, name):
    """polish=False returns the ADMM's (x, y, z, r_prim, r_dual) as they
    are: x to the measured NOPOLISH_TOL, the residuals consistent."""
    sol = flagship_solves[name]
    dx = np.abs(sol.x.numpy() - flagship[f"{name}_x"]).max()
    assert dx <= NOPOLISH_TOL[name], dx
    qp = tqp.QPData(*(torch.from_numpy(flagship[k]) for k in FIELDS))
    z, rp, rd = tqp._residuals(qp, sol.x, sol.y)
    torch.testing.assert_close(sol.z, z, rtol=0, atol=0)
    torch.testing.assert_close(sol.r_prim, rp, rtol=0, atol=0)
    np.testing.assert_allclose(sol.r_prim.numpy(), flagship[f"{name}_r_prim"], atol=2e-3)


# -- the facade and the PAN spec ---------------------------------------------------------

CORRIDOR = os.path.join(ROOT, "examples/corridor/diff/planner.yaml")


def _corridor_pan(admm):
    import yaml

    with open(CORRIDOR) as f:
        return dict(yaml.safe_load(f)["pan"], admm=admm)


@pytest.mark.parametrize("name", sorted(FACADE_SOLVERS))
def test_facade_takes_every_solver_setting(name):
    """NeuPan built from examples/corridor/diff/planner.yaml with ``pan.admm``
    set (FACADE_SOLVERS) on the CPU, fed the JAX facade's states, points and
    the state it carried into each tick (golden ``facade_solvers``), as
    tests/test_torch_loop.py feeds them: the setting reaches the spec, the
    banded permutation is the NRMP one, and every action is within
    FACADE_TOL of the JAX facade's under the same setting."""
    from neupan_tpu.ops.banded import nrmp_permutation
    from neupan_torch import NeuPan

    admm = FACADE_SOLVERS[name]
    with np.load(os.path.join(GOLDEN, "facade_solvers.npz")) as g:
        g = {k: g[k] for k in g.files}
    pts, counts = facade_points()
    planner = NeuPan.init_from_yaml(CORRIDOR, device="cpu", pan=_corridor_pan(admm))
    planner.spec = dataclasses.replace(planner.spec, dune_kernel=False)
    for k, v in admm.items():
        assert getattr(planner.spec.admm, k) == v
    perm = _admm_with_elim(planner.spec).banded_perm
    assert perm == (tuple(int(i) for i in nrmp_permutation(10)) if name == "banded" else None)
    for i in range(FACADE_SOLVER_TICKS):
        planner.pan_state = PANState(*(torch.as_tensor(g[f"{name}_{f}"][i])[None] for f in CARRY))
        planner.cur_vel_array = g[f"{name}_cur_vel"][i].copy()
        action, _ = planner(g[f"{name}_state"][i], pts[i, :, :counts[i]].astype(np.float64))
        np.testing.assert_allclose(action, g[f"{name}_action"][i], rtol=0,
                                   atol=FACADE_TOL[name], err_msg=f"tick {i}")
        assert planner.min_distance == pytest.approx(float(g[f"{name}_min_distance"][i]),
                                                     abs=1e-4)


def test_admm_json_hook_and_user_layout_win(monkeypatch, capsys):
    """NEUPAN_ADMM_JSON reaches ADMMConfig with the new fields; a user's
    elim_n_eq keeps the config as given (no banded permutation filled); the
    reg = 0 warning fires only with the polish on, as the JAX facade's."""
    from neupan_torch import NeuPan

    monkeypatch.setenv("NEUPAN_ADMM_JSON", '{"condense_admm": false, "inverse": "banded"}')
    planner = NeuPan.init_from_yaml(CORRIDOR, device="cpu")
    assert not planner.spec.admm.condense_admm and planner.spec.admm.inverse == "banded"
    assert _admm_with_elim(planner.spec).banded_perm is not None
    user = dataclasses.replace(planner.spec, admm=tqp.ADMMConfig(inverse="banded", elim_n_eq=33,
                                                                 elim_n_hard=48))
    assert _admm_with_elim(user) is user.admm
    monkeypatch.delenv("NEUPAN_ADMM_JSON")
    capsys.readouterr()
    for polish, warns in ((True, True), (False, False)):
        NeuPan.init_from_yaml(CORRIDOR, device="cpu", pan=_corridor_pan({"polish": polish}),
                              adjust={"reg_u": 0.0})
        assert ("reg_u/reg_d = 0" in capsys.readouterr().out) is warns


def _float64_routes(monkeypatch):
    """Run the QP's inverses and iterations on their plain versions, which
    take float64."""
    import functools

    from neupan_torch.ops.kernels import admm as AD
    from neupan_torch.ops.kernels import sweep as SW

    monkeypatch.setattr(tqp, "spd_inverse_any",
                        functools.partial(SW.spd_inverse_any, small=SW.sweep_spd_inverse_plain))
    monkeypatch.setattr(tqp, "admm_iterate", AD.admm_iterate_plain)


def test_fullspace_admm_equals_jax_in_float64(flagship, monkeypatch):
    """The port's full-space ADMM (``_admm_core``) in float64 equals JAX's in
    float64 (golden ``qp_fullspace_f64``) to 1e-9 on the five flagship
    instances: what parts the float32 runs (NOPOLISH_TOL) is rounding."""
    _float64_routes(monkeypatch)
    with np.load(os.path.join(GOLDEN, "qp_fullspace_f64.npz")) as g:
        g = {k: g[k] for k in g.files}
    qp = tqp.QPData(*(torch.from_numpy(flagship[k]).double() for k in FIELDS))
    x, y, *_ = tqp._admm_core(qp, tqp.ADMMConfig(), torch.from_numpy(flagship["x0"]).double(),
                              torch.from_numpy(flagship["y0"]).double())
    np.testing.assert_allclose(x.numpy(), g["flagship_x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(y.numpy(), g["flagship_y"], rtol=1e-9, atol=1e-8)
