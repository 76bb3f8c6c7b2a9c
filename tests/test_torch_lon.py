"""Port vs JAX: the QP's backward pass, the differentiated planner step and
LON (``neupan_torch/lon.py``).

tests/golden/torch/ (scripts/make_torch_goldens.py):

* ``qp_vjp.npz`` — the first PAN iteration's QP of the tests/test_lon.py
  setup and of a corridor/diff tick with its elimination basis, JAX's
  solution (x, y), a seeded
  cotangent g of x and JAX's cotangents of the QP's fields;
* ``lon_step.npz`` — ``neupan_tpu.lon.step_loss_and_grad`` on the
  test_lon.py setup (scalar and 3-vector q_s, iter_num 1 and 2) and on a
  corridor/diff tick near the first obstacle, with the near branch of the
  distance loss forced;
* ``lon_ticks_corridor_diff.npz`` — 8 ticks of JAX's
  ``examples/LON/LON_corridor.py:run_episode`` with the near branch forced.

Off the TPU the JAX step ranks the materialized point flow, so the port
runs that path (``dune_kernel=False``) where it is held to a golden; the
fused path's gradient is held to the same goldens where the two
selections pick the same points. No JAX step is compiled here.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neupan_torch import NeuPan
from neupan_torch.lon import (LONTuner, _loss_fn_arity, distance_loss, step_loss_and_grad,
                              tracking_losses)
from neupan_torch.models import ObsPointNet
from neupan_torch.ops import pan as tpan
from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
from neupan_torch.ops.pan import PANSpec, PANState
from neupan_torch.ops.qp import ADMMConfig, QPData, _solve_bwd_impl, solve_qp
from neupan_torch.robot import Robot
from neupan_tpu.lon import LONTuner as JaxLONTuner
from neupan_tpu.ops.nrmp import AdjustParams as JaxAdjustParams
from scripts.make_torch_goldens import (CARRY, LON_FD_EPS, LON_INPUTS, LON_STEP_CASES,
                                        QP_FIELDS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "torch")
FIELDS = AdjustParams._fields
# The backward alone, at JAX's own (qp, x, y, g): each cotangent field within
# this fraction of the field's largest magnitude (float32 LU of a KKT system
# with a 1e-7 ridge).
VJP_RTOL = 1e-4
# The differentiated step and the tuned weights: the ROADMAP's bar.
GRAD_RTOL = 1e-3


def _load(name):
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def vjp_golden():
    return _load("qp_vjp")


@pytest.fixture(scope="module")
def step_golden():
    return _load("lon_step")


def _rel_err(a, b):
    """Largest |a - b| over the largest |b| (1 where b is all zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max()) if b.size else 0.0
    return float(np.abs(a - b).max()) / (scale if scale > 0 else 1.0)


def _corridor_planner():
    return NeuPan.init_from_yaml(os.path.join(ROOT, "examples/corridor/diff/planner.yaml"),
                                 device="cpu")


def _lon_setup(g, name):
    """The port's (spec, encoder, vertices, G, h) for a lon_step case: the
    tests/test_lon.py setup (its random encoder weights from the golden) or
    the corridor/diff facade's."""
    if name == "corridor":
        p = _corridor_planner()
        return p.spec, p.encoder, p.vertices, p.G, p.h
    T = g[f"{name}__nom_u"].shape[-1]
    K = g[f"{name}__carry_prev_mu"].shape[-1]
    P = g[f"{name}__pts"].shape[-1]
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[4, 2],
                         max_acce=[4, 2], length=1.6, width=1.0)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]), ro_obs=100.0)
    spec = PANSpec(robot=robot, nrmp=nrmp, iter_num=int(g[f"{name}__iter_num"]),
                   dune_max_num=P, admm=ADMMConfig(iters=60))
    enc = ObsPointNet.from_jax_params({k[4:]: v for k, v in g.items() if k.startswith("enc_")},
                                      device="cpu")
    return (spec, enc, *robot.tensors("cpu"))


def _lon_inputs(g, prefix, i=None):
    """A case's (or a tick's) step inputs and carried state, batched (B=1)."""
    pick = (lambda k: g[f"{prefix}{k}"]) if i is None else (lambda k: g[k][i])
    t = lambda a: torch.as_tensor(np.asarray(a))[None]
    inputs = [t(pick(k)) for k in LON_INPUTS]
    state = PANState(*(t(pick(f)) for f in CARRY))
    return inputs, state


def _adjust(g, prefix, i=None, key="adjust"):
    pick = (lambda f: g[f"{prefix}{key}_{f}"]) if i is None else (lambda f: g[f"{key}_{f}"][i])
    return AdjustParams(*(torch.as_tensor(np.asarray(pick(f), np.float32)) for f in FIELDS))


def _vec_loss(out, ref_s, ref_us, stuck):
    s_l, u_l = tracking_losses(out, ref_s, ref_us)
    return s_l + u_l


def _step_case(g, name, **spec_kw):
    spec, enc, verts, G, h = _lon_setup(g, name)
    spec = dataclasses.replace(spec, **{"dune_kernel": False, **spec_kw})
    inputs, state = _lon_inputs(g, f"{name}__")
    adjust = _adjust(g, f"{name}__")
    loss_fn = _vec_loss if name.startswith("lon_vec") else None
    run = lambda adj: step_loss_and_grad(
        spec, enc, verts, G, h, adj, *inputs, state, loss_fn=loss_fn,
        collision_threshold=float(g[f"{name}__threshold"]))
    return run, adjust


# -- the backward alone ------------------------------------------------------------

@pytest.mark.parametrize("case", ["lon_scalar_it1", "corridor"])
def test_qp_backward_matches_jax_at_its_solution(vjp_golden, case):
    """_solve_bwd_impl at JAX's own (qp, x, y, g): every cotangent field
    within VJP_RTOL of the field's largest magnitude. The active set is
    chosen by |y_i| against eps_act; given JAX's y both packages take the
    same rows by construction. How close the duals sit to the threshold
    matters end to end, where each package's own y decides: the golden
    records it (no dual within 10x of eps_act in either case; the corridor
    QP's closest, 1.4e-7, is 70x below)."""
    g = {k[len(case) + 2:]: v for k, v in vjp_golden.items() if k.startswith(f"{case}__")}
    assert int(g["eps_near_rows"]) == 0
    t = lambda k: torch.as_tensor(g[k])[None]
    qp = QPData(*(t(k) for k in QP_FIELDS))
    cfg = ADMMConfig(eps_act=float(g["eps_act"]), polish_delta=float(g["polish_delta"]))
    dqp = _solve_bwd_impl(cfg, qp, t("x"), t("y"), t("g"))
    for k in QP_FIELDS:
        err = _rel_err(getattr(dqp, k)[0].numpy(), g[f"d{k}"])
        assert err <= VJP_RTOL, (k, err)
    # only the soft rows that are active carry a soft cotangent
    assert np.all(g["dsoft"][g["soft"] == 0.0] == 0.0)


def test_solve_qp_backward_is_the_implicit_adjoint(vjp_golden):
    """Through the autograd function: the cotangents that reach the QP's
    fields from a cotangent of x are _solve_bwd_impl's at the port's own
    solution, the warm start and the elimination basis receive none, and y
    carries no gradient."""
    case = "corridor"
    g = {k[len(case) + 2:]: v for k, v in vjp_golden.items() if k.startswith(f"{case}__")}
    p = _corridor_planner()
    cfg = tpan._admm_with_elim(p.spec)
    qp = QPData(*(torch.as_tensor(g[k])[None].requires_grad_(True) for k in QP_FIELDS))
    n, m = qp.P_diag.shape[1], qp.l.shape[1]
    x0 = torch.zeros((1, n), requires_grad=True)
    y0 = torch.zeros((1, m), requires_grad=True)
    Z = torch.as_tensor(g["Z"])[None].requires_grad_(True)
    xp = torch.as_tensor(g["xp"])[None]
    sol = solve_qp(qp, cfg, x0, y0, (Z, xp))
    assert not sol.y.requires_grad and not sol.z.requires_grad
    gx = torch.as_tensor(g["g"])[None]
    grads = torch.autograd.grad(sol.x, [*qp, x0, y0, Z], gx, allow_unused=True)
    want = _solve_bwd_impl(cfg, QPData(*(f.detach() for f in qp)), sol.x.detach(),
                           sol.y.detach(), gx)
    for k, got, ref in zip(QP_FIELDS, grads, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0, msg=k)
    assert torch.equal(grads[6], torch.zeros_like(x0)) and torch.equal(grads[7],
                                                                       torch.zeros_like(y0))
    assert grads[8] is None


# -- the differentiated step -------------------------------------------------------

@pytest.mark.parametrize("case", LON_STEP_CASES)
def test_step_loss_and_grad_matches_jax(step_golden, case):
    """Loss and grads of every lon_step case within GRAD_RTOL of JAX's:
    each field relative to the largest magnitude of the whole gradient
    (a field that the loss does not reach is zero in both)."""
    g = step_golden
    run, adjust = _step_case(g, case)
    loss, grads, out = run(adjust)
    assert loss.shape == (1,) and not loss.requires_grad
    assert not out.opt_u.requires_grad
    assert _rel_err(loss.numpy()[0], g[f"{case}__loss"]) <= GRAD_RTOL
    ref = {f: np.asarray(g[f"{case}__grad_{f}"], np.float64) for f in FIELDS}
    scale = max(float(np.abs(v).max()) for v in ref.values())
    assert scale > 0
    for f in FIELDS:
        got = getattr(grads, f).numpy()
        assert got.shape == ref[f].shape, f
        err = float(np.abs(got - ref[f]).max()) / scale
        assert err <= GRAD_RTOL, (f, got, ref[f])


@pytest.mark.parametrize("case", ["lon_scalar_it1", "corridor"])
def test_fused_path_gradient_matches_jax(step_golden, case):
    """The main path's selection (the kernel route, fused point flow): slots
    in exact-distance order instead of re-sorted by the learned distance,
    the same points picked, the same gradient within GRAD_RTOL.

    At lon_scalar_it2 the fused path also picks the same points in every
    frame of both iterations, but its slot order (the QP's row order) moves
    the second solve by 2.7e-3 in opt_u and q_s's gradient by 1.1e-3 of the
    largest: the polish's tolerance-driven active set flips on float32
    rounding there, as ROADMAP.md's standing findings record for the
    forward. The materialized path, whose row order is JAX's, holds that
    case to GRAD_RTOL (test_step_loss_and_grad_matches_jax)."""
    g = step_golden
    run, adjust = _step_case(g, case, dune_kernel=None)
    loss, grads, _ = run(adjust)
    assert _rel_err(loss.numpy()[0], g[f"{case}__loss"]) <= GRAD_RTOL
    scale = max(float(np.abs(g[f"{case}__grad_{f}"]).max()) for f in FIELDS)
    for f in FIELDS:
        err = float(np.abs(getattr(grads, f).numpy() - g[f"{case}__grad_{f}"]).max()) / scale
        assert err <= GRAD_RTOL, f


def test_gradient_reaches_the_second_iteration_through_the_first(step_golden, monkeypatch):
    """At iter_num=2 the second QP is assembled at the first one's
    trajectory: its dynamics block A_dyn (written into A by index) requires
    grad and receives a nonzero gradient from the loss."""
    run, adjust = _step_case(step_golden, "lon_scalar_it2")
    seen = []
    build = tpan.build_qp

    def spy(spec, adj, nom_s, nom_u, ref_s, ref_us, A_dyn, *rest):
        seen.append(A_dyn)
        return build(spec, adj, nom_s, nom_u, ref_s, ref_us, A_dyn, *rest)

    monkeypatch.setattr(tpan, "build_qp", spy)
    spec, enc, verts, G, h = _lon_setup(step_golden, "lon_scalar_it2")
    spec = dataclasses.replace(spec, dune_kernel=False)
    inputs, state = _lon_inputs(step_golden, "lon_scalar_it2__")
    adj = AdjustParams(*(t.clone().requires_grad_(True) for t in adjust))
    out = tpan.pan_forward(spec, enc, verts, G, h, adj, *inputs, state)
    assert len(seen) == 2 and not seen[0].requires_grad and seen[1].requires_grad
    loss = distance_loss(out.opt_d, out.min_distance, 10.0).sum()
    (d_dyn,) = torch.autograd.grad(loss, [seen[1]])
    assert float(d_dyn.abs().max()) > 0


def test_batch_gives_per_scenario_losses(step_golden):
    """Two scenarios in one batch: each loss is that scenario's alone, and
    the grads are the sum of the two single-scenario grads."""
    spec, enc, verts, G, h = _lon_setup(step_golden, "lon_scalar_it1")
    spec = dataclasses.replace(spec, dune_kernel=False)
    inputs, state = _lon_inputs(step_golden, "lon_scalar_it1__")
    adjust = _adjust(step_golden, "lon_scalar_it1__")
    shifted = [inputs[0].clone(), *inputs[1:]]
    shifted[4] = inputs[4] + torch.tensor([0.3, -0.2])[None, :, None]
    runs = [step_loss_and_grad(spec, enc, verts, G, h, adjust, *inp, state,
                               collision_threshold=10.0) for inp in (inputs, shifted)]
    cat = lambda xs: torch.cat(xs, 0)
    both = step_loss_and_grad(spec, enc, verts, G, h, adjust,
                              *(cat([a, b]) for a, b in zip(inputs, shifted)),
                              PANState(*(cat([s, s]) for s in state)), collision_threshold=10.0)
    torch.testing.assert_close(both[0], cat([r[0] for r in runs]), rtol=1e-5, atol=1e-4)
    for f in FIELDS:
        torch.testing.assert_close(getattr(both[1], f),
                                   getattr(runs[0][1], f) + getattr(runs[1][1], f),
                                   rtol=1e-4, atol=1e-4)


def test_eta_gradient_matches_its_finite_difference(step_golden):
    """The port's own central difference in eta (tests/test_lon.py's eps
    and bounds) beside its gradient, and beside JAX's recorded difference."""
    run, adjust = _step_case(step_golden, "lon_scalar_it1")
    _, grads, _ = run(adjust)
    at = lambda d: float(run(adjust._replace(eta=adjust.eta + d))[0])
    fd = (at(LON_FD_EPS) - at(-LON_FD_EPS)) / (2 * LON_FD_EPS)
    g = float(grads.eta)
    assert abs(fd) > 1e-6
    assert np.sign(fd) == np.sign(g)
    np.testing.assert_allclose(g, fd, rtol=0.3, atol=0.05)
    np.testing.assert_allclose(fd, float(step_golden["lon_scalar_it1__fd_eta"]), rtol=0.05)


# -- the tuning loop ---------------------------------------------------------------

def test_lon_ticks_match_the_jax_episode():
    """Each of the 8 recorded ticks of JAX's LON_corridor.run_episode, given
    JAX's inputs, carried state and weights: loss and grads within
    GRAD_RTOL, and the weights after the port's tuner (its moments carried
    over the port's own grads) within GRAD_RTOL of JAX's."""
    g = _load("lon_ticks_corridor_diff")
    p = _corridor_planner()
    spec = dataclasses.replace(p.spec, dune_kernel=False)
    tuner = LONTuner(_adjust(g, "", 0), lr=float(g["lr"]))
    for i in range(int(g["ticks"])):
        inputs, state = _lon_inputs(g, "", i)
        adjust = _adjust(g, "", i)
        loss, grads, _ = step_loss_and_grad(spec, p.encoder, p.vertices, p.G, p.h, adjust,
                                            *inputs, state,
                                            collision_threshold=float(g["threshold"]))
        assert _rel_err(loss.numpy()[0], g["loss"][i]) <= GRAD_RTOL, i
        scale = max(float(np.abs(g[f"grad_{f}"][i]).max()) for f in FIELDS)
        for f in FIELDS:
            err = float(np.abs(getattr(grads, f).numpy() - g[f"grad_{f}"][i]).max()) / scale
            assert err <= GRAD_RTOL, (i, f, err)
        new = tuner.update(adjust, grads)
        for f in FIELDS:
            assert _rel_err(getattr(new, f).numpy(), g[f"adjust_after_{f}"][i]) <= GRAD_RTOL, (
                i, f)


@pytest.mark.parametrize("lr", [5e-3, 0.5])
def test_tuner_matches_optax(lr):
    """Ten fixed gradient steps, from a numpy seed, through the port's
    LONTuner and the JAX package's (optax): the trained fields agree to
    float32 rounding, the frozen fields come back untouched; at lr 0.5 the
    clamps (d_max >= 1e-3, eta >= 0) engage.

    Both sit a few 1e-6 of a step from float64 Adam (optax forms its bias
    corrections and moments in float32, and the moments cancel where the
    gradient changes sign); the two differ by the rounding of the weight
    (rtol 2e-6) plus that of the accumulated steps (2e-6 of lr): at lr 0.5
    the largest difference is 7.5e-7, where XLA's fused multiply-adds round
    once and the port's separate products twice."""
    rng = np.random.default_rng(3)
    start = dict(q_s=np.float32(1.0), p_u=np.float32(1.0), eta=np.float32(0.6),
                 d_max=np.float32(0.5), d_min=np.float32(0.1))
    port = AdjustParams(**{k: torch.tensor(v) for k, v in start.items()})
    ref = JaxAdjustParams(**{k: jnp.asarray(v) for k, v in start.items()})
    fields = ("p_u", "eta", "d_max")
    t_tuner, j_tuner = LONTuner(port, lr=lr, train_fields=fields), JaxLONTuner(
        ref, lr=lr, train_fields=fields)
    clamped = set()
    for _ in range(10):
        grad = {k: np.float32(rng.normal() * 10 ** rng.uniform(-2, 2)) for k in start}
        grad["eta"], grad["d_max"] = abs(grad["eta"]) + 1, abs(grad["d_max"]) + 1
        port = t_tuner.update(port, AdjustParams(**{k: torch.tensor(v) for k, v in grad.items()}))
        ref = j_tuner.update(ref, JaxAdjustParams(**{k: jnp.asarray(v) for k, v in grad.items()}))
        for f in FIELDS:
            np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                       rtol=2e-6, atol=2e-6 * lr, err_msg=f)
        clamped |= {f for f, lo in (("eta", 0.0), ("d_max", 1e-3)) if float(getattr(port, f)) == np.float32(lo)}
    for f in ("q_s", "d_min"):
        assert float(getattr(port, f)) == float(start[f])
    assert clamped == ({"eta", "d_max"} if lr > 0.1 else set())


def test_tuning_lowers_a_fixed_step_loss(step_golden):
    """Gradient steps on the weights lower a fixed step's loss
    (tests/test_lon.py:test_tuning_descends_fixed_step_loss)."""
    run, adjust = _step_case(step_golden, "lon_scalar_it1")
    tuner = LONTuner(adjust, lr=2e-2)
    losses = []
    for _ in range(12):
        loss, grads, _ = run(adjust)
        losses.append(float(loss))
        adjust = tuner.update(adjust, grads)
    assert losses[-1] < losses[0], losses


# -- the loss and its contract -----------------------------------------------------

def test_distance_loss_branches():
    d = torch.tensor([0.5, 0.5, 0.5])
    assert float(distance_loss(d, torch.tensor(0.1), 0.3)) == 10 * (50 - 1.5)
    assert float(distance_loss(d, torch.tensor(1.0), 0.3, stuck=True)) == 10 * (50 + 1.5)
    assert float(distance_loss(d, torch.tensor(1.0), 0.3)) == 0.0
    # batched: one loss per scenario, stuck per scenario
    db = torch.stack([d, 2 * d, d])
    out = distance_loss(db, torch.tensor([0.1, 1.0, 1.0]), 0.3,
                        stuck=torch.tensor([False, True, False]))
    torch.testing.assert_close(out, torch.tensor([485.0, 530.0, 0.0]))


def test_loss_fn_arity_contract():
    assert _loss_fn_arity(lambda out: 0) == 1
    assert _loss_fn_arity(lambda out, ref_s, ref_us, stuck: 0) == 4
    for bad in (lambda out, ref_s: 0, lambda a, b, c: 0, lambda: 0):
        with pytest.raises(ValueError, match="exactly 1 argument"):
            _loss_fn_arity(bad)
    for bad in (lambda *args: 0, lambda out, **kw: 0):
        with pytest.raises(ValueError, match=r"\*args"):
            _loss_fn_arity(bad)
    with pytest.raises(TypeError, match="could not be inspected"):
        _loss_fn_arity(max)
    # step_loss_and_grad checks the contract before it runs the step
    with pytest.raises(ValueError, match="exactly 1 argument"):
        step_loss_and_grad(*[None] * 14, loss_fn=lambda out, ref_s: 0)


def test_lon_runner_tunes_without_jax(tmp_path):
    """examples/LON/LON_corridor_torch.py, 3 tuning ticks on the CPU, in a
    process whose import of jax fails: the weights move."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'neupan_tpu', 'optax'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {os.path.join(ROOT, 'examples', 'LON')!r})
import LON_corridor_torch as L
L.MAX_STEPS = 3
L.COLLISION_THRESHOLD = 10.0
planner = L.make_planner('corridor/diff', device='cpu')
before = float(planner.adjust.eta)
tuner = L.LONTuner(planner.adjust, lr=5e-3)
losses, dists = L.run_episode(planner, tuner, L.scenario_dir('corridor/diff'))
assert len(losses) == 3 and all(l > 0 for l in losses), losses
assert float(planner.adjust.eta) != before
print('tuned', losses)
"""
    res = subprocess.run([sys.executable, "-I", "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "tuned" in res.stdout
