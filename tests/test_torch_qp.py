"""Port vs JAX: the batched condensed QP solve, against the JAX goldens.

The goldens (tests/golden/torch/qp_solve.npz, written by
scripts/make_torch_goldens.py) hold three realistic contact QPs at the
flagship shapes, their warm starts and the JAX solution. Compiling the JAX
solver takes minutes on a CPU, so the test solves with the port only; the
QP data is re-derived from its seed through the JAX package to show the
golden is current.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neupan_tpu.ops import qp as jqp
from neupan_torch.ops import qp as tqp
from neupan_torch.ops.kernels import sweep as SW
from neupan_torch.ops.nrmp import NRMPSpec
from neupan_torch.ops.pan import PANSpec, _admm_with_elim
from neupan_torch.robot import Robot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch", "qp_solve.npz")
FIELDS = ("P_diag", "q", "A", "l", "u", "soft")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def _cfg(g):
    robot = Robot.create(receding=int(g["T"]), step_time=0.1, kinematics="diff",
                         max_speed=[8, 1], max_acce=[8, 3], length=1.6, width=2.0)
    nrmp = NRMPSpec(T=int(g["T"]), K=int(g["K"]), kinematics="diff",
                    speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    return _admm_with_elim(PANSpec(robot=robot, nrmp=nrmp))


def _qp(g):
    return tqp.QPData(*(torch.from_numpy(g[k]) for k in FIELDS))


def test_golden_inputs_rebuild_from_their_seed(golden):
    from tests.test_qp_condensed import make_flagship_instance

    seed = int(golden["seeds"][0])
    _, qp, (Z, xp), _ = make_flagship_instance(seed, contact=True)
    for name in FIELDS:
        np.testing.assert_allclose(golden[name][0], np.asarray(getattr(qp, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(golden["Z"][0], np.asarray(Z), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(golden["xp"][0], np.asarray(xp), rtol=1e-6, atol=1e-6)


def test_solve_matches_jax_golden(golden):
    """All three instances in one batch: x within 5e-4 of the JAX solution
    (the cross-backend bound of bench.py), and the solution feasible."""
    cfg = _cfg(golden)
    qp = _qp(golden)
    sol = tqp.solve_qp(qp, cfg, torch.from_numpy(golden["x0"]), torch.from_numpy(golden["y0"]),
                       (torch.from_numpy(golden["Z"]), torch.from_numpy(golden["xp"])))
    dx = np.abs(sol.x.numpy() - golden["x"]).max(axis=1)
    assert (dx <= 5e-4).all(), dx
    assert (sol.r_prim.numpy() < 2e-3).all(), sol.r_prim


def test_kkt_error_and_bound_snap_match_jax(golden):
    qp = _qp(golden)
    x, y = torch.from_numpy(golden["x"]), torch.from_numpy(golden["y"])
    l, u = tqp._clip_bounds(qp.l, qp.u)
    e = tqp.kkt_error(qp.P_diag, qp.q, qp.A, l, u, x, y, qp.soft).numpy()
    x_pert = x + 0.05 * torch.sin(torch.arange(x.shape[1], dtype=x.dtype))
    snap = tqp._snap_variable_bounds(qp, x_pert).numpy()
    for b in range(x.shape[0]):
        jq = jqp.QPData(*(jnp.asarray(golden[k][b]) for k in FIELDS))
        jl, ju = jqp._clip_bounds(jq.l, jq.u)
        with jax.default_matmul_precision("highest"):
            je = jqp.kkt_error(jq.P_diag, jq.q, jq.A, jl, ju, jnp.asarray(golden["x"][b]),
                               jnp.asarray(golden["y"][b]), jq.soft)
        assert e[b] == pytest.approx(float(je), rel=1e-4, abs=1e-6)
        np.testing.assert_array_equal(
            snap[b], np.asarray(jqp._snap_variable_bounds(jq, jnp.asarray(x_pert[b].numpy()))))


def test_spd_inverse_on_stiff_nrmp_normal_matrices(golden):
    """The sweep inverse (plain version on the CPU) on the real condensed,
    Ruiz-scaled normal matrices the first ADMM phase inverts."""
    cfg = _cfg(golden)
    qp = _qp(golden)
    Z, xp = torch.from_numpy(golden["Z"]), torch.from_numpy(golden["xp"])
    n_eq = cfg.elim_n_eq
    A_r = qp.A[:, n_eq:]
    Axp = torch.bmm(A_r, xp[:, :, None])[:, :, 0]
    Hr = torch.bmm(Z.transpose(1, 2), Z * qp.P_diag[:, :, None])
    qr = torch.bmm(Z.transpose(1, 2), (qp.q + qp.P_diag * xp)[:, :, None])[:, :, 0]
    Hs, _, As, ls, us, _, _, _, _ = tqp._ruiz_equilibrate_dense(
        Hr, qr, torch.bmm(A_r, Z), qp.l[:, n_eq:] - Axp, qp.u[:, n_eq:] - Axp,
        qp.soft[:, n_eq:], cfg.ruiz_iters)
    k = Hs.shape[-1]
    M = Hs + cfg.sigma * torch.eye(k) + torch.bmm(As.transpose(1, 2), As)
    X = SW.spd_inverse_any(M)
    resid = np.abs(np.einsum("bij,bjk->bik", M.double().numpy(), X.double().numpy())
                   - np.eye(k)).max()
    assert resid < 5e-4, resid
    # above n=96 the Cholesky route, where the JAX package's _spd_inverse takes it
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(2, 99, 99))
    M99 = (Q @ Q.transpose(0, 2, 1) / 99 + np.eye(99) * rng.uniform(0.5, 1e3, 99)).astype(np.float32)
    X99 = SW.spd_inverse_any(torch.from_numpy(M99)).numpy()
    with jax.default_matmul_precision("highest"):
        Xj = np.stack([np.asarray(jqp._spd_inverse(jnp.asarray(m), jqp.ADMMConfig())) for m in M99])
    assert np.abs(X99 - Xj).max() <= 1e-5 * np.abs(Xj).max()
