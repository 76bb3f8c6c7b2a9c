"""Port vs JAX: the block-tridiagonal factorization (ops/banded.py) and the
full-space ADMM on it, against tests/golden/torch/qp_banded_t30.npz.

The golden (scripts/make_torch_goldens.py) holds tests/test_banded.py's
real NRMP normal matrices at T = 4, 6, 10, 30 with JAX's raw and refined
btd inverses and its dense inverse, and the T=30 end-to-end instance with
JAX's banded and dense full-space solves. The port builds the same
matrices with its own nrmp layer (``_normal_matrix``) and is held to them.
Bounds: an inverse to 1e-4 of the matrix's scale in ||M X - I||_inf, as
the JAX test holds JAX; T=30 solutions to 1.5e-3 of JAX's.
"""

import os

import numpy as np
import pytest
import torch

from neupan_torch.ops import banded
from neupan_torch.ops import qp as tqp
from neupan_torch.ops.kernels.sweep import spd_inverse_any
from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec, build_qp, unpack_solution
from neupan_torch.robot import Robot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch", "qp_banded_t30.npz")
FIELDS = ("P_diag", "q", "A", "l", "u", "soft")
T30_TOL = 1.5e-3


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def _normal_matrix(T, seed):
    """tests/test_banded.py:make_M through the port: a real NRMP normal
    matrix diag(P + sigma) + A' rho A at horizon T, (1, n, n)."""
    rng = np.random.default_rng(seed)
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    spec = NRMPSpec(T=T, K=5, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    adjust = AdjustParams(*(torch.tensor(v) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))
    nom_u = torch.tensor(rng.uniform(-0.5, 0.5, (1, 2, T)), dtype=torch.float32)
    nom_s = robot.rollout(torch.zeros(1, 3), nom_u)
    A_dyn, B_dyn, C_dyn = robot.linearize(nom_s, nom_u)
    fa = torch.tensor(rng.normal(size=(1, T, 5, 2)) * 0.3, dtype=torch.float32)
    fb = torch.tensor(rng.normal(size=(1, T, 5)) - 1.0, dtype=torch.float32)
    qp = build_qp(spec, adjust, nom_s, nom_u, nom_s, torch.ones(1, T), A_dyn, B_dyn, C_dyn,
                  fa, fb)
    cfg = tqp.ADMMConfig()
    rho = tqp._rho_vec(qp.l, qp.u, cfg)
    return (torch.diag_embed(qp.P_diag + cfg.sigma)
            + torch.bmm((qp.A * rho[:, :, None]).transpose(1, 2), qp.A))


def _resid(M, X):
    M, X = np.asarray(M, np.float64), np.asarray(X, np.float64)
    return np.abs(M @ X - np.eye(M.shape[-1])).max()


def test_nrmp_permutation_matches_jax():
    from neupan_tpu.ops import banded as jbanded

    for T in (1, 4, 10, 30):
        for no_obs in (False, True):
            np.testing.assert_array_equal(banded.nrmp_permutation(T, no_obs),
                                          jbanded.nrmp_permutation(T, no_obs))


@pytest.mark.parametrize("T", [4, 6, 10, 30])
def test_port_normal_matrix_matches_jax(golden, T):
    M = _normal_matrix(T, T)[0].numpy()
    np.testing.assert_allclose(M, golden[f"M{T}"], rtol=1e-5, atol=1e-5 * np.abs(M).max())


def test_nrmp_normal_matrix_is_block_tridiagonal():
    """Under the interleaved permutation M has zero blocks beyond +-1."""
    T, b = 6, 6
    M = _normal_matrix(T, 0)[0].numpy()
    perm = banded.nrmp_permutation(T)
    Mp = M[np.ix_(perm, perm)]
    nb = -(-Mp.shape[0] // b)
    for i in range(nb):
        for j in range(nb):
            if abs(i - j) > 1:
                assert np.abs(Mp[i * b:(i + 1) * b, j * b:(j + 1) * b]).max() == 0.0, (i, j)


def test_blocks_pad_the_last_block_with_the_identity():
    n, b = 15, 6
    Mp = torch.arange(n * n, dtype=torch.float32).reshape(1, n, n)
    D, E = banded._blocks_from_dense(Mp, b)
    assert D.shape == (1, 3, b, b) and E.shape == (1, 2, b, b)
    torch.testing.assert_close(D[0, 2, 3:, 3:], torch.eye(3))
    torch.testing.assert_close(D[0, 2, :3, :3], Mp[0, 12:, 12:])
    torch.testing.assert_close(E[0, 1, :3], Mp[0, 12:, 6:12])
    assert float(E[0, 1, 3:].abs().max()) == 0.0


@pytest.mark.parametrize("T", [4, 10, 30])
def test_btd_inverse_matches_jax_and_dense(golden, T):
    """Raw and refined btd inverses of JAX's matrix: each within 1e-4 of
    the matrix's scale in ||M X - I||_inf, within 10x of the dense inverse's
    residual, and within 1e-5 of JAX's (relative to its largest entry)."""
    M = torch.from_numpy(golden[f"M{T}"])[None]
    perm = banded.nrmp_permutation(T)
    scale = float(M.abs().max())
    X_raw = banded.btd_spd_inverse(M, perm, 6, refine=0)[0]
    X = banded.btd_spd_inverse(M, perm, 6)[0]
    r_dense = _resid(M[0], spd_inverse_any(M)[0])
    for ours, ref in ((X_raw, golden[f"X{T}_raw"]), (X, golden[f"X{T}"])):
        assert _resid(M[0], ours) / scale < 1e-4
        assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert _resid(M[0], X) < 10 * max(r_dense, 1e-6)
    assert _resid(M[0], golden[f"X{T}_dense"]) < 10 * max(r_dense, 1e-6)


def test_btd_solve_single_rhs():
    T = 5
    M = _normal_matrix(T, 2)
    n = M.shape[-1]
    rhs = torch.from_numpy(np.random.default_rng(0).normal(size=(1, n)).astype(np.float32))
    x = torch.bmm(banded.btd_spd_inverse(M, banded.nrmp_permutation(T), 6), rhs[:, :, None])
    resid = float((torch.bmm(M, x)[:, :, 0] - rhs).abs().max())
    assert resid / float(rhs.abs().max()) < 1e-2
    # btd_solve on the permuted, padded system directly, one right-hand side
    perm = torch.from_numpy(banded.nrmp_permutation(T).astype(np.int64))
    Mp = M[:, perm][:, :, perm]
    fac = banded.btd_cholesky(*banded._blocks_from_dense(Mp, 6))
    pad = fac.L_diag.shape[1] * 6 - n
    sol = banded.btd_solve(fac, torch.cat([rhs[:, perm], torch.zeros(1, pad)], dim=1))
    assert sol.shape == (1, n + pad)
    d = torch.bmm(Mp.double(), sol[:, :n, None].double())[:, :, 0] - rhs[:, perm].double()
    assert float(d.abs().max()) / float(Mp.abs().max()) < 1e-4


def _guard_pair():
    """Two 18x18 matrices kron(M3, I_6) with M3 = [[1,a,f],[a,1,a],[f,a,1]]:
    f=0.35 puts the residual operator of the truncated factorization past a
    spectral radius of 1 (unguarded sweeps take the residual 1.47 -> 3.3 ->
    17), f=0.05 keeps it inside, where the sweeps refine."""
    out = []
    for f in (0.35, 0.05):
        M3 = np.array([[1, 0.65, f], [0.65, 1, 0.65], [f, 0.65, 1]])
        assert np.linalg.eigvalsh(M3).min() > 0
        out.append(np.kron(M3, np.eye(6)))
    return np.stack(out)


def test_banded_hotelling_guard_decides_per_scenario():
    """One diverging matrix beside one that refines, in the same batch: the
    guard drops the sweeps for the first (never worse than the raw
    factorization) and keeps them for the second, each as a batch of one
    decides it."""
    M = _guard_pair()
    Mt = torch.from_numpy(M.astype(np.float32))
    perm = np.arange(18)
    X0 = banded.btd_spd_inverse(Mt, perm, 6, refine=0).numpy()
    X2 = banded.btd_spd_inverse(Mt, perm, 6, refine=2).numpy()
    eye = np.eye(18)
    r0 = [_resid(M[b], X0[b]) for b in range(2)]
    r2 = [_resid(M[b], X2[b]) for b in range(2)]
    # precondition: an unguarded sweep really diverges on the first matrix only
    sweep = lambda b: X0[b] + X0[b] @ (eye - M[b] @ X0[b])
    assert _resid(M[0], sweep(0)) > r0[0] and _resid(M[1], sweep(1)) < r0[1]
    assert np.isfinite(r2[0]) and r2[0] <= 1.05 * r0[0]
    assert r2[1] < 0.1 * r0[1]
    for b in range(2):
        alone = banded.btd_spd_inverse(Mt[b:b + 1], perm, 6, refine=2)[0].numpy()
        np.testing.assert_array_equal(alone, X2[b])


def test_banded_hotelling_guard_still_refines(golden):
    """On the genuinely block-tridiagonal stiff T=30 matrix the guard keeps
    the sweeps: the refined inverse is at dense accuracy and better than
    the raw one."""
    M = torch.from_numpy(golden["M30"])[None]
    perm = banded.nrmp_permutation(30)
    r0 = _resid(M[0], banded.btd_spd_inverse(M, perm, 6, refine=0)[0])
    r2 = _resid(M[0], banded.btd_spd_inverse(M, perm, 6, refine=2)[0])
    assert r2 / float(M.abs().max()) < 1e-4
    assert r2 < r0


def test_banded_inverse_end_to_end_qp(golden):
    """solve_qp with ADMMConfig(condense_admm=False, inverse="banded") on the
    T=30 instance: within 2e-3 of the dense full-space solve in u (the JAX
    test's bound), each within T30_TOL of JAX's x."""
    T = int(golden["T"])
    qp = tqp.QPData(*(torch.from_numpy(golden[f"qp_{k}"])[None] for k in FIELDS))
    perm = tuple(int(i) for i in banded.nrmp_permutation(T))
    cfg_b = tqp.ADMMConfig(condense_admm=False, inverse="banded", banded_perm=perm)
    cfg_d = tqp.ADMMConfig(condense_admm=False)
    sols = {"banded": tqp.solve_qp(qp, cfg_b), "dense": tqp.solve_qp(qp, cfg_d)}
    spec = NRMPSpec(T=T, K=5, kinematics="diff", speed_bound=(8.0, 1.0), acce_bound=(0.8, 0.3))
    u = {k: unpack_solution(spec, s.x)[1].numpy() for k, s in sols.items()}
    np.testing.assert_allclose(u["banded"], u["dense"], atol=2e-3)
    for name, sol in sols.items():
        np.testing.assert_allclose(sol.x[0].numpy(), golden[f"{name}_x"], atol=T30_TOL, rtol=0)
        assert float(sol.r_prim) < 2e-3


@pytest.mark.parametrize("name", ["t30_dense", "t30_banded"])
def test_fullspace_admm_at_t30_equals_jax_in_float64(golden, name):
    """The T=30 instance's full-space ADMM in float64, dense (Cholesky above
    n=96) and banded inverse, against JAX's in float64 (golden
    ``qp_fullspace_f64``) to 1e-9: the float32 runs part by rounding alone.
    Every route here takes float64: the (183, 541) iterations take the plain
    ADMM by admission."""
    with np.load(os.path.join(os.path.dirname(GOLDEN), "qp_fullspace_f64.npz")) as g:
        want = {k: g[k] for k in g.files}
    T = int(golden["T"])
    qp = tqp.QPData(*(torch.from_numpy(golden[f"qp_{k}"]).double()[None] for k in FIELDS))
    cfg = tqp.ADMMConfig()
    if name == "t30_banded":
        cfg = tqp.ADMMConfig(inverse="banded",
                             banded_perm=tuple(int(i) for i in banded.nrmp_permutation(T)))
    B, m, n = qp.A.shape
    x, y, *_ = tqp._admm_core(qp, cfg, torch.zeros(B, n, dtype=torch.float64),
                              torch.zeros(B, m, dtype=torch.float64))
    np.testing.assert_allclose(x[0].numpy(), want[f"{name}_x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(y[0].numpy(), want[f"{name}_y"], rtol=1e-9, atol=1e-8)
