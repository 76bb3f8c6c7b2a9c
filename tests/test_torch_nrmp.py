"""Port vs JAX: NRMP QP assembly, condensation basis and DUNE coefficients."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neupan_tpu.ops import nrmp as jn
from neupan_torch.ops import nrmp as tn

T, K, B, E = 10, 10, 2, 4


def _specs(kin):
    kw = dict(T=T, K=K, kinematics=kin, speed_bound=(8.0, 1.0), acce_bound=(0.8, 0.3))
    return tn.NRMPSpec(**kw), jn.NRMPSpec(**kw)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=-1.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    return dict(nom_s=f(B, 3, T + 1, lo=-2, hi=2), nom_u=f(B, 2, T), ref_s=f(B, 3, T + 1),
                ref_us=f(B, T, lo=2, hi=4), A=f(B, T, 3, 3), Bm=f(B, T, 3, 2),
                C=f(B, T, 3, 1), fa=f(B, T, K, 2), fb=f(B, T, K))


def _adjust(lib):
    t = (lambda v: torch.tensor(v)) if lib is tn else (lambda v: jnp.asarray(v, jnp.float32))
    return lib.AdjustParams(q_s=t(1.5), p_u=t(0.7), eta=t(10.0), d_max=t(1.0), d_min=t(0.1))


def test_spec_layout_at_the_flagship_shape():
    spec, jspec = _specs("diff")
    assert (spec.n, spec.m) == (63, 181)
    for name in ("n_s", "n_u", "off_u", "off_d", "r_init", "r_acc", "r_spd", "r_d", "r_obs"):
        assert getattr(spec, name) == getattr(jspec, name)
    np.testing.assert_array_equal(tn._static_template(spec).numpy(), jn._static_template(jspec))


@pytest.mark.parametrize("kin", ["diff", "omni"])
def test_build_qp_and_condensation_match_jax(kin):
    spec, jspec = _specs(kin)
    x = _inputs()
    tt = {k: torch.from_numpy(v) for k, v in x.items()}
    qp = tn.build_qp(spec, _adjust(tn), tt["nom_s"], tt["nom_u"], tt["ref_s"], tt["ref_us"],
                     tt["A"], tt["Bm"], tt["C"], tt["fa"], tt["fb"])
    Z, xp = tn.condensation(spec, tt["A"], tt["Bm"], tt["C"], tt["nom_s"][:, :, 0])
    for b in range(B):
        j = {k: jnp.asarray(v[b]) for k, v in x.items()}
        jqp = jn.build_qp(jspec, _adjust(jn), j["nom_s"], j["nom_u"], j["ref_s"], j["ref_us"],
                          j["A"], j["Bm"], j["C"], j["fa"], j["fb"])
        for name in ("P_diag", "q", "A", "l", "u", "soft"):
            np.testing.assert_allclose(getattr(qp, name)[b].numpy(),
                                       np.asarray(getattr(jqp, name)), rtol=0, atol=1e-6,
                                       err_msg=name)
        jZ, jxp = jn.condensation(jspec, j["A"], j["Bm"], j["C"], j["nom_s"][:, 0])
        np.testing.assert_allclose(Z[b].numpy(), np.asarray(jZ), rtol=0, atol=1e-6)
        np.testing.assert_allclose(xp[b].numpy(), np.asarray(jxp), rtol=0, atol=1e-6)
    # every feasible x = Z w + xp satisfies the equality rows
    w = torch.randn(B, Z.shape[-1], generator=torch.Generator().manual_seed(0))
    xf = torch.bmm(Z, w[:, :, None])[:, :, 0] + xp
    Ax = torch.bmm(qp.A[:, :spec.r_acc], xf[:, :, None])[:, :, 0]
    torch.testing.assert_close(Ax, qp.l[:, :spec.r_acc], rtol=0, atol=2e-5)


def test_unpack_and_coefficients_from_dune_match_jax():
    spec, jspec = _specs("diff")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, spec.n)).astype(np.float32)
    mu = rng.uniform(0, 1, (B, T + 1, E, K)).astype(np.float32)
    lam = rng.normal(size=(B, T + 1, 2, K)).astype(np.float32)
    pts = rng.normal(size=(B, T + 1, 2, K)).astype(np.float32)
    valid = np.arange(K)[None, None, :] < rng.integers(1, K, (B, T + 1, 1))
    h = rng.uniform(0.5, 1.0, (E, 1)).astype(np.float32)
    has_points = np.array([True, False])
    s, u, d = tn.unpack_solution(spec, torch.from_numpy(x))
    fa, fb = tn.coefficients_from_dune(spec, *(torch.from_numpy(a) for a in
                                                (mu, lam, pts, valid, h, has_points)))
    for b in range(B):
        for mine, ref in zip((s, u, d), jn.unpack_solution(jspec, jnp.asarray(x[b]))):
            np.testing.assert_array_equal(mine[b].numpy(), np.asarray(ref))
        jfa, jfb = jn.coefficients_from_dune(jspec, jnp.asarray(mu[b]), jnp.asarray(lam[b]),
                                             jnp.asarray(pts[b]), jnp.asarray(valid[b]),
                                             jnp.asarray(h), jnp.asarray(has_points[b]))
        np.testing.assert_allclose(fa[b].numpy(), np.asarray(jfa), rtol=0, atol=1e-6)
        np.testing.assert_allclose(fb[b].numpy(), np.asarray(jfb), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kin", ["diff", "acker"])
def test_no_obstacle_problem_matches_jax(kin):
    """K=0: no d variables, no obstacle rows, no soft vector; the layout,
    the QP, the condensation basis and the unpacking against the JAX package."""
    kw = dict(T=T, K=0, kinematics=kin, speed_bound=(8.0, 1.0), acce_bound=(0.8, 0.3))
    spec, jspec = tn.NRMPSpec(**kw), jn.NRMPSpec(**kw)
    assert spec.no_obs and (spec.n, spec.m) == (jspec.n, jspec.m) == (5 * T + 3, 7 * T + 1)
    np.testing.assert_array_equal(tn._static_template(spec).numpy(), jn._static_template(jspec))
    x = _inputs(1)
    tt = {k: torch.from_numpy(v) for k, v in x.items()}
    qp = tn.build_qp(spec, _adjust(tn), tt["nom_s"], tt["nom_u"], tt["ref_s"], tt["ref_us"],
                     tt["A"], tt["Bm"], tt["C"])
    Z, xp = tn.condensation(spec, tt["A"], tt["Bm"], tt["C"], tt["nom_s"][:, :, 0])
    assert qp.soft is None and Z.shape == (B, spec.n, 2 * T)
    sol = np.random.default_rng(4).normal(size=(B, spec.n)).astype(np.float32)
    s, u, d = tn.unpack_solution(spec, torch.from_numpy(sol))
    assert d is None
    for b in range(B):
        j = {k: jnp.asarray(v[b]) for k, v in x.items()}
        jqp = jn.build_qp(jspec, _adjust(jn), j["nom_s"], j["nom_u"], j["ref_s"], j["ref_us"],
                          j["A"], j["Bm"], j["C"])
        assert jqp.soft is None
        for name in ("P_diag", "q", "A", "l", "u"):
            np.testing.assert_allclose(getattr(qp, name)[b].numpy(),
                                       np.asarray(getattr(jqp, name)), rtol=0, atol=1e-6,
                                       err_msg=name)
        jZ, jxp = jn.condensation(jspec, j["A"], j["Bm"], j["C"], j["nom_s"][:, 0])
        np.testing.assert_allclose(Z[b].numpy(), np.asarray(jZ), rtol=0, atol=1e-6)
        np.testing.assert_allclose(xp[b].numpy(), np.asarray(jxp), rtol=0, atol=1e-6)
        js, ju, jd = jn.unpack_solution(jspec, jnp.asarray(sol[b]))
        assert jd is None
        np.testing.assert_array_equal(s[b].numpy(), np.asarray(js))
        np.testing.assert_array_equal(u[b].numpy(), np.asarray(ju))
