"""Port vs JAX: robot geometry, exact rollout and closed-form linearization."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neupan_tpu.robot import Robot as JRobot
from neupan_torch.robot import Robot
from neupan_torch.utils import gen_inequal_from_vertex, wrap_to_pi

ROBOTS = {
    "diff": dict(kinematics="diff", max_speed=[8, 1], max_acce=[8, 3], length=1.6, width=2.0),
    "acker": dict(kinematics="acker", max_speed=[8, 0.8], max_acce=[8, 1], length=4.6,
                  width=1.6, wheelbase=3.0),
    "omni": dict(kinematics="omni", max_speed=[3, 3.14], max_acce=[1, 1],
                 vertices=[[-0.4, -0.3], [0.4, -0.3], [0.5, 0.2], [-0.3, 0.4]]),
}


def _pair(kin, T=6):
    return (Robot.create(receding=T, step_time=0.1, **ROBOTS[kin]),
            JRobot.create(receding=T, step_time=0.1, **ROBOTS[kin]))


def _controls(kin, rng, B, T):
    u = np.zeros((B, 2, T))
    u[:, 0] = rng.uniform(-1.0, 3.0, (B, T))
    u[:, 1] = rng.uniform(-0.6, 0.6, (B, T)) if kin != "omni" else rng.uniform(-3, 3, (B, T))
    return u.astype(np.float32)


@pytest.mark.parametrize("kin", sorted(ROBOTS))
def test_geometry_matches_jax(kin):
    tr, jr = _pair(kin)
    for name in ("vertices", "G", "h", "speed_bound", "acce_bound"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name))
    verts, G, h = tr.tensors("cpu")
    np.testing.assert_array_equal(verts.numpy(), jr.vertices.astype(np.float32))
    np.testing.assert_array_equal(G.numpy(), jr.G.astype(np.float32))
    np.testing.assert_array_equal(h.numpy(), jr.h.astype(np.float32))


@pytest.mark.parametrize("kin", sorted(ROBOTS))
def test_rollout_and_linearize_match_jax(kin):
    T, B = 6, 3
    tr, jr = _pair(kin, T)
    rng = np.random.default_rng(1)
    s0 = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    u = _controls(kin, rng, B, T)
    s_t = tr.rollout(torch.from_numpy(s0), torch.from_numpy(u)).numpy()
    A_t, B_t, C_t = (a.numpy() for a in tr.linearize(torch.from_numpy(s_t), torch.from_numpy(u)))
    for b in range(B):
        s_j = np.asarray(jr.rollout(jnp.asarray(s0[b]), jnp.asarray(u[b])))
        np.testing.assert_allclose(s_t[b], s_j, atol=1e-6)
        A_j, B_j, C_j = jr.linearize(jnp.asarray(s_t[b]), jnp.asarray(u[b]))
        np.testing.assert_allclose(A_t[b], np.asarray(A_j), atol=1e-6)
        np.testing.assert_allclose(B_t[b], np.asarray(B_j), atol=1e-6)
        np.testing.assert_allclose(C_t[b], np.asarray(C_j), atol=1e-6)


@pytest.mark.parametrize("kin", sorted(ROBOTS))
def test_linearize_is_jacobian_of_step(kin):
    """A_t, B_t are d step / d (s, u), and C_t makes the linearization exact
    at the nominal point (the check tests/test_robot.py makes in JAX)."""
    T = 4
    tr, _ = _pair(kin, T)
    rng = np.random.default_rng(2)
    u = torch.from_numpy(_controls(kin, rng, 1, T)[0]).double()
    s = tr.rollout(torch.zeros(3, dtype=torch.float64), u)
    A, Bm, C = tr.linearize(s, u)
    for t in range(T):
        Js, Ju = torch.func.jacrev(tr.step, argnums=(0, 1))(s[:, t], u[:, t])
        torch.testing.assert_close(A[t], Js)
        torch.testing.assert_close(Bm[t], Ju)
        lin = A[t] @ s[:, t] + Bm[t] @ u[:, t] + C[t, :, 0]
        torch.testing.assert_close(lin, tr.step(s[:, t], u[:, t]))


def test_acker_steering_clamp_and_validation():
    r = Robot.create(kinematics="acker", length=4.6, width=1.6, wheelbase=3.0,
                     max_speed=[8, 2.0])
    assert r.max_speed == (8.0, 1.57)
    with pytest.raises(ValueError):
        Robot.create(kinematics="tank", length=1.0, width=1.0)
    with pytest.raises(ValueError):
        Robot.create(kinematics="diff")


def test_utils_match_numpy_reference():
    from neupan_tpu.utils import gen_inequal_from_vertex as j_gen
    from neupan_tpu.utils import wrap_to_pi as j_wrap

    cw = np.array([[0.0, 0.0, 1.0, 1.0], [0.0, 1.0, 1.0, 0.0]])
    for verts in (cw, cw[:, ::-1]):
        for a, b in zip(gen_inequal_from_vertex(verts), j_gen(verts)):
            np.testing.assert_array_equal(a, b)
    ang = np.linspace(-10, 10, 41)
    np.testing.assert_array_equal(wrap_to_pi(ang), j_wrap(ang))
    with pytest.raises(ValueError):
        gen_inequal_from_vertex(np.array([[0, 2, 1, 2], [0, 0, 1, 2.0]]))
