"""Port vs JAX: the DUNE forward, fused and on a materialized point flow."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neupan_tpu.ops.pallas.mlp as MLPM
import neupan_tpu.ops.pallas.select as SEL
from neupan_tpu.models import obs_point_net as jnet
from neupan_tpu.ops import dune as jdune
from neupan_tpu.robot import Robot as JRobot
from neupan_torch.models import load_checkpoint
from neupan_torch.ops.dune import (dune_forward, dune_forward_flow, frame_transforms,
                                   generate_point_flow, signed_polygon_distance)
from neupan_torch.robot import Robot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")
ROBOT = dict(kinematics="diff", max_speed=[8, 1], max_acce=[8, 3], length=1.6, width=2.0)


@pytest.fixture
def interpret_select():
    """The JAX fused path with its Pallas select kernel in interpret mode."""
    orig = SEL.select_topk_flow_pallas
    SEL.select_topk_flow_pallas = functools.partial(orig, interpret=True)
    yield
    SEL.select_topk_flow_pallas = orig


@pytest.fixture
def interpret_kernels():
    """The JAX materialized paths with both Pallas kernels in interpret mode."""
    orig = SEL.select_topk_pallas, MLPM.dune_mlp_pallas
    SEL.select_topk_pallas = functools.partial(orig[0], interpret=True)
    MLPM.dune_mlp_pallas = functools.partial(orig[1], interpret=True)
    yield
    SEL.select_topk_pallas, MLPM.dune_mlp_pallas = orig


def _scene(T=4, P=128, B=3, seed=0):
    """Nominal states, points and masks; the last scenario has 3 valid points."""
    rng = np.random.default_rng(seed)
    jrobot = JRobot.create(receding=T, step_time=0.1, **ROBOT)
    robot = Robot.create(receding=T, step_time=0.1, **ROBOT)
    nom_u = rng.uniform(-0.5, 0.5, (B, 2, T)).astype(np.float32)
    nom_s = np.stack([np.asarray(jrobot.rollout(jnp.asarray(rng.uniform(-0.3, 0.3, 3), jnp.float32),
                                                jnp.asarray(u))) for u in nom_u])
    pts = rng.uniform(-5, 8, (B, 2, P)).astype(np.float32)
    vels = (rng.normal(scale=0.3, size=(B, 2, P)) * (np.arange(B) % 2)[:, None, None]
            ).astype(np.float32)
    mask = rng.uniform(size=(B, P)) < 0.8
    mask[-1] = np.arange(P) < 3
    return robot, jrobot, nom_s, pts, vels, mask


def _jgeom(jrobot):
    return (jnp.asarray(jrobot.vertices, jnp.float32), jnp.asarray(jrobot.G, jnp.float32),
            jnp.asarray(jrobot.h, jnp.float32))


def test_signed_polygon_distance_matches_jax():
    robot, jrobot, *_ = _scene()
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, (2, 5, 2, 200)).astype(np.float32)   # inside and outside
    d = signed_polygon_distance(*robot.tensors("cpu"), torch.from_numpy(pts))
    dj = jdune.signed_polygon_distance(*_jgeom(jrobot), jnp.asarray(pts))
    assert d.shape == (2, 5, 200) and bool((d < 0).any()) and bool((d > 0).any())
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=0, atol=1e-6)


def test_generate_point_flow_matches_jax():
    robot, jrobot, nom_s, pts, vels, _ = _scene()
    pf, R, pg = generate_point_flow(*(torch.from_numpy(a) for a in (nom_s, pts, vels)), robot.dt)
    assert pf.is_contiguous() and pf.shape == (3, 5, 2, 128)
    for b in range(nom_s.shape[0]):
        with jax.default_matmul_precision("highest"):
            pfj, Rj, pgj = jdune.generate_point_flow(jnp.asarray(nom_s[b]), jnp.asarray(pts[b]),
                                                     jnp.asarray(vels[b]), jrobot.dt)
        np.testing.assert_allclose(pf[b].numpy(), np.asarray(pfj), rtol=0, atol=2e-6)
        np.testing.assert_allclose(R[b].numpy(), np.asarray(Rj), rtol=0, atol=1e-7)
        np.testing.assert_allclose(pg[b].numpy(), np.asarray(pgj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("select,use_kernel,mlp_kernel,P", [
    ("mlp", False, None, 128), ("mlp", True, None, 256),
    ("exact", False, None, 128), ("exact", True, None, 256), ("exact", True, False, 128)])
def test_dune_forward_matches_jax(interpret_kernels, select, use_kernel, mlp_kernel, P):
    """T+1=5, K=5, three scenarios (the last with 3 valid points, so its
    trailing slots are ties at 1e9): valid_k equal, the selected points the
    same slot by slot, mu/lam/dist to 1e-5. Both sides read one point flow,
    so the ranking sees identical coordinates."""
    K = 5
    robot, jrobot, nom_s, pts, vels, mask = _scene(P=P)
    enc = load_checkpoint(CKPT, device="cpu")
    verts, G, h = robot.tensors("cpu")
    pf, R, pg = generate_point_flow(*(torch.from_numpy(a) for a in (nom_s, pts, vels)), robot.dt)
    with torch.no_grad():
        out = dune_forward(enc, G, h, pf, R, pg, torch.from_numpy(mask), K, use_kernel=use_kernel,
                           select=select, vertices=verts, mlp_kernel=mlp_kernel)
    params = jnet.load_checkpoint(CKPT)
    jv, jG, jh = _jgeom(jrobot)
    for b in range(nom_s.shape[0]):
        with jax.default_matmul_precision("highest"):
            ref = jdune.dune_forward(params, jG, jh, jnp.asarray(pf[b].numpy()),
                                     jnp.asarray(R[b].numpy()), jnp.asarray(pg[b].numpy()),
                                     jnp.asarray(mask[b]), K, use_pallas=use_kernel,
                                     select=select, vertices=jv, mlp_pallas=mlp_kernel)
        np.testing.assert_array_equal(out.valid_k[b].numpy(), np.asarray(ref.valid_k))
        np.testing.assert_array_equal(out.points_k[b].numpy(), np.asarray(ref.points_k))
        for name in ("mu_k", "lam_k", "dist_k"):
            np.testing.assert_allclose(getattr(out, name)[b].numpy(),
                                       np.asarray(getattr(ref, name)), rtol=0, atol=1e-5,
                                       err_msg=name)
        assert float(out.min_distance[b]) == pytest.approx(float(ref.min_distance), abs=1e-5)
    assert out.valid_k[-1].sum() == 5 * 3 and out.mu_k.shape == (3, 5, 4, K)
    assert bool((out.dist_k[:, :, 1:] >= out.dist_k[:, :, :-1]).all())   # ascending slots


def test_dune_forward_rejects_what_it_cannot_rank():
    robot, _, nom_s, pts, vels, mask = _scene()
    enc = load_checkpoint(CKPT, device="cpu")
    _, G, h = robot.tensors("cpu")
    pf, R, pg = generate_point_flow(*(torch.from_numpy(a) for a in (nom_s, pts, vels)), robot.dt)
    with pytest.raises(ValueError, match="requires polygon vertices"):
        dune_forward(enc, G, h, pf, R, pg, torch.from_numpy(mask), 5, select="exact")
    with pytest.raises(ValueError, match="select must be"):
        dune_forward(enc, G, h, pf, R, pg, torch.from_numpy(mask), 5, select="nearest")


@pytest.mark.parametrize("select,use_kernel", [("exact", True), ("exact", False), ("mlp", False)])
def test_dune_forward_gradient_flows_through_the_gathers_only(select, use_kernel):
    """With points that require a gradient, the selection itself runs
    without one; the gathered winners carry it, so d(sum points_k^2) is
    nonzero only at the selected columns."""
    K = 5
    robot, _, nom_s, pts, vels, mask = _scene()
    enc = load_checkpoint(CKPT, device="cpu")
    verts, G, h = robot.tensors("cpu")
    mask_t = torch.from_numpy(np.ones_like(mask))
    p = torch.from_numpy(pts).requires_grad_(True)
    pf, R, pg = generate_point_flow(torch.from_numpy(nom_s), p, torch.from_numpy(vels), robot.dt)
    out = dune_forward(enc, G, h, pf, R, pg, mask_t, K, use_kernel=use_kernel, select=select,
                       vertices=verts, mlp_kernel=False)
    torch.sum(out.points_k ** 2).backward()
    nz = int(torch.count_nonzero(p.grad))
    B, Tp1 = nom_s.shape[0], nom_s.shape[2]
    assert 0 < nz <= B * Tp1 * 2 * K
    # the learned distance is differentiable in the points as well
    p.grad = None
    pf, R, pg = generate_point_flow(torch.from_numpy(nom_s), p, torch.from_numpy(vels), robot.dt)
    out = dune_forward(enc, G, h, pf, R, pg, mask_t, K, use_kernel=use_kernel, select=select,
                       vertices=verts, mlp_kernel=False)
    out.dist_k.sum().backward()
    assert 0 < int(torch.count_nonzero(p.grad)) <= B * Tp1 * 2 * K


def test_dune_forward_flow_matches_jax(interpret_select):
    """T=10, K=10, P=300, two scenarios (one with moving points and a sparse
    mask): identical selections in the same slot order; mu/lam/dist to 1e-5."""
    T, K, P, B = 10, 10, 300, 2
    rng = np.random.default_rng(0)
    jrobot = JRobot.create(receding=T, step_time=0.1, **ROBOT)
    robot = Robot.create(receding=T, step_time=0.1, **ROBOT)
    nom_u = rng.uniform(-0.5, 0.5, (B, 2, T)).astype(np.float32)
    nom_s = np.stack([np.asarray(jrobot.rollout(jnp.zeros(3), jnp.asarray(u))) for u in nom_u])
    pts = rng.uniform(-5, 8, (B, 2, P)).astype(np.float32)
    vels = (rng.normal(scale=0.3, size=(B, 2, P)) * np.array([0, 1])[:, None, None]
            ).astype(np.float32)
    mask = rng.uniform(size=(B, P)) < np.array([[0.9], [0.3]])

    enc = load_checkpoint(CKPT, device="cpu")
    verts, G, h = robot.tensors("cpu")
    with torch.no_grad():
        out = dune_forward_flow(enc, G, h, *(torch.from_numpy(a) for a in (pts, vels, mask, nom_s)),
                                robot.dt, K, verts)

    params = jnet.load_checkpoint(CKPT)
    jG, jh = jnp.asarray(jrobot.G, jnp.float32), jnp.asarray(jrobot.h, jnp.float32)
    jv = jnp.asarray(jrobot.vertices, jnp.float32)
    for b in range(B):
        with jax.default_matmul_precision("highest"):
            ref = jdune.dune_forward_flow(params, jG, jh, jnp.asarray(pts[b]),
                                          jnp.asarray(vels[b]), jnp.asarray(mask[b]),
                                          jnp.asarray(nom_s[b]), jrobot.dt, K, jv)
        np.testing.assert_array_equal(out.valid_k[b].numpy(), np.asarray(ref.valid_k))
        # the selected points, slot by slot (the same index picks the same point)
        np.testing.assert_allclose(out.points_k[b].numpy(), np.asarray(ref.points_k),
                                   rtol=0, atol=1e-6)
        for name in ("mu_k", "lam_k", "dist_k"):
            np.testing.assert_allclose(getattr(out, name)[b].numpy(),
                                       np.asarray(getattr(ref, name)), rtol=0, atol=1e-5)
        assert float(out.min_distance[b]) == pytest.approx(float(ref.min_distance), abs=1e-5)


def test_frame_transforms_match_jax():
    rng = np.random.default_rng(1)
    nom_s = rng.uniform(-3, 3, (3, 3, 6)).astype(np.float32)
    R, tr = frame_transforms(torch.from_numpy(nom_s))
    for b in range(3):
        Rj, trj = jdune.frame_transforms(jnp.asarray(nom_s[b]))
        np.testing.assert_allclose(R[b].numpy(), np.asarray(Rj), atol=1e-7)
        np.testing.assert_array_equal(tr[b].numpy(), np.asarray(trj))
