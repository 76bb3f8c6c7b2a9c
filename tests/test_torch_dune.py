"""Port vs JAX: the fused exact-selection DUNE forward."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neupan_tpu.ops.pallas.select as SEL
from neupan_tpu.models import obs_point_net as jnet
from neupan_tpu.ops import dune as jdune
from neupan_tpu.robot import Robot as JRobot
from neupan_torch.models import load_checkpoint
from neupan_torch.ops.dune import dune_forward_flow, frame_transforms
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
