"""Port vs JAX: the batched planner step, against the JAX golden.

tests/golden/torch/planner_step.npz (scripts/make_torch_goldens.py) holds
two chained JAX ``batched_planner_step`` calls at T=4, P=128, K=5, B=4 on
the fused DUNE path (Pallas select in interpret mode, so the slot order is
the port's). Its inputs come from a numpy seed, re-derived here.
planner_step_mlp.npz and planner_step_noobs.npz hold the same two calls
with ``dune_select="mlp"`` and without obstacle slots (K=0).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neupan_tpu.ops import pan as jpan
from neupan_torch.models import load_checkpoint
from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
from neupan_torch.ops.pan import PANSpec, init_state
from neupan_torch.parallel import batched_init_state, batched_planner_step
from neupan_torch.robot import Robot
from scripts.make_torch_goldens import step_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch", "planner_step.npz")
CKPT = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def _setup(T, P, K, **spec_kw):
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P, **spec_kw)
    adjust = AdjustParams(*(torch.tensor(v) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))
    return spec, load_checkpoint(CKPT, device="cpu"), robot.tensors("cpu"), adjust


def test_golden_inputs_rebuild_from_their_seed(golden):
    T, P, K, B = (int(golden[k]) for k in "TPKB")
    inp = step_inputs(int(golden["seed"]), T, P, K, B)
    for name, val in inp.items():
        np.testing.assert_array_equal(golden[name], val, err_msg=name)


def test_two_chained_steps_match_jax_golden(golden):
    """opt_u within 5e-4 (bench.py's cross-backend bound), nrmp_valid
    identical, min_distance to 1e-5, over two calls that carry PANState."""
    T, P, K, B = (int(golden[k]) for k in "TPKB")
    spec, enc, geom, adjust = _setup(T, P, K)
    g = {k: torch.from_numpy(v) for k, v in golden.items()}
    state = batched_init_state(spec, B, "cpu")
    nom_s, nom_u = g["nom_s"], g["nom_u"]
    for i in (1, 2):
        out = batched_planner_step(spec, enc, *geom, adjust, nom_s, nom_u, g["ref_s"],
                                   g["ref_us"], g[f"pts{i}"], g[f"vels{i}"], g[f"mask{i}"], state)
        du = float((out.opt_u - g[f"opt_u_{i}"]).abs().max())
        assert du <= 5e-4, (i, du)
        assert torch.equal(out.nrmp_valid, g[f"nrmp_valid_{i}"])
        torch.testing.assert_close(out.min_distance, g[f"min_distance_{i}"], rtol=0, atol=1e-5)
        assert out.opt_s.shape == (B, 3, T + 1) and out.opt_d.shape == (B, T)
        nom_s, nom_u, state = out.opt_s, out.opt_u, out.state


@pytest.mark.parametrize("variant,mlp_kernel", [("mlp", False), ("mlp", True), ("noobs", False)])
def test_two_chained_steps_match_the_mlp_and_no_obstacle_goldens(variant, mlp_kernel):
    """The reference-parity ranking (with the encoder as a module and
    through the fused-MLP wrapper) and the K=0 step: opt_u and opt_s within
    5e-4 of the JAX package over two calls that carry PANState."""
    with np.load(GOLDEN.replace("planner_step", f"planner_step_{variant}")) as f:
        g = {k: torch.from_numpy(f[k]) for k in f.files}
    T, P, K, B = (int(g[k]) for k in "TPKB")
    for name, val in step_inputs(int(g["seed"]), T, P, K, B).items():
        np.testing.assert_array_equal(g[name].numpy(), val, err_msg=name)
    if variant == "noobs":
        spec, enc, geom, adjust = _setup(T, P, 0)
        assert spec.nrmp.no_obs and spec.nrmp.n == 5 * T + 3 and spec.nrmp.m == 7 * T + 1
    else:
        spec, enc, geom, adjust = _setup(T, P, K, dune_select="mlp", dune_mlp_kernel=mlp_kernel)
        assert not spec.use_dune_kernel() and spec.use_dune_mlp_kernel() == mlp_kernel
    state = batched_init_state(spec, B, "cpu")
    nom_s, nom_u = g["nom_s"], g["nom_u"]
    for i in (1, 2):
        out = batched_planner_step(spec, enc, *geom, adjust, nom_s, nom_u, g["ref_s"],
                                   g["ref_us"], g[f"pts{i}"], g[f"vels{i}"], g[f"mask{i}"], state)
        assert float((out.opt_u - g[f"opt_u_{i}"]).abs().max()) <= 5e-4, i
        assert float((out.opt_s - g[f"opt_s_{i}"]).abs().max()) <= 5e-4, i
        assert torch.equal(out.nrmp_valid, g[f"nrmp_valid_{i}"])
        torch.testing.assert_close(out.min_distance, g[f"min_distance_{i}"], rtol=0, atol=1e-5)
        if variant == "noobs":
            assert out.opt_d is None and f"opt_d_{i}" not in g
            assert bool((out.min_distance > 1e8).all()) and not out.nrmp_valid.any()
            assert not out.state.prev_has_points.any()
        else:
            torch.testing.assert_close(out.opt_d, g[f"opt_d_{i}"], rtol=0, atol=5e-4)
        nom_s, nom_u, state = out.opt_s, out.opt_u, out.state


def test_spec_switches_follow_the_jax_auto_rules():
    """None = auto: the selection kernels with "exact" on either device,
    the fused MLP on a card while no gradient is recorded and never on the
    CPU; precision "highest" (the default) or "default", as in JAX."""
    robot = Robot.create(receding=4, kinematics="diff", length=1.6, width=2.0)
    nrmp = NRMPSpec(T=4, K=3, kinematics="diff", speed_bound=(8.0, 1.0), acce_bound=(0.8, 0.3))
    mk = lambda **kw: PANSpec(robot=robot, nrmp=nrmp, **kw)
    assert mk().use_dune_kernel() and not mk().use_dune_mlp_kernel()
    assert not mk(dune_select="mlp").use_dune_kernel()
    assert mk(dune_select="mlp", dune_kernel=True).use_dune_kernel()
    assert not mk(dune_kernel=False).use_dune_kernel()
    assert mk(dune_mlp_kernel=True).use_dune_mlp_kernel()
    assert not mk().use_dune_mlp_kernel("cpu") and mk(dune_mlp_kernel=True).use_dune_mlp_kernel("cpu")
    with torch.no_grad():
        assert mk().use_dune_mlp_kernel("cuda") and mk(dune_select="mlp").use_dune_mlp_kernel("cuda:0")
        assert not mk(dune_mlp_kernel=False).use_dune_mlp_kernel("cuda")
    assert not mk().use_dune_mlp_kernel("cuda")      # a gradient is recorded
    assert mk().precision == "highest" and mk().dune_select == "exact"
    assert jpan.PANSpec.__dataclass_fields__["dune_select"].default == mk().dune_select
    assert jpan.PANSpec.__dataclass_fields__["precision"].default == mk().precision
    assert mk(precision="default").precision == "default"
    with pytest.raises(ValueError, match="TF32"):
        mk(precision="high")
    with pytest.raises(ValueError, match="dune_select"):
        mk(dune_select="nearest")


def test_init_state_matches_jax_layout():
    spec, _, _, _ = _setup(4, 16, 5)
    from neupan_tpu.ops.nrmp import NRMPSpec as JNRMPSpec
    from neupan_tpu.robot import Robot as JRobot

    jr = JRobot.create(receding=4, step_time=0.1, kinematics="diff", length=1.6, width=2.0)
    jspec = jpan.PANSpec(robot=jr, nrmp=JNRMPSpec(T=4, K=5, kinematics="diff",
                                                  speed_bound=(8.0, 1.0), acce_bound=(0.8, 0.3)))
    mine, ref = init_state(spec, "cpu"), jpan.init_state(jspec)
    for a, b in zip(mine, ref):
        assert tuple(a.shape) == tuple(jnp.shape(b))
    st = batched_init_state(spec, 3, "cpu")
    assert st.x_warm.shape == (3, spec.nrmp.n) and st.prev_valid.shape == (3,)


def test_step_rejects_inputs_on_different_devices(golden):
    T, P, K, B = (int(golden[k]) for k in "TPKB")
    spec, enc, geom, adjust = _setup(T, P, K)
    g = {k: torch.from_numpy(v) for k, v in golden.items()}
    state = batched_init_state(spec, B, "cpu")
    with pytest.raises(ValueError, match="different devices"):
        batched_planner_step(spec, enc, *geom, adjust, g["nom_s"], g["nom_u"], g["ref_s"],
                             g["ref_us"], g["pts1"], g["vels1"], g["mask1"].to("meta"), state)
