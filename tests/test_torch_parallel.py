"""Port vs JAX: the planner step split over a mesh of devices, and the
data-parallel DUNE training update.

The mesh is ``Mesh((cpu,) * 8)``, the port's analogue of the JAX suite's 8
virtual CPU devices (tests/conftest.py). tests/golden/torch/sharded_step.npz
(``scripts/make_torch_goldens.py sharded_step``) holds JAX's
``sharded_planner_step`` on those devices at tests/test_parallel.py's
shapes (T=3, K=2, P=8, 40 ADMM iterations, one PAN iteration), B=8 and
B=16, two chained steps each, with JAX's ``init_params(PRNGKey(0))``
weights. Off the TPU the JAX step ranks the obstacle points on the
materialized point flow without the Pallas kernel, so the port meets the
golden with its selection kernel off (``dune_kernel=False``): the fused
selection orders the K slots otherwise, which permutes the obstacle rows
of the carried dual warm start and moves the second step. The other tests
run the port's default path. No JAX step is compiled here.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from neupan_torch.models import ObsPointNet
from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
from neupan_torch.ops.pan import PANOutput, PANSpec, PANState
from neupan_torch.ops.qp import ADMMConfig
from neupan_torch.parallel import (Mesh, Sharded, batched_init_state, batched_planner_step,
                                   gather, make_mesh, replicated_sharding, scenario_sharding,
                                   sharded_planner_step)
from neupan_torch.robot import Robot
from neupan_torch.training import polygon_distance_labels
from neupan_torch.training.dune_train import _loss_terms, rotation
from neupan_torch.training.optim import Adam, exponential_decay
from scripts.make_torch_goldens import SHARDED_BATCHES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch", "sharded_step.npz")
CPU = torch.device("cpu")
MESH8 = Mesh((CPU,) * 8)
INPUTS = ("nom_s", "nom_u", "ref_s", "ref_us", "pts", "vels", "mask")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: torch.from_numpy(g[k]) for k in g.files}


def small_spec(T=3, K=2, P=8, **kw):
    """tests/test_parallel.py's small_spec in the port."""
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[4, 2],
                         max_acce=[4, 2], length=1.6, width=1.0)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]), ro_obs=100.0)
    kw.setdefault("iter_num", 1)
    return PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P, admm=ADMMConfig(iters=40), **kw)


def shared(g, spec, requires_grad=False):
    enc = ObsPointNet.from_jax_params(
        {k[len("param_"):]: v.numpy() for k, v in g.items() if k.startswith("param_")}, "cpu")
    adjust = AdjustParams(*(g[f"adjust_{f}"].clone().requires_grad_(requires_grad)
                            for f in AdjustParams._fields))
    return enc, spec.robot.tensors("cpu"), adjust


def inputs(g, B):
    return [g[f"B{B}_{n}"] for n in INPUTS]


def two_steps(step, spec, g, B, enc, geom, adjust):
    """Two chained steps, the second from the first's trajectory and state
    (as the golden was written)."""
    nom_s, nom_u, ref_s, ref_us, pts, vels, mask = inputs(g, B)
    out1 = step(spec, enc, *geom, adjust, nom_s, nom_u, ref_s, ref_us, pts, vels, mask,
                batched_init_state(spec, B, "cpu"))
    out2 = step(spec, enc, *geom, adjust, out1.opt_s, out1.opt_u, ref_s, ref_us,
                g[f"B{B}_pts2"], vels, mask, out1.state)
    return out1, out2


def on_mesh(mesh):
    return lambda spec, *a: sharded_planner_step(spec, mesh, *a)


@pytest.mark.parametrize("B", SHARDED_BATCHES)
def test_sharded_steps_match_the_jax_golden(golden, B):
    """Two chained steps on the 8-entry CPU mesh against JAX's on 8 virtual
    devices: the trajectories within 5e-4, min_distance within 1e-5,
    nrmp_valid and the carried flags identical."""
    spec = small_spec(dune_kernel=False)
    enc, geom, adjust = shared(golden, spec)
    outs = two_steps(on_mesh(MESH8), spec, golden, B, enc, geom, adjust)
    for i, out in enumerate(outs, 1):
        out = gather(out, CPU)
        for name in ("opt_u", "opt_s", "opt_d"):
            d = float((getattr(out, name) - golden[f"B{B}_{name}_{i}"]).abs().max())
            assert d <= 5e-4, (i, name, d)
        torch.testing.assert_close(out.min_distance, golden[f"B{B}_min_distance_{i}"],
                                   rtol=0, atol=1e-5)
        assert torch.equal(out.nrmp_valid, golden[f"B{B}_nrmp_valid_{i}"])
        for name in ("prev_valid", "prev_has_points"):
            assert torch.equal(getattr(out.state, name), golden[f"B{B}_state_{name}_{i}"])
        for name in ("prev_s", "prev_u", "x_warm", "y_warm"):
            d = float((getattr(out.state, name) - golden[f"B{B}_state_{name}_{i}"]).abs().max())
            assert d <= 5e-4, (i, name, d)


@pytest.mark.parametrize("B,iter_num", [(8, 1), (16, 1), (16, 2)])
def test_sharded_matches_batched(golden, B, iter_num):
    """tests/test_parallel.py's bound, rtol 1e-4 and atol 1e-5, on every
    output and carried field of two chained steps."""
    spec = small_spec(iter_num=iter_num)
    enc, geom, adjust = shared(golden, spec)
    ref = two_steps(batched_planner_step, spec, golden, B, enc, geom, adjust)
    out = two_steps(on_mesh(MESH8), spec, golden, B, enc, geom, adjust)
    for r, o in zip(ref, out):
        o = gather(o, CPU)
        for name in ("opt_s", "opt_u", "opt_d", "min_distance"):
            torch.testing.assert_close(getattr(o, name), getattr(r, name), rtol=1e-4, atol=1e-5)
        assert torch.equal(o.nrmp_valid, r.nrmp_valid)
        for name in PANState._fields:
            a, b = getattr(o.state, name), getattr(r.state, name)
            if a.dtype == torch.bool:
                assert torch.equal(a, b), name
            else:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_one_device_mesh_is_the_batched_step_bit_for_bit(golden):
    spec = small_spec(iter_num=2)
    enc, geom, adjust = shared(golden, spec)
    ref = two_steps(batched_planner_step, spec, golden, 16, enc, geom, adjust)
    out = two_steps(on_mesh(Mesh((CPU,))), spec, golden, 16, enc, geom, adjust)
    for r, o in zip(ref, out):
        o = gather(o)
        for name in PANOutput._fields[:-1]:
            assert torch.equal(getattr(o, name), getattr(r, name)), name
        for name in PANState._fields:
            assert torch.equal(getattr(o.state, name), getattr(r.state, name)), name


@pytest.mark.parametrize("shards", [2, 8])
def test_each_shard_is_the_batched_step_on_its_own_scenarios(golden, shards):
    """Bit for bit: shard q of two chained sharded steps is the batched step
    run on scenarios [q b, (q + 1) b) alone, chained the same."""
    spec = small_spec(iter_num=2)
    enc, geom, adjust = shared(golden, spec)
    out = two_steps(on_mesh(Mesh((CPU,) * shards)), spec, golden, 16, enc, geom, adjust)
    b = 16 // shards
    for q in range(shards):
        part = {k.replace("B16_", f"B{b}_"): v[q * b:(q + 1) * b]
                for k, v in golden.items() if k.startswith("B16_")}
        ref = two_steps(batched_planner_step, spec, part, b, enc, geom, adjust)
        for o, r in zip(out, ref):
            for name in PANOutput._fields[:-1]:
                assert torch.equal(getattr(o, name).shards[q], getattr(r, name)), name
            for name in PANState._fields:
                assert torch.equal(getattr(o.state, name).shards[q], getattr(r.state, name))


def test_outputs_stay_split_over_the_mesh(golden):
    """The analogue of tests/test_parallel.py's test_sharded_output_sharding:
    every field of the output and of its state is 8 shards of 2 scenarios."""
    spec = small_spec()
    enc, geom, adjust = shared(golden, spec)
    out = on_mesh(MESH8)(spec, enc, *geom, adjust, *inputs(golden, 16),
                         batched_init_state(spec, 16, "cpu"))
    for field in (*out[:-1], *out.state):
        assert isinstance(field, Sharded) and len(field) == 8
        assert field.shape[0] == 16 and all(s.shape[0] == 2 for s in field.shards)
        assert tuple(s.device for s in field.shards) == MESH8.devices


def test_chained_step_takes_the_sharded_state_without_a_gather(golden, monkeypatch):
    """The second step is fed the first's Sharded trajectory and state as
    they lie: nothing is gathered, no shard is copied, and it equals the
    step fed the gathered tensors."""
    spec = small_spec()
    enc, geom, adjust = shared(golden, spec)
    nom_s, nom_u, ref_s, ref_us, pts, vels, mask = inputs(golden, 16)
    step = on_mesh(MESH8)
    out1 = step(spec, enc, *geom, adjust, nom_s, nom_u, ref_s, ref_us, pts, vels, mask,
                batched_init_state(spec, 16, "cpu"))
    whole = gather(out1, CPU)
    split = scenario_sharding(MESH8)
    assert all(a is b for a, b in zip(split.put(out1.state.x_warm).shards,
                                       out1.state.x_warm.shards))

    def no_gather(*_):
        raise AssertionError("a Sharded input was gathered")

    with monkeypatch.context() as m:
        m.setattr(Sharded, "gather", no_gather)
        out2 = step(spec, enc, *geom, adjust, out1.opt_s, out1.opt_u, ref_s, ref_us,
                    golden["B16_pts2"], vels, mask, out1.state)
    ref2 = step(spec, enc, *geom, adjust, whole.opt_s, whole.opt_u, ref_s, ref_us,
                golden["B16_pts2"], vels, mask, whole.state)
    for a, b in zip(gather(out2)[:-1], gather(ref2)[:-1]):
        assert torch.equal(a, b)


def test_a_batch_that_does_not_divide_by_the_mesh_raises(golden):
    spec = small_spec()
    enc, geom, adjust = shared(golden, spec)
    args = [a[:12] for a in inputs(golden, 16)]
    with pytest.raises(ValueError, match="split evenly"):
        sharded_planner_step(spec, MESH8, enc, *geom, adjust, *args,
                             batched_init_state(spec, 12, "cpu"))
    with pytest.raises(ValueError, match="4 shards for a mesh of 8"):
        scenario_sharding(MESH8).put(scenario_sharding(Mesh((CPU,) * 4)).put(args[0][:8]))
    with pytest.raises(ValueError, match="axis"):
        scenario_sharding(MESH8, axis_name="batch")


def test_adjust_grads_through_the_sharded_step_match_the_batched_step(golden):
    """A summed distance loss (min_distance and the d slacks of two PAN
    iterations) differentiated in every AdjustParams weight: the sharded
    step's gradient equals the batched step's to 1e-5 relative, and is not
    zero (the step did not detach; d_min's is, on these inputs, in both)."""
    spec = small_spec(iter_num=2)
    enc, geom, _ = shared(golden, spec)
    args = inputs(golden, 16)

    def grads(step):
        _, _, adjust = shared(golden, spec, requires_grad=True)
        out = gather(step(spec, enc, *geom, adjust, *args, batched_init_state(spec, 16, "cpu")))
        loss = out.min_distance.sum() + out.opt_d.sum() + (out.opt_u ** 2).sum()
        return torch.stack(torch.autograd.grad(loss, adjust))

    ref, got = grads(batched_planner_step), grads(on_mesh(MESH8))
    scale = float(ref.abs().max())
    assert scale > 0 and int((ref != 0).sum()) >= 4
    assert float((got - ref).abs().max()) <= 1e-5 * scale, (got, ref)


def test_placements_replicate_once_per_device_and_follow_updates():
    """The replicated placement: one copy per distinct device, the original
    where it already lies; a copy elsewhere (the meta device stands for a
    second card here) is cached until a parameter is updated in place."""
    enc = ObsPointNet.seeded(2, 4, seed=0, device="cpu")
    mesh = Mesh((CPU, CPU, torch.device("meta")))
    repl = replicated_sharding(mesh)
    first = repl.put(enc)
    assert first[0] is enc and first[1] is enc and first[2] is not enc
    assert next(first[2].parameters()).device.type == "meta"
    assert repl.put(enc)[2] is first[2]
    with torch.no_grad():
        next(enc.parameters()).add_(1.0)
    assert repl.put(enc)[2] is not first[2]
    w = torch.ones(3, requires_grad=True)
    with torch.enable_grad():
        copies = repl.put(w)
    assert copies[0] is w and copies[2].grad_fn is not None


def test_make_mesh_needs_a_card():
    if torch.cuda.is_available():
        assert len(make_mesh()) == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="Mesh"):
        make_mesh()
    with pytest.raises(RuntimeError, match="Mesh"):
        make_mesh(1)


@pytest.mark.parametrize("optimizer", ["adam_l2", "adamw"])
def test_data_parallel_update_matches_the_single_device_update(optimizer):
    """chip_smoke.py's data-parallel DUNE update on 4 CPU shards of 64 against
    one update on the whole batch of 256: the summed gradients to 1e-5 of
    the largest, the updated weights to 1e-3 of the learning rate."""
    robot = Robot.create(receding=10, kinematics="diff", length=1.6, width=2.0)
    _, G, h = robot.tensors("cpu")
    rng = np.random.default_rng(0)
    pts = torch.tensor(rng.uniform(-5, 5, (256, 2)), dtype=torch.float32)
    mu, d = polygon_distance_labels(G, h, pts)
    R = rotation(torch.tensor(0.3))
    lr = 5e-5
    nets = [ObsPointNet.seeded(2, G.shape[0], seed=0, device="cpu") for _ in range(2)]
    opts = [Adam(list(n.parameters()), exponential_decay(lr, 0, 1.0), optimizer) for n in nets]

    params = list(nets[0].parameters())
    ref = torch.autograd.grad(sum(_loss_terms(nets[0], pts, mu, d, G, h, R)), params)
    opts[0].step(params, ref)
    got = chip_smoke.data_parallel_update(torch, nets[1], opts[1], Mesh((CPU,) * 4),
                                          (pts, mu, d), G, h, R)
    scale = max(float(g.abs().max()) for g in ref)
    assert max(float((a - b).abs().max()) for a, b in zip(got, ref)) <= 1e-5 * scale
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert float((a - b).detach().abs().max()) <= 1e-3 * lr
