"""``PANSpec(precision="default")``: the JAX package's split, with TF32 in
place of the TPU's bfloat16 passes. The step's CUDA matmuls may use TF32,
the QP's solve and its backward switch back to exact float32 inside that
scope, and the process-global CUDA flag is restored on the way out, also
when the step raises. The CPU has no TF32, so there the two precisions
give the same bits."""

import os

import pytest
import torch

import neupan_torch.ops.pan as PAN
import neupan_torch.ops.qp as QP
from neupan_torch import matmul_precision
from neupan_torch.models import load_checkpoint
from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
from neupan_torch.ops.pan import PANSpec
from neupan_torch.parallel import batched_init_state, batched_planner_step
from neupan_torch.robot import Robot
from scripts.make_torch_goldens import step_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")
FLAGS = torch.backends.cuda.matmul


def _setup(precision, T=4, P=64, K=3, B=4, iter_num=2):
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P, iter_num=iter_num,
                   precision=precision)
    inp = {k: torch.from_numpy(v) for k, v in step_inputs(3, T, P, K, B).items()}
    args = [inp[k] for k in ("nom_s", "nom_u", "ref_s", "ref_us", "pts1", "vels1", "mask1")]
    return spec, load_checkpoint(CKPT, device="cpu"), robot.tensors("cpu"), args, \
        batched_init_state(spec, B, "cpu")


def _adjust(requires_grad=False):
    return AdjustParams(*(torch.tensor(v, requires_grad=requires_grad)
                          for v in (1.0, 1.0, 10.0, 1.0, 0.1)))


def _step(precision, adjust=None):
    spec, enc, geom, args, state = _setup(precision)
    return batched_planner_step(spec, enc, *geom, adjust or _adjust(), *args, state)


def test_default_gives_the_cpu_the_bits_of_highest():
    ref, out = _step("highest"), _step("default")
    for name in ("opt_s", "opt_u", "opt_d", "min_distance", "nrmp_points", "nrmp_valid"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for a, b in zip(out.state, ref.state):
        assert torch.equal(a, b)


def _spy(monkeypatch, module, name, seen):
    orig = getattr(module, name)

    def spy(*args, **kw):
        seen.append((name, FLAGS.allow_tf32))
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_tf32_reaches_the_assembly_and_not_the_qp(monkeypatch, precision):
    """Inside the step the NRMP assembly sees the flag of ``precision``, the
    QP's solve and its backward exact float32 (the backward is run inside a
    "default" scope of its own); the flag reads as before afterwards."""
    seen = []
    _spy(monkeypatch, PAN, "build_qp", seen)
    _spy(monkeypatch, QP, "_solve", seen)
    _spy(monkeypatch, QP, "_solve_bwd_impl", seen)
    before = FLAGS.allow_tf32
    adjust = _adjust(requires_grad=True)
    out = _step(precision, adjust)
    assert FLAGS.allow_tf32 == before
    with matmul_precision("default"):
        torch.autograd.grad(out.opt_u.sum(), adjust)
    assert FLAGS.allow_tf32 == before
    want = {"build_qp": precision == "default", "_solve": False, "_solve_bwd_impl": False}
    assert {n for n, _ in seen} == set(want)
    assert all(flag == want[n] for n, flag in seen), seen


@pytest.mark.parametrize("before", [False, True])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_the_flag_is_restored_after_a_step_that_raised(monkeypatch, before, precision):
    def boom(*_, **__):
        assert FLAGS.allow_tf32 == (precision == "default")
        raise RuntimeError("boom")

    monkeypatch.setattr(PAN, "build_qp", boom)
    FLAGS.allow_tf32 = before
    try:
        with pytest.raises(RuntimeError, match="boom"):
            _step(precision)
        assert FLAGS.allow_tf32 == before
    finally:
        FLAGS.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"


def test_other_precisions_raise():
    spec = _setup("highest")[0]
    for bad in ("high", "medium", "fastest", "tf32"):
        with pytest.raises(ValueError, match="TF32"):
            PANSpec(robot=spec.robot, nrmp=spec.nrmp, precision=bad)
        with pytest.raises(ValueError, match="precision"):
            with matmul_precision(bad):
                pass
    assert FLAGS.allow_tf32 is False
