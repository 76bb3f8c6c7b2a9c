"""``neupan_torch.utils.profile_trace``, the port's profiler hook (the JAX
package's ``jax.profiler`` trace): a planner step inside it leaves a
Chrome/Perfetto trace in the given directory whose events are the step's
operations."""

import json
import os

import numpy as np
import torch

from neupan_torch.models import load_checkpoint
from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
from neupan_torch.ops.pan import PANSpec
from neupan_torch.parallel import Mesh, batched_init_state, gather, sharded_planner_step
from neupan_torch.robot import Robot
from neupan_torch.utils import profile_trace
from scripts.make_torch_goldens import step_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_a_sharded_step_inside_profile_trace_writes_its_trace(tmp_path):
    T, P, K, B = 4, 32, 3, 4
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P)
    inp = {k: torch.from_numpy(v) for k, v in step_inputs(5, T, P, K, B).items()}
    enc = load_checkpoint(os.path.join(ROOT, "examples/model/diff_robot_default/model.npz"),
                          device="cpu")
    adjust = AdjustParams(*(torch.tensor(v) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))
    args = [inp[k] for k in ("nom_s", "nom_u", "ref_s", "ref_us", "pts1", "vels1", "mask1")]
    log_dir = str(tmp_path / "trace")

    with profile_trace(log_dir) as where:
        out = sharded_planner_step(spec, Mesh((torch.device("cpu"),) * 2), enc,
                                   *robot.tensors("cpu"), adjust, *args,
                                   batched_init_state(spec, B, "cpu"))
    assert where == log_dir
    assert np.isfinite(gather(out).opt_u.numpy()).all()
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, os.listdir(log_dir)
    with open(os.path.join(log_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    # the encoder (tanh), the QP assembly and solve (bmm), the sweep's plain version
    for op in ("aten::tanh", "aten::bmm", "aten::cat"):
        assert op in names, op


def test_profile_trace_keeps_the_jax_signature():
    import inspect

    from neupan_tpu import utils as jutils

    ours = inspect.signature(profile_trace).parameters
    theirs = inspect.signature(jutils.profile_trace).parameters
    assert list(ours) == list(theirs) == ["log_dir"]
    assert ours["log_dir"].default == theirs["log_dir"].default
