"""The plain reference against ``neupan_torch`` on the CPU at a tiny shape
(B=4, P=64), T=10 and T=30: step 0 from the empty state each side makes,
step 1 from the state the program carried out of step 0, as the check
follows it. The bounds on actions are the repository's own gates for the
port against another float32 evaluation (5e-4 at T=10, 3e-3 at T=30): the
QP's fixed ADMM iterations carry float32 rounding of the inputs into the
actions at about that size. The selection is exact."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import runner as D  # noqa: E402
from benchmark.harness import traffic as TR  # noqa: E402
from benchmark.reference import step as R  # noqa: E402

U_GATE = {"diff-t10": 5e-4, "diff-t30": 3e-3}


def setup(name, B=4, P=64):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["pan"]["dune_max_num"] = P
    prog = D.Program(ROOT, cfg, "cpu")
    lanes = TR.Lanes(2 ** 31 + 77, B, P, cfg["receding"], cfg["step_time"], cfg["ref_speed"],
                     (1.0, 9.0), "cpu")
    return cfg, prog, lanes, R.problem_from_config(cfg, ROOT)


def gap(a, b):
    return float((a - b.to(a.dtype)).abs().max())


@pytest.mark.parametrize("name", ["diff-t10", "diff-t30"])
def test_reference_follows_the_program(name):
    cfg, prog, lanes, pb = setup(name)
    enc = R.Encoder(pb.checkpoint, torch.float32, "cpu")
    fixed = lanes.fixed(lanes.batch, "cpu")
    state = prog.init_state(lanes)
    ref_state = R.empty_state(pb, lanes.batch, torch.float32, "cpu")
    for n in range(2):
        pts = lanes.points(n)
        out = prog.step(pts, fixed, state)
        ref = R.step(pb, enc, *fixed[:4], pts, *fixed[4:], ref_state)
        assert gap(out.opt_u, ref.opt_u) <= U_GATE[name]
        assert gap(out.opt_s, ref.opt_s) <= U_GATE[name]
        assert gap(out.opt_d, ref.opt_d) <= U_GATE[name]
        assert gap(out.min_distance, ref.min_distance) <= 1e-5 * (1 + float(ref.min_distance.abs().max()))
        assert torch.equal(out.nrmp_points, ref.nrmp_points)
        assert torch.equal(out.nrmp_valid, ref.nrmp_valid)
        assert gap(out.state.prev_mu, ref.state.prev_mu) <= U_GATE[name]
        assert gap(out.state.x_warm, ref.state.x_warm) <= U_GATE[name]
        assert gap(out.state.prev_s, ref.state.prev_s) <= U_GATE[name]
        assert gap(out.state.prev_u, ref.state.prev_u) <= U_GATE[name]
        assert torch.equal(out.state.prev_valid, ref.state.prev_valid)
        assert torch.equal(out.state.prev_has_points, ref.state.prev_has_points)
        state, ref_state = out.state, R.State(*out.state)


def test_float64_mode_agrees_with_float32():
    cfg, prog, lanes, pb = setup("diff-t10")
    fixed = [t.double() if t.is_floating_point() else t for t in lanes.fixed(lanes.batch, "cpu")]
    pts = lanes.points(0)
    ref32 = R.step(pb, R.Encoder(pb.checkpoint, torch.float32, "cpu"),
                   *(t.float() if t.is_floating_point() else t for t in fixed[:4]), pts,
                   *(t.float() if t.is_floating_point() else t for t in fixed[4:]),
                   R.empty_state(pb, lanes.batch, torch.float32, "cpu"))
    ref64 = R.step(pb, R.Encoder(pb.checkpoint, torch.float64, "cpu"), *fixed[:4], pts.double(),
                   *fixed[4:], R.empty_state(pb, lanes.batch, torch.float64, "cpu"), keep_qps=True)
    assert ref64.opt_u.dtype == torch.float64
    assert gap(ref32.opt_u, ref64.opt_u) <= U_GATE["diff-t10"]
    # the answer is judged by what it says: the float64 QP's objective and feasibility
    qp = ref64.trail["qp"][-1][0]
    f64, viol64 = R.objective(qp, ref64.trail["x"][-1])
    f32, viol32 = R.objective(qp, ref32.trail["x"][-1].double())
    assert bool((viol64 <= 2e-3).all()) and bool((viol32 <= 2e-3).all())
    assert bool(((f32 - f64).abs() <= 1e-4 * (1 + f64.abs())).all())
