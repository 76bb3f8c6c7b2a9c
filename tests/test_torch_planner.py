"""Port vs JAX: the NeuPan planner facade.

tests/golden/torch/facade_corridor.npz (scripts/make_torch_goldens.py) holds
20 control ticks of the JAX facade on the CPU for
examples/corridor/diff/planner.yaml: the states it was fed, the seeded
points of each tick, and what it returned. Off the TPU the JAX planner
ranks the materialized point flow by ``signed_polygon_distance`` (no Pallas
kernel), so the port runs the same path here: its spec's ``dune_kernel``
switched off.
"""

import dataclasses
import os
import subprocess
import sys

import jax  # noqa: F401  (JAX and PyTorch share this process: both are imported up front)
import numpy as np
import pytest
import torch

from neupan_torch import NeuPan, neupan
from neupan_torch.ops.nrmp import AdjustParams
from scripts.make_torch_goldens import FACADE_SEED, FACADE_TICKS, facade_points

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORRIDOR = os.path.join(ROOT, "examples/corridor/diff/planner.yaml")
PF_DIFF = os.path.join(ROOT, "examples/pf/diff/planner.yaml")
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch", "facade_corridor.npz")


def corridor(**kwargs):
    return NeuPan.init_from_yaml(CORRIDOR, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def test_golden_points_rebuild_from_their_seed(golden):
    pts, counts = facade_points(int(golden["seed"]), len(golden["counts"]))
    assert int(golden["seed"]) == FACADE_SEED and len(counts) == FACADE_TICKS
    np.testing.assert_array_equal(golden["points"], pts)
    np.testing.assert_array_equal(golden["counts"], counts)


def test_twenty_corridor_ticks_match_the_jax_facade(golden):
    """Fed the recorded states and points: every action within 5e-4
    (bench.py's cross-backend bound on opt_u), min_distance to 1e-4, the
    stop/arrive/collision flags equal; the planner carries its own
    PANState and velocity plan from tick to tick, as the JAX one did."""
    planner = corridor()
    planner.spec = dataclasses.replace(planner.spec, dune_kernel=False)
    for i in range(FACADE_TICKS):
        n = int(golden["counts"][i])
        action, info = planner(golden["state"][i], golden["points"][i, :, :n].astype(np.float64))
        assert action.shape == (2, 1)
        np.testing.assert_allclose(action, golden["action"][i], rtol=0, atol=5e-4,
                                   err_msg=f"tick {i}")
        assert planner.min_distance == pytest.approx(float(golden["min_distance"][i]), abs=1e-4)
        for flag in ("stop", "arrive", "collision"):
            assert info[flag] == bool(golden[flag][i]), (i, flag)
    assert golden["stop"][-1] and not golden["stop"][:-1].any()   # the golden ends in a stop


def _pan_section():
    import yaml

    with open(CORRIDOR) as f:
        return yaml.safe_load(f)["pan"]


def test_info_holds_tensors_on_the_planner_device_and_the_trajectories():
    planner = corridor()
    rng = np.random.default_rng(0)
    # more points than the capacity first: the decimated columns reach the
    # fused selection path as a contiguous tensor
    many = np.stack([rng.uniform(3, 12, 150), 20 + rng.uniform(1.5, 3, 150)])
    planner(np.array([[0.0], [20.0], [0.0]]), many)
    assert planner.dune_points.shape == (2, planner.spec.dune_max_num)
    pts = np.stack([rng.uniform(3, 12, 30), 20 + rng.uniform(1.5, 3, 30)])
    action, info = planner(np.array([[0.2], [20.0], [0.0]]), pts)
    T = planner.T
    for key, shape in (("state_tensor", (3, T + 1)), ("vel_tensor", (2, T)),
                       ("distance_tensor", (T,)), ("ref_state_tensor", (3, T + 1)),
                       ("ref_speed_tensor", (T,))):
        assert isinstance(info[key], torch.Tensor) and tuple(info[key].shape) == shape, key
        assert info[key].device.type == "cpu"
    assert len(planner.opt_trajectory) == T + 1 and planner.opt_trajectory[0].shape == (3, 1)
    assert len(planner.ref_trajectory) == T + 1
    assert planner.dune_points.shape == (2, 30) and planner.nrmp_points.shape[0] == 2
    assert planner.nrmp_points.shape[1] <= planner.spec.nrmp.K
    assert np.isfinite(action).all() and planner.min_distance < 1e8
    assert planner.waypoints is not None and planner.initial_path is not None
    assert neupan is NeuPan


def test_no_obstacle_planner_takes_five_ticks():
    """examples/pf/diff (K=0): the tracking QP alone; opt_d is None."""
    planner = NeuPan.init_from_yaml(PF_DIFF, device="cpu")
    assert planner.no_obs and planner.spec.nrmp.no_obs
    state = np.zeros((3, 1))
    speeds = []
    for _ in range(5):
        action, info = planner(state)
        assert info["distance_tensor"] is None and not info["stop"]
        assert planner.min_distance > 1e8 and planner.nrmp_points.shape == (2, 0)
        speeds.append(action[0, 0])
        state = state + planner.dt * np.array([[action[0, 0] * np.cos(state[2, 0])],
                                               [action[0, 0] * np.sin(state[2, 0])],
                                               [action[1, 0]]])
    # on a straight reference at ref_speed 4 the robot speeds up to it and holds its heading
    assert speeds[-1] == pytest.approx(4.0, abs=5e-2) and abs(state[1, 0]) < 1e-3
    assert state[0, 0] > 1.0


def test_pad_points_decimates_and_pads():
    planner = corridor()
    P = planner.spec.dune_max_num
    pts, vels, mask = planner._pad_points(None, None)
    assert pts.shape == (2, P) and not mask.any()
    few = np.arange(14, dtype=np.float64).reshape(2, 7)
    pts, vels, mask = planner._pad_points(few, None)
    assert pts.dtype == np.float32 and pts.shape == (2, P) and mask.sum() == 7
    np.testing.assert_array_equal(pts[:, :7], few.astype(np.float32))
    assert not pts[:, 7:].any() and not vels.any()
    many = np.stack([np.arange(250.0), -np.arange(250.0)])
    pts, vels, mask = planner._pad_points(many, many * 2)
    assert mask.all() and pts[0, 0] == 0.0 and pts[0, -1] == 249.0   # endpoints kept
    idx = (np.arange(P) * 249) // (P - 1)
    np.testing.assert_array_equal(pts[0], idx.astype(np.float32))
    np.testing.assert_array_equal(vels[1], -2.0 * idx.astype(np.float32))


def test_update_adjust_parameters_keeps_the_arity_of_q_s():
    planner = corridor()
    planner.update_adjust_parameters(q_s=[2.0, 3.0, 4.0], eta=7.0)
    adj = planner.adjust_parameters
    assert adj.q_s.dim() == 0 and float(adj.q_s) == 2.0 and float(adj.eta) == 7.0
    assert float(adj.p_u) == 1.0 and float(adj.d_min) == pytest.approx(0.25)
    vec = corridor(adjust={"q_s": [1.0, 2.0, 0.5]})
    assert tuple(vec.adjust.q_s.shape) == (3,)
    vec.update_adjust_parameters(q_s=[3.0, 3.0, 1.0])
    np.testing.assert_array_equal(vec.adjust.q_s.numpy(), [3.0, 3.0, 1.0])
    with pytest.raises(ValueError, match="3-element"):
        vec.update_adjust_parameters(q_s=[1.0, 2.0])
    with pytest.raises(ValueError, match="scalar or 3-element"):
        corridor(adjust={"q_s": [1.0, 2.0]})
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in vec.adjust)


def test_reset_restores_the_initial_state():
    planner = corridor()
    planner(np.array([[0.0], [20.0], [0.0]]), np.array([[5.0], [22.5]]))
    assert bool(planner.pan_state.prev_valid.any()) and planner.cur_vel_array.any()
    planner.info["stop"] = True
    planner.reset()
    assert not planner.pan_state.prev_valid.any() and not planner.pan_state.x_warm.any()
    assert not planner.cur_vel_array.any() and not planner.info["stop"]
    assert planner.ipath.point_index == 0 and not planner.ipath.arrive_flag


def test_stuck_escape_boosts_and_restores_the_weights():
    planner = corridor(stuck_escape={"patience": 2, "hold": 3})
    base = planner.adjust
    still = np.zeros((2, 1))
    planner._stuck_escape_tick(still)
    assert planner.adjust is base
    planner._stuck_escape_tick(still)                      # patience reached: boost
    assert float(planner.adjust.eta) == pytest.approx(3.0 * float(base.eta))
    assert float(planner.adjust.d_max) == pytest.approx(2.0 * float(base.d_max))
    assert planner.info["stuck_escape"] == 1
    for _ in range(3):                                      # hold runs out: restore
        planner._stuck_escape_tick(still)
    assert planner.adjust is base and planner._saved_adjust is None
    # an explicit set cancels a hold in flight
    planner._stuck_escape_tick(still)
    planner._stuck_escape_tick(still)
    mine = AdjustParams(*(t * 2 for t in base))
    planner.set_adjust_parameters(mine)
    planner._stuck_escape_tick(np.ones((2, 1)))
    assert planner.adjust is mine and planner._escape_hold == 0


@pytest.mark.parametrize("velocity", [False, True])
def test_scan_to_point_matches_the_jax_facade(velocity):
    from neupan_tpu.planner import NeuPan as JNeuPan

    rng = np.random.default_rng(5)
    n = 180
    scan = {"ranges": rng.uniform(0.1, 6.0, n), "angle_min": -np.pi, "angle_max": np.pi,
            "range_min": 0.3, "range_max": 5.0, "velocity": rng.normal(size=(2, n))}
    state = np.array([[1.0], [2.0], [0.7]])
    kw = dict(scan_offset=(0.2, -0.1, 0.3), angle_range=(-2.5, 2.0), down_sample=2)
    mine, ref = corridor(), JNeuPan.init_from_yaml(PF_DIFF)
    if velocity:
        (p, v), (pj, vj) = (mine.scan_to_point_velocity(state, scan, **kw),
                            ref.scan_to_point_velocity(state, scan, **kw))
        np.testing.assert_allclose(v, vj, rtol=0, atol=1e-12)
    else:
        p, pj = mine.scan_to_point(state, scan, **kw), ref.scan_to_point(state, scan, **kw)
    assert p.shape[0] == 2 and p.shape[1] > 10
    np.testing.assert_allclose(p, pj, rtol=0, atol=1e-12)


def test_device_none_raises_without_a_card_and_unknown_devices_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeuPan.init_from_yaml(CORRIDOR)
    with pytest.raises(RuntimeError):
        NeuPan.init_from_yaml(CORRIDOR, device="no_such_device")
    # the DUNE trainer, NeuPan.train_dune's engine, defaults to the card too
    from neupan_torch.training import DuneTrainer

    planner = corridor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DuneTrainer(planner.G.numpy(), planner.h.numpy(), str(tmp_path))


def test_missing_checkpoint_raises_and_direct_train_gets_a_seeded_encoder():
    with pytest.raises(FileNotFoundError, match="DUNE checkpoint not found"):
        corridor(pan={**_pan_section(), "dune_checkpoint": "no/such/model.npz"})
    a = corridor(pan={**_pan_section(), "dune_checkpoint": None}, train={"direct_train": True})
    b = corridor(pan={**_pan_section(), "dune_checkpoint": None}, train={"direct_train": True})
    for pa, pb in zip(a.encoder.parameters(), b.encoder.parameters()):
        assert torch.equal(pa, pb)


def test_planners_construct_and_step_where_jax_cannot_be_imported():
    """Both shipped kinds of configuration, in a process whose import of jax fails."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'neupan_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {ROOT!r})
import numpy as np
from neupan_torch import NeuPan
for path, pts in (({CORRIDOR!r}, np.array([[4.0, 6.0], [22.0, 18.2]])), ({PF_DIFF!r}, None)):
    planner = NeuPan.init_from_yaml(path, device='cpu')
    action, info = planner(np.array([[0.0], [20.0 if pts is not None else 0.0], [0.0]]), pts)
    assert np.isfinite(action).all() and action[0, 0] > 0.5, action
assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'neupan_tpu')]
print('stepped')
"""
    res = subprocess.run([sys.executable, "-I", "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "stepped" in res.stdout
