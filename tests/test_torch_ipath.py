"""The port's copies of the initial-path subsystem against the JAX package's
numpy originals: the same arithmetic on the same seeded inputs, equal to 1e-12."""

import numpy as np
import pytest

from neupan_tpu.ipath import InitialPath as JInitialPath
from neupan_tpu.ipath import curves as jcurves
from neupan_tpu.ipath.reeds_shepp import reeds_shepp_path as j_reeds
from neupan_tpu.robot import Robot as JRobot
from neupan_torch.ipath import InitialPath
from neupan_torch.ipath import curves
from neupan_torch.ipath.reeds_shepp import reeds_shepp_path
from neupan_torch.robot import Robot

ATOL = 1e-12


def _robots(kind):
    kw = dict(receding=10, step_time=0.1, kinematics=kind, max_speed=[8, 1], max_acce=[8, 3],
              length=1.6, width=2.0, wheelbase=3.0 if kind == "acker" else None)
    return Robot.create(**kw), JRobot.create(**kw)


def _pair(kind="diff", **kwargs):
    defaults = dict(waypoints=[[0, 0, 0], [20, 0, 0]], curve_style="line")
    defaults.update(kwargs)
    robot, jrobot = _robots(kind)
    return (InitialPath(10, 0.1, 2.0, robot, **defaults),
            JInitialPath(10, 0.1, 2.0, jrobot, **defaults))


def _same_path(a, b):
    assert len(a) == len(b) and len(a) > 1
    np.testing.assert_allclose(np.hstack(a), np.hstack(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("style,radius", [("line", 0.0), ("dubins", 2.5), ("reeds", 3.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_curves_match(style, radius, seed):
    rng = np.random.default_rng(seed)
    wps = [np.array([rng.uniform(-10, 10), rng.uniform(-10, 10), rng.uniform(-np.pi, np.pi)])
           for _ in range(3)]
    _same_path(curves.generate_curve(style, wps, 0.2, radius),
               jcurves.generate_curve(style, wps, 0.2, radius))
    no_gear = curves.generate_curve(style, wps, 0.2, radius, include_gear=False)
    assert no_gear[0].shape == (3, 1)


def test_reeds_shepp_path_matches_and_reverses():
    start, goal = (0.0, 0.0, 0.0), (-4.0, 0.5, 0.2)
    mine, ref = reeds_shepp_path(start, goal, 2.0, 0.1), j_reeds(start, goal, 2.0, 0.1)
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=0, atol=ATOL)
    assert any(p[3] < 0 for p in mine)          # a goal behind the start needs reverse gear
    with pytest.raises(ValueError, match="unknown curve style"):
        curves.generate_curve("spline", [start, goal], 0.1)


@pytest.mark.parametrize("kind,style", [("diff", "line"), ("acker", "dubins"), ("acker", "reeds"),
                                        ("omni", "line")])
def test_tracking_and_reference_assembly_match_over_a_drive(kind, style):
    """Twelve ticks along seeded waypoints: check_arrive, the tracking
    indices and generate_nom_ref_state agree at every tick."""
    rng = np.random.default_rng(3)
    wps = [[0, 0, 0], [8, 3, 0.5], [2, 6, 2.5]] if kind == "acker" else [[0, 0, 0], [6, 2, 0]]
    mine, ref = _pair(kind, waypoints=wps, curve_style=style, interval=0.15)
    state = np.array([[0.1], [-0.2], [0.05]])
    for tick in range(12):
        assert mine.check_arrive(state) == ref.check_arrive(state)
        assert (mine.curve_index, mine.point_index) == (ref.curve_index, ref.point_index)
        vel = rng.uniform(-0.5, 1.5, (2, 10))
        out, jout = (mine.generate_nom_ref_state(state, vel, 2.0),
                     ref.generate_nom_ref_state(state, vel, 2.0))
        for a, b in zip(out, jout):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
        state = out[0][:, 2:3] + rng.normal(scale=0.02, size=(3, 1))
    _same_path(mine.initial_path, ref.initial_path)


def test_arrival_loop_and_path_setters_match():
    mine, ref = _pair(waypoints=[[0, 0, 0], [1, 0, 0]])
    near_goal = np.array([[0.98], [0.0], [0.0]])
    for ip in (mine, ref):
        ip.check_arrive(np.zeros((3, 1)))
    assert mine.check_arrive(near_goal) and ref.check_arrive(near_goal)
    assert mine.arrive_flag and ref.arrive_flag

    mine, ref = _pair()
    for ip in (mine, ref):
        ip.update_initial_path_from_goal(np.array([[0.0], [0.0], [0.0]]),
                                         np.array([[5.0], [5.0], [1.0]]))
    _same_path(mine.initial_path, ref.initial_path)
    for ip in (mine, ref):
        ip.set_ipath_with_waypoints([[0, 0, 0], [3, 1, 0], [6, 0, 0]])
    _same_path(mine.initial_path, ref.initial_path)
    path = [np.array([[x], [0.5 * x], [0.4], [1.0]]) for x in np.linspace(0, 4, 30)]
    for ip in (mine, ref):
        ip.set_initial_path(path)
        ip.init_check(np.array([[0.0], [0.0], [0.0]]))
    assert (mine.curve_index, mine.point_index) == (ref.curve_index, ref.point_index)
    assert mine._default_min_radius() == ref._default_min_radius()
    acker, jacker = _pair("acker")
    assert acker._default_min_radius() == jacker._default_min_radius() > 0
