"""The port's host helpers (neupan_torch/utils, native, config) against the
JAX package's numpy originals: equal to 1e-12 on seeded inputs."""

import os

import numpy as np
import pytest

from neupan_tpu import native as jnative
from neupan_tpu import utils as jutils
from neupan_tpu.config import load_planner_config as j_load
from neupan_torch import native, utils
from neupan_torch.config import load_planner_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,m", [(250, 100), (101, 100), (100, 100), (7, 20), (50, 1), (9, 2)])
def test_downsample_decimation_matches(n, m):
    mat = np.random.default_rng(n).normal(size=(2, n))
    out, ref = utils.downsample_decimation(mat, m), jutils.downsample_decimation(mat, m)
    np.testing.assert_array_equal(out, ref)
    assert out.shape[1] == min(n, max(m, 1))
    if 1 < m < n:
        assert out[0, 0] == mat[0, 0] and out[0, -1] == mat[0, -1]   # endpoints kept


def test_get_transform_and_wrap_to_pi_match():
    rng = np.random.default_rng(0)
    for _ in range(5):
        state = rng.uniform(-4, 4, (3, 1))
        (t, R), (tj, Rj) = utils.get_transform(state), jutils.get_transform(state)
        np.testing.assert_allclose(t, tj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(R @ R.T, np.eye(2), atol=1e-12)
    t, R = utils.get_transform(np.array([[1.0], [2.0]]))
    np.testing.assert_array_equal(R, np.eye(2))
    ang = rng.uniform(-20, 20, 50)
    np.testing.assert_allclose(utils.wrap_to_pi(ang), jutils.wrap_to_pi(ang), rtol=0, atol=1e-12)
    np.testing.assert_allclose(utils.wrap_to_pi(ang, True), jutils.wrap_to_pi(ang, True),
                               rtol=0, atol=1e-12)


def test_file_check_resolves_like_the_original(tmp_path, monkeypatch):
    rel = "examples/corridor/diff/planner.yaml"
    assert utils.file_check(rel) == jutils.file_check(rel) == os.path.join(ROOT, rel)
    assert utils.file_check(None) is None
    monkeypatch.chdir(tmp_path)                  # from elsewhere: found under the repo root
    assert utils.file_check(rel) == os.path.join(ROOT, rel)
    (tmp_path / "local.yaml").write_text("receding: 3\n")
    assert utils.file_check("local.yaml") == str(tmp_path / "local.yaml")
    with pytest.raises(FileNotFoundError, match="no/such/file"):
        utils.file_check("no/such/file.yaml")


def test_repeat_mk_dirs_and_time_it(tmp_path, capsys):
    base = str(tmp_path / "run")
    assert utils.repeat_mk_dirs(base) == base and utils.repeat_mk_dirs(base) == base
    open(os.path.join(base, "f"), "w").close()
    assert utils.repeat_mk_dirs(base) == base + "_1"
    open(os.path.join(base + "_1", "f"), "w").close()
    assert utils.repeat_mk_dirs(base) == base + "_2"        # the first name not yet taken
    calls = []

    @utils.time_it("step")
    def step(x):
        calls.append(x)
        return x + 1

    utils.set_time_print(False)
    assert step(1) == 2 and capsys.readouterr().out == ""
    utils.set_time_print(True)
    try:
        assert step(2) == 3 and "step execute time" in capsys.readouterr().out
    finally:
        utils.set_time_print(False)
    assert step.count == 2 and calls == [1, 2]


def test_planner_config_loads_like_the_original():
    rel = "examples/corridor/diff/planner.yaml"
    mine, ref = load_planner_config(rel, ref_speed=3.0), j_load(rel, ref_speed=3.0)
    assert mine == ref and mine["ref_speed"] == 3.0
    assert set(mine) >= {"robot_kwargs", "ipath_kwargs", "pan_kwargs", "adjust_kwargs",
                         "train_kwargs", "receding"}
    assert "pan" not in mine and mine["train_kwargs"] == {}


def _native_or_skip():
    if not (native.available() and jnative.available()):
        pytest.skip("native library not built (sh native/build.sh)")


@pytest.mark.parametrize("offset_inverse,min_inclusive", [(False, False), (True, True)])
def test_native_scan_to_points_matches_the_numpy_path(offset_inverse, min_inclusive):
    _native_or_skip()
    rng = np.random.default_rng(0)
    n = 100
    ranges, velocity = rng.uniform(0.5, 10.0, n), rng.normal(size=(2, n))
    state, offset = np.array([[1.0], [2.0], [0.7]]), (0.1, -0.2, 0.3)
    args = (ranges, -np.pi, np.pi, 0.1, 10.0, (-np.pi, np.pi), 2, offset, state)
    kw = dict(velocity=velocity, offset_inverse=offset_inverse, min_inclusive=min_inclusive)
    pts, vels = native.scan_to_points(*args, **kw)
    pts_j, vels_j = jnative.scan_to_points(*args, **kw)
    np.testing.assert_array_equal(pts, pts_j)
    np.testing.assert_array_equal(vels, vels_j)

    angles = np.linspace(-np.pi, np.pi, n)
    keep = (ranges < 10.0 - 0.02) & ((ranges >= 0.1) if min_inclusive else (ranges > 0.1)) \
        & (angles > -np.pi) & (angles < np.pi)
    pa = np.vstack([ranges[keep] * np.cos(angles[keep]), ranges[keep] * np.sin(angles[keep])])
    s_t, s_R = utils.get_transform(np.c_[list(offset)])
    temp = s_R.T @ (pa - s_t) if offset_inverse else s_R @ pa + s_t
    t, R = utils.get_transform(state)
    np.testing.assert_allclose(pts, (R @ temp + t)[:, ::2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(vels, velocity[:, keep][:, ::2], rtol=0, atol=1e-12)


def test_native_raycast_and_closest_point_match():
    _native_or_skip()
    segs = np.array([[[4.9, -5.0], [4.9, 5.0]], [[-3.0, -1.0], [-3.0, 1.0]]])
    args = ((0.0, 0.0), 0.3, -np.pi, np.pi, 64, 0.1, 8.0, segs)
    (r, hit), (rj, hitj) = native.raycast(*args), jnative.raycast(*args)
    np.testing.assert_array_equal(r, rj)
    np.testing.assert_array_equal(hit, hitj)
    assert r.min() < 5.0 and r.max() == 8.0
    path = np.stack([np.linspace(0, 10, 101), np.zeros(101)])
    for start, xy in ((0, (2.52, 0.3)), (20, (2.0, 0.0)), (95, (11.0, 0.0))):
        assert native.closest_point_index(path, xy, start, 10, 0.1) == \
            jnative.closest_point_index(path, xy, start, 10, 0.1)
