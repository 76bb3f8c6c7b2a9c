"""The frozen work counts against hand counts at tiny shapes, and the
launches and shapes that the configurations give."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.work import counts as W  # noqa: E402


def shapes(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return W.Shapes(json.load(f))


def test_select_work_by_hand():
    # one point, one frame, V = E = 4, K = 1: flow 12, edges 80, faces 20, key 2, extraction 1
    assert W.select_work(1, 1, 1, 4, 4, 1) == (115, 17 + 20 + 8)
    assert W.select_work(3, 2, 5, 4, 4, 1)[0] == 3 * 2 * 5 * 115


def test_mlp_work_by_hand():
    w = W.mlp_work(1, 4)
    assert w["macs"] == 2 * 32 + 4 * 32 * 32 + 32 * 4 == 4288
    assert w["fp32"] == 3 * 5 * 32 + 2 * 32 + 4 + 3 * 32 * 9
    assert w["mufu"] == 3 * 32 * 2 + 3
    assert w["bytes"] == 6 * 4 + 9128 * 4


def test_sweep_work_by_hand():
    # n = 2: two pivots of 2 n^2 + n, 4 n scales, 5 n^2 scaling and unscaling
    assert W.sweep_work(1, 2) == (2 * 10 + 8 + 20, 2 * 4 * 4)


def test_admm_work_by_hand():
    # k = 2, m = 3, one iteration: 4 m k + 2 k^2 + 16 m + 6 k
    assert W.admm_work(1, 2, 3, 1) == (24 + 8 + 48 + 12, (4 + 6 + 6 + 24) * 4)
    assert W.admm_work(5, 2, 3, 7)[0] == 5 * 7 * 92


def test_polish_work_by_hand():
    # k = na = 1, no refinement: 3 + inv(1) + 2 + 2 + 1 + inv(1) + kkt, inv(1) = 9, kkt = 19
    assert W.polish_work(1, 1, 1, 0) == (45, 11 * 4)
    # each refinement adds 2 + 4 + 4 + 6 + kkt
    assert W.polish_work(1, 1, 1, 2)[0] == 45 + 2 * (16 + 19)


def test_bound():
    assert W.bound(W.PEAK_FLOPS, 0) == (1000.0, "operations")
    assert W.bound(0, W.PEAK_BYTES * 2) == (2000.0, "bytes")


@pytest.mark.parametrize("name,k,mr,na,n,m", [("diff-t10", 30, 148, 18, 63, 181),
                                             ("diff-t30", 90, 448, 58, 183, 541)])
def test_shapes_of_the_configurations(name, k, mr, na, n, m):
    sh = shapes(name)
    assert (sh.k, sh.mr, sh.na, sh.n, sh.m) == (k, mr, na, n, m)
    assert sh.admm_iters() == [120, 120, 60, 60]
    assert W.launches_per_step(sh) == {"select": 2, "mlp": 2, "sweep": 6, "admm": 4, "polish": 10}


def test_kernel_bounds_scale_with_the_batch():
    sh = shapes("diff-t10")
    one, many = W.kernel_bounds_ms(sh, 1), W.kernel_bounds_ms(sh, 512)
    assert many["admm"] == pytest.approx(512 * one["admm"])
    assert many["admm"] == pytest.approx(sum(W.bound(*W.admm_work(512, 30, 148, i))[0]
                                             for i in (120, 120, 60, 60)))
    assert many["polish"] == pytest.approx(10 * W.bound(*W.polish_work(512, 30, 18, 7))[0])


def test_step_flops_count_every_part():
    sh = shapes("diff-t10")
    f = W.step_flops(sh)
    assert set(f) == {"select", "encoder", "assembly", "inverses", "admm", "polish"}
    assert f["select"] == 2 * W.select_work(1, 11, 2048, 4, 4, 10)[0]
    assert f["admm"] == sum(W.admm_work(1, 30, 148, i)[0] for i in (120, 120, 60, 60))
    assert all(v > 0 for v in f.values())
