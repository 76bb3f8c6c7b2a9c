"""The traffic generator: the same seed gives the same inputs, consecutive
scans share most of their points, and it reads nothing the program makes."""

import ast
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import traffic as TR  # noqa: E402

SEEDS = (0, 7, 2 ** 31 + 11, 3 * 2 ** 40 + 5)


def lanes(seed, batch=6, P=96):
    return TR.Lanes(seed, batch, P, 10, 0.1, 4.0, (1.0, 9.0), "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_points(seed):
    a, b = lanes(seed), lanes(seed)
    for n in (0, 1, 17, 400):
        assert torch.equal(a.points(n), b.points(n))


def test_seeds_differ():
    pts = [lanes(s).points(3) for s in SEEDS]
    for i in range(len(pts)):
        for j in range(i):
            assert not torch.equal(pts[i], pts[j])


@pytest.mark.parametrize("seed", SEEDS)
def test_points_stay_in_the_field_and_move_back(seed):
    L = lanes(seed)
    for n in (0, 5, 123):
        p, q = L.points(n), L.points(n + 1)
        assert float(p.min()) >= 1.0 and float(p.max()) <= 9.0
        dx = q[:, 0] - p[:, 0]
        moved = torch.isclose(dx, torch.full_like(dx, -0.4), atol=1e-5)
        wrapped = dx > 0
        assert bool((moved | wrapped).all())
        # about one point in twenty passes behind the robot each step
        assert 0.0 < float(wrapped.float().mean()) < 0.15
        same_lane = moved & torch.eq(q[:, 1], p[:, 1])
        assert bool(torch.eq(same_lane, moved).all())


def test_a_sample_is_made_again_bit_for_bit():
    L = lanes(2 ** 31 + 3, batch=8)
    for n in (0, 9, 250):
        ids = [1, 4, 7]
        assert torch.equal(L.points_of(ids, n, "cpu"), L.points(n)[ids])


def test_the_checked_sample_is_drawn_from_the_seed():
    key = TR.seed_key(12345)
    a = [n for n in range(2000) if TR.is_sampled(key, n, 16)]
    assert a == [n for n in range(2000) if TR.is_sampled(TR.seed_key(12345), n, 16)]
    assert a[0] == 0 and 80 < len(a) < 180
    s = TR.sampled_scenarios(12345, 40, 8192, 64)
    assert len(set(s.tolist())) == 64 and list(s) == list(TR.sampled_scenarios(12345, 40, 8192, 64))


def test_the_generator_reads_nothing_of_the_program():
    path = os.path.join(ROOT, "benchmark", "harness", "traffic.py")
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert set(roots) <= {"numpy", "torch", "__future__"}, roots
