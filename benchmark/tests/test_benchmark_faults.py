"""The output check fails a broken step and passes a sound one.

Each test drives a whole run of a cell (``run.measure``) on the CPU at a
size a test run holds (8 scenarios of 64 points, a one-second window, a
chain of three steps), skipping only the look for a card, with the cell's
own limits: the sound program comes out correct, and each fault planted in
the timed path comes out not correct. The faults: a step that returns its
state unchanged; half of the scenarios left out (their results copied from
the other half); the first action altered by 0.01 where the step returns
it.

``test_the_lower_precision_control_fails`` runs on the card only: the
program at ``precision="default"`` (TF32 matmuls) at 512 scenarios of the
cell's own point count."""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import benchmark.run as run  # noqa: E402
from benchmark.harness import cells as C  # noqa: E402
from benchmark.harness import runner as D  # noqa: E402

CELLS = [w["name"] for w in C.manifest(ROOT)["workloads"]]


def small(name, batch=8, P=64):
    cell = C.resolve(ROOT, name)
    cell.config = copy.deepcopy(cell.config)
    cell.mix = copy.deepcopy(cell.mix)
    cell.config["pan"]["dune_max_num"] = P
    cell.mix.update(batch=batch, warmup_steps=1, trace_steps=1)
    cell.mix["check"] = {"every": 2, "scenarios": batch, "block": 64, "chain": 3}
    return cell


def measure(name, device, fault=None, precision=None, seconds=1.0, **kw):
    quiet = lambda *a, **k: None
    return run.measure(ROOT, small(name, **kw), 2 ** 31 + 17, seconds, 0, torch.device(device),
                       precision=precision, fault=fault, log=quiet)


@pytest.mark.parametrize("fault", (None,) + D.FAULTS, ids=str)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault):
    result = measure(name, "cpu", fault=fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = C.resolve(ROOT, name)
    P = int(cell.config["pan"]["dune_max_num"])
    sound = measure(name, "cuda", seconds=3.0, batch=512, P=P)
    control = measure(name, "cuda", precision="default", seconds=3.0, batch=512, P=P)
    assert sound["correct"] and not control["correct"]
