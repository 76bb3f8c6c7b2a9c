"""Import guards and the refusals of ``run.py``: nothing in the benchmark, nor
what it loads of the program, is JAX or the JAX package; the reference
loads nothing of the program; without a card ``run.py`` prints no result."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "neupan_tpu"}
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs if f.endswith(".py"))


def roots(path):
    """Top-level names of every module that ``path`` imports, whole."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_the_reference_loads_nothing_of_the_program(path):
    assert roots(path) <= {"__future__", "dataclasses", "os", "typing", "numpy", "torch"}


def _python(args, cwd, timeout=300):
    # -I: no PYTHON* variables and no user site, so nothing imports jax on the run's behalf
    return subprocess.run([sys.executable, "-I", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_what_a_run_loads_holds_no_jax():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "import benchmark.run, benchmark.harness.runner, benchmark.harness.check\n"
            "import benchmark.harness.trace, benchmark.reference.step, benchmark.work.counts\n"
            "import neupan_torch, neupan_torch.parallel, neupan_torch.models, neupan_torch.ops.pan\n"
            "from benchmark.harness import cells\n"
            "for m in cells.manifest(benchmark.run.ROOT)['end_to_end'] + "
            "cells.manifest(benchmark.run.ROOT)['per_layer']:\n"
            "    cells.reader(benchmark.run.ROOT, m['name'])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(benchmark.run.FORBIDDEN)))\n")
    out = _python(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_names_compared_are_whole_top_level_names():
    # the port's name starts with the JAX package's, and is not it
    assert "neupan_torch".split(".")[0] not in FORBIDDEN


def test_run_refuses_without_a_card(tmp_path):
    """No card here: a non-zero exit, no result on standard output, no CPU run."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for a host without one")
    out = _python(["benchmark/run.py", "--workload", "diff-t10.fleet", "--seed", str(2 ** 31 + 9),
                   "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "not measured" in out.stderr


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _python(["benchmark/run.py", "--workload", "diff-t10.fleet", "--seed", "5",
                   "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_cache_is_a_fixed_path_inside_the_checkout():
    """The kernel caches and Python's bytecode go to fixed, ignored paths in the
    checkout, so that only a cell's first run there builds or compiles."""
    sys.path.insert(0, ROOT)
    from benchmark import run
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    for rel in [*run.CACHES.values(), run.PYCACHE]:
        assert not os.path.isabs(rel) and ".." not in rel.split("/")
        assert rel.split("/")[0] + "/" in ignored
