"""BENCHMARK.json keeps the contract's form, and every cell finds its files by name."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import cells as C  # noqa: E402

MAN = C.manifest(ROOT)
E2E = {m["name"]: m for m in MAN["end_to_end"]}
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[key]:
            yield key, entry["name"]
    for w in MAN["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in MAN["configs"]:
        for r in c["reduced"]:
            yield "reduced", r


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["command"]) <= 32
    assert MAN["paths"] == ["benchmark"]
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
        assert 1 <= len(word) <= 200


@pytest.mark.parametrize("kind,name", list(_names()))
def test_every_name_uses_the_allowed_characters(kind, name):
    assert C.NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_every_metric_is_well_formed_and_has_its_reader(metric):
    assert C.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    mod = C.reader(ROOT, metric["name"])
    assert (mod.UNIT, mod.SOURCE) == (metric["unit"], metric["source"])
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
        assert metric["moves"] in E2E
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_to_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    got = C.resolve(ROOT, cell["name"])
    assert got.config["name"] == cell["config"]
    assert {"batch", "field", "warmup_steps", "trace_steps", "check"} <= set(got.mix)
    assert "u_flip" in got.limits and "compared" in got.limits
    reported = {m["name"] for m in got.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert got.per_layer
    for m in got.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_its_own_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    with open(os.path.join(ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["source"] == config["source"]
    assert sorted(data["reduced"]) == sorted(config["reduced"])
    assert any(w["config"] == config["name"] for w in MAN["workloads"])


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
