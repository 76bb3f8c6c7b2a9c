"""Finding a cell's files by name, and the names' rules.

A cell of ``BENCHMARK.json`` names a configuration (``benchmark/configs/
<config>.json``) and a traffic mix (``benchmark/traffic/<traffic>.json``);
its output check reads ``benchmark/limits/<cell>.json``; each metric is a
reader of its own, ``benchmark/metrics/<metric>.py``. Adding a cell, a mix
or a metric is adding a file and an entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, "benchmark", *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list


def resolve(root: str, workload: str) -> Cell:
    """The cell ``workload`` of the manifest at ``root`` with its files."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    mine = lambda m: "workloads" not in m or workload in m["workloads"]
    return Cell(name=workload, chips=int(entry["chips"]),
                config=_json(root, "configs", f"{entry['config']}.json"),
                mix=_json(root, "traffic", f"{entry['traffic']}.json"),
                limits=_json(root, "limits", f"{workload}.json"),
                end_to_end=[m for m in man["end_to_end"] if mine(m)],
                per_layer=[m for m in man["per_layer"] if mine(m)])


def reader(root: str, metric: str):
    """The module ``benchmark/metrics/<metric>.py``: UNIT, SOURCE, LAYER,
    MOVES and ``read(run)``, which returns the value or None where the run
    has nothing to read."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
