"""YAML configuration loading for the planner facade (the port's own copy
of ``neupan_tpu/config.py``).

A planner YAML holds five sections — robot / ipath / pan / adjust / train —
plus top-level MPC keys (receding, step_time, ref_speed, device, time_print,
collision_threshold). Call-site kwargs override file values.

``yaml`` is imported inside ``load_planner_config``: only
``NeuPan.init_from_yaml`` needs it, and a planner built from kwargs (or from
a dict through ``planner_kwargs``) runs on a machine without pyyaml.
"""

from __future__ import annotations

from typing import Any, Dict

from neupan_torch.utils import file_check


def load_planner_config(yaml_file: str, **overrides) -> Dict[str, Any]:
    import yaml

    abs_path = file_check(yaml_file)
    with open(abs_path, "r") as f:
        config = yaml.safe_load(f) or {}
    return planner_kwargs(config, **overrides)


def planner_kwargs(config: Dict[str, Any], **overrides) -> Dict[str, Any]:
    """``NeuPan`` keyword arguments from a parsed planner YAML (a dict with
    the five sections and the top-level keys); ``overrides`` replace keys of
    the dict before the sections are renamed."""
    config = dict(config, **overrides)
    config["robot_kwargs"] = config.pop("robot", dict()) or dict()
    config["ipath_kwargs"] = config.pop("ipath", dict()) or dict()
    config["pan_kwargs"] = config.pop("pan", dict()) or dict()
    config["adjust_kwargs"] = config.pop("adjust", dict()) or dict()
    config["train_kwargs"] = config.pop("train", dict()) or dict()
    return config
