"""Train a DUNE model for the default diff robot on the PyTorch port (the
counterpart of ``dune_train_diff.py``; imports no JAX).

    python examples/dune_train/dune_train_diff_torch.py [--device cpu]
        [--epoch N] [--data-size N] [--out DIR]

Reads ``dune_train_diff.yaml`` beside this file, builds the port's planner
from it (``direct_train``: a seeded encoder) and calls ``train_dune``,
which writes ``model_{i}.npz``, ``results.txt`` and ``train_dict.json``
under ``--out`` (default ``<cwd>/model/<model_name>``). The planner runs
on the CUDA card unless ``--device`` names another device.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from neupan_torch import NeuPan  # noqa: E402


def main(yaml_name: str, argv=None) -> str:
    """Train from ``yaml_name`` (a file beside this one) with the command
    line's overrides; returns the last checkpoint's path."""
    ap = argparse.ArgumentParser(description=f"DUNE training from {yaml_name}")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--epoch", type=int, default=None, help="epochs after the first")
    ap.add_argument("--data-size", type=int, default=None, help="labeled points")
    ap.add_argument("--out", default=None, help="checkpoint directory")
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in (("epoch", args.epoch), ("data_size", args.data_size),
                                   ("checkpoint_dir", args.out)) if v is not None}
    planner = NeuPan.init_from_yaml(os.path.join(HERE, yaml_name), device=args.device)
    return planner.train_dune(**overrides)


if __name__ == "__main__":
    main("dune_train_diff.yaml")
