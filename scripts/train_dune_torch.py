"""Train DUNE checkpoints for the standard robot geometries on the PyTorch port.

The counterpart of ``scripts/train_dune_tpu.py``: the same three
geometries, hyperparameters and deploy gate, on the CUDA card unless
``--device`` names another device. Imports no JAX.

    python scripts/train_dune_torch.py [diff|acker|polygon|all] [epochs]
        [--out DIR] [--device DEV] [--valid-freq N]

Writes only under ``--out`` (default ``build/dune_train``, which git
ignores): per geometry ``<out>/<name>/`` gets the trainer's
``model_{i}.npz``, ``results.txt`` and ``train_dict.json``, and
``model.npz`` when the holdout gate passes. ``--valid-freq`` sets the
epochs between logged losses (the TPU script's rule by default: epochs /
20, at most 100), e.g. 100 to log the lines of the JAX record's
``results.txt``. The shipped checkpoints under
``examples/model/`` are the JAX package's and are never written here.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from neupan_torch.models import save_checkpoint  # noqa: E402
from neupan_torch.robot import Robot  # noqa: E402
from neupan_torch.training import DuneTrainer, polygon_distance_labels  # noqa: E402

GEOMETRIES = {
    "diff_robot_default": dict(kinematics="diff", length=1.6, width=2.0,
                               max_speed=[8, 1], max_acce=[8, 3]),
    "acker_robot_default": dict(kinematics="acker", length=4.6, width=1.6,
                                wheelbase=3.0, max_speed=[8, 1],
                                max_acce=[8, 1]),
    "polygon_robot": dict(kinematics="diff",
                          vertices=[[-0.8, -1.0], [-1.8, 1.0], [1.8, 1.0],
                                    [0.8, -1.0]],
                          max_speed=[8, 3], max_acce=[8, 3]),
}
SHORT = {"diff": "diff_robot_default", "acker": "acker_robot_default", "polygon": "polygon_robot"}
HOLDOUT, HOLDOUT_SEED = 20000, 123
# the deploy gate: an order of magnitude above reference-class quality
# (mu ~1e-5, dist ~1e-4), so a run stuck on the loss's constant-function
# plateau is never deployed
GATE_MU, GATE_DIST = 1e-4, 5e-3


def train(name: str, epochs: int, out: str, device=None, valid_freq=None) -> bool:
    out_dir = os.path.join(out, name)
    robot = Robot.create(receding=10, step_time=0.1, **GEOMETRIES[name])
    trainer = DuneTrainer(robot.G, robot.h, out_dir, device=device)
    # the reference trainer's published hyperparameters, cut to the run's length
    t0 = time.time()
    encoder, ckpt = trainer.start(data_size=100000, epoch=epochs, batch_size=256,
                                  valid_freq=valid_freq or min(100, max(epochs // 20, 1)),
                                  save_freq=min(500, max(epochs // 4, 1)),
                                  lr=5e-5, lr_decay=0.5,
                                  decay_freq=min(1500, max(epochs // 3, 1)))
    dev = trainer.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)

    gen = torch.Generator(device=dev).manual_seed(HOLDOUT_SEED)
    G, h = trainer.G, trainer.h
    with torch.no_grad():
        pts = -25.0 + 50.0 * torch.rand((HOLDOUT, 2), generator=gen, device=dev)
        mu_l, d_l = polygon_distance_labels(G, h, pts)
        mu_o = encoder(pts)
        d_o = torch.sum(mu_o * (pts @ G.T - h.reshape(1, -1)), dim=1)
        mu_mse = float(torch.mean((mu_o - mu_l) ** 2))
        d_mse = float(torch.mean((d_o - d_l) ** 2))
    ok = mu_mse < GATE_MU and d_mse < GATE_DIST
    trainer._log(f"[{name}] trained {epochs} epochs in {wall:.1f}s ({where}); "
                 f"holdout mu_mse={mu_mse:.2e} dist_mse={d_mse:.2e} "
                 f"gate={'PASS' if ok else 'FAIL'}")
    if not ok:
        trainer._log(f"[{name}] NOT deploying: quality gate failed "
                     f"(last checkpoint kept at {ckpt})")
        return False
    final = os.path.join(out_dir, "model.npz")
    save_checkpoint(final, encoder)
    trainer._log(f"[{name}] deployed checkpoint: {final}")
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all", help="diff, acker, polygon or all")
    ap.add_argument("epochs", nargs="?", type=int, default=1000)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "dune_train"))
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--valid-freq", type=int, default=None,
                    help="epochs between logged validations (default: epochs / 20, at most 100)")
    args = ap.parse_args(argv)
    names = list(GEOMETRIES) if args.which == "all" else [SHORT.get(args.which, args.which)]
    for n in names:
        train(n, args.epochs, args.out, args.device, args.valid_freq)


if __name__ == "__main__":
    main()
