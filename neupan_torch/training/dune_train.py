"""DUNE offline training (port of ``neupan_tpu/training/dune_train.py``).

The JAX trainer's observable behaviour, on the card by default: the same
defaults (100k points in [-25, 25]^2, batch 256, 5000 epochs, lr 5e-5
with weight decay 1e-4, lr x0.5 every 1500 epochs, validation every 100,
a checkpoint every 500), the same four-term MSE loss (mu, distance, fa
with one random rotation per batch, fb), the same optimizers and schedule
(``training/optim.py``), and the same files: ``train_dict.json``,
``results.txt``, ``model_{i}.npz`` (the JAX package's ``.npz``, which both
packages load) and, with ``save_loss``, ``loss.npy``.

The encoder is the ``ObsPointNet`` module, trained under autograd (the
fused MLP kernel has no backward pass, nor has the TPU kernel it
replaces); ``test`` evaluates it through the kernel under ``no_grad``.

An epoch makes no host synchronization: the permutation and the
rotations are drawn on the device, the loss terms are summed there and
read once per epoch (``run_epoch``), as the JAX trainer runs an epoch as
one ``lax.scan`` and returns only its four mean losses. ``run_epoch``
takes the permutation and the rotations as tensors, so a test can feed it
the JAX trainer's draws: ``jax.random`` cannot be reproduced in torch.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from neupan_torch import resolve_device
from neupan_torch.models.obs_point_net import ObsPointNet, save_checkpoint
from neupan_torch.ops.kernels.mlp import dune_mlp
from neupan_torch.training.labels import polygon_distance_labels
from neupan_torch.training.optim import Adam, exponential_decay

Data = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def rotation(theta: torch.Tensor) -> torch.Tensor:
    """[[cos, -sin], [sin, cos]] of a 0-dim angle."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def loss_terms_of(out_mu, batch_p, batch_mu, batch_d, G, h, R):
    """The four MSE terms of the encoder's output ``out_mu`` (B, E):
    mu, distance, fa = -(mu G) R' and fb = <fa, p> + mu h, each against the
    labels' own."""
    hv = h.reshape(-1)
    dist = torch.sum(out_mu * (batch_p @ G.T - hv), dim=1)
    mse_mu = torch.mean((out_mu - batch_mu) ** 2)
    mse_d = torch.mean((dist - batch_d) ** 2)

    fa_o = -(out_mu @ G) @ R.T                                  # (B, 2) = (-R G' mu)'
    fa_l = -(batch_mu @ G) @ R.T
    fb_o = torch.sum(fa_o * batch_p, dim=1) + out_mu @ hv
    fb_l = torch.sum(fa_l * batch_p, dim=1) + batch_mu @ hv
    mse_fa = torch.mean((fa_o - fa_l) ** 2)
    mse_fb = torch.mean((fb_o - fb_l) ** 2)
    return mse_mu, mse_d, mse_fa, mse_fb


def _loss_terms(net, batch_p, batch_mu, batch_d, G, h, R):
    """The four MSE terms of the encoder module on a batch
    (``neupan_tpu/training/dune_train.py:_loss_terms``)."""
    return loss_terms_of(net(batch_p), batch_p, batch_mu, batch_d, G, h, R)


def run_epoch(net: ObsPointNet, opt: Adam, data: Data, perm: torch.Tensor,
              thetas: torch.Tensor, G: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One epoch: ``len(thetas)`` updates of ``net`` in place, batch j the
    points ``perm[j * bs:(j + 1) * bs]`` rotated by ``thetas[j]``. Returns
    the four loss terms' means over the epoch, on the device (nothing here
    waits for the card)."""
    p_all, mu_all, d_all = data
    nb = thetas.shape[0]
    bs = perm.shape[0] // nb
    pb = p_all[perm].reshape(nb, bs, 2)
    mb = mu_all[perm].reshape(nb, bs, -1)
    db = d_all[perm].reshape(nb, bs)
    params = list(net.parameters())
    total = torch.zeros(4, dtype=torch.float32, device=p_all.device)
    for j in range(nb):
        terms = _loss_terms(net, pb[j], mb[j], db[j], G, h, rotation(thetas[j]))
        grads = torch.autograd.grad(sum(terms), params)
        opt.step(params, grads)
        total += torch.stack(terms).detach()
    return total / nb


@torch.no_grad()
def eval_losses(net: ObsPointNet, data: Data, theta: torch.Tensor, G, h) -> torch.Tensor:
    """The four loss terms of the module on a whole split under one
    rotation (the JAX trainer's validation)."""
    p_all, mu_all, d_all = data
    return torch.stack(_loss_terms(net, p_all, mu_all, d_all, G, h, rotation(theta)))


class DuneTrainer:
    """Offline trainer for one robot geometry (G, h) on ``device`` (the card
    unless another is named)."""

    def __init__(self, G, h, checkpoint_path: str, device=None):
        self.device = resolve_device(device)
        self.G = torch.as_tensor(np.asarray(G, np.float32), device=self.device)
        self.h = torch.as_tensor(np.asarray(h, np.float32), device=self.device)
        self.checkpoint_path = checkpoint_path
        os.makedirs(checkpoint_path, exist_ok=True)

    # ------------------------------------------------------------------

    def generate_dataset(self, data_size: int, data_range, generator: torch.Generator):
        """``data_size`` points uniform in ``data_range`` (x0, y0, x1, y1),
        drawn from ``generator`` on the trainer's device, and their labels:
        (points (N, 2), mu (N, E), d (N,))."""
        lo = torch.tensor(data_range[:2], dtype=torch.float32, device=self.device)
        hi = torch.tensor(data_range[2:], dtype=torch.float32, device=self.device)
        u = torch.rand((data_size, 2), generator=generator, device=self.device)
        pts = lo + (hi - lo) * u
        mu, d = polygon_distance_labels(self.G, self.h, pts)
        return pts, mu, d

    def draws(self, generator: torch.Generator, n: int, n_batches: int, batch_size: int):
        """One epoch's random draws on the device: the permutation of the
        ``n`` training points cut to whole batches, one rotation per batch
        and the validation's rotation."""
        perm = torch.randperm(n, generator=generator, device=self.device)[:n_batches * batch_size]
        thetas = 2 * math.pi * torch.rand(n_batches, generator=generator, device=self.device)
        theta_valid = 2 * math.pi * torch.rand((), generator=generator, device=self.device)
        return perm, thetas, theta_valid

    # ------------------------------------------------------------------

    def start(
        self,
        encoder: Optional[ObsPointNet] = None,
        data_size: int = 100000,
        data_range=(-25, -25, 25, 25),
        batch_size: int = 256,
        epoch: int = 5000,
        valid_freq: int = 100,
        save_freq: int = 500,
        lr: float = 5e-5,
        lr_decay: float = 0.5,
        decay_freq: int = 1500,
        save_loss: bool = False,
        seed: int = 0,
        optimizer: str = "adam_l2",
        **_: object,
    ):
        """Train ``encoder`` in place (a seeded init when None); returns
        (the trained encoder, the last checkpoint's path)."""
        # a YAML file gives "5e-5" as a string (YAML 1.1 floats need a dot)
        lr, lr_decay = float(lr), float(lr_decay)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        net = encoder if encoder is not None else ObsPointNet.seeded(
            2, self.G.shape[0], seed=seed, device=self.device)

        train_dict = dict(
            data_size=data_size, data_range=list(data_range),
            batch_size=batch_size, epoch=epoch, valid_freq=valid_freq,
            save_freq=save_freq, lr=lr, lr_decay=lr_decay,
            decay_freq=decay_freq,
            robot_G=self.G.cpu().numpy().tolist(),
            robot_h=self.h.cpu().numpy().tolist(),
        )
        with open(os.path.join(self.checkpoint_path, "train_dict.json"), "w") as f:
            json.dump(train_dict, f, indent=2)
        self._log(f"train config: {train_dict}")

        t0 = time.time()
        pts, mu, dist = self.generate_dataset(data_size, data_range, gen)
        n_train = int(data_size * 0.8)
        train = (pts[:n_train], mu[:n_train], dist[:n_train])
        valid = (pts[n_train:], mu[n_train:], dist[n_train:])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._log(f"dataset ({data_size} pts) labeled in {time.time()-t0:.2f}s")

        n_batches = max(n_train // batch_size, 1)
        sched = exponential_decay(lr, decay_freq * n_batches, lr_decay)
        opt = Adam(list(net.parameters()), sched, optimizer)

        progress, task = self._progress(epoch)
        full_model_name = None
        loss_list = []
        try:
            for i in range(epoch + 1):
                perm, thetas, theta_valid = self.draws(gen, n_train, n_batches, batch_size)
                tr = run_epoch(net, opt, train, perm, thetas, self.G, self.h).cpu().numpy()

                if i % valid_freq == 0:
                    va = eval_losses(net, valid, theta_valid, self.G, self.h).cpu().numpy()
                    cur_lr = float(sched(torch.tensor(i * n_batches)))
                    self._log(
                        f"Epoch {i}/{epoch} lr {cur_lr:.2e} | "
                        f"mu {tr[0]:.2e}/{va[0]:.2e} "
                        f"dist {tr[1]:.2e}/{va[1]:.2e} "
                        f"fa {tr[2]:.2e}/{va[2]:.2e} fb {tr[3]:.2e}/{va[3]:.2e}",
                        console=progress is None)

                if i % save_freq == 0:
                    full_model_name = os.path.join(self.checkpoint_path, f"model_{i}.npz")
                    save_checkpoint(full_model_name, net)

                loss_list.append(float(tr.sum()))
                if save_loss:
                    np.save(os.path.join(self.checkpoint_path, "loss.npy"),
                            np.asarray(loss_list))
                if progress is not None:
                    progress.update(task, advance=1,
                                    losses=f"mu {tr[0]:.1e} d {tr[1]:.1e} "
                                           f"fa {tr[2]:.1e} fb {tr[3]:.1e}")
        finally:
            if progress is not None:
                progress.stop()

        return net, full_model_name

    @staticmethod
    def _progress(epoch: int):
        """A rich progress bar when stdout is a terminal and rich imports
        (display only); results.txt is written either way."""
        try:
            if not sys.stdout.isatty():
                return None, None
            from rich.progress import BarColumn, Progress, TextColumn, TimeRemainingColumn

            progress = Progress(
                TextColumn("[bold]DUNE[/bold]"), BarColumn(),
                TextColumn("{task.completed}/{task.total}"),
                TimeRemainingColumn(),
                TextColumn("{task.fields[losses]}"))
            task = progress.add_task("train", total=epoch + 1, losses="")
            progress.start()
            return progress, task
        except Exception:
            return None, None

    # ------------------------------------------------------------------

    @torch.no_grad()
    def test(self, encoder: ObsPointNet, data_size_list: Sequence[int] = (1000,),
             data_range=(-25, -25, 25, 25), seed: int = 1):
        """Accuracy and latency of the encoder as the planner runs it: the
        fused MLP kernel (``dune_mlp``) on the card, its plain version on
        the CPU. Per data size: ms per call over 10 chained calls
        (each call's input depends on the previous output, timed by CUDA
        events on the card and the host clock on the CPU), the four loss
        terms of the kernel's output (no rotation) and its largest
        difference from ``encoder(points)``. Appends each result to
        ``test_results.txt``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        eye = torch.eye(2, device=self.device)
        cuda = self.device.type == "cuda"
        results, n_timing = [], 10
        for ds in data_size_list:
            pts, mu, dist = self.generate_dataset(ds, data_range, gen)
            out = dune_mlp(encoder, pts)                        # warm-up (the first pack)
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize(self.device)
                start.record()
            t0 = time.perf_counter()
            cur = pts
            for _ in range(n_timing):
                out = dune_mlp(encoder, cur)
                cur = pts + 1e-30 * out[:, :2]
            if cuda:
                end.record()
                torch.cuda.synchronize(self.device)
                ms = start.elapsed_time(end) / n_timing
            else:
                ms = (time.perf_counter() - t0) * 1e3 / n_timing
            out = dune_mlp(encoder, pts)
            losses = torch.stack(loss_terms_of(out, pts, mu, dist, self.G, self.h, eye)).cpu()
            err = float((out - encoder(pts)).abs().max())
            results.append(dict(data_size=ds, inference_time=ms / 1e3,
                                mu_loss=float(losses[0]), distance_loss=float(losses[1]),
                                fa_loss=float(losses[2]), fb_loss=float(losses[3]),
                                kernel_vs_module_max_abs=err, device=str(self.device)))
            with open(os.path.join(self.checkpoint_path, "test_results.txt"), "a") as f:
                print(results[-1], file=f)
        return results

    def _log(self, msg: str, console: bool = True):
        if console:
            print(msg)
        with open(os.path.join(self.checkpoint_path, "results.txt"), "a") as f:
            print(msg, file=f)
