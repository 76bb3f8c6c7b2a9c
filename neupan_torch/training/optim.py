"""The DUNE trainer's optimizers, written out as optax forms them.

``neupan_tpu/training/dune_train.py`` builds two optax chains:

* ``adam_l2`` (the default): ``add_decayed_weights(1e-4)`` adds ``1e-4 * p``
  to the gradient, then ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8
  outside the square root, float32 bias corrections), then
  ``scale_by_learning_rate(schedule)``;
* ``adamw``: ``optax.adamw(schedule, weight_decay=1e-4)``, i.e.
  ``scale_by_adam``, then ``add_decayed_weights`` on the Adam direction,
  then the learning rate.

The schedule is ``optax.exponential_decay(lr, transition_steps,
decay_rate, staircase=True)``. As in optax the step count lives on the
device (an int32 tensor), so an update makes no host synchronization; the
update is in place under ``no_grad``, which bumps each parameter's version
counter (the fused MLP kernel repacks its weights on that). ``torch.optim``
is not used: its Adam orders the arithmetic otherwise than optax
(``neupan_torch/lon.py:LONTuner`` found the same).
"""

from __future__ import annotations

from typing import Sequence

import torch

OPTIMIZERS = ("adam_l2", "adamw")


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float):
    """``optax.exponential_decay(..., staircase=True)``: count -> learning
    rate, ``init_value * decay_rate ** floor(count / transition_steps)`` in
    float32, for an int tensor of update counts (0-based)."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        if transition_steps <= 0:
            return torch.full(count.shape, init_value, dtype=torch.float32, device=count.device)
        p = torch.floor(count.to(torch.float32) / transition_steps)
        return torch.where(count <= 0, init_value, init_value * torch.pow(decay_rate, p))

    return schedule


class Adam:
    """Adam with weight decay 1e-4, coupled (``adam_l2``) or decoupled
    (``adamw``), on a list of parameters."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Sequence[torch.Tensor], schedule, optimizer: str = "adam_l2",
                 weight_decay: float = 1e-4):
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got {optimizer!r}")
        self.schedule = schedule
        self.decoupled = optimizer == "adamw"
        self.weight_decay = weight_decay
        dev = params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        """One update of ``params`` in place from ``grads``."""
        step_size = -self.schedule(self.count)
        self.count += 1
        k = self.count.to(torch.float32)
        c1 = 1.0 - torch.pow(self.b1, k)
        c2 = 1.0 - torch.pow(self.b2, k)
        for i, (p, g) in enumerate(zip(params, grads)):
            if not self.decoupled:
                g = g + self.weight_decay * p
            self.mu[i] = (1.0 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1.0 - self.b2) * g ** 2 + self.b2 * self.nu[i]
            u = (self.mu[i] / c1) / (torch.sqrt(self.nu[i] / c2) + self.eps)
            if self.decoupled:
                u = u + self.weight_decay * p
            p.add_(u * step_size)
