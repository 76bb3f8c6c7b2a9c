"""ObsPointNet — the DUNE point encoder as an ``nn.Module``.

2 -> 32 [LayerNorm, tanh] -> 32 [ReLU] -> 32 [LayerNorm, tanh] -> 32 [ReLU]
-> 32 [LayerNorm, tanh] -> E [ReLU]. The layers sit in an ``nn.Sequential``
named ``MLP`` at the reference indices (Linear at 0, 3, 5, 8, 10, 13;
LayerNorm at 1, 6, 11), so a reference ``.pth`` state dict loads with
``load_state_dict`` as it is. The JAX package's ``.npz`` checkpoints
(``w_i`` stored (in, out), ``ln{j}_scale``/``ln{j}_bias``) load through
``from_jax_params``; ``to_jax_params`` is its inverse, and
``save_checkpoint`` writes that dict as the JAX package does, so each
package loads the other's ``.npz``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from neupan_torch import resolve_device

HIDDEN_DIM = 32
_LINEAR_IDX = (0, 3, 5, 8, 10, 13)
_LN_IDX = (1, 6, 11)


class ObsPointNet(nn.Module):
    def __init__(self, input_dim: int = 2, output_dim: int = 4,
                 hidden_dim: int = HIDDEN_DIM):
        super().__init__()
        H = hidden_dim
        self.MLP = nn.Sequential(
            nn.Linear(input_dim, H), nn.LayerNorm(H, eps=1e-5), nn.Tanh(),
            nn.Linear(H, H), nn.ReLU(),
            nn.Linear(H, H), nn.LayerNorm(H, eps=1e-5), nn.Tanh(),
            nn.Linear(H, H), nn.ReLU(),
            nn.Linear(H, H), nn.LayerNorm(H, eps=1e-5), nn.Tanh(),
            nn.Linear(H, output_dim), nn.ReLU(),
        )

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """Map points (..., 2) to nonnegative duals mu (..., E)."""
        return self.MLP(points)

    @staticmethod
    def seeded(input_dim: int = 2, output_dim: int = 4, seed: int = 0,
               device=None) -> "ObsPointNet":
        """A randomly initialized encoder from a seeded ``torch.Generator``:
        uniform in +-1/sqrt(fan_in) for weights and biases, LayerNorm at
        one and zero (the JAX package's ``init_params`` distribution, not
        its numbers)."""
        dev = resolve_device(device)
        net = ObsPointNet(input_dim, output_dim)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for idx in _LINEAR_IDX:
                layer = net.MLP[idx]
                bound = 1.0 / np.sqrt(layer.in_features)
                for p in (layer.weight, layer.bias):
                    p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * bound)
        return net.to(dev).eval()

    @staticmethod
    def from_jax_params(params: Dict[str, np.ndarray], device=None) -> "ObsPointNet":
        """Build from the JAX package's parameter dict (numpy arrays)."""
        dev = resolve_device(device)
        w = [np.asarray(params[f"w{i}"], np.float32) for i in range(len(_LINEAR_IDX))]
        net = ObsPointNet(w[0].shape[0], w[-1].shape[1], w[0].shape[1])
        state = {}
        for i, idx in enumerate(_LINEAR_IDX):
            state[f"MLP.{idx}.weight"] = torch.tensor(w[i].T)
            state[f"MLP.{idx}.bias"] = torch.tensor(np.asarray(params[f"b{i}"], np.float32))
        for j, idx in enumerate(_LN_IDX):
            state[f"MLP.{idx}.weight"] = torch.tensor(np.asarray(params[f"ln{j}_scale"], np.float32))
            state[f"MLP.{idx}.bias"] = torch.tensor(np.asarray(params[f"ln{j}_bias"], np.float32))
        net.load_state_dict(state)
        return net.to(dev).eval()


def to_jax_params(net: ObsPointNet) -> Dict[str, np.ndarray]:
    """The JAX package's parameter dict of ``net`` (float32 numpy, ``w_i``
    stored (in, out)), in the order of its ``init_params``: the inverse of
    ``ObsPointNet.from_jax_params``."""
    seq, params = net.MLP, {}
    as_np = lambda t: t.detach().to("cpu", torch.float32).numpy().copy()
    for i, idx in enumerate(_LINEAR_IDX):
        params[f"w{i}"] = as_np(seq[idx].weight.T)
        params[f"b{i}"] = as_np(seq[idx].bias)
    for j, idx in enumerate(_LN_IDX):
        params[f"ln{j}_scale"] = as_np(seq[idx].weight)
        params[f"ln{j}_bias"] = as_np(seq[idx].bias)
    return params


def save_checkpoint(path: str, net: ObsPointNet) -> None:
    """Write ``net`` as a ``.npz`` that ``neupan_tpu.models.obs_point_net.
    load_checkpoint`` and ``load_checkpoint`` below both read."""
    np.savez(path, **to_jax_params(net))


def load_checkpoint(path: str, device=None) -> ObsPointNet:
    """Load an encoder from a JAX-package ``.npz`` or a reference ``.pth``."""
    dev = resolve_device(device)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return ObsPointNet.from_jax_params({k: data[k] for k in data.files}, dev)
    state = torch.load(path, map_location="cpu", weights_only=True)
    E = state[f"MLP.{_LINEAR_IDX[-1]}.weight"].shape[0]
    net = ObsPointNet(output_dim=E)
    net.load_state_dict(state)
    return net.to(dev).eval()
