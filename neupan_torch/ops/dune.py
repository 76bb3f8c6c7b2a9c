"""DUNE — the point encoder stage of the PAN step, fused exact-selection path.

Port of ``neupan_tpu/ops/dune.py:dune_forward_flow`` with the scenario batch
as a leading axis. The selection kernel (``ops/kernels/select.py``) ranks
every point of every horizon frame by its exact polygon distance and keeps
the K closest; the encoder then runs on those K points per frame only, and
lambda and the learned distance follow in closed form:

    mu = MLP(p0);  lam = -R G' mu;  d = mu'(G p0 - h).

Slots stay in the kernel's exact-distance order: the NRMP problem is
invariant to slot order, so there is no re-sort by learned distance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neupan_torch.ops.kernels.select import select_topk_flow

_INF = 1e9


class DuneOutput(NamedTuple):
    mu_k: torch.Tensor          # (B, T+1, E, K)
    lam_k: torch.Tensor         # (B, T+1, 2, K)
    points_k: torch.Tensor      # (B, T+1, 2, K) world-frame coordinates
    dist_k: torch.Tensor        # (B, T+1, K)
    valid_k: torch.Tensor       # (B, T+1, K) bool
    min_distance: torch.Tensor  # (B,) min distance at frame 0


def frame_transforms(nom_s: torch.Tensor):
    """World-from-robot rotations R_all (B, T+1, 2, 2) and translations
    trans (B, T+1, 2) of the nominal states nom_s (B, 3, T+1)."""
    theta = nom_s[:, 2, :]
    c, s = torch.cos(theta), torch.sin(theta)
    R_all = torch.stack([torch.stack([c, -s], dim=-1),
                         torch.stack([s, c], dim=-1)], dim=-2)
    return R_all, nom_s[:, 0:2, :].transpose(1, 2)


def dune_forward_flow(encoder, G: torch.Tensor, h: torch.Tensor,
                      points: torch.Tensor, velocities: torch.Tensor,
                      mask: torch.Tensor, nom_s: torch.Tensor, dt: float,
                      k: int, vertices: torch.Tensor) -> DuneOutput:
    """Fused exact-selection DUNE forward for a scenario batch.

    Args:
        encoder: the ObsPointNet mapping (..., 2) points to (..., E) duals.
        G (E, 2), h (E, 1), vertices (2, V): the robot polygon.
        points, velocities: (B, 2, P); mask: (B, P) bool.
        nom_s: (B, 3, T+1) nominal states; dt: step time; k: points per frame.
    """
    B, _, Tp1 = nom_s.shape
    E = G.shape[0]
    R_all, trans = frame_transforms(nom_s)

    with torch.no_grad():  # indices are piecewise constant in every input
        keys_k, idx = select_topk_flow(points, velocities, mask, R_all, trans, dt,
                                       vertices, G, h, k)
    valid_k = keys_k < _INF * 0.5

    # winners only: world-frame advance + robot-frame transform (B, T+1, 2, K)
    pv = torch.cat([points, velocities], dim=1)                  # (B, 4, P)
    flat = idx.reshape(B, 1, Tp1 * k).long().expand(B, 4, Tp1 * k)
    pvw = torch.gather(pv, 2, flat).reshape(B, 4, Tp1, k)
    ptsw, velw = pvw[:, :2], pvw[:, 2:]
    steps = torch.arange(Tp1, dtype=points.dtype, device=points.device) * dt
    p_glob_k = (ptsw + steps[None, None, :, None] * velw).transpose(1, 2)
    pf_k = torch.einsum("ntba,ntbk->ntak", R_all, p_glob_k - trans[:, :, :, None])

    mu_tk = encoder(pf_k.transpose(2, 3))                         # (B, T+1, K, E)

    RG = torch.einsum("ntab,eb->ntae", R_all, G)                  # (B, T+1, 2, E)
    lam_k = -torch.einsum("ntae,ntke->ntak", RG, mu_tk)
    Gp_k = torch.einsum("eb,ntbk->ntek", G, pf_k) - h.reshape(1, 1, E, 1)
    dist_k = torch.einsum("ntke,ntek->ntk", mu_tk, Gp_k)
    dist_k = torch.where(valid_k, dist_k, torch.full_like(dist_k, _INF))

    min_distance = torch.min(dist_k[:, 0], dim=-1).values
    return DuneOutput(mu_tk.transpose(2, 3), lam_k, p_glob_k, dist_k, valid_k,
                      min_distance)
