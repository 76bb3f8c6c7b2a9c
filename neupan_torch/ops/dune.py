"""DUNE — the point encoder stage of the PAN step.

Port of ``neupan_tpu/ops/dune.py`` with the scenario batch as a leading
axis. Every path maps obstacle points in the robot frames of the horizon to
the K closest per frame with their duals:

    mu = MLP(p0);  lam = -R G' mu;  d = mu'(G p0 - h).

* ``dune_forward_flow``: the fused exact-selection path. The selection
  kernel (``ops/kernels/select.py:select_topk_flow``) builds the point flow
  itself, ranks every point of every frame by its exact polygon distance
  and keeps the K closest; the encoder runs on those K only. Slots stay in
  exact-distance order: the NRMP problem is invariant to slot order.
* ``generate_point_flow`` + ``dune_forward``: the materialized paths. The
  per-frame point flow is written to memory; ``select="exact"`` ranks it by
  the exact polygon distance (by ``select_topk`` with ``use_kernel``, else
  by ``signed_polygon_distance`` and a stable sort) and re-sorts the K
  slots by the learned distance; ``select="mlp"`` is the reference-parity
  ranking by the learned distance, which pays the encoder on all P points.
  ``mlp_kernel`` routes the encoder through the fused MLP kernel
  (``ops/kernels/mlp.py``).

Ties go to the lower index everywhere (stable sorts, argmin rounds), as
``lax.top_k`` and ``jnp.argsort`` break them: masked points all share the
key 1e9, so every scenario with fewer than K valid points has ties.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from neupan_torch.ops.kernels.mlp import dune_mlp
from neupan_torch.ops.kernels.select import select_topk, select_topk_flow

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
                      k: int, vertices: torch.Tensor,
                      mlp_kernel: bool = False) -> DuneOutput:
    """Fused exact-selection DUNE forward for a scenario batch.

    Args:
        encoder: the ObsPointNet mapping (..., 2) points to (..., E) duals.
        G (E, 2), h (E, 1), vertices (2, V): the robot polygon.
        points, velocities: (B, 2, P); mask: (B, P) bool.
        nom_s: (B, 3, T+1) nominal states; dt: step time; k: points per frame.
        mlp_kernel: run the encoder on the winners through the fused MLP
            kernel (the JAX function's ``mlp_pallas``).
    """
    B, _, Tp1 = nom_s.shape
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

    mu_tk = _run_encoder(encoder, pf_k.transpose(2, 3), mlp_kernel)  # (B, T+1, K, E)
    lam_k, dist_k = _lam_and_distance(mu_tk, pf_k, R_all, G, h)
    dist_k = torch.where(valid_k, dist_k, torch.full_like(dist_k, _INF))

    min_distance = torch.min(dist_k[:, 0], dim=-1).values
    return DuneOutput(mu_tk.transpose(2, 3), lam_k, p_glob_k, dist_k, valid_k,
                      min_distance)


def _run_encoder(encoder, pts: torch.Tensor, mlp_kernel: bool) -> torch.Tensor:
    """mu (..., E) of points (..., 2), through the fused kernel or the module."""
    if mlp_kernel:
        return dune_mlp(encoder, pts.contiguous())
    return encoder(pts)


def _lam_and_distance(mu: torch.Tensor, pf: torch.Tensor, R_all: torch.Tensor,
                      G: torch.Tensor, h: torch.Tensor):
    """lam = -R G' mu (B, T+1, 2, N) and d = mu'(G p0 - h) (B, T+1, N) of
    mu (B, T+1, N, E) at the robot-frame points pf (B, T+1, 2, N).

    Broadcast products summed over E and over the two coordinates: as
    batched products, (2 x E)(E x N) per frame, cuBLAS runs them as a gemv
    five times slower at N = 2048, B = 512 (scripts/exp_dune_glue_timing.py)."""
    mu_t = mu.transpose(2, 3)                                     # (B, T+1, E, N)
    RG = torch.einsum("ntab,eb->ntae", R_all, G)                  # (B, T+1, 2, E)
    lam = -(RG[..., None] * mu_t[:, :, None]).sum(dim=3)
    Gp = (G[:, :, None] * pf[:, :, None]).sum(dim=3) - h.reshape(1, 1, -1, 1)
    return lam, (mu_t * Gp).sum(dim=2)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Columns idx (B, T+1, K) of arr (B, T+1, C, P) per frame: (B, T+1, C, K)."""
    return torch.gather(arr, 3, idx[:, :, None, :].expand(-1, -1, arr.shape[2], -1))


def signed_polygon_distance(vertices: torch.Tensor, G: torch.Tensor, h: torch.Tensor,
                            points: torch.Tensor) -> torch.Tensor:
    """Exact signed Euclidean distance from points to a convex polygon.

    The encoder is trained to reproduce this quantity. Outside points: the
    distance to the nearest edge segment; inside points: the (negative)
    largest normalized face margin.

    Args:
        vertices: (2, V) polygon vertices, CCW; G (E, 2), h (E, 1): its
            half-spaces G x <= h, rows matching the edges.
        points: (..., 2, P).
    Returns:
        (..., P) signed distances, negative inside.
    """
    v0 = vertices
    e = torch.roll(vertices, -1, dims=1) - v0                      # (2, V)
    ee = torch.clamp(torch.sum(e * e, dim=0), min=1e-12)           # (V,)

    pv = points[..., :, None, :] - v0[:, :, None]                  # (..., 2, V, P)
    t = torch.clamp(torch.sum(pv * e[:, :, None], dim=-3) / ee[:, None], 0.0, 1.0)
    diff = pv - e[:, :, None] * t[..., None, :, :]
    d_out = torch.sqrt(torch.min(torch.sum(diff * diff, dim=-3), dim=-2).values + 1e-30)

    g_norm = torch.sqrt(torch.sum(G * G, dim=1))                   # (E,)
    marg = (torch.einsum("eb,...bp->...ep", G, points)
            - h.reshape(-1)[:, None]) / g_norm[:, None]
    d_in = torch.max(marg, dim=-2).values                          # <= 0 inside
    return torch.where(d_in <= 0.0, d_in, d_out)


def generate_point_flow(nom_s: torch.Tensor, points: torch.Tensor,
                        velocities: torch.Tensor, dt: float):
    """Advance points by their velocity per frame and express them in the
    robot frames: frame i sees p + i dt v, transformed by p0 = R_i'(p - t_i).

    Args:
        nom_s: (B, 3, T+1) nominal states; points, velocities: (B, 2, P).
    Returns:
        point_flow (B, T+1, 2, P), R_all (B, T+1, 2, 2), points_glob
        (B, T+1, 2, P), each contiguous.
    """
    Tp1 = nom_s.shape[-1]
    steps = torch.arange(Tp1, dtype=points.dtype, device=points.device).reshape(1, Tp1, 1, 1)
    points_glob = points[:, None] + steps * (velocities[:, None] * dt)
    R_all, trans = frame_transforms(nom_s)
    point_flow = torch.einsum("ntba,ntbp->ntap", R_all, points_glob - trans[:, :, :, None])
    return point_flow.contiguous(), R_all, points_glob


def dune_forward(encoder, G: torch.Tensor, h: torch.Tensor, point_flow: torch.Tensor,
                 R_all: torch.Tensor, points_glob: torch.Tensor, mask: torch.Tensor,
                 k: int, use_kernel: bool = False, select: str = "mlp",
                 vertices: Optional[torch.Tensor] = None,
                 mlp_kernel: Optional[bool] = None) -> DuneOutput:
    """Map a materialized point flow to the duals of the k closest points.

    Args:
        point_flow, points_glob: (B, T+1, 2, P); R_all: (B, T+1, 2, 2);
            mask: (B, P) bool (``generate_point_flow``'s outputs).
        select: ``"mlp"`` ranks by the learned distance, the encoder running
            on every point; ``"exact"`` ranks by the exact polygon distance
            (needs ``vertices``) and runs the encoder on the k winners, whose
            slots are then re-sorted by the learned distance.
        use_kernel: with ``"exact"``, rank through the selection kernel
            (``select_topk``) instead of ``signed_polygon_distance`` and a
            sort; the JAX function's ``use_pallas``.
        mlp_kernel: run the encoder through the fused MLP kernel; ``None``
            inherits ``use_kernel``. The JAX function's ``mlp_pallas``.

    The selection runs without gradients (indices are piecewise constant in
    every input); the gathers that follow carry them.
    """
    if select not in ("mlp", "exact"):
        raise ValueError(f'select must be "mlp" or "exact", got {select!r}')
    if mlp_kernel is None:
        mlp_kernel = use_kernel
    inf = lambda t: torch.full_like(t, _INF)

    if select == "exact":
        if vertices is None:
            raise ValueError('select="exact" requires polygon vertices')
        with torch.no_grad():
            if use_kernel:
                keys_k, idx = select_topk(point_flow, mask, vertices, G, h, k)
                valid_k = keys_k < _INF * 0.5
                idx = idx.long()
            else:
                d_sel = signed_polygon_distance(vertices, G, h, point_flow)
                masked_sel = torch.where(mask[:, None, :], d_sel, inf(d_sel))
                top, idx = torch.sort(masked_sel, dim=-1, stable=True)
                valid_k, idx = top[..., :k] < _INF * 0.5, idx[..., :k]

        pf_k = _take(point_flow, idx)                              # (B, T+1, 2, K)
        mu_tk = _run_encoder(encoder, pf_k.transpose(2, 3), mlp_kernel)
        lam_k, dist_k = _lam_and_distance(mu_tk, pf_k, R_all, G, h)
        dist_k = torch.where(valid_k, dist_k, inf(dist_k))

        # slots ascending by the learned distance, as the reference keeps them
        with torch.no_grad():
            order = torch.sort(dist_k, dim=-1, stable=True).indices
        dist_k = torch.gather(dist_k, -1, order)
        valid_k = torch.gather(valid_k, -1, order)
        mu_k = _take(mu_tk.transpose(2, 3), order)
        lam_k = _take(lam_k, order)
        points_k = _take(points_glob, torch.gather(idx, -1, order))
        min_distance = torch.min(dist_k[:, 0], dim=-1).values
        return DuneOutput(mu_k, lam_k, points_k, dist_k, valid_k, min_distance)

    mu = _run_encoder(encoder, point_flow.transpose(2, 3), mlp_kernel)  # (B, T+1, P, E)
    lam, dist = _lam_and_distance(mu, point_flow, R_all, G, h)
    masked_dist = torch.where(mask[:, None, :], dist, inf(dist))
    min_distance = torch.min(masked_dist[:, 0], dim=-1).values

    with torch.no_grad():
        idx = torch.sort(masked_dist, dim=-1, stable=True).indices[..., :k]
    dist_k = torch.gather(masked_dist, -1, idx)
    valid_k = dist_k < _INF * 0.5
    return DuneOutput(_take(mu.transpose(2, 3), idx), _take(lam, idx),
                      _take(points_glob, idx), dist_k, valid_k, min_distance)
