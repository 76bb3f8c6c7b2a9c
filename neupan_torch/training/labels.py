"""Ground-truth labels for DUNE training (port of ``neupan_tpu/training/labels.py``).

Each training point p is labelled with the optimum of

    max_mu  mu' (G p - h)   s.t.  ||G' mu|| <= 1,  mu >= 0

the dual of Euclidean projection onto the polygon {x : G x <= h}. Its
value is d*(p) = max(0, dist(p, polygon)) and mu* lives on the faces
active at the projection, so the labels come in closed form
(``polygon_distance_labels``), in one batched pass over all points. A
projected-gradient ascent on the same dual (``dual_ascent_labels``) is the
independent numerical cross-check.

The small linear systems (the E polygon vertices, one E x E ridge system
per point) go through ``torch.linalg.solve_ex``, which on a CUDA device
does not wait on the host to check its result as ``torch.linalg.solve``
does. Everything runs in float32 with TF32 off (``neupan_torch``
pins it): reduced-precision solves put about 1e-2 of noise into mu, which
makes the dataset unlearnable (``neupan_tpu/training/dune_train.py``).
"""

from __future__ import annotations

import torch


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A x = b for a batch of square A (..., n, n) and b (..., n)."""
    return torch.linalg.solve_ex(A, b.unsqueeze(-1))[0].squeeze(-1)


def polygon_vertices(G: torch.Tensor, h: torch.Tensor):
    """The polygon's vertices as edge segments: (starts, ends), each (E, 2);
    edge i runs from the intersection of faces i-1 and i to that of faces
    i and i+1."""
    hv = h.reshape(-1)
    A = torch.stack([G, G.roll(-1, 0)], dim=1)                 # (E, 2, 2): rows G_i, G_i+1
    verts = _solve(A, torch.stack([hv, hv.roll(-1)], dim=1))   # (E, 2)
    return verts.roll(1, 0), verts


def polygon_labels(G: torch.Tensor, h: torch.Tensor, points: torch.Tensor):
    """``polygon_distance_labels`` with the active faces: (mu (N, E),
    d (N,), active (N, E) bool), all zero for a point inside."""
    E, hv = G.shape[0], h.reshape(-1)
    a, b = polygon_vertices(G, h)
    inside = torch.all(points @ G.T - hv <= 0.0, dim=1)                      # (N,)

    # projection onto each edge segment
    ab = b - a                                                               # (E, 2)
    rel = points[:, None, :] - a                                             # (N, E, 2)
    t = torch.clamp(torch.sum(rel * ab, dim=2)
                    / torch.clamp(torch.sum(ab * ab, dim=1), min=1e-12), 0.0, 1.0)
    proj = a + t[:, :, None] * ab                                            # (N, E, 2)
    d2 = torch.sum((points[:, None, :] - proj) ** 2, dim=2)                  # (N, E)
    best = torch.argmin(d2, dim=1)
    rows = torch.arange(points.shape[0], device=points.device)
    cp = proj[rows, best]                                                    # (N, 2)
    dist = torch.sqrt(torch.clamp(d2[rows, best], min=1e-30))
    nu = (points - cp) / torch.clamp(dist, min=1e-12)[:, None]               # unit outward

    # mu on the active faces: min ||Ga' mu - nu||^2 with a ridge, where Ga is
    # G with the inactive rows zeroed
    act = torch.abs(cp @ G.T - hv) < 1e-4 * (1.0 + torch.abs(hv))            # (N, E)
    Ga = G * act[:, :, None]                                                 # (N, E, 2)
    M = Ga @ Ga.transpose(1, 2) + 1e-9 * torch.eye(E, dtype=G.dtype, device=G.device)
    mu = torch.clamp(_solve(M, (Ga @ nu[:, :, None]).squeeze(-1)) * act, min=0.0)

    out = ~inside
    return mu * out[:, None], torch.where(out, dist, 0.0), act & out[:, None]


def polygon_distance_labels(G: torch.Tensor, h: torch.Tensor, points: torch.Tensor):
    """Exact (mu*, d*) for a batch of points.

    Args:
        G: (E, 2), h: (E, 1) half-space description (CCW polygon).
        points: (N, 2), on G's device.
    Returns:
        mu: (N, E) optimal duals, d: (N,) optimal values.
    """
    mu, d, _ = polygon_labels(G, h, points)
    return mu, d


def _project_dual(mu: torch.Tensor, G: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Dykstra projection of each row of mu (N, E) onto {mu >= 0} and
    {||G' mu|| <= 1}, the ball approximated by scaling as in the JAX package."""
    p1 = torch.zeros_like(mu)
    p2 = torch.zeros_like(mu)
    for _ in range(iters):
        y = torch.clamp(mu + p1, min=0.0)
        p1 = mu + p1 - y
        nrm = torch.linalg.vector_norm((y + p2) @ G, dim=1, keepdim=True)
        m2 = (y + p2) * torch.where(nrm > 1.0, 1.0 / nrm, 1.0)
        p2 = y + p2 - m2
        mu = m2
    return torch.clamp(mu, min=0.0)


def dual_ascent_labels(G: torch.Tensor, h: torch.Tensor, points: torch.Tensor,
                       iters: int = 200, lr: float = 0.2):
    """Batched projected-gradient ascent on the dual (the numerical label
    path, independent of the geometric shortcut): (mu (N, E), d (N,))."""
    grad = points @ G.T - h.reshape(1, -1)                                   # (N, E) = (Gp - h)'
    mu = torch.zeros_like(grad)
    for _ in range(iters):
        mu = _project_dual(mu + lr * grad, G)
    return mu, torch.clamp(torch.sum(mu * grad, dim=1), min=0.0)
