"""Numpy geometry helpers (own copies of ``neupan_tpu/utils``).

The port cannot import ``neupan_tpu.utils``: importing any ``neupan_tpu``
module runs the package ``__init__``, which imports jax.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def wrap_to_pi(rad, positive: bool = False):
    """Wrap angle(s) to [-pi, pi] via the atan2 identity (array-friendly)."""
    wrapped = np.arctan2(np.sin(rad), np.cos(rad))
    return np.abs(wrapped) if positive else wrapped


def _edge_turns(vertex: np.ndarray) -> np.ndarray:
    """z-components of consecutive-edge cross products for a (2, N) polygon."""
    edges = np.roll(vertex, -1, axis=1) - vertex
    nxt = np.roll(edges, -1, axis=1)
    return edges[0] * nxt[1] - edges[1] * nxt[0]


def is_convex_and_ordered(points: np.ndarray) -> Tuple[bool, Optional[str]]:
    """Convexity + winding of a (2, N) polygon: (True, 'CCW'|'CW') or (False, None)."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[0] != 2 or pts.shape[1] < 3:
        return False, None
    turns = _edge_turns(pts)
    has_left, has_right = bool(np.any(turns > 0)), bool(np.any(turns < 0))
    if has_left == has_right:
        return False, None
    return True, "CCW" if has_left else "CW"


def gen_inequal_from_vertex(vertex: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Convex polygon (2, N) -> half-space description G x <= h.

    CW input is rewound to CCW about its first vertex. For CCW edges e_i
    the outward normal is (e_y, -e_x); h pins each face to its base vertex.
    Raises ValueError on non-convex input.
    """
    pts = np.asarray(vertex, dtype=np.float64)
    convex, winding = is_convex_and_ordered(pts)
    if not convex:
        raise ValueError("The polygon constructed by vertex is not convex.")
    if winding == "CW":
        pts = np.concatenate([pts[:, :1], pts[:, :0:-1]], axis=1)
    edges = np.roll(pts, -1, axis=1) - pts
    G = np.stack([edges[1], -edges[0]], axis=1)
    h = np.einsum("nd,dn->n", G, pts)[:, None]
    return G, h
