"""Host-side helpers (own copies of ``neupan_tpu/utils``): timing, file
resolution, angle wrapping, rigid transforms, convex-polygon half-spaces and
decimation down-sampling, in plain numpy and Python; and ``profile_trace``,
the profiler hook (it imports torch when entered, not here).

The port cannot import ``neupan_tpu.utils``: importing any ``neupan_tpu``
module runs the package ``__init__``, which imports jax.
"""

from __future__ import annotations

import functools
import itertools
import os
import sys
import time
from contextlib import contextmanager
from math import cos, sin
from typing import Callable, Optional, Tuple

import numpy as np

# Process-global switch, mirrored by the planner's `time_print` YAML knob.
TIME_PRINT = False


def set_time_print(flag: bool) -> None:
    global TIME_PRINT
    TIME_PRINT = bool(flag)


def time_it(name: str = "Function") -> Callable:
    """Decorator printing wall-clock duration per call when TIME_PRINT is on."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            wrapper.count += 1
            start = time.perf_counter()
            result = func(*args, **kwargs)
            elapsed = time.perf_counter() - start
            if TIME_PRINT:
                print(f"{name} execute time {elapsed:.6f} seconds")
            return result

        wrapper.count = 0
        return wrapper

    return decorator


def file_check(file_name: Optional[str], root_path: Optional[str] = None) -> Optional[str]:
    """Resolve ``file_name`` against the script dir, cwd, and the repo root.

    Returns an absolute path to the first existing candidate, or raises
    FileNotFoundError listing the roots that were searched.
    """
    if file_name is None:
        return None

    if root_path is None:
        root_path = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))

    roots = ["", sys.path[0] if sys.path and sys.path[0] else None,
             os.getcwd(), root_path]
    tried = []
    for root in roots:
        if root is None:
            continue
        cand = os.path.join(root, file_name) if root else file_name
        tried.append(cand)
        if os.path.exists(cand):
            return os.path.abspath(cand)

    raise FileNotFoundError(f"File not found: {file_name} (searched {tried})")


def repeat_mk_dirs(path: str, max_num: int = 100) -> str:
    """Create ``path``; if it exists non-empty, create ``path_<k>`` instead."""
    if not os.path.isdir(path):
        os.makedirs(path)
        return path
    if not os.listdir(path):
        return path
    for k in itertools.count(1):
        cand = f"{path}_{k}"
        if not os.path.exists(cand):
            os.makedirs(cand)
            return cand
        if k >= max_num:
            os.makedirs(cand, exist_ok=True)
            return cand


def wrap_to_pi(rad, positive: bool = False):
    """Wrap angle(s) to [-pi, pi] via the atan2 identity (array-friendly)."""
    wrapped = np.arctan2(np.sin(rad), np.cos(rad))
    return np.abs(wrapped) if positive else wrapped


def get_transform(state: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """State [x, y, theta] (3,1) -> (translation (2,1), rotation (2,2)).

    A (2,1) state yields the identity rotation.
    """
    if state.shape == (2, 1):
        return state[0:2], np.eye(2)
    theta = state[2, 0]
    rot = np.array([[cos(theta), -sin(theta)], [sin(theta), cos(theta)]])
    return state[0:2], rot


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


def downsample_decimation(mat: np.ndarray, m: int) -> np.ndarray:
    """Uniformly subsample a (dim, n) matrix to m columns, keeping endpoints.

    Column i maps to index floor(i * (n-1) / (m-1)) — pure integer stride
    arithmetic, so the selection is deterministic across platforms. Returns
    the input unchanged when m >= n.
    """
    n = mat.shape[1]
    if m >= n:
        return mat
    if m <= 1:
        return mat[:, :1]
    idx = (np.arange(m) * (n - 1)) // (m - 1)
    return mat[:, idx]


@contextmanager
def profile_trace(log_dir: str = "/tmp/neupan_trace"):
    """Record the enclosed block with ``torch.profiler`` and write a
    Chrome/Perfetto trace (``<worker>.<ms>.pt.trace.json``) into
    ``log_dir``; yields ``log_dir``. The port's counterpart of the JAX
    package's ``jax.profiler`` hook, for per-kernel analysis: host activity
    always, the card's kernels where one is present (the card is
    synchronized before the profiler stops, so the block's last kernels are
    in the trace). View in Perfetto or ``chrome://tracing``.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize()
