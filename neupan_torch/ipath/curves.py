"""Curve generation for the initial path: line / Dubins / Reeds-Shepp.

Standalone replacement for the reference's external ``gctl`` dependency
(reference: blocks/initial_path.py:24,62,330-332 uses
``curve_generator.generate_curve(style, waypoints, interval, min_radius,
True)``).  Output format parity: a list of (4,1) numpy arrays
[x, y, theta, gear] with consecutive points spaced ~``interval`` apart and
gear = +1 forward / -1 reverse (Reeds-Shepp backward segments).

The Dubins and Reeds-Shepp word computations are implemented from the
classical formulas (Dubins 1957; Reeds & Shepp 1990) — pure host-side numpy.
"""

from __future__ import annotations

from math import atan2, cos, pi, sin, sqrt
from typing import List, Optional, Sequence

import numpy as np

from neupan_torch.utils import wrap_to_pi


def _col(x, y, theta, gear) -> np.ndarray:
    return np.array([[x], [y], [theta], [gear]], dtype=np.float64)


def _as_pose(wp) -> np.ndarray:
    arr = np.asarray(wp, dtype=np.float64).reshape(-1)
    if arr.shape[0] < 3:
        arr = np.concatenate([arr, np.zeros(3 - arr.shape[0])])
    return arr[:3]


# ---------------------------------------------------------------------------
# line
# ---------------------------------------------------------------------------

def line_curve(waypoints: Sequence, interval: float) -> List[np.ndarray]:
    """Straight segments between waypoints, theta = travel direction."""
    poses = [_as_pose(w) for w in waypoints]
    path: List[np.ndarray] = []
    for a, b in zip(poses[:-1], poses[1:]):
        seg = b[:2] - a[:2]
        dist = float(np.hypot(*seg))
        if dist < 1e-12:
            # duplicate waypoint (e.g. start state == first waypoint after
            # the prepend in init_path_with_state) — emit nothing
            continue
        theta = atan2(seg[1], seg[0])
        n = max(int(dist / max(interval, 1e-9)), 1)
        for i in range(n):
            t = i / n
            p = a[:2] + t * seg
            path.append(_col(p[0], p[1], theta, 1))
    last = poses[-1]
    prev_theta = path[-1][2, 0] if path else last[2]
    path.append(_col(last[0], last[1], prev_theta, 1))
    return path


# ---------------------------------------------------------------------------
# Dubins
# ---------------------------------------------------------------------------

def _mod2pi(x: float) -> float:
    return x % (2 * pi)


def _dubins_words(alpha: float, beta: float, d: float):
    """All six Dubins words in normalized coordinates.

    Returns list of (t, p, q, mode) with segment lengths in units of the
    turning radius; mode is a 3-char string over {L, S, R}.
    """
    sa, sb = sin(alpha), sin(beta)
    ca, cb = cos(alpha), cos(beta)
    c_ab = cos(alpha - beta)
    words = []

    # LSL
    tmp = d + sa - sb
    p_sq = 2 + d * d - 2 * c_ab + 2 * d * (sa - sb)
    if p_sq >= 0:
        theta = atan2(cb - ca, tmp)
        words.append((_mod2pi(-alpha + theta), sqrt(p_sq), _mod2pi(beta - theta), "LSL"))
    # RSR
    tmp = d - sa + sb
    p_sq = 2 + d * d - 2 * c_ab + 2 * d * (sb - sa)
    if p_sq >= 0:
        theta = atan2(ca - cb, tmp)
        words.append((_mod2pi(alpha - theta), sqrt(p_sq), _mod2pi(-beta + theta), "RSR"))
    # LSR
    p_sq = -2 + d * d + 2 * c_ab + 2 * d * (sa + sb)
    if p_sq >= 0:
        p = sqrt(p_sq)
        theta = atan2(-ca - cb, d + sa + sb) - atan2(-2.0, p)
        words.append((_mod2pi(-alpha + theta), p, _mod2pi(-_mod2pi(beta) + theta), "LSR"))
    # RSL
    p_sq = -2 + d * d + 2 * c_ab - 2 * d * (sa + sb)
    if p_sq >= 0:
        p = sqrt(p_sq)
        theta = atan2(ca + cb, d - sa - sb) - atan2(2.0, p)
        words.append((_mod2pi(alpha - theta), p, _mod2pi(beta - theta), "RSL"))
    # RLR
    tmp = (6.0 - d * d + 2 * c_ab + 2 * d * (sa - sb)) / 8.0
    if abs(tmp) <= 1.0:
        p = _mod2pi(2 * pi - np.arccos(tmp))
        theta = atan2(ca - cb, d - sa + sb)
        t = _mod2pi(alpha - theta + _mod2pi(p / 2.0))
        words.append((t, p, _mod2pi(alpha - beta - t + _mod2pi(p)), "RLR"))
    # LRL
    tmp = (6.0 - d * d + 2 * c_ab + 2 * d * (sb - sa)) / 8.0
    if abs(tmp) <= 1.0:
        p = _mod2pi(2 * pi - np.arccos(tmp))
        theta = atan2(-ca + cb, d + sa - sb)
        t = _mod2pi(-alpha + theta + _mod2pi(p / 2.0))
        words.append((t, p, _mod2pi(_mod2pi(beta) - alpha - t + _mod2pi(p)), "LRL"))
    return words


def _dubins_shortest(q0: np.ndarray, q1: np.ndarray, radius: float):
    dx, dy = q1[0] - q0[0], q1[1] - q0[1]
    D = sqrt(dx * dx + dy * dy)
    d = D / radius
    theta = atan2(dy, dx) if D > 1e-12 else 0.0
    alpha = _mod2pi(q0[2] - theta)
    beta = _mod2pi(q1[2] - theta)
    words = _dubins_words(alpha, beta, d)
    if not words:
        return None
    return min(words, key=lambda w: w[0] + w[1] + w[2])


def _integrate_word(q0: np.ndarray, word, radius: float, step: float,
                    reverse_gear: bool = False):
    """Sample poses along a Dubins/RS word.  Segments: (length, mode, gear)."""
    t, p, q, mode = word
    segs = [(t, mode[0]), (p, mode[1]), (q, mode[2])]
    poses = [(q0[0], q0[1], q0[2], 1.0)]
    x, y, th = q0[0], q0[1], q0[2]
    for length, m in segs:
        if length < 1e-12:
            continue
        arc = length * radius if m != "S" else length * radius
        n = max(int(arc / step), 1)
        for i in range(1, n + 1):
            ell = (length * i / n) * radius
            if m == "S":
                nx, ny, nth = x + ell * cos(th), y + ell * sin(th), th
            elif m == "L":
                nth = th + ell / radius
                nx = x + radius * (sin(nth) - sin(th))
                ny = y - radius * (cos(nth) - cos(th))
            else:  # R
                nth = th - ell / radius
                nx = x - radius * (sin(nth) - sin(th))
                ny = y + radius * (cos(nth) - cos(th))
            poses.append((nx, ny, nth, 1.0))
        # advance segment start
        ell = length * radius
        if m == "S":
            x, y = x + ell * cos(th), y + ell * sin(th)
        elif m == "L":
            nth = th + length
            x = x + radius * (sin(nth) - sin(th))
            y = y - radius * (cos(nth) - cos(th))
            th = nth
        else:
            nth = th - length
            x = x - radius * (sin(nth) - sin(th))
            y = y + radius * (cos(nth) - cos(th))
            th = nth
    return poses


def dubins_curve(waypoints: Sequence, interval: float, min_radius: float) -> List[np.ndarray]:
    """Piecewise-Dubins path through the waypoints (forward gear only)."""
    radius = max(min_radius, 1e-6)
    poses = [_as_pose(w) for w in waypoints]
    path: List[np.ndarray] = []
    for a, b in zip(poses[:-1], poses[1:]):
        word = _dubins_shortest(a, b, radius)
        if word is None:
            seg = line_curve([a, b], interval)
            path.extend(seg[:-1])
            continue
        samples = _integrate_word(a, word, radius, interval)
        for (x, y, th, g) in samples[:-1]:
            path.append(_col(x, y, wrap_to_pi(th), 1))
    last = poses[-1]
    path.append(_col(last[0], last[1], last[2], 1))
    return path


# ---------------------------------------------------------------------------
# Reeds-Shepp (via neupan_torch.ipath.reeds_shepp)
# ---------------------------------------------------------------------------

def reeds_curve(waypoints: Sequence, interval: float, min_radius: float) -> List[np.ndarray]:
    from neupan_torch.ipath.reeds_shepp import reeds_shepp_path

    radius = max(min_radius, 1e-6)
    poses = [_as_pose(w) for w in waypoints]
    path: List[np.ndarray] = []
    for a, b in zip(poses[:-1], poses[1:]):
        samples = reeds_shepp_path(a, b, radius, interval)
        for (x, y, th, g) in samples[:-1]:
            path.append(_col(x, y, wrap_to_pi(th), g))
    last = poses[-1]
    gear = path[-1][3, 0] if path else 1
    path.append(_col(last[0], last[1], last[2], gear))
    return path


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def generate_curve(style: str, waypoints: Sequence, interval: float,
                   min_radius: float = 0.0,
                   include_gear: bool = True) -> List[np.ndarray]:
    """gctl-compatible entry point: list of (4,1) [x, y, theta, gear]."""
    if len(waypoints) < 2:
        raise ValueError("need at least two waypoints")
    if style == "line":
        path = line_curve(waypoints, interval)
    elif style == "dubins":
        path = dubins_curve(waypoints, interval, min_radius)
    elif style in ("reeds", "reedsshepp", "reeds_shepp"):
        path = reeds_curve(waypoints, interval, min_radius)
    else:
        raise ValueError(f"unknown curve style: {style}")
    if not include_gear:
        path = [p[0:3] for p in path]
    return path
