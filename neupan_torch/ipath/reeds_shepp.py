"""Reeds-Shepp shortest paths (forward + reverse motion with gear flags).

Classical closed-form word computation (Reeds & Shepp, "Optimal paths for a
car that goes both forwards and backwards", Pacific J. Math, 1990) covering
the CSC / CCC / CCCC / CCSC / CCSCC families through the usual timeflip /
reflect transforms.  Host-side numpy; used by ipath/curves.py for the
``reeds`` curve style (reference uses gctl for this,
initial_path.py:330-332), enabling reverse-parking scenarios.

Sampling yields (x, y, theta, gear) tuples with gear = +1 forward,
-1 backward — the gear flag drives the reference-speed sign and the
path-splitting logic in the initial-path subsystem.
"""

from __future__ import annotations

from math import atan2, cos, pi, sin, sqrt
from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class RSWord(NamedTuple):
    lengths: Tuple[float, ...]   # signed segment lengths (radius units)
    course: Tuple[str, ...]      # 'L' | 'S' | 'R' per segment


def _mod2pi(x: float) -> float:
    v = x % (2 * pi)
    if v > pi:
        v -= 2 * pi
    return v


def _polar(x: float, y: float) -> Tuple[float, float]:
    return sqrt(x * x + y * y), atan2(y, x)


def _tw(u: float, u1: float, xi: float, eta: float, phi: float):
    """tauOmega helper used by the CCCC family."""
    delta = _mod2pi(u - u1)
    A = sin(u) - sin(delta)
    B = cos(u) - cos(delta) - 1.0
    t1 = atan2(eta * A - xi * B, xi * A + eta * B)
    t2 = 2.0 * (cos(delta) - cos(u1) - cos(u)) + 3.0
    tau = _mod2pi(t1 + pi) if t2 < 0 else _mod2pi(t1)
    omega = _mod2pi(tau - u + u1 - phi)
    return tau, omega


# ---- base words (each returns (ok, t, u, v)) ------------------------------

def _LpSpLp(x, y, phi):
    u, t = _polar(x - sin(phi), y - 1.0 + cos(phi))
    if t >= -1e-12:
        v = _mod2pi(phi - t)
        if v >= -1e-12:
            return True, t, u, v
    return False, 0.0, 0.0, 0.0


def _LpSpRp(x, y, phi):
    u1, t1 = _polar(x + sin(phi), y - 1.0 - cos(phi))
    if u1 * u1 >= 4.0:
        u = sqrt(u1 * u1 - 4.0)
        theta = atan2(2.0, u)
        t = _mod2pi(t1 + theta)
        v = _mod2pi(t - phi)
        if t >= -1e-12 and v >= -1e-12:
            return True, t, u, v
    return False, 0.0, 0.0, 0.0


def _LpRmL(x, y, phi):
    xi = x - sin(phi)
    eta = y - 1.0 + cos(phi)
    u1, theta = _polar(xi, eta)
    if u1 <= 4.0:
        u = -2.0 * np.arcsin(0.25 * u1)
        t = _mod2pi(theta + 0.5 * u + pi)
        v = _mod2pi(phi - t + u)
        if t >= -1e-12 and u <= 1e-12:
            return True, t, u, v
    return False, 0.0, 0.0, 0.0


def _LpRupLumRm(x, y, phi):
    xi = x + sin(phi)
    eta = y - 1.0 - cos(phi)
    rho = 0.25 * (2.0 + sqrt(xi * xi + eta * eta))
    if rho <= 1.0:
        u = np.arccos(rho)
        t, v = _tw(u, -u, xi, eta, phi)
        if t >= -1e-12 and v <= 1e-12:
            return True, t, u, v
    return False, 0.0, 0.0, 0.0


def _LpRumLumRp(x, y, phi):
    xi = x + sin(phi)
    eta = y - 1.0 - cos(phi)
    rho = (20.0 - xi * xi - eta * eta) / 16.0
    if 0.0 <= rho <= 1.0:
        u = -np.arccos(rho)
        if u >= -0.5 * pi:
            t, v = _tw(u, u, xi, eta, phi)
            if t >= -1e-12 and v >= -1e-12:
                return True, t, u, v
    return False, 0.0, 0.0, 0.0


def _LpRmSmLm(x, y, phi):
    xi = x - sin(phi)
    eta = y - 1.0 + cos(phi)
    rho, theta = _polar(xi, eta)
    if rho >= 2.0:
        r = sqrt(rho * rho - 4.0)
        u = 2.0 - r
        t = _mod2pi(theta + atan2(r, -2.0))
        v = _mod2pi(phi - 0.5 * pi - t)
        if t >= -1e-12 and u <= 1e-12 and v <= 1e-12:
            return True, t, u, v
    return False, 0.0, 0.0, 0.0


def _LpRmSmRm(x, y, phi):
    xi = x + sin(phi)
    eta = y - 1.0 - cos(phi)
    rho, theta = _polar(-eta, xi)
    if rho >= 2.0:
        t = theta
        u = 2.0 - rho
        v = _mod2pi(t + 0.5 * pi - phi)
        if t >= -1e-12 and u <= 1e-12 and v <= 1e-12:
            return True, t, u, v
    return False, 0.0, 0.0, 0.0


def _LpRmSmLmRp(x, y, phi):
    xi = x + sin(phi)
    eta = y - 1.0 - cos(phi)
    rho, _ = _polar(xi, eta)
    if rho >= 2.0:
        u = 4.0 - sqrt(rho * rho - 4.0)
        if u <= 1e-12:
            t = _mod2pi(
                atan2((4.0 - u) * xi - 2.0 * eta, -2.0 * xi + (u - 4.0) * eta)
            )
            v = _mod2pi(t - phi)
            if t >= -1e-12 and v >= -1e-12:
                return True, t, u, v
    return False, 0.0, 0.0, 0.0


# ---- enumeration over transforms ------------------------------------------

def _variants(x, y, phi, base, lengths_sig, course):
    """Apply identity/timeflip/reflect/both to one base word."""
    out = []
    for timeflip in (False, True):
        for reflect in (False, True):
            xs = -x if timeflip else x
            ys = -y if reflect else y
            ps = phi if not (timeflip ^ reflect) else -phi
            ok, t, u, v = base(xs, ys, ps)
            if not ok:
                continue
            seg = dict(zip("tuv", (t, u, v)))
            lens = [seg[c] * s for c, s in lengths_sig]
            if timeflip:
                lens = [-l for l in lens]
            crs = list(course)
            if reflect:
                crs = ["R" if c == "L" else ("L" if c == "R" else "S") for c in crs]
            out.append(RSWord(tuple(lens), tuple(crs)))
    return out


_FAMILIES = [
    # (base fn, [(param, sign)] per segment, course)
    (_LpSpLp, [("t", 1), ("u", 1), ("v", 1)], ("L", "S", "L")),
    (_LpSpRp, [("t", 1), ("u", 1), ("v", 1)], ("L", "S", "R")),
    (_LpRmL, [("t", 1), ("u", 1), ("v", 1)], ("L", "R", "L")),
    # LpRmL with swapped roles (backwards variant): v,u,t
    (_LpRmL, [("v", 1), ("u", 1), ("t", 1)], ("L", "R", "L")),
    (_LpRupLumRm, [("t", 1), ("u", 1), ("u", -1), ("v", -1)], ("L", "R", "L", "R")),
    (_LpRumLumRp, [("t", 1), ("u", 1), ("u", 1), ("v", 1)], ("L", "R", "L", "R")),
    (_LpRmSmLm, [("t", 1), ("u", 1), ("v", 1)], ("L", "R", "S", "L")),
    (_LpRmSmRm, [("t", 1), ("u", 1), ("v", 1)], ("L", "R", "S", "R")),
    # backwards CCSC variants: reverse segment order
    (_LpRmSmLm, [("v", 1), ("u", 1), ("t", 1)], ("L", "S", "R", "L")),
    (_LpRmSmRm, [("v", 1), ("u", 1), ("t", 1)], ("R", "S", "R", "L")),
    (_LpRmSmLmRp, [("t", 1), ("u", 1), ("v", 1)], ("L", "R", "S", "L", "R")),
]

# Fixed -pi/2 middle arcs for the CCSC / CCSCC families (the formulas fold
# the quarter-turn into the word definition).
_QUARTER = {
    _LpRmSmLm: ("R",),
    _LpRmSmRm: ("R",),
    _LpRmSmLmRp: ("R", "L"),
}


def _enumerate_words(x: float, y: float, phi: float) -> List[RSWord]:
    words: List[RSWord] = []
    for base, sig, course in _FAMILIES:
        if base in (_LpRmSmLm, _LpRmSmRm, _LpRmSmLmRp):
            continue  # handled below with explicit quarter arcs
        words.extend(_variants(x, y, phi, base, sig, course))

    # CCSC: L+ R-(pi/2) S- L-   and   L+ R-(pi/2) S- R-
    for base, course, quarter_first in [
        (_LpRmSmLm, ("L", "R", "S", "L"), True),
        (_LpRmSmRm, ("L", "R", "S", "R"), True),
    ]:
        for timeflip in (False, True):
            for reflect in (False, True):
                for backwards in (False, True):
                    xs, ys, ps = x, y, phi
                    if backwards:
                        # run the word in reverse: transform goal frame
                        xs = x * cos(phi) + y * sin(phi)
                        ys = x * sin(phi) - y * cos(phi)
                        ps = phi
                    if timeflip:
                        xs, ps = -xs, -ps
                    if reflect:
                        ys, ps = -ys, -ps
                    ok, t, u, v = base(xs, ys, ps)
                    if not ok:
                        continue
                    lens = [t, -0.5 * pi, u, v]
                    crs = list(course)
                    if backwards:
                        lens = lens[::-1]
                        crs = crs[::-1]
                    if timeflip:
                        lens = [-l for l in lens]
                    if reflect:
                        crs = ["R" if c == "L" else ("L" if c == "R" else "S")
                               for c in crs]
                    words.append(RSWord(tuple(lens), tuple(crs)))

    # CCSCC: L+ R-(pi/2) S- L-(pi/2) R+
    base = _LpRmSmLmRp
    course = ("L", "R", "S", "L", "R")
    for timeflip in (False, True):
        for reflect in (False, True):
            xs = -x if timeflip else x
            ys = -y if reflect else y
            ps = phi if not (timeflip ^ reflect) else -phi
            ok, t, u, v = base(xs, ys, ps)
            if not ok:
                continue
            lens = [t, -0.5 * pi, u, -0.5 * pi, v]
            crs = list(course)
            if timeflip:
                lens = [-l for l in lens]
            if reflect:
                crs = ["R" if c == "L" else ("L" if c == "R" else "S")
                       for c in crs]
            words.append(RSWord(tuple(lens), tuple(crs)))

    return words


def _word_end(word: RSWord) -> Tuple[float, float, float]:
    """Closed-form endpoint of a word in the normalized start frame."""
    x = y = th = 0.0
    for length, course in zip(word.lengths, word.course):
        if course == "S":
            x += length * cos(th)
            y += length * sin(th)
        elif course == "L":
            nth = th + length
            x += sin(nth) - sin(th)
            y -= cos(nth) - cos(th)
            th = nth
        else:  # R
            nth = th - length
            x -= sin(nth) - sin(th)
            y += cos(nth) - cos(th)
            th = nth
    return x, y, th


def shortest_rs_word(start, goal, radius: float) -> Optional[RSWord]:
    """Shortest Reeds-Shepp word from start to goal pose ([x, y, theta]).

    Candidates are validated by analytic integration before selection, so a
    word family with an inapplicable branch can never produce a wrong path.
    """
    dx = goal[0] - start[0]
    dy = goal[1] - start[1]
    th = start[2]
    # normalize into the start frame, radius units
    x = (cos(th) * dx + sin(th) * dy) / radius
    y = (-sin(th) * dx + cos(th) * dy) / radius
    phi = _mod2pi(goal[2] - start[2])
    best: Optional[RSWord] = None
    best_len = float("inf")
    for w in _enumerate_words(x, y, phi):
        ex, ey, eth = _word_end(w)
        if abs(ex - x) > 1e-6 or abs(ey - y) > 1e-6 or abs(_mod2pi(eth - phi)) > 1e-6:
            continue
        total = sum(abs(l) for l in w.lengths)
        if total < best_len:
            best, best_len = w, total
    return best


def _sample_segment(x, y, th, length, course, radius, step):
    """Sample one signed segment; returns (samples, end pose)."""
    samples = []
    gear = 1.0 if length >= 0 else -1.0
    total = abs(length) * radius
    n = max(int(total / step), 1)
    for i in range(1, n + 1):
        ell = gear * (total * i / n)  # signed arc length travelled
        if course == "S":
            nx, ny, nth = x + ell * cos(th), y + ell * sin(th), th
        elif course == "L":
            nth = th + ell / radius
            nx = x + radius * (sin(nth) - sin(th))
            ny = y - radius * (cos(nth) - cos(th))
        else:  # R
            nth = th - ell / radius
            nx = x - radius * (sin(nth) - sin(th))
            ny = y + radius * (cos(nth) - cos(th))
        samples.append((nx, ny, nth, gear))
    end = samples[-1][:3]
    return samples, end


def reeds_shepp_path(start, goal, radius: float, step: float):
    """Sampled shortest RS path: list of (x, y, theta, gear)."""
    word = shortest_rs_word(start, goal, radius)
    if word is None:  # degenerate; straight-line fallback
        return [(start[0], start[1], start[2], 1.0),
                (goal[0], goal[1], goal[2], 1.0)]
    poses = [(start[0], start[1], start[2],
              1.0 if word.lengths[0] >= 0 else -1.0)]
    x, y, th = float(start[0]), float(start[1]), float(start[2])
    for length, course in zip(word.lengths, word.course):
        if abs(length) < 1e-12:
            continue
        samples, (x, y, th) = _sample_segment(x, y, th, length, course, radius, step)
        poses.extend(samples)
    return poses


def path_length(word: RSWord, radius: float) -> float:
    return sum(abs(l) for l in word.lengths) * radius
