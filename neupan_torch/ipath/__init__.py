"""Reference-path subsystem: generation, progress tracking, and MPC
reference assembly (the port's own copy of ``neupan_tpu/ipath``, same
arithmetic).

Host-side (pure numpy) — this layer is control-flow heavy, runs once per
control tick on small data, and deliberately stays off the device; it emits
the fixed-shape (nom_s, nom_u, ref_s, ref_us) arrays that feed the PAN
step.  Capability parity target: the reference InitialPath (reference:
blocks/initial_path.py), i.e. SURVEY.md §2.3 item 6:

  * waypoints -> line / dubins / reeds curves with gear flags
    (own generators in ipath/curves.py, replacing gctl);
  * gear-change segmentation, loop mode, runtime path replacement;
  * windowed closest-point tracking, per-segment + final arrival;
  * nominal rollout of the current velocity plan through the exact
    kinematics, plus the look-ahead reference for the horizon.

Architecture (original, array-first — not a translation of the reference):
the user-visible path stays a list of (4,1) ``[x, y, heading, gear]``
columns (external code mutates those arrays in place, e.g. the reverse
scenario flips gears mid-run), but each tick the path is compiled into a
struct-of-arrays form — per gear segment: positions (N,2), headings (N,),
and *cumulative arc length* (N,).  On that form, the whole-horizon
reference advance is one vectorized ``searchsorted`` + lerp over the arc
table (the reference implementation instead walks the point list with a
per-step circle/segment intersection), and closest-point tracking is a
windowed prefix-min (or the native C kernel, ``native.closest_point_index``).
"""

from __future__ import annotations

from math import cos, sin, tan
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from neupan_torch.ipath.curves import generate_curve
from neupan_torch.robot import Robot
from neupan_torch.utils import wrap_to_pi


class _Track(NamedTuple):
    """One constant-gear segment of the path, compiled for array math."""

    pts: np.ndarray       # (N, 2) positions
    heading: np.ndarray   # (N,)
    arc: np.ndarray       # (N,) cumulative arc length from the segment start
    gear: float           # +1 forward / -1 reverse (0 never stored)


def _as_columns(seq, rows: Optional[int] = None) -> List[np.ndarray]:
    """Normalize a sequence of points to a list of float64 column vectors."""
    if seq is None:
        return []
    out = []
    for p in seq:
        col = np.asarray(p, dtype=np.float64).reshape(-1, 1)
        out.append(col[:rows] if rows else col)
    return out


def _compile_tracks(path: List[np.ndarray]) -> List[_Track]:
    """List of (4,1) columns -> per-gear-segment struct-of-arrays tables."""
    flat = np.hstack(path)                                  # (4, N)
    gear = flat[3]
    cuts = np.flatnonzero(np.diff(gear) != 0.0) + 1
    bounds = np.concatenate([[0], cuts, [flat.shape[1]]]).astype(int)
    tracks = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        pts = np.ascontiguousarray(flat[:2, a:b].T)         # (n, 2)
        steps = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        arc = np.concatenate([[0.0], np.cumsum(steps)])
        tracks.append(_Track(pts, flat[2, a:b].copy(), arc, float(gear[a])))
    return tracks


def _gear_bounds(path: List[np.ndarray]) -> List[tuple]:
    gear = np.hstack(path)[3]
    cuts = np.flatnonzero(np.diff(gear) != 0.0) + 1
    bounds = np.concatenate([[0], cuts, [len(path)]]).astype(int)
    return list(zip(bounds[:-1], bounds[1:]))


def _align_headings_with_travel(path: List[np.ndarray]) -> None:
    """Overwrite headings with the direction of travel (line-style paths,
    whose waypoint headings are placeholders)."""
    if len(path) < 2:
        return
    flat = np.hstack(path)
    d = np.diff(flat[:2], axis=1)
    ang = np.arctan2(d[1], d[0])
    for i, p in enumerate(path[:-1]):
        p[2, 0] = ang[i]
    path[-1][2, 0] = ang[-1]


class InitialPath:
    def __init__(
        self,
        receding: int,
        step_time: float,
        ref_speed: float,
        robot: Robot,
        waypoints: Optional[Sequence] = None,
        loop: bool = False,
        curve_style: str = "line",
        **kwargs,
    ) -> None:
        self.T = receding
        self.dt = step_time
        self.ref_speed = ref_speed
        self.robot = robot
        self.waypoints = _as_columns(waypoints)
        self.loop = loop
        self.curve_style = curve_style
        self.min_radius = kwargs.get("min_radius", self._default_min_radius())
        self.interval = kwargs.get("interval", self.dt * self.ref_speed)
        self.arrive_threshold = kwargs.get("arrive_threshold", 0.1)
        self.close_threshold = kwargs.get("close_threshold", 0.1)
        self.ind_range = kwargs.get("ind_range", 10)
        self.arrive_index_threshold = kwargs.get("arrive_index_threshold", 1)
        self.arrive_flag = False

        self.initial_path: Optional[List[np.ndarray]] = None
        self._tracks: Optional[List[_Track]] = None
        self.curve_index = 0
        self.point_index = 0

    # ------------------------------------------------------------------
    # per-tick tracking + arrival (capability: initial_path.py:166-292)
    # ------------------------------------------------------------------

    def check_arrive(self, state) -> bool:
        """Advance the tracking indices for this tick; True once the final
        segment's end is reached (loop mode wraps instead)."""
        state = np.asarray(state, dtype=np.float64).reshape(-1, 1)
        self.init_check(state)
        # Recompile every tick: the exposed list-of-columns path is mutable
        # by design (external planners and the reverse scenario edit it in
        # place), and the compile is O(path length) numpy — microseconds.
        self._tracks = _compile_tracks(self.initial_path)
        self._advance_tracking(state[:2, 0])

        if not self._segment_done(state[:2, 0]):
            return False
        if self.curve_index + 1 < len(self._tracks):
            self.curve_index += 1
            self.point_index = 0
            return False
        if self.loop:
            self.curve_index = 0
            self.point_index = 0
            print("Loop mode: path tracking restarted from the first segment")
            return False
        if not self.arrive_flag:
            print("Goal reached: end of the reference path")
            self.arrive_flag = True
        return True

    def _advance_tracking(self, xy: np.ndarray) -> None:
        """Windowed closest-point update of ``point_index``.

        Semantics (shared with the native kernel): scan forward up to
        ``ind_range`` points, keep the running argmin, stop early at the
        first new minimum closer than ``close_threshold``.
        """
        trk = self._tracks[self.curve_index]
        n = trk.pts.shape[0]
        i0 = min(max(self.point_index, 0), n)
        i1 = min(i0 + self.ind_range, n)
        if i1 <= i0:
            return
        from neupan_torch import native

        if native.available():
            self.point_index = native.closest_point_index(
                trk.pts.T, xy, i0, self.ind_range, self.close_threshold)
            return
        d2 = np.sum((trk.pts[i0:i1] - xy) ** 2, axis=1)
        run_min = np.minimum.accumulate(d2)
        improved = np.empty(d2.shape, dtype=bool)
        improved[0] = True
        improved[1:] = d2[1:] < run_min[:-1]
        near = improved & (d2 < self.close_threshold ** 2)
        k = int(np.argmax(near)) if near.any() else int(np.argmin(d2))
        self.point_index = i0 + k

    def _segment_done(self, xy: np.ndarray) -> bool:
        trk = self._tracks[self.curve_index]
        end_gap = float(np.hypot(*(xy - trk.pts[-1])))
        tail = self.point_index >= (
            trk.pts.shape[0] - self.arrive_index_threshold - 2)
        return end_gap < self.arrive_threshold and tail

    # ------------------------------------------------------------------
    # MPC reference assembly (capability: initial_path.py:68-126,185-249)
    # ------------------------------------------------------------------

    def generate_nom_ref_state(self, state: np.ndarray, cur_vel_array: np.ndarray,
                               ref_speed: float):
        """Build nominal + reference trajectories for the receding horizon.

        Nominal = the current velocity plan rolled through the exact
        kinematics.  Reference = the path sampled at arc lengths
        ``s0 + t * ref_speed * dt`` ahead of the tracked point — one
        vectorized searchsorted/lerp over the segment's arc table — with
        headings lerped (wrapped) and then unwrapped relative to the
        nominal headings.  Past the segment end the reference clamps to the
        final point and its speed gear drops to zero.

        Returns (nom_s (3,T+1), nom_u (2,T), ref_s (3,T+1), ref_us (T,)).
        """
        state = np.asarray(state, dtype=np.float64).reshape(-1, 1)[:3]
        if self._tracks is None:
            if self.initial_path is None:
                self.init_check(state)
            self._tracks = _compile_tracks(self.initial_path)
        trk = self._tracks[self.curve_index]
        T = self.T

        # --- nominal rollout of the current velocity plan ----------------
        vel = np.asarray(cur_vel_array, dtype=np.float64)
        nom_s = np.empty((3, T + 1))
        nom_s[:, 0] = state[:, 0]
        for t in range(T):
            nom_s[:, t + 1] = self._step_exact(nom_s[:, t], vel[:, t])

        # --- arc-length reference advance (vectorized over the horizon) --
        n = trk.pts.shape[0]
        p_idx = min(self.point_index, n - 1)
        targets = trk.arc[p_idx] + ref_speed * self.dt * np.arange(1, T + 1)
        if n < 2:
            xy = np.repeat(trk.pts[-1:], T, axis=0)
            hdg = np.full(T, trk.heading[-1])
            past_end = np.ones(T, dtype=bool)
        else:
            seg = np.clip(np.searchsorted(trk.arc, targets, side="right") - 1,
                          0, n - 2)
            span = trk.arc[seg + 1] - trk.arc[seg]
            frac = np.clip((targets - trk.arc[seg])
                           / np.where(span > 1e-12, span, 1.0), 0.0, 1.0)
            xy = trk.pts[seg] + frac[:, None] * (trk.pts[seg + 1] - trk.pts[seg])
            hdg = trk.heading[seg] + frac * wrap_to_pi(
                trk.heading[seg + 1] - trk.heading[seg])
            past_end = targets >= trk.arc[-1] - 1e-12
            xy[past_end] = trk.pts[-1]
            hdg[past_end] = trk.heading[-1]

        ref_s = np.empty((3, T + 1))
        ref_s[:2, 0] = trk.pts[p_idx]
        ref_s[2, 0] = trk.heading[p_idx]
        ref_s[:2, 1:] = xy.T
        # unwrap each reference heading to the branch nearest the nominal
        ref_s[2, 1:] = nom_s[2, 1:] + wrap_to_pi(hdg - nom_s[2, 1:])

        ref_us = np.where(past_end, 0.0, trk.gear) * ref_speed
        return nom_s, vel, ref_s, ref_us

    # ------------------------------------------------------------------
    # path generation / replacement (capability: initial_path.py:128-386)
    # ------------------------------------------------------------------

    def init_check(self, state) -> None:
        """Lazily build the path from the robot's current pose on first use."""
        if self.initial_path is None:
            print("No reference path yet: generating one from the current pose")
            self.set_ipath_with_state(state)

    def set_ipath_with_state(self, state) -> None:
        if not self.waypoints:
            raise ValueError("waypoints must be set before path generation")
        start = np.asarray(state, dtype=np.float64).reshape(-1, 1)[:3]
        wps = [start] + list(self.waypoints)
        if self.loop:
            wps = wps + [wps[0]]
        self.waypoints = wps
        self._generate()

    def set_ipath_with_waypoints(self, waypoints) -> None:
        self.waypoints = _as_columns(waypoints)
        self._generate()

    def update_initial_path_from_goal(self, start, goal) -> None:
        wps = [start, goal, start] if self.loop else [start, goal]
        self.waypoints = _as_columns(wps)
        self._generate()

    def _generate(self) -> None:
        path = generate_curve(self.curve_style, self.waypoints, self.interval,
                              self.min_radius, True)
        if self.curve_style == "line":
            _align_headings_with_travel(path)
        self.initial_path = path
        self._reset_tracking()

    def set_initial_path(self, path) -> None:
        """Install an externally provided path (sequence of (4,1) columns)."""
        self.initial_path = list(path)
        flat = np.hstack(self.initial_path)
        if flat.shape[1] >= 2:
            gaps = np.linalg.norm(np.diff(flat[:2], axis=1), axis=0)
            self.interval = float(gaps.mean())
        else:
            self.interval = 0.0
        self._reset_tracking()

    def _reset_tracking(self) -> None:
        self.curve_index = 0
        self.point_index = 0
        self._tracks = None

    # ------------------------------------------------------------------
    # exact motion models (capability: initial_path.py:388-444)
    # ------------------------------------------------------------------

    def _step_exact(self, s: np.ndarray, u: np.ndarray) -> np.ndarray:
        """One exact kinematic step on flat (3,) state / (2,) control."""
        kind = self.robot.kinematics
        if kind == "acker":
            rate = u[0] * tan(u[1]) / self.robot.L
        elif kind == "diff":
            rate = u[1]
        else:  # omni: control is (speed, direction), heading is free
            vx, vy = u[0] * cos(u[1]), u[0] * sin(u[1])
            return s + self.dt * np.array([vx, vy, 0.0])
        return s + self.dt * np.array(
            [u[0] * cos(s[2]), u[0] * sin(s[2]), rate])

    def motion_predict_model(self, robot_state, vel, wheel_base, sample_time):
        """Column-vector wrapper kept for API parity with the reference."""
        if self.robot.kinematics == "acker":
            return self.ackermann_model(robot_state, vel, wheel_base,
                                        sample_time)
        if self.robot.kinematics == "diff":
            return self.diff_model(robot_state, vel, sample_time)
        return self.omni_model(robot_state, vel, sample_time)

    @staticmethod
    def ackermann_model(car_state, vel, wheel_base, sample_time):
        phi, (v, psi) = car_state[2, 0], (vel[0, 0], vel[1, 0])
        ds = np.array([[v * cos(phi)], [v * sin(phi)],
                       [v * tan(psi) / wheel_base]])
        return car_state + ds * sample_time

    @staticmethod
    def diff_model(robot_state, vel, sample_time):
        phi, (v, w) = robot_state[2, 0], (vel[0, 0], vel[1, 0])
        ds = np.array([[v * cos(phi)], [v * sin(phi)], [w]])
        return robot_state + ds * sample_time

    @staticmethod
    def omni_model(robot_state, vel, sample_time):
        v, ang = vel[0, 0], vel[1, 0]
        ds = np.array([[v * cos(ang)], [v * sin(ang)], [0.0]])
        return robot_state + ds * sample_time

    # ------------------------------------------------------------------
    # views / defaults
    # ------------------------------------------------------------------

    @property
    def curve_list(self) -> List[List[np.ndarray]]:
        """Per-gear-segment view of the path (lists share the path's
        column arrays, so in-place edits remain visible)."""
        if self.initial_path is None:
            return []
        return [self.initial_path[a:b]
                for a, b in _gear_bounds(self.initial_path)]

    @property
    def curve_number(self) -> int:
        if self._tracks is not None:
            return len(self._tracks)
        return len(_gear_bounds(self.initial_path)) if self.initial_path else 0

    def _default_min_radius(self) -> float:
        if self.robot.kinematics == "acker":
            return self.robot.L / tan(self.robot.max_speed[1])
        return 0.0
