"""Lightweight 2-D closed-loop simulator with a ray-cast lidar (port of
``neupan_tpu/sim``).

The port keeps its own copy: importing ``neupan_tpu.sim`` runs
``neupan_tpu/__init__.py``, which imports JAX. The code and its numbers are
the JAX package's: the same seed builds the same world, and the same
actions give the same states and scans. It replaces IR-SIM for tests and
the closed-loop runners (the reference's examples depend on the external
``ir-sim`` package, reference: example/run_exp.py:18), with

  * exact diff/acker/omni robot stepping (same models as the planner);
  * polygon / rectangle / circle obstacles, optionally moving (dynamic
    scenarios) with per-point velocity exposure for scan_to_point_velocity;
  * vectorized 2-D lidar: beams x segment intersection in one numpy op, or
    the native host raycaster (``neupan_torch.native``) where it is built;
  * collision check: robot polygon vs obstacle edges + containment;
  * goal arrival check.

Host-side numpy float64 only: the simulator is the test harness, not the
product. It reads the port's ``Robot`` (``kinematics``, ``L``, ``dt``,
``vertices``, ``G``, ``h``).
"""

from __future__ import annotations

import dataclasses
from math import cos, pi, sin
from typing import List, Optional, Sequence

import numpy as np

from neupan_torch.robot import Robot
from neupan_torch.utils import get_transform


@dataclasses.dataclass
class Obstacle:
    vertices: np.ndarray              # (2, V) world-frame polygon (closed implicitly)
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((2, 1)))
    behavior: Optional["Behavior"] = None   # dynamic-motion policy (or None)

    def step(self, dt: float):
        self.vertices = self.vertices + self.velocity * dt

    @property
    def center(self) -> np.ndarray:
        return self.vertices.mean(axis=1, keepdims=True)   # (2, 1)

    @property
    def segments(self):
        """(S, 2, 2): [start, end] per edge."""
        v = self.vertices
        nxt = np.roll(v, -1, axis=1)
        return np.stack([v.T, nxt.T], axis=1)


def rectangle_obstacle(cx, cy, theta, length, width, velocity=(0.0, 0.0)) -> Obstacle:
    local = np.array([
        [-length / 2, length / 2, length / 2, -length / 2],
        [-width / 2, -width / 2, width / 2, width / 2],
    ])
    R = np.array([[cos(theta), -sin(theta)], [sin(theta), cos(theta)]])
    verts = R @ local + np.array([[cx], [cy]])
    return Obstacle(verts, np.asarray(velocity, dtype=np.float64).reshape(2, 1))


def circle_obstacle(cx, cy, radius, n=16, velocity=(0.0, 0.0)) -> Obstacle:
    ang = np.linspace(0, 2 * pi, n, endpoint=False)
    verts = np.vstack([cx + radius * np.cos(ang), cy + radius * np.sin(ang)])
    return Obstacle(verts, np.asarray(velocity, dtype=np.float64).reshape(2, 1))


def polygon_obstacle(vertices, velocity=(0.0, 0.0)) -> Obstacle:
    v = np.asarray(vertices, dtype=np.float64)
    if v.shape[0] != 2:
        v = v.T
    return Obstacle(v, np.asarray(velocity, dtype=np.float64).reshape(2, 1))


def random_polygon_vertices(rng: np.random.Generator, avg_radius_range=(0.5, 1.5),
                            irregularity: float = 0.9, n: int = 8) -> np.ndarray:
    """Random star-shaped polygon around the origin, (2, n) local vertices.

    Equivalent role to IR-SIM's ``random_shape: true`` polygons used by the
    reference's dyna/non_obs scenario envs (e.g. reference:
    example/dyna_non_obs/acker/env.yaml obstacle shape entries): angles are
    jittered uniformly by ``irregularity`` and radii drawn per-vertex from
    ``avg_radius_range``.
    """
    base = np.linspace(0, 2 * pi, n, endpoint=False)
    jitter = (rng.uniform(-0.5, 0.5, n)) * (2 * pi / n) * irregularity
    ang = np.sort(base + jitter)
    radii = rng.uniform(avg_radius_range[0], avg_radius_range[1], n)
    return np.vstack([radii * np.cos(ang), radii * np.sin(ang)])


def _det(a, b):
    return a[0] * b[1] - a[1] * b[0]


def _orca_line(p_rel, v_rel, r, tau, dt):
    """ORCA constraint of agent A against B (van den Berg et al., RVO2).

    Returns (direction d, u) where u is the smallest change of the RELATIVE
    velocity that exits the tau-truncated velocity obstacle and d is the
    ORCA line direction (the feasible half-plane lies to the LEFT of the
    line through point + u oriented along d).
    """
    dist_sq = float(p_rel @ p_rel)
    r_sq = r * r
    if dist_sq > r_sq:
        w = v_rel - p_rel / tau
        w_len_sq = float(w @ w)
        dot = float(w @ p_rel)
        if dot < 0.0 and dot * dot > r_sq * w_len_sq:
            # project onto the cutoff circle
            w_len = np.sqrt(max(w_len_sq, 1e-18))
            unit_w = w / w_len
            direction = np.array([unit_w[1], -unit_w[0]])
            u = (r / tau - w_len) * unit_w
        else:
            # project onto the nearer leg of the cone
            leg = np.sqrt(max(dist_sq - r_sq, 0.0))
            if _det(p_rel, w) > 0.0:
                direction = np.array([p_rel[0] * leg - p_rel[1] * r,
                                      p_rel[0] * r + p_rel[1] * leg]) / dist_sq
            else:
                direction = -np.array([p_rel[0] * leg + p_rel[1] * r,
                                       -p_rel[0] * r + p_rel[1] * leg]) / dist_sq
            u = float(v_rel @ direction) * direction - v_rel
    else:
        # already overlapping: resolve the penetration within one step
        inv_dt = 1.0 / dt
        w = v_rel - p_rel * inv_dt
        w_len = float(np.linalg.norm(w))
        unit_w = w / max(w_len, 1e-9)
        direction = np.array([unit_w[1], -unit_w[0]])
        u = (r * inv_dt - w_len) * unit_w
    return direction, u


def _lp1(lines, i, vmax, vpref):
    """Optimize along line i subject to lines[:i] and |v| <= vmax."""
    pt, dr = lines[i]
    disc = float(dr @ pt) ** 2 + vmax * vmax - float(pt @ pt)
    if disc < 0.0:
        return None
    sq = np.sqrt(disc)
    tl, tr = -float(dr @ pt) - sq, -float(dr @ pt) + sq
    for pt2, dr2 in lines[:i]:
        denom = _det(dr, dr2)
        num = _det(dr2, pt - pt2)
        if abs(denom) < 1e-9:
            if num < 0.0:
                return None
            continue
        t = num / denom
        if denom >= 0.0:
            tr = min(tr, t)
        else:
            tl = max(tl, t)
        if tl > tr:
            return None
    t = float(np.clip(float(dr @ (vpref - pt)), tl, tr))
    return pt + t * dr


def _orca_velocity(lines, vpref, vmax):
    """2-D incremental linear program (RVO2 linearProgram2, simplified):
    the velocity closest to vpref satisfying every ORCA half-plane and the
    speed cap.  On infeasibility (dense crowds) stop — the safe fallback."""
    v = vpref.copy()
    sp = float(np.linalg.norm(v))
    if sp > vmax:
        v = v / sp * vmax
    for i, (pt, dr) in enumerate(lines):
        if _det(dr, v - pt) < 0.0:       # current v violates half-plane i
            vi = _lp1(lines, i, vmax, vpref)
            if vi is None:
                return np.zeros(2)
            v = vi
    return v


class Behavior:
    """Dynamic-motion policy for obstacles (the reference scenarios delegate
    this to IR-SIM's ``behavior: {name: rvo|dash, wander: True, ...}``,
    reference: example/dyna_obs/acker/env.yaml).

    ``wander``: drive straight toward a random goal inside the range box.
    ``rvo``: same goal-seeking preferred velocity, filtered through true
    ORCA reciprocal collision avoidance (van den Berg et al.; RVO2's
    half-plane construction + incremental 2-D LP) against the other
    obstacles (responsibility 0.5) and the robot (responsibility 1.0 — the
    robot does not cooperate).
    """

    def __init__(self, name: str = "wander", range_low=(0.0, 0.0),
                 range_high=(10.0, 10.0), max_speed: float = 1.0,
                 factor: float = 1.0, goal_threshold: float = 0.3,
                 rng: Optional[np.random.Generator] = None,
                 tau: float = 2.0):
        self.name = name
        self.low = np.asarray(range_low, dtype=np.float64)[:2]
        self.high = np.asarray(range_high, dtype=np.float64)[:2]
        self.max_speed = float(max_speed)
        self.factor = float(factor)
        self.goal_threshold = float(goal_threshold)
        self.rng = rng or np.random.default_rng(7)
        self.goal = self._sample_goal()
        self.tau = float(tau)

    def _sample_goal(self) -> np.ndarray:
        return self.rng.uniform(self.low, self.high).reshape(2, 1)

    @staticmethod
    def _radius(obs: Obstacle) -> float:
        c = obs.center
        return float(np.max(np.linalg.norm(obs.vertices - c, axis=0)))

    def update(self, obs: Obstacle, others: Sequence[Obstacle], dt: float,
               robot_pos: Optional[np.ndarray] = None,
               robot_vel: Optional[np.ndarray] = None,
               robot_radius: float = 1.0):
        c = obs.center
        to_goal = self.goal - c
        dist = float(np.linalg.norm(to_goal))
        if dist < self.goal_threshold:
            self.goal = self._sample_goal()
            to_goal = self.goal - c
            dist = float(np.linalg.norm(to_goal))
        vpref = (to_goal / max(dist, 1e-9) * self.max_speed).reshape(2)
        if self.name != "rvo":
            obs.velocity = vpref.reshape(2, 1)
            return

        pA = c.reshape(2)
        vA = obs.velocity.reshape(2)
        rA = self._radius(obs)
        lines = []
        for o in others:
            if o is obs:
                continue
            p_rel = o.center.reshape(2) - pA
            if float(np.linalg.norm(p_rel)) > 6.0:
                continue                      # neighbor cutoff
            d, u = _orca_line(p_rel, vA - o.velocity.reshape(2),
                              rA + self._radius(o), self.tau, dt)
            lines.append((vA + 0.5 * u, d))   # reciprocal: share half
        if robot_pos is not None:
            p_rel = np.asarray(robot_pos, np.float64).reshape(2) - pA
            if float(np.linalg.norm(p_rel)) <= 6.0:
                vR = (np.zeros(2) if robot_vel is None
                      else np.asarray(robot_vel, np.float64).reshape(2))
                d, u = _orca_line(p_rel, vA - vR, rA + robot_radius,
                                  self.tau, dt)
                lines.append((vA + 1.0 * u, d))  # robot won't yield
        obs.velocity = _orca_velocity(lines, vpref,
                                      self.max_speed).reshape(2, 1)


@dataclasses.dataclass
class LidarSpec:
    range_min: float = 0.0
    range_max: float = 10.0
    angle_min: float = -pi
    angle_max: float = pi
    number: int = 100


class Sim2D:
    """Minimal closed-loop world for a single robot."""

    def __init__(self, robot: Robot, start_state, goal,
                 obstacles: Optional[List[Obstacle]] = None,
                 lidar: Optional[LidarSpec] = None,
                 goal_threshold: float = 0.3,
                 step_time: Optional[float] = None,
                 collision_mode: str = "stop"):
        self.robot = robot
        self.state = np.asarray(start_state, dtype=np.float64).reshape(-1, 1)[:3]
        self.goal = np.asarray(goal, dtype=np.float64).reshape(-1, 1)[:3]
        self.obstacles = obstacles or []
        self.lidar = lidar or LidarSpec()
        self.goal_threshold = goal_threshold
        self.dt = step_time if step_time is not None else robot.dt
        # 'stop' latches self.collided; 'unobstructed' /
        # 'unobstructed_obstacles' only count contacts (the reference's
        # dynamic scenarios run IR-SIM in these modes, e.g. reference:
        # example/dyna_obs/acker/env.yaml world.collision_mode)
        self.collision_mode = collision_mode
        self.collided = False
        self.collision_count = 0
        self.steps = 0

    # -- dynamics ----------------------------------------------------------

    def step(self, action: np.ndarray):
        """Advance robot with the exact kinematic model + move obstacles."""
        a = np.asarray(action, dtype=np.float64).reshape(2, 1)
        phi = self.state[2, 0]
        v = a[0, 0]
        if self.robot.kinematics == "acker":
            ds = np.array([[v * cos(phi)], [v * sin(phi)],
                           [v * np.tan(a[1, 0]) / self.robot.L]])
        elif self.robot.kinematics == "diff":
            ds = np.array([[v * cos(phi)], [v * sin(phi)], [a[1, 0]]])
        else:  # omni: action already [vx, vy] (facade converts)
            ds = np.array([[a[0, 0]], [a[1, 0]], [0.0]])
        self.state = self.state + ds * self.dt
        robot_radius = 0.5 * float(np.max(
            np.ptp(self.robot.vertices, axis=1)))
        for obs in self.obstacles:
            if obs.behavior is not None:
                obs.behavior.update(obs, self.obstacles, self.dt,
                                    robot_pos=self.state[:2],
                                    robot_vel=ds[:2],
                                    robot_radius=robot_radius)
            obs.step(self.dt)
        self.steps += 1
        if self._check_collision():
            self.collision_count += 1
            if self.collision_mode == "stop":
                self.collided = True

    def get_robot_state(self) -> np.ndarray:
        return self.state.copy()

    def arrived(self) -> bool:
        return float(np.linalg.norm(self.state[0:2] - self.goal[0:2])) < self.goal_threshold

    def done(self) -> bool:
        return self.arrived() or self.collided

    # -- lidar -------------------------------------------------------------

    def _all_segments(self) -> np.ndarray:
        if not self.obstacles:
            return np.zeros((0, 2, 2))
        return np.concatenate([o.segments for o in self.obstacles], axis=0)

    def _segment_velocities(self) -> np.ndarray:
        if not self.obstacles:
            return np.zeros((0, 2))
        return np.concatenate(
            [np.repeat(o.velocity.T, o.vertices.shape[1], axis=0)
             for o in self.obstacles], axis=0)

    def get_lidar_scan(self) -> dict:
        """Ray-cast all beams against all obstacle segments.

        Uses the native C++ raycaster when built (neupan_torch.native);
        otherwise the vectorized numpy path.  Returns a scan dict compatible
        with ``NeuPan.scan_to_point`` — ranges are measured in the robot
        frame (sensor at robot origin).
        """
        from neupan_torch import native

        spec = self.lidar
        x, y, th = self.state[0, 0], self.state[1, 0], self.state[2, 0]

        if native.available():
            segs = self._all_segments()
            ranges, hit_seg = native.raycast(
                (x, y), th, spec.angle_min, spec.angle_max, spec.number,
                spec.range_min, spec.range_max, segs)
            seg_vel = self._segment_velocities()
            velocity = np.zeros((2, spec.number))
            if seg_vel.shape[0] > 0:
                hit = hit_seg >= 0
                velocity[:, hit] = seg_vel[hit_seg[hit]].T
            return {
                "ranges": ranges,
                "angle_min": spec.angle_min,
                "angle_max": spec.angle_max,
                "range_min": spec.range_min,
                "range_max": spec.range_max,
                "velocity": velocity,
            }
        angles = np.linspace(spec.angle_min, spec.angle_max, spec.number) + th
        dirs = np.stack([np.cos(angles), np.sin(angles)], axis=1)  # (B, 2)

        segs = self._all_segments()                                # (S, 2, 2)
        B, S = dirs.shape[0], segs.shape[0]
        ranges = np.full(B, spec.range_max)
        hit_seg = np.full(B, -1, dtype=int)
        if S > 0:
            o = np.array([x, y])
            p = segs[:, 0, :]                                      # (S, 2)
            r = segs[:, 1, :] - segs[:, 0, :]                      # (S, 2)
            # solve o + t*d = p + u*r for each (beam, segment)
            d = dirs[:, None, :]                                   # (B, 1, 2)
            denom = d[..., 0] * (-r[None, :, 1]) - d[..., 1] * (-r[None, :, 0])
            po = p[None, :, :] - o[None, None, :]
            t_num = po[..., 0] * (-r[None, :, 1]) - po[..., 1] * (-r[None, :, 0])
            u_num = d[..., 0] * po[..., 1] - d[..., 1] * po[..., 0]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = t_num / denom
                u = u_num / denom
            valid = (np.abs(denom) > 1e-12) & (t > spec.range_min) & \
                    (u >= 0.0) & (u <= 1.0) & (t <= spec.range_max)
            t = np.where(valid, t, np.inf)                         # (B, S)
            idx = np.argmin(t, axis=1)
            best = t[np.arange(B), idx]
            hit = np.isfinite(best)
            ranges = np.where(hit, best, spec.range_max)
            hit_seg = np.where(hit, idx, -1)

        seg_vel = self._segment_velocities()
        velocity = np.zeros((2, B))
        if seg_vel.shape[0] > 0:
            hit = hit_seg >= 0
            velocity[:, hit] = seg_vel[hit_seg[hit]].T

        return {
            "ranges": ranges,
            "angle_min": spec.angle_min,
            "angle_max": spec.angle_max,
            "range_min": spec.range_min,
            "range_max": spec.range_max,
            "velocity": velocity,
        }

    # -- collision ---------------------------------------------------------

    def _check_collision(self) -> bool:
        """Robot polygon vs obstacle edges (intersection or containment)."""
        trans, R = get_transform(self.state)
        rverts = R @ self.robot.vertices + trans        # (2, V)
        segs = self._all_segments()
        if segs.shape[0] == 0:
            return False
        rv = rverts.T
        rsegs = np.stack([rv, np.roll(rv, -1, axis=0)], axis=1)   # (Vr, 2, 2)
        if _segments_intersect_any(rsegs, segs):
            return True
        # containment: any obstacle vertex inside the robot polygon
        G, h = self.robot.G, self.robot.h
        pts_local = R.T @ (segs[:, 0, :].T - trans)
        inside = np.all(G @ pts_local - h <= 0, axis=0)
        return bool(np.any(inside))


def _segments_intersect_any(a: np.ndarray, b: np.ndarray) -> bool:
    """Any intersection between segment sets a (N,2,2) and b (M,2,2)."""
    p, r = a[:, 0, :], a[:, 1, :] - a[:, 0, :]
    q, s = b[:, 0, :], b[:, 1, :] - b[:, 0, :]
    denom = r[:, None, 0] * s[None, :, 1] - r[:, None, 1] * s[None, :, 0]
    qp = q[None, :, :] - p[:, None, :]
    t_num = qp[..., 0] * s[None, :, 1] - qp[..., 1] * s[None, :, 0]
    u_num = qp[..., 0] * r[:, None, 1] - qp[..., 1] * r[:, None, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = t_num / denom
        u = u_num / denom
    hit = (np.abs(denom) > 1e-12) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    return bool(np.any(hit))
