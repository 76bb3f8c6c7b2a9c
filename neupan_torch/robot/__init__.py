"""Robot geometry and kinematics (port of ``neupan_tpu/robot``).

``Robot`` is a frozen description: convex geometry (G, h), kinematics tag,
bounds. ``step``/``rollout``/``linearize`` act on tensors with any leading
batch dimensions, so one call serves a whole scenario batch.

Kinematics: ``diff`` (state [x, y, phi], control [v, w]), ``acker``
(control [v, steer psi], wheelbase L) and ``omni`` (control [speed,
orientation]).
"""

from __future__ import annotations

import dataclasses
from math import inf
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from neupan_torch import resolve_device
from neupan_torch.utils import gen_inequal_from_vertex

KINEMATICS = ("diff", "acker", "omni")


def rectangle_vertices(length: float, width: float,
                       wheelbase: Optional[float] = None) -> np.ndarray:
    """Rectangle footprint vertices (2, 4), CCW, origin offset by wheelbase/2
    (rear-axle convention for car-like robots)."""
    wb = 0.0 if wheelbase is None else wheelbase
    sx = -(length - wb) / 2.0
    sy = -width / 2.0
    return np.array([[sx, sx + length, sx + length, sx],
                     [sy, sy, sy + width, sy + width]])


def _as_bound(value, default=inf) -> np.ndarray:
    if value is None:
        return np.full((2, 1), default, dtype=np.float64)
    return np.array(value, dtype=np.float64).reshape(2, 1)


@dataclasses.dataclass(frozen=True)
class Robot:
    """Frozen robot description (arrays stored as tuples, so it hashes)."""

    kinematics: str
    vertices_flat: Tuple[float, ...]
    n_vertices: int
    T: int
    dt: float
    wheelbase: Optional[float]
    max_speed: Tuple[float, float]
    max_acce: Tuple[float, float]
    length: Optional[float] = None
    width: Optional[float] = None
    name: str = ""

    @staticmethod
    def create(receding: int = 10, step_time: float = 0.1,
               kinematics: Optional[str] = None,
               vertices: Optional[Union[Sequence, np.ndarray]] = None,
               max_speed=(inf, inf), max_acce=(inf, inf),
               wheelbase: Optional[float] = None,
               length: Optional[float] = None, width: Optional[float] = None,
               name: Optional[str] = None, **_: object) -> "Robot":
        if kinematics is None:
            raise ValueError("kinematics is required")
        if kinematics not in KINEMATICS:
            raise ValueError(f"kinematics must be one of {KINEMATICS}, got {kinematics}")
        if vertices is not None:
            verts = np.asarray(vertices, dtype=np.float64)
            if verts.ndim == 2 and verts.shape[0] != 2:
                verts = verts.T  # accept [[x1, y1], ...] lists
        else:
            if length is None or width is None:
                raise ValueError("either vertices or length/width must be given")
            verts = rectangle_vertices(length, width, wheelbase)
        if verts.shape[0] != 2 or verts.shape[1] < 3:
            raise ValueError("vertices must be (2, N) with N >= 3")

        ms = _as_bound(max_speed)
        ma = _as_bound(max_acce)
        if kinematics == "acker" and ms[1, 0] >= 1.57:
            print(f"Warning: max steering angle {ms[1, 0]} rad > 1.57 rad, clamped to 1.57")
            ms[1, 0] = 1.57

        return Robot(
            kinematics=kinematics,
            vertices_flat=tuple(float(v) for v in verts.T.reshape(-1)),
            n_vertices=verts.shape[1], T=int(receding), dt=float(step_time),
            wheelbase=None if wheelbase is None else float(wheelbase),
            max_speed=(float(ms[0, 0]), float(ms[1, 0])),
            max_acce=(float(ma[0, 0]), float(ma[1, 0])),
            length=length, width=width,
            name=name or f"{kinematics}_robot_default")

    # -- geometry (numpy, float64) ------------------------------------------

    @property
    def vertices(self) -> np.ndarray:
        return np.array(self.vertices_flat, dtype=np.float64).reshape(self.n_vertices, 2).T

    @property
    def G(self) -> np.ndarray:
        return gen_inequal_from_vertex(self.vertices)[0]

    @property
    def h(self) -> np.ndarray:
        return gen_inequal_from_vertex(self.vertices)[1]

    @property
    def edge_dim(self) -> int:
        return self.n_vertices

    @property
    def L(self) -> Optional[float]:
        return self.wheelbase

    @property
    def speed_bound(self) -> np.ndarray:
        return np.array(self.max_speed, dtype=np.float64).reshape(2, 1)

    @property
    def acce_bound(self) -> np.ndarray:
        """Per-step acceleration bound."""
        return np.array(self.max_acce, dtype=np.float64).reshape(2, 1) * self.dt

    def tensors(self, device=None, dtype=torch.float32):
        """(vertices (2, V), G (E, 2), h (E, 1)) as tensors on ``device``."""
        dev = resolve_device(device)
        G, h = gen_inequal_from_vertex(self.vertices)
        return tuple(torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
                     for a in (self.vertices, G, h))

    # -- exact kinematics ---------------------------------------------------

    def step(self, state: torch.Tensor, vel: torch.Tensor,
             dt: Optional[float] = None) -> torch.Tensor:
        """Exact nonlinear step: state (..., 3), vel (..., 2) -> (..., 3)."""
        dt = self.dt if dt is None else dt
        phi = state[..., 2]
        v = vel[..., 0]
        if self.kinematics == "acker":
            ds = torch.stack([v * torch.cos(phi), v * torch.sin(phi),
                              v * torch.tan(vel[..., 1]) / self.wheelbase], dim=-1)
        elif self.kinematics == "diff":
            ds = torch.stack([v * torch.cos(phi), v * torch.sin(phi), vel[..., 1]], dim=-1)
        else:
            ds = torch.stack([v * torch.cos(vel[..., 1]), v * torch.sin(vel[..., 1]),
                              torch.zeros_like(v)], dim=-1)
        return state + dt * ds

    def rollout(self, s0: torch.Tensor, u_seq: torch.Tensor) -> torch.Tensor:
        """Roll the exact model: s0 (..., 3), u_seq (..., 2, T) -> (..., 3, T+1)."""
        states = [s0]
        s = s0
        for t in range(u_seq.shape[-1]):
            s = self.step(s, u_seq[..., t])
            states.append(s)
        return torch.stack(states, dim=-1)

    def linearize(self, nom_s: torch.Tensor, nom_u: torch.Tensor):
        """Per-step linearization around a nominal trajectory.

        nom_s (..., 3, T+1), nom_u (..., 2, T) -> A (..., T, 3, 3),
        B (..., T, 3, 2), C (..., T, 3, 1) with s_{t+1} = A_t s_t + B_t u_t + C_t.
        """
        dt = self.dt
        T = nom_u.shape[-1]
        phi = nom_s[..., 2, :T]
        v = nom_u[..., 0, :]
        zeros = torch.zeros_like(v)
        ones = torch.ones_like(v)
        st = lambda rows: torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

        if self.kinematics in ("acker", "diff"):
            sin_p, cos_p = torch.sin(phi), torch.cos(phi)
            A = st([[ones, zeros, -v * dt * sin_p],
                    [zeros, ones, v * dt * cos_p],
                    [zeros, zeros, ones]])
            if self.kinematics == "acker":
                psi = nom_u[..., 1, :]
                cos_psi2 = torch.cos(psi) ** 2
                L = self.wheelbase
                B_r2 = [torch.tan(psi) * dt / L, v * dt / (L * cos_psi2)]
                C_r2 = -psi * v * dt / (L * cos_psi2)
            else:
                B_r2 = [zeros, dt * ones]
                C_r2 = zeros
            B = st([[cos_p * dt, zeros], [sin_p * dt, zeros], B_r2])
            C = torch.stack([phi * v * sin_p * dt, -phi * v * cos_p * dt, C_r2],
                            dim=-1)[..., None]
        else:
            theta = nom_u[..., 1, :]
            sin_t, cos_t = torch.sin(theta), torch.cos(theta)
            A = torch.eye(3, dtype=nom_s.dtype, device=nom_s.device).expand(
                *v.shape, 3, 3)
            B = st([[cos_t * dt, -v * sin_t * dt],
                    [sin_t * dt, v * cos_t * dt],
                    [zeros, zeros]])
            C = torch.stack([theta * v * sin_t * dt, -theta * v * cos_t * dt, zeros],
                            dim=-1)[..., None]
        return A, B, C
