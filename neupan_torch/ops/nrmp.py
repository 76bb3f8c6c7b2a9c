"""NRMP — the motion-planning QP of the PAN step (port of ``neupan_tpu/ops/nrmp.py``).

Assembles, for a scenario batch, the OSQP-standard-form QP

    minimize   1/2 x' diag(P) x + q' x   (+ one-sided soft rows)
    subject to l <= A x <= u

over x = (s, u, d): the state tracking and proximal terms, the control
proximal term reg_u, the distance ridge reg_d and reward eta; linearized
dynamics and the initial state as equality rows; acceleration, speed and
distance bounds as hard rows; and the obstacle hinge penalty
0.5 ro_obs neg(fa p - fb - d)^2 as soft rows, so no slack variables are
needed. n = 5T+3+2T variables, m = 8T+1+TK rows (n=63, m=181 at T=10,
K=10). Row layout: dynamics (3T), init (3), acc (2(T-1)), speed (2T),
d box (T), obstacle (TK).

Every constant is built on the tensors' device from ``arange`` arithmetic,
so assembling a QP copies nothing from the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from neupan_torch.ops.qp import QPData

_INF = 1e20


class AdjustParams(NamedTuple):
    """Runtime-tunable weights, scalar tensors shared by the batch."""

    q_s: torch.Tensor   # () or (3,)
    p_u: torch.Tensor
    eta: torch.Tensor
    d_max: torch.Tensor
    d_min: torch.Tensor


@dataclasses.dataclass(frozen=True)
class NRMPSpec:
    """Static problem description (hashable)."""

    T: int
    K: int                      # points per frame (0 => no-obstacle problem)
    kinematics: str
    speed_bound: Tuple[float, float]
    acce_bound: Tuple[float, float]
    ro_obs: float = 400.0
    bk: float = 0.1
    reg_u: float = 0.001        # control proximal weight, see neupan_tpu/ops/nrmp.py
    reg_d: float = 0.01         # distance ridge

    @property
    def no_obs(self) -> bool:
        return self.K == 0

    @property
    def n_s(self) -> int:
        return 3 * (self.T + 1)

    @property
    def n_u(self) -> int:
        return 2 * self.T

    @property
    def n(self) -> int:
        return self.n_s + self.n_u + (0 if self.no_obs else self.T)

    @property
    def off_u(self) -> int:
        return self.n_s

    @property
    def off_d(self) -> int:
        return self.n_s + self.n_u

    @property
    def m(self) -> int:
        base = 3 * self.T + 3 + 2 * (self.T - 1) + 2 * self.T
        return base if self.no_obs else base + self.T + self.T * self.K

    @property
    def r_init(self) -> int:
        return 3 * self.T

    @property
    def r_acc(self) -> int:
        return self.r_init + 3

    @property
    def r_spd(self) -> int:
        return self.r_acc + 2 * (self.T - 1)

    @property
    def r_d(self) -> int:
        return self.r_spd + 2 * self.T

    @property
    def r_obs(self) -> int:
        return self.r_d + self.T


def _static_template(spec: NRMPSpec, dtype=torch.float32, device=None) -> torch.Tensor:
    """Constant entries of the constraint matrix A (m, n)."""
    T, K = spec.T, spec.K
    A0 = torch.zeros((spec.m, spec.n), dtype=dtype, device=device)
    ar = lambda n: torch.arange(n, device=device)
    r = ar(3 * T)
    A0[r, r + 3] = -1.0                                    # dynamics: -I on s_{t+1}
    A0[spec.r_init + ar(3), ar(3)] = 1.0                   # init: I on s_0
    r = ar(2 * (T - 1))
    A0[spec.r_acc + r, spec.off_u + 2 + r] = 1.0           # acc: u_{t+1} - u_t
    A0[spec.r_acc + r, spec.off_u + r] = -1.0
    r = ar(2 * T)
    A0[spec.r_spd + r, spec.off_u + r] = 1.0               # speed: I on u
    if not spec.no_obs:
        r = ar(T)
        A0[spec.r_d + r, spec.off_d + r] = 1.0             # d box
        r = ar(T * K)
        A0[spec.r_obs + r, spec.off_d + r // K] = -1.0     # obstacle rows: -1 on d_t
    return A0


def _dyn_indices(spec: NRMPSpec, device=None):
    """Index grids scattering A_t (T, 3, 3) / B_t (T, 3, 2) into the dyn rows."""
    T = spec.T
    t = torch.arange(T, device=device)[:, None, None]
    r = torch.arange(3, device=device)[None, :, None]
    rows_a = (3 * t + r).expand(T, 3, 3)
    cols_a = (3 * t + torch.arange(3, device=device)[None, None, :]).expand(T, 3, 3)
    rows_b = (3 * t + r).expand(T, 3, 2)
    cols_b = (spec.off_u + 2 * t + torch.arange(2, device=device)[None, None, :]).expand(T, 3, 2)
    return rows_a, cols_a, rows_b, cols_b


def _obs_indices(spec: NRMPSpec, device=None):
    T, K = spec.T, spec.K
    t = torch.arange(T, device=device)[:, None, None]
    i = torch.arange(K, device=device)[None, :, None]
    rows = (spec.r_obs + t * K + i).expand(T, K, 2)
    cols = (3 * (t + 1) + torch.arange(2, device=device)[None, None, :]).expand(T, K, 2)
    return rows, cols


def _pair(values: Tuple[float, float], reps: int, like: torch.Tensor) -> torch.Tensor:
    """(v0, v1) tiled ``reps`` times, built on device: (2 * reps,)."""
    return torch.stack([torch.full((reps,), float(values[0]), dtype=like.dtype, device=like.device),
                        torch.full((reps,), float(values[1]), dtype=like.dtype, device=like.device)],
                       dim=-1).reshape(-1)


def build_qp(spec: NRMPSpec, adjust: AdjustParams,
             nom_s: torch.Tensor, nom_u: torch.Tensor,
             ref_s: torch.Tensor, ref_us: torch.Tensor,
             A_dyn: torch.Tensor, B_dyn: torch.Tensor, C_dyn: torch.Tensor,
             fa: Optional[torch.Tensor] = None,
             fb: Optional[torch.Tensor] = None) -> QPData:
    """Assemble the NRMP QP of each scenario.

    nom_s/ref_s (B, 3, T+1), nom_u (B, 2, T), ref_us (B, T), A_dyn
    (B, T, 3, 3), B_dyn (B, T, 3, 2), C_dyn (B, T, 3, 1), fa (B, T, K, 2),
    fb (B, T, K). Returns QPData with every field batched.
    """
    T, K = spec.T, spec.K
    B = nom_s.shape[0]
    dtype, dev = nom_s.dtype, nom_s.device

    q_s_vec = torch.reshape(adjust.q_s, (-1,)).to(dtype).expand(3)
    p_u = adjust.p_u.to(dtype)
    m_s = torch.ones(3, dtype=dtype, device=dev)
    if spec.kinematics == "omni":
        m_s[2] = 0.0   # omni tracks x, y only

    # objective
    w_s = m_s * q_s_vec ** 2
    P_s = (2.0 * w_s + spec.bk).repeat(T + 1)
    q_lin_s = (-2.0 * w_s[None, :, None] * ref_s - spec.bk * nom_s).transpose(1, 2).reshape(B, -1)
    P_u = torch.stack([2.0 * p_u ** 2 + spec.reg_u,
                       torch.full_like(p_u, spec.reg_u)]).repeat(T)
    nom_u_flat = nom_u.transpose(1, 2).reshape(B, -1)
    q_lin_u = torch.stack([-2.0 * p_u ** 2 * ref_us, torch.zeros_like(ref_us)],
                          dim=-1).reshape(B, -1) - spec.reg_u * nom_u_flat
    if spec.no_obs:
        P_diag = torch.cat([P_s, P_u])
        q_lin = torch.cat([q_lin_s, q_lin_u], dim=1)
    else:
        P_d = torch.full((T,), spec.reg_d, dtype=dtype, device=dev)
        q_lin_d = torch.full((B, T), -1.0, dtype=dtype, device=dev) * adjust.eta.to(dtype)
        P_diag = torch.cat([P_s, P_u, P_d])
        q_lin = torch.cat([q_lin_s, q_lin_u, q_lin_d], dim=1)

    # constraint matrix
    A = _static_template(spec, dtype, dev).expand(B, spec.m, spec.n).clone()
    rows_a, cols_a, rows_b, cols_b = _dyn_indices(spec, dev)
    A[:, rows_a, cols_a] = A_dyn.to(dtype)
    A[:, rows_b, cols_b] = B_dyn.to(dtype)
    if not spec.no_obs:
        rows_o, cols_o = _obs_indices(spec, dev)
        A[:, rows_o, cols_o] = fa.to(dtype)

    # bounds
    neg_C = -C_dyn[..., 0].reshape(B, -1)
    s0 = nom_s[:, :, 0]
    acce = _pair(spec.acce_bound, T - 1, nom_s).expand(B, -1)
    speed = _pair(spec.speed_bound, T, nom_s).expand(B, -1)
    l_parts = [neg_C, s0, -acce, -speed]
    u_parts = [neg_C, s0, acce, speed]
    soft = None
    if not spec.no_obs:
        ones = torch.ones((B, T), dtype=dtype, device=dev)
        # at d_min == 0 exactly the clamp passes the whole gradient where
        # jnp.maximum passes half; only a tuner that drives d_min to 0 sees it
        d_lo = ones * torch.clamp(adjust.d_min, min=0.0).to(dtype)
        d_hi = ones * adjust.d_max.to(dtype)
        l_parts += [d_lo, fb.reshape(B, -1).to(dtype)]
        u_parts += [d_hi, torch.full((B, T * K), _INF, dtype=dtype, device=dev)]
        soft = torch.cat([torch.zeros((B, spec.r_obs), dtype=dtype, device=dev),
                          torch.full((B, T * K), spec.ro_obs, dtype=dtype, device=dev)], dim=1)

    return QPData(P_diag=P_diag.expand(B, -1).contiguous(), q=q_lin, A=A,
                  l=torch.cat(l_parts, dim=1), u=torch.cat(u_parts, dim=1), soft=soft)


def condensation(spec: NRMPSpec, A_dyn: torch.Tensor, B_dyn: torch.Tensor,
                 C_dyn: torch.Tensor, s0: torch.Tensor):
    """Nullspace basis of the equality block: every feasible x = Z w + xp
    with w = (u, d). Returns Z (B, n, k) and xp (B, n)."""
    T = spec.T
    B = A_dyn.shape[0]
    dtype, dev = A_dyn.dtype, A_dyn.device
    M = torch.zeros((B, 3, 2 * T), dtype=dtype, device=dev)
    rows = [M]
    for t in range(T):
        M = torch.bmm(A_dyn[:, t], M)
        M[:, :, 2 * t:2 * t + 2] += B_dyn[:, t]
        rows.append(M)
    s_block = torch.stack(rows, dim=1).reshape(B, -1, 2 * T)     # (B, 3(T+1), 2T)
    eye_u = torch.eye(2 * T, dtype=dtype, device=dev).expand(B, -1, -1)
    if spec.no_obs:
        Z = torch.cat([s_block, eye_u], dim=1)
    else:
        zeros = lambda r, c: torch.zeros((B, r, c), dtype=dtype, device=dev)
        top = torch.cat([s_block, zeros(spec.n_s, T)], dim=2)
        mid = torch.cat([eye_u, zeros(2 * T, T)], dim=2)
        bot = torch.cat([zeros(T, 2 * T),
                         torch.eye(T, dtype=dtype, device=dev).expand(B, -1, -1)], dim=2)
        Z = torch.cat([top, mid, bot], dim=1)

    s = s0
    s_rows = [s0]
    for t in range(T):
        s = torch.bmm(A_dyn[:, t], s[:, :, None])[:, :, 0] + C_dyn[:, t, :, 0]
        s_rows.append(s)
    xp = torch.cat([torch.stack(s_rows, dim=1).reshape(B, -1),
                    torch.zeros((B, spec.n - spec.n_s), dtype=dtype, device=dev)], dim=1)
    return Z, xp


def unpack_solution(spec: NRMPSpec, x: torch.Tensor):
    """Split x (B, n) into s (B, 3, T+1), u (B, 2, T), d (B, T) or None."""
    T, B = spec.T, x.shape[0]
    s = x[:, :spec.n_s].reshape(B, T + 1, 3).transpose(1, 2)
    u = x[:, spec.off_u:spec.off_u + spec.n_u].reshape(B, T, 2).transpose(1, 2)
    d = None if spec.no_obs else x[:, spec.off_d:spec.off_d + T]
    return s, u, d


def coefficients_from_dune(spec: NRMPSpec, mu_k, lam_k, points_k, valid_k,
                           h: torch.Tensor, has_points: torch.Tensor):
    """Obstacle coefficients (fa (B, T, K, 2), fb (B, T, K)) of frames 1..T.

    fa = lam', fb = lam'p + mu'h per slot; invalid slots copy slot 0 (the
    closest point); with no points at all fa = fb = 0.
    """
    lam_f, mu_f, pts_f, val_f = lam_k[:, 1:], mu_k[:, 1:], points_k[:, 1:], valid_k[:, 1:]
    fa = lam_f.transpose(2, 3)
    fb = (torch.einsum("ntak,ntak->ntk", lam_f, pts_f)
          + torch.einsum("ntek,e->ntk", mu_f, h[:, 0]))
    fa = torch.where(val_f[..., None], fa, fa[:, :, 0:1, :])
    fb = torch.where(val_f, fb, fb[:, :, 0:1])
    fa = torch.where(has_points[:, None, None, None], fa, torch.zeros_like(fa))
    fb = torch.where(has_points[:, None, None], fb, torch.zeros_like(fb))
    return fa, fb
