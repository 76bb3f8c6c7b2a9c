"""The plain reference of one NeuPAN planner step, batched over scenarios.

A frozen copy of the step's mathematics as the port's plain versions do
it: the exact-distance selection of the K closest points per horizon
frame from the point flow, the DUNE encoder on those points, their duals
and distances, the NRMP QP's assembly and condensation, the condensed
ADMM with Ruiz scaling in two rho phases, the box-eliminating active-set
polish and the bound snap, and the PAN loop with its per-scenario early
stop. Plain ``torch`` operations only, in float32 (the configuration's
precision, TF32 off) or float64. It imports nothing of the program and
takes nothing the program made: the geometry comes from the
configuration, the encoder from the checkpoint read with numpy.

Only the differential-drive kinematics and the default solver path
(condensed ADMM, box polish) are written out: those are what the
configurations in ``benchmark/configs`` run.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

INF_KEY = 1e9       # ranking key of a masked point; distance of an empty slot
BIG = 1e20          # stand-in for an infinite bound


# -- the problem, from the configuration -----------------------------------------

@dataclasses.dataclass(frozen=True)
class Problem:
    T: int
    dt: float
    K: int
    P: int
    vertices: np.ndarray        # (2, V) float64, counter-clockwise
    G: np.ndarray               # (E, 2)
    h: np.ndarray               # (E, 1)
    speed: tuple                # per-control bounds
    acce: tuple                 # per-step bounds (max_acce * dt)
    adjust: dict
    nrmp: dict
    solver: dict
    iter_num: int
    iter_threshold: float
    checkpoint: str

    @property
    def n(self) -> int:        # x = (s, u, d)
        return 3 * (self.T + 1) + 2 * self.T + self.T

    @property
    def m(self) -> int:
        return 3 * self.T + 3 + 2 * (self.T - 1) + 2 * self.T + self.T + self.T * self.K

    @property
    def n_eq(self) -> int:
        return 3 * self.T + 3

    @property
    def n_acc(self) -> int:
        return 2 * (self.T - 1)

    @property
    def n_hard(self) -> int:   # acceleration, speed and d-box rows
        return 2 * (self.T - 1) + 2 * self.T + self.T


def problem_from_config(cfg: dict, root: str) -> Problem:
    """The step that the configuration ``cfg`` (a ``benchmark/configs`` file)
    states; ``root`` is the checkout the checkpoint path is relative to."""
    robot = cfg["robot"]
    if robot["kinematics"] != "diff":
        raise ValueError("the reference writes out the diff kinematics only")
    length, width = float(robot["length"]), float(robot["width"])
    sx, sy = -length / 2.0, -width / 2.0
    verts = np.array([[sx, sx + length, sx + length, sx], [sy, sy, sy + width, sy + width]])
    edges = np.roll(verts, -1, axis=1) - verts
    G = np.stack([edges[1], -edges[0]], axis=1)
    h = np.einsum("nd,dn->n", G, verts)[:, None]
    dt = float(cfg["step_time"])
    pan = cfg["pan"]
    return Problem(
        T=int(cfg["receding"]), dt=dt, K=int(pan["nrmp_max_num"]), P=int(pan["dune_max_num"]),
        vertices=verts, G=G, h=h, speed=tuple(float(v) for v in robot["max_speed"]),
        acce=tuple(float(v) * dt for v in robot["max_acce"]), adjust=dict(cfg["adjust"]),
        nrmp=dict(cfg["nrmp"]), solver=dict(cfg["solver"]), iter_num=int(pan["iter_num"]),
        iter_threshold=float(pan["iter_threshold"]),
        checkpoint=os.path.join(root, pan["dune_checkpoint"]))


class Encoder:
    """The DUNE encoder from its ``.npz`` checkpoint (``w_i`` stored (in, out)):
    2 -> 32 [LayerNorm, tanh] -> 32 [ReLU] -> 32 [LayerNorm, tanh] -> 32 [ReLU]
    -> 32 [LayerNorm, tanh] -> E [ReLU]."""

    def __init__(self, path: str, dtype, device):
        with np.load(path) as data:
            self.p = {k: torch.tensor(np.asarray(data[k], np.float64), dtype=dtype, device=device)
                      for k in data.files}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p

        def ln(v, j):
            mean = v.mean(dim=-1, keepdim=True)
            var = ((v - mean) ** 2).mean(dim=-1, keepdim=True)
            return (v - mean) * torch.rsqrt(var + 1e-5) * p[f"ln{j}_scale"] + p[f"ln{j}_bias"]

        x = torch.tanh(ln(x @ p["w0"] + p["b0"], 0))
        x = torch.relu(x @ p["w1"] + p["b1"])
        x = torch.tanh(ln(x @ p["w2"] + p["b2"], 1))
        x = torch.relu(x @ p["w3"] + p["b3"])
        x = torch.tanh(ln(x @ p["w4"] + p["b4"], 2))
        return torch.relu(x @ p["w5"] + p["b5"])


class State(NamedTuple):
    """The carried state of a batch, field for field the program's PANState."""
    prev_mu: torch.Tensor          # (B, T+1, E, K)
    prev_lam: torch.Tensor         # (B, T+1, 2, K)
    prev_s: torch.Tensor           # (B, 3, T+1)
    prev_u: torch.Tensor           # (B, 2, T)
    prev_valid: torch.Tensor       # (B,) bool
    prev_has_points: torch.Tensor  # (B,) bool
    x_warm: torch.Tensor           # (B, n)
    y_warm: torch.Tensor           # (B, m)


class Output(NamedTuple):
    opt_s: torch.Tensor
    opt_u: torch.Tensor
    opt_d: torch.Tensor
    min_distance: torch.Tensor
    nrmp_points: torch.Tensor      # (B, 2, K) frame-0 points
    nrmp_valid: torch.Tensor
    state: State
    trail: dict                    # per PAN iteration: x, stop measure, done flag


def empty_state(pb: Problem, B: int, dtype, device) -> State:
    z = lambda *s: torch.zeros((B, *s), dtype=dtype, device=device)
    f = torch.zeros((B,), dtype=torch.bool, device=device)
    E = pb.G.shape[0]
    return State(z(pb.T + 1, E, pb.K), z(pb.T + 1, 2, pb.K), z(3, pb.T + 1), z(2, pb.T), f,
                 f.clone(), z(pb.n), z(pb.m))


# -- DUNE --------------------------------------------------------------------------

def dune(pb: Problem, enc: Encoder, points, velocities, mask, nom_s):
    """The K closest points of every frame by the exact polygon distance,
    with their duals mu, lam = -R G' mu and distances d = mu'(G p0 - h)."""
    dtype, dev = points.dtype, points.device
    T1, K = pb.T + 1, pb.K
    theta = nom_s[:, 2, :]
    c, s = torch.cos(theta), torch.sin(theta)                          # (B, T+1)
    tx, ty = nom_s[:, 0, :], nom_s[:, 1, :]
    step = torch.arange(T1, dtype=dtype, device=dev) * pb.dt
    # the point flow: frame t sees p + t dt v in the robot frame R_t'(p - t_t)
    px, py = points[:, 0:1, :], points[:, 1:2, :]
    vx, vy = velocities[:, 0:1, :], velocities[:, 1:2, :]
    dx = (px + step[None, :, None] * vx) - tx[:, :, None]
    dy = (py + step[None, :, None] * vy) - ty[:, :, None]
    x = c[:, :, None] * dx + s[:, :, None] * dy
    y = c[:, :, None] * dy - s[:, :, None] * dx

    # ranking key: squared distance to the nearest edge outside, the largest
    # normalized face margin inside, INF_KEY for a masked point
    verts = torch.tensor(pb.vertices, dtype=dtype, device=dev)
    e_xy = torch.roll(verts, -1, dims=1) - verts
    inv_ee = 1.0 / torch.clamp(torch.sum(e_xy * e_xy, dim=0), min=1e-12)
    Gt = torch.tensor(pb.G, dtype=dtype, device=dev)
    ht = torch.tensor(pb.h, dtype=dtype, device=dev)
    g_norm = torch.sqrt(torch.sum(Gt * Gt, dim=1, keepdim=True))
    Gn, hn = Gt / g_norm, ht / g_norm
    d_out = torch.full_like(x, INF_KEY)
    for j in range(verts.shape[1]):
        ax, ay, ex, ey = verts[0, j], verts[1, j], e_xy[0, j], e_xy[1, j]
        t = torch.clamp(((x - ax) * ex + (y - ay) * ey) * inv_ee[j], 0.0, 1.0)
        ddx, ddy = x - (ax + ex * t), y - (ay + ey * t)
        d_out = torch.minimum(d_out, ddx * ddx + ddy * ddy)
    d_in = torch.full_like(x, -INF_KEY)
    for e in range(Gn.shape[0]):
        d_in = torch.maximum(d_in, Gn[e, 0] * x + Gn[e, 1] * y - hn[e, 0])
    key = torch.where(d_in <= 0.0, d_in, d_out)
    key = torch.where(mask[:, None, :], key, torch.full_like(key, INF_KEY))
    keys, idx = torch.sort(key, dim=-1, stable=True)                  # ties: lower index
    valid = keys[..., :K] < INF_KEY * 0.5
    idx = idx[..., :K]                                                 # (B, T+1, K)

    pick = lambda a: torch.gather(a, 2, idx)
    pgx = torch.gather(px.expand(-1, T1, -1), 2, idx) + step[None, :, None] * pick(vx.expand(-1, T1, -1))
    pgy = torch.gather(py.expand(-1, T1, -1), 2, idx) + step[None, :, None] * pick(vy.expand(-1, T1, -1))
    rx, ry = pgx - tx[:, :, None], pgy - ty[:, :, None]
    p0x = c[:, :, None] * rx + s[:, :, None] * ry                      # robot frame
    p0y = c[:, :, None] * ry - s[:, :, None] * rx
    p0 = torch.stack([p0x, p0y], dim=-1)                              # (B, T+1, K, 2)

    mu = enc(p0)                                                       # (B, T+1, K, E)
    # lam = -R G' mu with R = [[c, -s], [s, c]]
    gx = mu @ Gt[:, 0]                                                 # sum_e G[e,0] mu_e
    gy = mu @ Gt[:, 1]
    lam = -torch.stack([c[:, :, None] * gx - s[:, :, None] * gy,
                        s[:, :, None] * gx + c[:, :, None] * gy], dim=2)  # (B, T+1, 2, K)
    Gp = p0 @ Gt.T - ht[:, 0]                                         # (B, T+1, K, E)
    dist = torch.sum(mu * Gp, dim=-1)
    dist = torch.where(valid, dist, torch.full_like(dist, INF_KEY))
    return dict(mu=mu.transpose(2, 3), lam=lam, points=torch.stack([pgx, pgy], dim=2),
                dist=dist, valid=valid, min_distance=torch.min(dist[:, 0], dim=-1).values)


# -- NRMP: the QP of one PAN iteration ---------------------------------------------

def linearize(pb: Problem, nom_s, nom_u):
    """s_{t+1} = A_t s_t + B_t u_t + C_t about the nominal, diff drive."""
    dt, T = pb.dt, pb.T
    phi, v = nom_s[:, 2, :T], nom_u[:, 0, :]
    sp, cp = torch.sin(phi), torch.cos(phi)
    z, o = torch.zeros_like(v), torch.ones_like(v)
    st = lambda rows: torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    A = st([[o, z, -v * dt * sp], [z, o, v * dt * cp], [z, z, o]])
    Bm = st([[cp * dt, z], [sp * dt, z], [z, dt * o]])
    C = torch.stack([phi * v * sp * dt, -phi * v * cp * dt, z], dim=-1)
    return A, Bm, C


def build_qp(pb: Problem, nom_s, nom_u, ref_s, ref_us, A_dyn, B_dyn, C_dyn, du):
    """P_diag (B, n), q (B, n), A (B, m, n), l, u, soft (B, m). Rows:
    dynamics (3T), init (3), acc (2(T-1)), speed (2T), d box (T), obstacles (TK)."""
    T, K, n, m = pb.T, pb.K, pb.n, pb.m
    B, dtype, dev = nom_s.shape[0], nom_s.dtype, nom_s.device
    a, c = pb.adjust, pb.nrmp
    n_s, off_u, off_d = 3 * (T + 1), 3 * (T + 1), 3 * (T + 1) + 2 * T
    q_s, p_u, eta = float(a["q_s"]), float(a["p_u"]), float(a["eta"])
    w_s = q_s ** 2
    P = torch.cat([torch.full((n_s,), 2.0 * w_s + c["bk"], dtype=dtype, device=dev),
                   torch.tensor([2.0 * p_u ** 2 + c["reg_u"], c["reg_u"]] * T, dtype=dtype,
                                device=dev),
                   torch.full((T,), c["reg_d"], dtype=dtype, device=dev)]).expand(B, n)
    q_s_lin = (-2.0 * w_s * ref_s - c["bk"] * nom_s).transpose(1, 2).reshape(B, -1)
    q_u_lin = (torch.stack([-2.0 * p_u ** 2 * ref_us, torch.zeros_like(ref_us)], dim=-1)
               .reshape(B, -1) - c["reg_u"] * nom_u.transpose(1, 2).reshape(B, -1))
    q = torch.cat([q_s_lin, q_u_lin, torch.full((B, T), -eta, dtype=dtype, device=dev)], dim=1)

    A = torch.zeros((B, m, n), dtype=dtype, device=dev)
    for t in range(T):
        A[:, 3 * t:3 * t + 3, 3 * t:3 * t + 3] = A_dyn[:, t]
        A[:, 3 * t:3 * t + 3, off_u + 2 * t:off_u + 2 * t + 2] = B_dyn[:, t]
        for r in range(3):
            A[:, 3 * t + r, 3 * t + 3 + r] = -1.0
    r_init = 3 * T
    for r in range(3):
        A[:, r_init + r, r] = 1.0
    r_acc = r_init + 3
    for i in range(2 * (T - 1)):
        A[:, r_acc + i, off_u + 2 + i] = 1.0
        A[:, r_acc + i, off_u + i] = -1.0
    r_spd = r_acc + 2 * (T - 1)
    for i in range(2 * T):
        A[:, r_spd + i, off_u + i] = 1.0
    r_d = r_spd + 2 * T
    for t in range(T):
        A[:, r_d + t, off_d + t] = 1.0
    r_obs = r_d + T
    fa, fb = du
    for t in range(T):
        for k in range(K):
            row = r_obs + t * K + k
            A[:, row, 3 * (t + 1):3 * (t + 1) + 2] = fa[:, t, k]
            A[:, row, off_d + t] = -1.0

    acce = torch.tensor([pb.acce[0], pb.acce[1]] * (T - 1), dtype=dtype, device=dev).expand(B, -1)
    speed = torch.tensor([pb.speed[0], pb.speed[1]] * T, dtype=dtype, device=dev).expand(B, -1)
    neg_C = -C_dyn.reshape(B, -1)
    s0 = nom_s[:, :, 0]
    ones = torch.ones((B, T), dtype=dtype, device=dev)
    l = torch.cat([neg_C, s0, -acce, -speed, ones * max(float(a["d_min"]), 0.0),
                   fb.reshape(B, -1)], dim=1)
    u = torch.cat([neg_C, s0, acce, speed, ones * float(a["d_max"]),
                   torch.full((B, T * K), BIG, dtype=dtype, device=dev)], dim=1)
    soft = torch.cat([torch.zeros((B, r_obs), dtype=dtype, device=dev),
                      torch.full((B, T * K), float(c["ro_obs"]), dtype=dtype, device=dev)], dim=1)
    return P.contiguous(), q, A, l, u, soft


def obstacle_rows(pb: Problem, d, has_points):
    """fa (B, T, K, 2) = lam', fb (B, T, K) = lam'p + mu'h of frames 1..T;
    an empty slot copies slot 0, no points at all gives zeros."""
    lam, mu, pts, val = d["lam"][:, 1:], d["mu"][:, 1:], d["points"][:, 1:], d["valid"][:, 1:]
    h = torch.tensor(pb.h[:, 0], dtype=lam.dtype, device=lam.device)
    fa = lam.transpose(2, 3)
    fb = torch.sum(lam * pts, dim=2) + torch.sum(mu * h[None, None, :, None], dim=2)
    fa = torch.where(val[..., None], fa, fa[:, :, 0:1, :])
    fb = torch.where(val, fb, fb[:, :, 0:1])
    fa = torch.where(has_points[:, None, None, None], fa, torch.zeros_like(fa))
    fb = torch.where(has_points[:, None, None], fb, torch.zeros_like(fb))
    return fa, fb


def nullspace(pb: Problem, A_dyn, B_dyn, C_dyn, s0):
    """x = Z w + xp for every x meeting the dynamics and initial rows, w = (u, d)."""
    T = pb.T
    B, dtype, dev = A_dyn.shape[0], A_dyn.dtype, A_dyn.device
    M = torch.zeros((B, 3, 2 * T), dtype=dtype, device=dev)
    rows = [M]
    for t in range(T):
        M = torch.bmm(A_dyn[:, t], M)
        M[:, :, 2 * t:2 * t + 2] += B_dyn[:, t]
        rows.append(M)
    Zs = torch.cat([torch.stack(rows, dim=1).reshape(B, -1, 2 * T),
                    torch.zeros((B, 3 * (T + 1), T), dtype=dtype, device=dev)], dim=2)
    Z = torch.cat([Zs, torch.eye(3 * T, dtype=dtype, device=dev).expand(B, -1, -1)], dim=1)
    s, srows = s0, [s0]
    for t in range(T):
        s = torch.bmm(A_dyn[:, t], s[:, :, None])[:, :, 0] + C_dyn[:, t]
        srows.append(s)
    xp = torch.cat([torch.stack(srows, dim=1).reshape(B, -1),
                    torch.zeros((B, 3 * T), dtype=dtype, device=dev)], dim=1)
    return Z, xp


# -- the QP solver ---------------------------------------------------------------------

def mv(A, v):
    return torch.bmm(A, v[:, :, None])[:, :, 0]


def mtv(A, v):
    return torch.bmm(A.transpose(1, 2), v[:, :, None])[:, :, 0]


def amax(v):
    return torch.amax(torch.abs(v), dim=-1)


def sweep_inverse(M):
    """Inverse of a batch of SPD matrices by the sweep operator."""
    A = M.clone()
    for j in range(M.shape[-1]):
        row = A[:, j, :].clone()
        inv_d = 1.0 / row[:, j:j + 1]
        rs = row * inv_d
        A = A - row[:, :, None] * rs[:, None, :]
        A[:, j, :] = rs
        A[:, :, j] = rs
        A[:, j, j] = -inv_d[:, 0]
    return -A


def spd_inverse(M):
    """Jacobi scaling, a 1e-7 ridge, the sweep (Cholesky above n = 96), unscaling."""
    n = M.shape[-1]
    dj = 1.0 / torch.sqrt(torch.abs(torch.diagonal(M, dim1=-2, dim2=-1)) + 1e-30)
    Mt = M * dj[:, :, None] * dj[:, None, :] + 1e-7 * torch.eye(n, dtype=M.dtype, device=M.device)
    if n <= 96:
        X = sweep_inverse(Mt)
    else:
        eye = torch.eye(n, dtype=M.dtype, device=M.device).expand_as(Mt)
        X = torch.cholesky_solve(eye, torch.linalg.cholesky(Mt))
    return X * dj[:, :, None] * dj[:, None, :]


def ruiz(H, qv, A, l, u, soft, iters):
    B, m, k = A.shape
    D = torch.ones((B, k), dtype=H.dtype, device=H.device)
    E = torch.ones((B, m), dtype=H.dtype, device=H.device)
    c = torch.ones((B,), dtype=H.dtype, device=H.device)
    for _ in range(iters):
        col = torch.sqrt(torch.clamp(torch.maximum(torch.amax(torch.abs(A), dim=1),
                                                   torch.amax(torch.abs(H), dim=1)), min=1e-8))
        row = torch.sqrt(torch.clamp(torch.amax(torch.abs(A), dim=2), min=1e-8))
        d, e = 1.0 / col, 1.0 / row
        H = H * d[:, :, None] * d[:, None, :]
        qv = qv * d
        A = A * e[:, :, None] * d[:, None, :]
        g = 1.0 / torch.clamp(torch.maximum(torch.mean(torch.abs(H), dim=(1, 2)), amax(qv)), min=1e-8)
        g = torch.clamp(g, 1e-6, 1e6)
        H, qv = H * g[:, None, None], qv * g[:, None]
        D, E, c = D * d, E * e, c * g
    return H, qv, A, E * l, E * u, c[:, None] * soft / (E * E), D, E, c


def admm_iterations(Minv, As, qs, ls, us, soft, rho, w, z, y, iters, sigma, alpha):
    inv_rho, soft_fac, is_soft = 1.0 / rho, rho / (rho + soft), soft > 0.0
    AsT = As.transpose(1, 2)
    for _ in range(iters):
        t = rho * z - y
        rhs = sigma * w - qs + mv(AsT, t)
        w_t = mv(Minv, rhs)
        z_t = mv(As, w_t)
        w_new = alpha * w_t + (1.0 - alpha) * w
        z_mix = alpha * z_t + (1.0 - alpha) * z
        v = z_mix + y * inv_rho
        z_sf = torch.where(v >= ls, v, ls + (v - ls) * soft_fac)
        z_new = torch.where(is_soft, torch.minimum(z_sf, us), torch.clamp(v, ls, us))
        y = y + rho * (z_mix - z_new)
        w, z = w_new, z_new
    return w, z, y


def admm_condensed(pb: Problem, cfg: dict, iters: int, qp, x0, y0, Z, xp, Geq_inv):
    P, q, A, l, u, soft = qp
    n_eq, k = pb.n_eq, Z.shape[-1]
    A_r = A[:, n_eq:]
    Ar = torch.bmm(A_r, Z)
    Axp = mv(A_r, xp)
    l_r = torch.clamp(l[:, n_eq:] - Axp, min=-BIG)
    u_r = torch.clamp(u[:, n_eq:] - Axp, max=BIG)
    Hr = torch.bmm(Z.transpose(1, 2), Z * P[:, :, None])
    qr = mtv(Z, q + P * xp)
    Hs, qs, As, ls, us, soft_s, D, E, c = ruiz(Hr, qr, Ar, l_r, u_r, soft[:, n_eq:],
                                               cfg["ruiz_iters"])
    ls, us = torch.clamp(ls, min=-BIG), torch.clamp(us, max=BIG)
    w = x0[:, -k:] / D
    y = c[:, None] * y0[:, n_eq:] / E

    B, m, _ = As.shape
    sigma, alpha = float(cfg["sigma"]), float(cfg["alpha"])
    is_eq = (us - ls) < 1e-9
    H_sig = Hs + sigma * torch.eye(k, dtype=Hs.dtype, device=Hs.device)
    n_phases = max(1, int(cfg["rho_updates"]) + 1)
    per_phase = max(iters // n_phases, 1)
    base = torch.full((B,), float(cfg["rho"]), dtype=Hs.dtype, device=Hs.device)
    z = torch.clamp(mv(As, w), ls, us)
    for i in range(n_phases):
        rho = torch.where(is_eq, base[:, None] * cfg["rho_eq_scale"], base[:, None])
        M = H_sig + torch.bmm((As * rho[:, :, None]).transpose(1, 2), As)
        its = per_phase if i < n_phases - 1 else iters - per_phase * (n_phases - 1)
        w, z, y = admm_iterations(spd_inverse(M), As, qs, ls, us, soft_s, rho, w, z, y, its,
                                  sigma, alpha)
        if i < n_phases - 1:   # residual balancing
            Aw, Hw, Aty = mv(As, w), mv(Hs, w), mtv(As, y)
            rp = amax(Aw - z) / torch.clamp(torch.maximum(amax(Aw), amax(z)), min=1e-6)
            rd = amax(Hw + qs + Aty) / torch.clamp(torch.maximum(
                amax(Hw), torch.maximum(amax(Aty), amax(qs))), min=1e-6)
            scale = torch.clamp(torch.sqrt(rp / torch.clamp(rd, min=1e-12)), 1e-2, 1e2)
            base = torch.clamp(base * scale, 1e-4, 1e3)
    w = D * w
    y_r = E * y / c[:, None]
    x = mv(Z, w) + xp
    r_stat = -(P * x + q + mtv(A_r, y_r))
    y_eq = mv(Geq_inv, mv(A[:, :n_eq], r_stat))
    return x, torch.cat([y_eq, y_r], dim=1)


def kkt_error(qp, x, y):
    P, q, A, l, u, soft = qp
    Ax = mv(A, x)
    stat = amax(P * x + q + mtv(A, y))
    viol = torch.clamp(torch.maximum(Ax - u, l - Ax), min=0.0)
    comp_u = torch.minimum(torch.clamp(y, min=0.0), torch.abs(u - Ax))
    comp_l = torch.minimum(torch.clamp(-y, min=0.0), torch.abs(Ax - l))
    is_soft, zero = soft > 0.0, torch.zeros_like(viol)
    viol = torch.where(is_soft, torch.abs(y - soft * torch.clamp(Ax - l, max=0.0)), viol)
    comp_u = torch.where(is_soft, zero, comp_u)
    comp_l = torch.where(is_soft, zero, comp_l)
    return torch.maximum(torch.maximum(stat, torch.amax(viol, dim=-1)),
                         torch.maximum(torch.amax(comp_u, dim=-1), torch.amax(comp_l, dim=-1)))


def polish_candidate(pb: Problem, cfg: dict, qp, low, up, soft_act, Z, xp, Geq_inv):
    """The active-set EQP with the bound-active coordinates of w pinned and
    the active acceleration rows in a dual Schur complement."""
    P, q, A, l, u, soft = qp
    l, u = torch.clamp(l, min=-BIG), torch.clamp(u, max=BIG)
    n_eq, n_acc = pb.n_eq, pb.n_acc
    sl_acc, sl_box = slice(n_eq, n_eq + n_acc), slice(n_eq + n_acc, n_eq + pb.n_hard)
    up_b = up[:, sl_box]
    act_box = low[:, sl_box] | up_b
    b_box = torch.where(act_box, torch.where(up_b, u[:, sl_box], l[:, sl_box]),
                        torch.zeros_like(l[:, sl_box]))
    fix = act_box.to(P.dtype)
    free = 1.0 - fix

    ssd = torch.sqrt(soft * soft_act.to(P.dtype))
    SA = A * ssd[:, :, None]
    SAtg3 = mtv(SA, ssd * l)
    soft_grad = lambda v: mtv(SA, mv(SA, v)) - SAtg3
    g1 = -q + SAtg3
    Pr = P + float(cfg["sigma"])
    SZ = torch.bmm(SA, Z)
    SZtSZ = torch.bmm(SZ.transpose(1, 2), SZ)
    Zt = Z.transpose(1, 2)
    Hr = torch.bmm(Zt, Z * Pr[:, :, None]) + SZtSZ
    g1r = mv(Zt, g1 - (Pr * xp + mtv(SA, mv(SA, xp))))

    A_accx = A[:, sl_acc]
    A_acc = torch.bmm(A_accx, Z)
    act_acc = low[:, sl_acc] | up[:, sl_acc]
    b_acc = torch.where(up[:, sl_acc], u[:, sl_acc], l[:, sl_acc])
    A_acc_f = A_acc * free[:, None, :]
    rn = torch.sqrt(torch.sum(A_acc_f * A_acc_f, dim=2))
    act_acc = act_acc & (rn > 1e-6)
    d = act_acc.to(P.dtype)
    rs = torch.where(act_acc, 1.0 / torch.clamp(rn, min=1e-8), torch.zeros_like(rn))
    DAn = (A_acc_f * d[:, :, None]) * rs[:, :, None]
    b_eff = b_acc - mv(A_accx, xp) - mv(A_acc, fix * b_box)
    g2n = torch.where(act_acc, b_eff * rs, torch.zeros_like(b_eff))
    Hr_ref = torch.bmm(Zt, Z * P[:, :, None]) + SZtSZ
    C0 = mv(Zt, -q - P * xp + SAtg3) - mtv(SZ, mv(SA, xp))

    # the candidate solve (the polish kernel's mathematics)
    Hm = Hr * free[:, :, None] * free[:, None, :] + torch.diag_embed(fix)
    Hm_inv = spd_inverse(Hm)
    DAnT = DAn.transpose(1, 2)
    HD = torch.bmm(DAn, Hm_inv)
    S_inv = spd_inverse(torch.bmm(HD, DAnT) + torch.diag_embed((1.0 - d) + 1e-6))

    def kkt_solve(r1, r_fix, r2n):
        t = free * (r1 - mv(Hr, fix * r_fix)) + fix * r_fix
        dw0 = mv(Hm_inv, t)
        dyn = mv(S_inv, mv(DAn, dw0) - r2n)
        return dw0 - mv(Hm_inv, free * mv(DAnT, dyn)), dyn

    w, yn = kkt_solve(g1r, b_box, g2n)
    for _ in range(int(cfg["refine_steps"])):
        r1 = C0 - mv(Hr_ref, w) - mv(DAnT, d * yn)
        r2n = g2n - (mv(DAn, w) + (1.0 - d) * yn)
        dw, dyn = kkt_solve(r1, fix * (b_box - w), r2n)
        w, yn = w + dw, yn + dyn

    x = mv(Z, w) + xp
    y_acc = d * yn * rs
    y_box = fix * ((C0 - mv(Hr_ref, w)) - mtv(A_acc, y_acc))
    m = A.shape[1]
    y_hard = torch.cat([y_acc, y_box], dim=1)
    y_soft = soft * torch.clamp(mv(A, x) - l, max=0.0)
    y_tail = torch.cat([y_hard, torch.zeros((x.shape[0], m - n_eq - y_hard.shape[1]),
                                            dtype=P.dtype, device=P.device)], dim=1)
    y_tail = torch.where(soft[:, n_eq:] > 0.0, y_soft[:, n_eq:], y_tail)
    r_stat = -q - P * x - soft_grad(x) - mtv(A[:, n_eq:], y_tail)
    y = torch.cat([mv(Geq_inv, mv(A[:, :n_eq], r_stat)), y_tail], dim=1)
    ok = torch.isfinite(x).all(dim=1) & torch.isfinite(y).all(dim=1)
    return x, y, ok


def polish(pb: Problem, cfg: dict, qp, x, y, Z, xp, Geq_inv):
    """Rounds of active-set identification at the best point so far, each
    candidate kept where its ranked KKT error improves enough."""
    P, q, A, l, u, soft = qp
    l, u = torch.clamp(l, min=-BIG), torch.clamp(u, max=BIG)
    is_eq, is_soft = (u - l) < 1e-9, soft > 0.0
    tol_scale = torch.clamp(torch.sqrt(torch.sum(A * A, dim=2)), min=1.0)
    qpc = (P, q, A, l, u, soft)

    def hard_viol(Ax):
        v = torch.abs(Ax - torch.clamp(Ax, l, u))
        return torch.amax(torch.where(is_soft, torch.zeros_like(v), v), dim=-1)

    rank = lambda Ax, e: torch.maximum(e, 5.0 * hard_viol(Ax))

    def identify(Ax, tol):
        lo = ((torch.abs(Ax - l) < tol) | (Ax < l)) & ~is_soft
        hi = ((torch.abs(Ax - u) < tol) | (Ax > u)) & ~is_soft
        return lo & ~is_eq, hi & ~is_eq, is_soft & (Ax - l < 0.0)

    Ax = mv(A, x)
    e0 = rank(Ax, kkt_error(qpc, x, y))
    tol0 = torch.clamp(10.0 * hard_viol(Ax), 1e-5, 1e-2)
    x_g, y_g, e_g = x, y, e0
    x_o, y_o, e_o = x, y, e0
    rounds = max(int(cfg["polish_rounds"]), 1)
    tols = [None] + [max(3e-3 * (0.3 ** (r - 1)), 3e-4) for r in range(1, rounds)]
    inf = torch.full_like(e0, float("inf"))
    eps_act = float(cfg["eps_act"])
    for r in range(rounds):
        Axg = mv(A, x_g)
        vlow, vup, sact = identify(Axg, (tol0[:, None] if r == 0 else tols[r]) * tol_scale)
        if r == 0:
            vlow = vlow | ((y < -eps_act) & ~is_eq & ~is_soft)
            vup = vup | ((y > eps_act) & ~is_eq & ~is_soft)
        drop = torch.clamp(0.3 * e_g, min=1e-3)[:, None]
        xc, yc, okc = polish_candidate(pb, cfg, qpc, vlow & ~(y_g > drop), vup & ~(y_g < -drop),
                                       sact, Z, xp, Geq_inv)
        ec = torch.where(okc, rank(mv(A, xc), kkt_error(qpc, xc, yc)), inf)
        use = (ec <= 0.3 * e_o) | ((ec <= 0.7 * e_o) & (e_o > 3e-2))
        x_o = torch.where(use[:, None], xc, x_o)
        y_o = torch.where(use[:, None], yc, y_o)
        e_o = torch.where(use, ec, e_o)
        better = ec < e_g
        x_g = torch.where(better[:, None], xc, x_g)
        y_g = torch.where(better[:, None], yc, y_g)
        e_g = torch.where(better, ec, e_g)
    return x_o, y_o


def snap(qp, x):
    """x projected onto its single-variable hard rows (speed, d box)."""
    P, q, A, l, u, soft = qp
    nz = torch.abs(A) > 1e-12
    is_box = (torch.sum(nz, dim=2) == 1) & ~(soft > 0.0) & (u - l >= 1e-9)
    a = torch.sum(torch.where(nz, A, torch.zeros_like(A)), dim=2)
    safe = torch.where(torch.abs(a) > 1e-12, a, torch.ones_like(a))
    lo = torch.clamp(torch.where(a > 0, l, u) / safe, min=-BIG)
    hi = torch.clamp(torch.where(a > 0, u, l) / safe, max=BIG)
    sel = nz & is_box[:, :, None]
    lo_v = torch.amax(torch.where(sel, lo[:, :, None], torch.full_like(A, -BIG)), dim=1)
    hi_v = torch.amin(torch.where(sel, hi[:, :, None], torch.full_like(A, BIG)), dim=1)
    return torch.clamp(x, lo_v, hi_v)


def solve(pb: Problem, cfg: dict, iters: int, qp, x0, y0, Z, xp):
    """Condensed ADMM, polish, snap: (x, y)."""
    A = qp[2]
    Aeq = A[:, :pb.n_eq]
    Geq_inv = spd_inverse(torch.bmm(Aeq, Aeq.transpose(1, 2))
                          + 1e-8 * torch.eye(pb.n_eq, dtype=A.dtype, device=A.device))
    x, y = admm_condensed(pb, cfg, iters, qp, x0, y0, Z, xp, Geq_inv)
    if cfg.get("polish", True):
        x, y = polish(pb, cfg, qp, x, y, Z, xp, Geq_inv)
        x = snap(qp, x)
    return x, y


# -- the PAN step -----------------------------------------------------------------------

def objective(qp, x):
    """1/2 x'Px + q'x plus the soft rows' penalty, and the largest violation
    of a hard row: what an answer of the QP is judged by."""
    P, q, A, l, u, soft = qp
    Ax = mv(A, x)
    pen = 0.5 * soft * torch.clamp(Ax - l, max=0.0) ** 2
    f = 0.5 * torch.sum(P * x * x, dim=1) + torch.sum(q * x, dim=1) + torch.sum(pen, dim=1)
    lc, uc = torch.clamp(l, min=-BIG), torch.clamp(u, max=BIG)
    v = torch.clamp(torch.maximum(Ax - uc, lc - Ax), min=0.0)
    return f, torch.amax(torch.where(soft > 0.0, torch.zeros_like(v), v), dim=1)


def step(pb: Problem, enc: Encoder, nom_s, nom_u, ref_s, ref_us, points, velocities, mask,
         state: State, keep_qps: bool = False) -> Output:
    """One PAN control step for a batch: ``iter_num`` rounds of DUNE, the
    QP at the current nominal and its solve; a scenario whose change from
    the carried values falls below ``iter_threshold`` keeps that round's
    result and discards the rest."""
    T, K = pb.T, pb.K
    B, dtype, dev = nom_s.shape[0], nom_s.dtype, nom_s.device
    cfg = pb.solver
    n_s, off_u = 3 * (T + 1), 3 * (T + 1)
    has_points = torch.any(mask, dim=1)
    n_valid = torch.clamp(torch.sum(mask.to(torch.int64), dim=1), max=K)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    min_d = torch.full((B,), INF_KEY, dtype=dtype, device=dev)
    opt_d = torch.zeros((B, T), dtype=dtype, device=dev)
    pts0 = torch.zeros((B, 2, K), dtype=dtype, device=dev)
    val0 = torch.zeros((B, K), dtype=torch.bool, device=dev)
    cur = state
    trail = {"x": [], "diff": [], "done": [], "qp": []}
    for it in range(pb.iter_num):
        iters = int(cfg["iters"]) if it == 0 else int(cfg["admm_warm_iters"])
        d = dune(pb, enc, points, velocities, mask, nom_s)
        fa, fb = obstacle_rows(pb, d, has_points)
        A_dyn, B_dyn, C_dyn = linearize(pb, nom_s, nom_u)
        qp = build_qp(pb, nom_s, nom_u, ref_s, ref_us, A_dyn, B_dyn, C_dyn, (fa, fb))
        Z, xp = nullspace(pb, A_dyn, B_dyn, C_dyn, nom_s[:, :, 0])
        x, y = solve(pb, cfg, iters, qp, cur.x_warm, cur.y_warm, Z, xp)
        s_new = x[:, :n_s].reshape(B, T + 1, 3).transpose(1, 2)
        u_new = x[:, off_u:off_u + 2 * T].reshape(B, T, 2).transpose(1, 2)
        d_new = x[:, off_u + 2 * T:]

        # the stop measure (reference pan.py:215-243)
        su = (torch.sum((s_new - cur.prev_s) ** 2, dim=(1, 2))
              + torch.sum((u_new - cur.prev_u) ** 2, dim=(1, 2)))
        cols = (torch.arange(K, device=dev)[None, :] < n_valid[:, None]).to(dtype)[:, None, None, :]
        denom = torch.clamp(n_valid, min=1).to(dtype)
        mu_d = torch.sqrt(torch.sum(((d["mu"] - cur.prev_mu) * cols) ** 2, dim=(1, 2, 3))) / denom
        lam_d = torch.sqrt(torch.sum(((d["lam"] - cur.prev_lam) * cols) ** 2, dim=(1, 2, 3))) / denom
        use_ml = has_points & cur.prev_has_points & (n_valid > 0)
        diff = torch.where(use_ml, mu_d ** 2 + lam_d ** 2, su)
        newly = (diff < pb.iter_threshold) & cur.prev_valid
        trail["x"].append(x)
        trail["diff"].append(diff)
        trail["done"].append(done.clone())
        if keep_qps:
            trail["qp"].append((qp, Z, xp))

        keep = done
        upd = lambda old, new: torch.where(keep.reshape(-1, *([1] * (old.dim() - 1))), old, new)
        nom_s, nom_u = upd(nom_s, s_new), upd(nom_u, u_new)
        opt_d, min_d = upd(opt_d, d_new), upd(min_d, d["min_distance"])
        pts0, val0 = upd(pts0, d["points"][:, 0]), upd(val0, d["valid"][:, 0])
        cur = State(upd(cur.prev_mu, d["mu"]), upd(cur.prev_lam, d["lam"]),
                    upd(cur.prev_s, s_new), upd(cur.prev_u, u_new), cur.prev_valid | ~keep,
                    upd(cur.prev_has_points, has_points), upd(cur.x_warm, x),
                    upd(cur.y_warm, y))
        done = done | newly
    min_d = torch.where(has_points, min_d, torch.full_like(min_d, INF_KEY))
    return Output(nom_s, nom_u, opt_d, min_d, pts0, val0, cur, trail)
