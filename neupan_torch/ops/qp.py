"""Batched OSQP-style ADMM QP solver (port of ``neupan_tpu/ops/qp.py``).

Solves a batch of QPs in standard form

    minimize    1/2 x' diag(P) x + q' x  (+ 0.5 soft_i min(A_i x - l_i, 0)^2)
    subject to  l <= A x <= u

The planner step runs the condensed path, for rows laid out as the NRMP
problem lays them out (ops/nrmp.py: equality rows first, then hard rows,
general acceleration rows before unit bounds on the reduced coordinates w,
then soft rows; ``ADMMConfig``'s ``elim_n_*`` statics filled by
``ops/pan.py:_admm_with_elim``):

1. the equality Gram inverse (sweep kernel, n = n_eq);
2. ADMM in the equality-eliminated space x = Z w + xp, Ruiz-equilibrated,
   in two rho phases with a residual-balancing rho update between them:
   each phase inverts its normal matrix (sweep kernel) and runs its
   iterations in the ADMM kernel;
3. ``polish_rounds`` rounds of the box-eliminating active-set polish, each
   candidate solved by the polish kernel;
4. a snap of x onto the single-variable bound rows.

The paths off it, each an ``ADMMConfig`` option as in the JAX package:
``condense_admm=False`` (or no elimination basis) runs the ADMM in the full
space, its normal matrix diag(P + sigma) + A' rho A inverted densely or,
with ``inverse="banded"``, by the block-tridiagonal factorization
(``ops/banded.py``), its iterations in the same ADMM kernel; a basis
without ``elim_n_acc`` polishes with the generic condensed candidate (dual
Schur over every hard row), no basis with the full-space candidate (dual
Schur over every row); ``polish=False`` returns the ADMM's iterate.
``solve_qp_batch`` solves generic QPs with no basis.

Every tensor carries the scenario batch as its leading axis. Shapes a
kernel does not admit (n > 96 inverses, which take the JAX package's
Cholesky route; an ADMM operator or a polish candidate too large for one
block) take the plain versions by an explicit admission check, as the JAX
package's gates do; no kernel error is caught.

``solve_qp`` is differentiable in the QP's fields (``_SolveQP``): the
backward is the JAX package's implicit differentiation of the active-set
KKT system at the solution, one batched linear solve; the forward keeps
running the kernels above. Both run with exact float32 matmuls, also
inside a step at ``precision="default"`` (neupan_tpu/ops/qp.py pins
"highest" for its solve and its backward alike).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from neupan_torch import matmul_precision
from neupan_torch.ops.banded import btd_spd_inverse
from neupan_torch.ops.kernels.admm import admm_fits, admm_iterate, admm_iterate_plain
from neupan_torch.ops.kernels.polish import box_candidate, box_candidate_plain, polish_fits
from neupan_torch.ops.kernels.sweep import spd_inverse_any

_BIG = 1e20  # stand-in for +inf bounds


class QPData(NamedTuple):
    """A batch of QPs in standard form; ``soft`` marks one-sided penalty rows."""

    P_diag: torch.Tensor  # (B, n)
    q: torch.Tensor       # (B, n)
    A: torch.Tensor       # (B, m, n)
    l: torch.Tensor       # (B, m)
    u: torch.Tensor       # (B, m)
    soft: Optional[torch.Tensor] = None  # (B, m)


class QPSolution(NamedTuple):
    x: torch.Tensor       # (B, n)
    y: torch.Tensor       # (B, m)
    z: torch.Tensor       # (B, m)
    r_prim: torch.Tensor  # (B,)
    r_dual: torch.Tensor  # (B,)


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Solver settings; the fields and defaults are the JAX package's
    qualified ones (neupan_tpu/ops/qp.py:ADMMConfig, where each is argued).

    ``elim_n_eq``/``elim_n_hard``/``elim_n_acc`` are the NRMP row-layout
    statics (filled by ops/pan.py:_admm_with_elim): with an elimination
    basis they select the condensed ADMM (``condense_admm``) and the
    box-eliminating polish (``elim_n_acc``; None = the generic condensed
    candidate). ``inverse="banded"`` with a ``banded_perm`` inverts the
    full-space normal matrix by the block-tridiagonal factorization in
    blocks of ``banded_block``; any other value (or no permutation) means
    the dense inverse. ``polish=False`` skips the polish and the bound snap.
    """

    iters: int = 240
    rho: float = 1.0
    rho_updates: int = 1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    polish: bool = True
    polish_delta: float = 1e-7
    refine_steps: int = 7
    eps_act: float = 1e-5
    polish_rounds: int = 5
    ruiz_iters: int = 10
    elim_n_eq: Optional[int] = None
    elim_n_hard: Optional[int] = None
    elim_n_acc: Optional[int] = None
    condense_admm: bool = True
    inverse: str = "auto"
    banded_perm: Optional[Tuple[int, ...]] = None
    banded_block: int = 6


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: (B, r, c) @ (B, c) -> (B, r)."""
    return torch.bmm(A, v[:, :, None])[:, :, 0]


def _mtv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched transposed product: (B, r, c)' @ (B, r) -> (B, c)."""
    return torch.bmm(A.transpose(1, 2), v[:, :, None])[:, :, 0]


def _amax(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(v), dim=-1)


def _clip_bounds(l: torch.Tensor, u: torch.Tensor):
    return torch.clamp(l, min=-_BIG), torch.clamp(u, max=_BIG)


def _ruiz_equilibrate_dense(H, qv, A, l, u, soft, iters: int = 10):
    """Ruiz equilibration with a dense quadratic term H (condensed ADMM).

    Returns the scaled (H, q, A, l, u, soft) and (D, E, c) with
    H~ = c D H D, q~ = c D q, A~ = E A D, l~ = E l, u~ = E u.
    """
    B, m, k = A.shape
    D = torch.ones((B, k), dtype=H.dtype, device=H.device)
    E = torch.ones((B, m), dtype=H.dtype, device=H.device)
    c = torch.ones((B,), dtype=H.dtype, device=H.device)
    for _ in range(iters):
        col_norm = torch.sqrt(torch.clamp(torch.maximum(
            torch.amax(torch.abs(A), dim=1), torch.amax(torch.abs(H), dim=1)), min=1e-8))
        row_norm = torch.sqrt(torch.clamp(torch.amax(torch.abs(A), dim=2), min=1e-8))
        d = 1.0 / col_norm
        e = 1.0 / row_norm
        H = H * d[:, :, None] * d[:, None, :]
        qv = qv * d
        A = A * e[:, :, None] * d[:, None, :]
        gamma = 1.0 / torch.clamp(torch.maximum(
            torch.mean(torch.abs(H), dim=(1, 2)), _amax(qv)), min=1e-8)
        gamma = torch.clamp(gamma, 1e-6, 1e6)
        H = H * gamma[:, None, None]
        qv = qv * gamma[:, None]
        D, E, c = D * d, E * e, c * gamma
    return H, qv, A, E * l, E * u, c[:, None] * soft / (E * E), D, E, c


def _ruiz_equilibrate(qp: QPData, iters: int = 10):
    """Ruiz equilibration with the diagonal P (full-space ADMM; OSQP's scaling).

    Returns the scaled QPData and (D (B, n), E (B, m), c (B,)) with
    P~ = c D P D, q~ = c D q, A~ = E A D, l~ = E l, u~ = E u; the unscaled
    solution is x = D x~, y = E y~ / c.
    """
    P, q, A = qp.P_diag, qp.q, qp.A
    B, m, n = A.shape
    D = torch.ones((B, n), dtype=P.dtype, device=P.device)
    E = torch.ones((B, m), dtype=P.dtype, device=P.device)
    c = torch.ones((B,), dtype=P.dtype, device=P.device)
    for _ in range(iters):
        col_norm = torch.sqrt(torch.clamp(torch.maximum(
            torch.amax(torch.abs(A), dim=1), torch.abs(P)), min=1e-8))
        row_norm = torch.sqrt(torch.clamp(torch.amax(torch.abs(A), dim=2), min=1e-8))
        d = 1.0 / col_norm
        e = 1.0 / row_norm
        P = P * d * d
        q = q * d
        A = A * e[:, :, None] * d[:, None, :]
        gamma = 1.0 / torch.clamp(torch.maximum(
            torch.mean(torch.abs(P), dim=1), _amax(q)), min=1e-8)
        gamma = torch.clamp(gamma, 1e-6, 1e6)
        P = P * gamma[:, None]
        q = q * gamma[:, None]
        D, E, c = D * d, E * e, c * gamma
    soft = c[:, None] * qp.soft / (E * E)
    return QPData(P, q, A, E * qp.l, E * qp.u, soft), D, E, c


def _rho_vec(l: torch.Tensor, u: torch.Tensor, cfg: ADMMConfig) -> torch.Tensor:
    """The full-space ADMM's first-phase rho per row: equality rows stiffened
    by ``rho_eq_scale``."""
    rho = torch.full_like(l, cfg.rho)
    return torch.where((u - l) < 1e-9, rho * cfg.rho_eq_scale, rho)


def _admm_phases(cfg: ADMMConfig, Hs, qs, As, ls, us, soft_s, w0, y0, invert):
    """The ADMM phase loop on a scaled problem, condensed or full-space.

    ``Hs`` is the quadratic term, dense (B, k, k) or diagonal (B, k). Each
    phase builds its normal matrix Hs + sigma I + As' diag(rho) As with one
    batched product, inverts it (``invert``) and runs its fixed iteration
    count in the ADMM kernel, or in its plain version where the kernel does
    not admit (k, m) (``admm_fits``, as the JAX package's
    ``admm_kernel_fits`` gate); the rho of the next phase comes from OSQP's
    residual balancing.
    """
    B, m, k = As.shape
    iterate = admm_iterate if admm_fits(k, m) else admm_iterate_plain
    is_eq = (us - ls) < 1e-9
    if Hs.dim() == 2:
        H_mv = lambda v: Hs * v
        H_sig = torch.diag_embed(Hs + cfg.sigma)
    else:
        H_mv = lambda v: _mv(Hs, v)
        H_sig = Hs + cfg.sigma * torch.eye(k, dtype=Hs.dtype, device=Hs.device)

    def rebalance(base_rho, w, z, y):
        Aw, Hw, Aty = _mv(As, w), H_mv(w), _mtv(As, y)
        rp = _amax(Aw - z) / torch.clamp(torch.maximum(_amax(Aw), _amax(z)), min=1e-6)
        rd = _amax(Hw + qs + Aty) / torch.clamp(torch.maximum(
            _amax(Hw), torch.maximum(_amax(Aty), _amax(qs))), min=1e-6)
        scale = torch.clamp(torch.sqrt(rp / torch.clamp(rd, min=1e-12)), 1e-2, 1e2)
        return torch.clamp(base_rho * scale, 1e-4, 1e3)

    n_phases = max(1, int(cfg.rho_updates) + 1)
    per_phase = max(cfg.iters // n_phases, 1)
    base_rho = torch.full((B,), cfg.rho, dtype=Hs.dtype, device=Hs.device)
    z0 = torch.clamp(_mv(As, w0), ls, us)
    w, z, y = w0, z0, y0
    As = As.contiguous()
    for i in range(n_phases):
        rho = torch.where(is_eq, base_rho[:, None] * cfg.rho_eq_scale, base_rho[:, None])
        M = H_sig + torch.bmm((As * rho[:, :, None]).transpose(1, 2), As)
        Minv = invert(M)
        iters = per_phase if i < n_phases - 1 else cfg.iters - per_phase * (n_phases - 1)
        w, z, y = iterate(Minv.contiguous(), As, qs.contiguous(), ls.contiguous(),
                          us.contiguous(), soft_s.contiguous(), rho.contiguous(),
                          w.contiguous(), z.contiguous(), y.contiguous(), iters=iters,
                          sigma=float(cfg.sigma), alpha=float(cfg.alpha))
        if i < n_phases - 1:
            base_rho = rebalance(base_rho, w, z, y)
    return w, z, y


def _residuals(qp: QPData, x, y):
    """(z, r_prim, r_dual) of a solution: z = A x projected on the hard rows'
    bounds (A x itself on soft rows, which cannot be violated)."""
    l, u = _clip_bounds(qp.l, qp.u)
    Ax = _mv(qp.A, x)
    z = torch.where(qp.soft > 0.0, Ax, torch.clamp(Ax, l, u))
    viol = torch.where(qp.soft > 0.0, torch.zeros_like(Ax), torch.abs(Ax - z))
    return (z, torch.amax(viol, dim=-1),
            _amax(qp.P_diag * x + qp.q + _mtv(qp.A, y)))


def _admm_core(qp: QPData, cfg: ADMMConfig, x0, y0):
    """ADMM in the full space (neupan_tpu/ops/qp.py:_admm_core): the
    Ruiz-equilibrated problem's phases (``_admm_phases``) with its normal
    matrix diag(P + sigma) + A' rho A inverted by ``btd_spd_inverse`` for
    ``inverse="banded"`` with a permutation, by ``spd_inverse_any``
    otherwise. Returns (x, y, z, r_prim, r_dual) unscaled."""
    qp_s, D, E, c = _ruiz_equilibrate(qp, cfg.ruiz_iters)
    ls, us = _clip_bounds(qp_s.l, qp_s.u)
    if cfg.inverse == "banded" and cfg.banded_perm is not None:
        invert = lambda M: btd_spd_inverse(M, cfg.banded_perm, cfg.banded_block)
    else:
        invert = spd_inverse_any
    x, _, y = _admm_phases(cfg, qp_s.P_diag, qp_s.q, qp_s.A, ls, us, qp_s.soft,
                           x0 / D, c[:, None] * y0 / E, invert)
    x = D * x
    y = E * y / c[:, None]
    return (x, y, *_residuals(qp, x, y))


def _admm_core_condensed(qp: QPData, cfg: ADMMConfig, x0, y0, elim, Geq_inv):
    """ADMM on the equality-eliminated problem; returns the full-space
    (x, y, z, r_prim, r_dual), the equality duals recovered from
    stationarity through the equality Gram inverse."""
    Z, xp = elim
    n_eq = cfg.elim_n_eq
    k = Z.shape[-1]
    P, q, A = qp.P_diag, qp.q, qp.A
    A_r = A[:, n_eq:]

    Ar = torch.bmm(A_r, Z)
    Axp = _mv(A_r, xp)
    l_r, u_r = _clip_bounds(qp.l[:, n_eq:] - Axp, qp.u[:, n_eq:] - Axp)
    Hr = torch.bmm(Z.transpose(1, 2), Z * P[:, :, None])
    qr = _mtv(Z, q + P * xp)

    Hs, qs, As, ls, us, soft_s, D, E, c = _ruiz_equilibrate_dense(
        Hr, qr, Ar, l_r, u_r, qp.soft[:, n_eq:], cfg.ruiz_iters)
    ls, us = _clip_bounds(ls, us)
    w0 = x0[:, -k:] / D
    y0_r = c[:, None] * y0[:, n_eq:] / E

    w, z, y = _admm_phases(cfg, Hs, qs, As, ls, us, soft_s, w0, y0_r, spd_inverse_any)

    w = D * w
    y_r = E * y / c[:, None]
    x = _mv(Z, w) + xp
    r_stat = -(P * x + q + _mtv(A_r, y_r))
    y_eq = _mv(Geq_inv, _mv(A[:, :n_eq], r_stat))
    y = torch.cat([y_eq, y_r], dim=1)
    return (x, y, *_residuals(qp, x, y))


def kkt_error(P, q, A, l, u, x, y, soft=None):
    """Per-scenario KKT error: stationarity, primal feasibility and
    complementarity; soft rows check dual consistency y = soft neg(Ax - l)."""
    Ax = _mv(A, x)
    stat = _amax(P * x + q + _mtv(A, y))
    viol_r = torch.clamp(torch.maximum(Ax - u, l - Ax), min=0.0)
    comp_u_r = torch.minimum(torch.clamp(y, min=0.0), torch.abs(u - Ax))
    comp_l_r = torch.minimum(torch.clamp(-y, min=0.0), torch.abs(Ax - l))
    if soft is not None:
        is_soft = soft > 0.0
        zero = torch.zeros_like(viol_r)
        dual_err = torch.abs(y - soft * torch.clamp(Ax - l, max=0.0))
        viol_r = torch.where(is_soft, dual_err, viol_r)
        comp_u_r = torch.where(is_soft, zero, comp_u_r)
        comp_l_r = torch.where(is_soft, zero, comp_l_r)
    viol = torch.amax(viol_r, dim=-1)
    comp = torch.maximum(torch.amax(comp_u_r, dim=-1), torch.amax(comp_l_r, dim=-1))
    return torch.maximum(torch.maximum(stat, viol), comp)


def _soft_terms(qp: QPData, soft_act, l):
    """The active soft rows as exact quadratics: SA = sqrt(soft * active) A,
    SA' g3 (g3 = sqrt(soft * active) l) and the gradient of their penalty."""
    ssd = torch.sqrt(qp.soft * soft_act.to(qp.P_diag.dtype))
    SA = qp.A * ssd[:, :, None]
    SAtg3 = _mtv(SA, ssd * l)
    return SA, SAtg3, lambda v: _mtv(SA, _mv(SA, v)) - SAtg3


def _polish_candidate(qp: QPData, cfg: ADMMConfig, low_act, up_act, soft_act):
    """Full-space active-set EQP by a dual Schur complement over all m rows
    (neupan_tpu/ops/qp.py:_polish_candidate, where the scheme is argued):

        Hp = diag(P + sigma) + SA'SA,  S = DAn Hp^{-1} DAn' + diag(1 - d) + 1e-6 I

    with DAn the unit-normalized active hard rows (equalities always
    active), then ``refine_steps`` refinements against the exact KKT
    operator. Both inverses take ``spd_inverse_any``. Returns (x, y, ok);
    the soft rows' duals are their penalty gradients.
    """
    P, q, A = qp.P_diag, qp.q, qp.A
    l, u = _clip_bounds(qp.l, qp.u)
    is_eq = (u - l) < 1e-9
    is_soft = qp.soft > 0.0
    zero = torch.zeros_like(l)

    active = (low_act | up_act | is_eq) & (torch.sum(A * A, dim=2) > 1e-16) & ~is_soft
    d = active.to(P.dtype)
    b_act = torch.where(active, torch.where(is_eq, l, torch.where(up_act, u, l)), zero)
    DA = A * d[:, :, None]
    rn = torch.sqrt(torch.sum(DA * DA, dim=2))
    rs = torch.where(active, 1.0 / torch.clamp(rn, min=1e-8), zero)
    DAn = DA * rs[:, :, None]
    g2n = b_act * rs

    SA, SAtg3, soft_grad = _soft_terms(qp, soft_act, l)
    g1 = -q + SAtg3
    Hp = torch.diag_embed(P + cfg.sigma) + torch.bmm(SA.transpose(1, 2), SA)
    Hp_inv = spd_inverse_any(Hp)
    HDAt = torch.bmm(Hp_inv, DAn.transpose(1, 2))                    # (B, n, m)
    S = torch.bmm(DAn, HDAt) + torch.diag_embed((1.0 - d) + 1e-6)    # (B, m, m)
    S_inv = spd_inverse_any(S)

    def kkt_solve(r1, r2n):
        dyn = _mv(S_inv, _mtv(HDAt, r1) - r2n)
        return _mv(Hp_inv, r1 - _mtv(DAn, dyn)), dyn

    x, yn = kkt_solve(g1, g2n)
    for _ in range(cfg.refine_steps):
        r1 = -q - P * x - soft_grad(x) - _mtv(DAn, d * yn)
        r2n = g2n - (_mv(DAn, x) + (1.0 - d) * yn)
        dx, dyn = kkt_solve(r1, r2n)
        x, yn = x + dx, yn + dyn

    y = torch.where(is_soft, qp.soft * torch.clamp(_mv(A, x) - l, max=0.0), d * yn * rs)
    ok = torch.isfinite(x).all(dim=1) & torch.isfinite(y).all(dim=1)
    return x, y, ok


def _polish_candidate_condensed(qp: QPData, cfg: ADMMConfig, low_act, up_act, soft_act,
                                Z, xp, Geq_inv):
    """Generic condensed active-set EQP (``elim_n_acc`` None;
    neupan_tpu/ops/qp.py:_polish_candidate_condensed): the equalities
    eliminated by x = Z w + xp, the dual Schur complement over every active
    hard row, (k, k) and (n_hard, n_hard) inverses by ``spd_inverse_any``;
    the equality duals recovered from stationarity through ``Geq_inv``.
    Returns (x, y, ok)."""
    P, q, A = qp.P_diag, qp.q, qp.A
    l, u = _clip_bounds(qp.l, qp.u)
    n_eq, n_hard = cfg.elim_n_eq, cfg.elim_n_hard
    sl = slice(n_eq, n_eq + n_hard)

    A_h = A[:, sl]
    act_h = low_act[:, sl] | up_act[:, sl]
    d = act_h.to(P.dtype)
    zero = torch.zeros_like(d)
    b_act = torch.where(act_h, torch.where(up_act[:, sl], u[:, sl], l[:, sl]), zero)
    DAh = A_h * d[:, :, None]
    rn = torch.sqrt(torch.sum(DAh * DAh, dim=2))
    rs = torch.where(act_h, 1.0 / torch.clamp(rn, min=1e-8), zero)
    DAnh = DAh * rs[:, :, None]

    SA, SAtg3, soft_grad = _soft_terms(qp, soft_act, l)
    g1 = -q + SAtg3
    Pr = P + cfg.sigma
    Zt = Z.transpose(1, 2)
    SZ = torch.bmm(SA, Z)
    Hr = torch.bmm(Zt, Z * Pr[:, :, None]) + torch.bmm(SZ.transpose(1, 2), SZ)
    g1r = _mv(Zt, g1 - (Pr * xp + _mtv(SA, _mv(SA, xp))))
    DAr = torch.bmm(DAnh, Z)                                         # (B, n_hard, k)
    g2r = b_act * rs - _mv(DAnh, xp)

    Hr_inv = spd_inverse_any(Hr)
    HDAt = torch.bmm(Hr_inv, DAr.transpose(1, 2))                    # (B, k, n_hard)
    S = torch.bmm(DAr, HDAt) + torch.diag_embed((1.0 - d) + 1e-6)
    S_inv = spd_inverse_any(S)

    def kkt_solve(r1, r2):
        dyn = _mv(S_inv, _mtv(HDAt, r1) - r2)
        return _mv(Hr_inv, r1 - _mtv(DAr, dyn)), dyn

    w, yn = kkt_solve(g1r, g2r)
    for _ in range(cfg.refine_steps):
        x_full = _mv(Z, w) + xp
        r1 = _mv(Zt, -q - P * x_full - soft_grad(x_full)) - _mtv(DAr, d * yn)
        r2 = g2r - (_mv(DAr, w) + (1.0 - d) * yn)
        dw, dyn = kkt_solve(r1, r2)
        w, yn = w + dw, yn + dyn

    x = _mv(Z, w) + xp
    y_h = d * yn * rs
    m = A.shape[1]
    y_tail = torch.cat([y_h, torch.zeros((x.shape[0], m - n_eq - n_hard), dtype=P.dtype,
                                         device=P.device)], dim=1)
    y_soft = qp.soft * torch.clamp(_mv(A, x) - l, max=0.0)
    y_tail = torch.where(qp.soft[:, n_eq:] > 0.0, y_soft[:, n_eq:], y_tail)
    r_stat = -q - P * x - soft_grad(x) - _mtv(A_h, y_h)
    y = torch.cat([_mv(Geq_inv, _mv(A[:, :n_eq], r_stat)), y_tail], dim=1)
    ok = torch.isfinite(x).all(dim=1) & torch.isfinite(y).all(dim=1)
    return x, y, ok


def _polish_candidate_condensed_box(qp: QPData, cfg: ADMMConfig, low_act, up_act,
                                    soft_act, Z, xp, Geq_inv):
    """Condensed EQP with the bound-active variables pinned.

    Active bound rows pin coordinates of w (identity row/column in the
    reduced Hessian); only the active acceleration rows enter the dual
    Schur complement. The candidate solve runs in the polish kernel, or in
    its plain version where the kernel does not admit (k, na) (``polish_fits``).
    Returns (x, y, ok) with y's bound and equality duals recovered from
    stationarity.
    """
    P, q, A = qp.P_diag, qp.q, qp.A
    l, u = _clip_bounds(qp.l, qp.u)
    n_eq, n_acc = cfg.elim_n_eq, cfg.elim_n_acc
    sl_acc = slice(n_eq, n_eq + n_acc)
    sl_box = slice(n_eq + n_acc, n_eq + cfg.elim_n_hard)

    # bound rows -> pinned coordinates
    up_b = up_act[:, sl_box]
    act_box = low_act[:, sl_box] | up_b
    b_box = torch.where(up_b, u[:, sl_box], l[:, sl_box])
    b_box = torch.where(act_box, b_box, torch.zeros_like(b_box))
    fix = act_box.to(P.dtype)
    free = 1.0 - fix

    # objective pieces: active soft rows become exact quadratics
    SA, SAtg3, soft_grad = _soft_terms(qp, soft_act, l)
    g1 = -q + SAtg3

    Pr = P + cfg.sigma
    SZ = torch.bmm(SA, Z)
    SZtSZ = torch.bmm(SZ.transpose(1, 2), SZ)
    Zt = Z.transpose(1, 2)
    Hr = torch.bmm(Zt, Z * Pr[:, :, None]) + SZtSZ
    g1r = _mv(Zt, g1 - (Pr * xp + _mtv(SA, _mv(SA, xp))))

    # acc rows: dual Schur over the general rows only
    A_accx = A[:, sl_acc]
    A_acc = torch.bmm(A_accx, Z)
    act_acc = low_act[:, sl_acc] | up_act[:, sl_acc]
    b_acc = torch.where(up_act[:, sl_acc], u[:, sl_acc], l[:, sl_acc])
    A_acc_f = A_acc * free[:, None, :]
    rn = torch.sqrt(torch.sum(A_acc_f * A_acc_f, dim=2))
    act_acc = act_acc & (rn > 1e-6)   # a row whose variables are all pinned drops out
    d = act_acc.to(P.dtype)
    rs = torch.where(act_acc, 1.0 / torch.clamp(rn, min=1e-8), torch.zeros_like(rn))
    DAn = (A_acc_f * d[:, :, None]) * rs[:, :, None]
    b_eff = b_acc - _mv(A_accx, xp) - _mv(A_acc, fix * b_box)
    g2n = torch.where(act_acc, b_eff * rs, torch.zeros_like(b_eff))

    # reduced refinement operator: Z'(-q - P x - soft_grad(x)) = C0 - Hr_ref w
    Hr_ref = torch.bmm(Zt, Z * P[:, :, None]) + SZtSZ
    C0 = _mv(Zt, -q - P * xp + SAtg3) - _mtv(SZ, _mv(SA, xp))

    candidate = box_candidate if polish_fits(Z.shape[-1], n_acc) else box_candidate_plain
    w, yn = candidate(*(t.contiguous() for t in (Hr, Hr_ref, DAn, C0, g1r, g2n,
                                                 b_box, fix, d)),
                      refine=int(cfg.refine_steps))

    x = _mv(Z, w) + xp
    y_acc = d * yn * rs
    y_box = fix * ((C0 - _mv(Hr_ref, w)) - _mtv(A_acc, y_acc))
    m = A.shape[1]
    y_hard = torch.cat([y_acc, y_box], dim=1)
    y_soft = qp.soft * torch.clamp(_mv(A, x) - l, max=0.0)
    y_rest = torch.zeros((x.shape[0], m - n_eq - y_hard.shape[1]), dtype=P.dtype,
                         device=P.device)
    y_tail = torch.cat([y_hard, y_rest], dim=1)
    y_tail = torch.where(qp.soft[:, n_eq:] > 0.0, y_soft[:, n_eq:], y_tail)
    r_stat = -q - P * x - soft_grad(x) - _mtv(A[:, n_eq:], y_tail)
    y_eq = _mv(Geq_inv, _mv(A[:, :n_eq], r_stat))
    y = torch.cat([y_eq, y_tail], dim=1)

    ok = torch.isfinite(x).all(dim=1) & torch.isfinite(y).all(dim=1)
    return x, y, ok


def _polish(qp: QPData, cfg: ADMMConfig, x, y, elim, Geq_inv):
    """Iterated active-set polish with value-based identification.

    Each round guesses the active set at the best point tried so far (the
    anchor): rows whose value sits within a shrinking tolerance of a bound,
    vetoed where the anchor's dual has the wrong sign; round 0 also trusts
    the ADMM dual signs. A candidate replaces the output when its ranked
    KKT error improves enough, and the anchor when it improves at all. The
    reasoning behind each rule is in neupan_tpu/ops/qp.py:_polish.

    The candidate, as the JAX package picks it: with an elimination basis
    ``elim`` (and ``Geq_inv``) the box-eliminating one where ``elim_n_acc``
    is set, the generic condensed one where it is not; without a basis the
    full-space one.
    """
    P, q, A = qp.P_diag, qp.q, qp.A
    l, u = _clip_bounds(qp.l, qp.u)
    is_eq = (u - l) < 1e-9
    is_soft = qp.soft > 0.0
    tol_scale = torch.clamp(torch.sqrt(torch.sum(A * A, dim=2)), min=1.0)
    if elim is None:
        candidate = lambda lo, hi, sa: _polish_candidate(qp, cfg, lo, hi, sa)
    else:
        cand = (_polish_candidate_condensed if cfg.elim_n_acc is None
                else _polish_candidate_condensed_box)
        candidate = lambda lo, hi, sa: cand(qp, cfg, lo, hi, sa, *elim, Geq_inv)

    def hard_viol(Axc):
        v = torch.abs(Axc - torch.clamp(Axc, l, u))
        return torch.amax(torch.where(is_soft, torch.zeros_like(v), v), dim=-1)

    def rank_error(Axc, e_kkt):
        return torch.maximum(e_kkt, 5.0 * hard_viol(Axc))

    def identify(Axc, tol):
        lo = ((torch.abs(Axc - l) < tol) | (Axc < l)) & ~is_soft
        hi = ((torch.abs(Axc - u) < tol) | (Axc > u)) & ~is_soft
        sa = is_soft & (Axc - l < 0.0)
        return lo & ~is_eq, hi & ~is_eq, sa

    Ax = _mv(A, x)
    e0 = rank_error(Ax, kkt_error(P, q, A, l, u, x, y, qp.soft))
    tol0 = torch.clamp(10.0 * hard_viol(Ax), 1e-5, 1e-2)

    x_g, y_g, e_g = x, y, e0
    x_out, y_out, e_out = x, y, e0
    margin = 0.3
    n_rounds = max(int(cfg.polish_rounds), 1)
    tols = [None] + [max(3e-3 * (0.3 ** (r - 1)), 3e-4) for r in range(1, n_rounds)]
    inf = torch.full_like(e0, float("inf"))

    for r in range(n_rounds):
        Axg = _mv(A, x_g)
        tol_r = tol0[:, None] if r == 0 else tols[r]
        vlow, vup, sact_g = identify(Axg, tol_r * tol_scale)
        if r == 0:
            vlow = vlow | ((y < -cfg.eps_act) & ~is_eq & ~is_soft)
            vup = vup | ((y > cfg.eps_act) & ~is_eq & ~is_soft)
        eps_drop = torch.clamp(0.3 * e_g, min=1e-3)[:, None]
        low_g = vlow & ~(y_g > eps_drop)
        up_g = vup & ~(y_g < -eps_drop)
        xc, yc, okc = candidate(low_g, up_g, sact_g)
        Axc = _mv(A, xc)
        ec = torch.where(okc, rank_error(Axc, kkt_error(P, q, A, l, u, xc, yc, qp.soft)),
                         inf)
        usec = (ec <= margin * e_out) | ((ec <= 0.7 * e_out) & (e_out > 3e-2))
        x_out = torch.where(usec[:, None], xc, x_out)
        y_out = torch.where(usec[:, None], yc, y_out)
        e_out = torch.where(usec, ec, e_out)
        gc = ec < e_g
        x_g = torch.where(gc[:, None], xc, x_g)
        y_g = torch.where(gc[:, None], yc, y_g)
        e_g = torch.where(gc, ec, e_g)
    return x_out, y_out


def _snap_variable_bounds(qp: QPData, x: torch.Tensor) -> torch.Tensor:
    """Project x onto its single-variable hard rows (the speed and d-box
    rows) exactly, removing the f32 polish's epsilon violations."""
    A, l, u = qp.A, qp.l, qp.u
    nz = torch.abs(A) > 1e-12
    nnz = torch.sum(nz, dim=2)
    hard = torch.ones_like(l, dtype=torch.bool) if qp.soft is None else ~(qp.soft > 0.0)
    is_box = (nnz == 1) & hard & (u - l >= 1e-9)
    a = torch.sum(torch.where(nz, A, torch.zeros_like(A)), dim=2)
    safe_a = torch.where(torch.abs(a) > 1e-12, a, torch.ones_like(a))
    lo = torch.clamp(torch.where(a > 0, l, u) / safe_a, min=-_BIG)
    hi = torch.clamp(torch.where(a > 0, u, l) / safe_a, max=_BIG)
    sel = nz & is_box[:, :, None]
    lo_var = torch.amax(torch.where(sel, lo[:, :, None], torch.full_like(A, -_BIG)), dim=1)
    hi_var = torch.amin(torch.where(sel, hi[:, :, None], torch.full_like(A, _BIG)), dim=1)
    return torch.clamp(x, lo_var, hi_var)


def solve_qp(qp: QPData, cfg: ADMMConfig, x0: Optional[torch.Tensor] = None,
             y0: Optional[torch.Tensor] = None, elim=None) -> QPSolution:
    """Solve a batch of QPs: ADMM, the active-set polish, the bound snap.

    ``elim`` = (Z (B, n, k), xp (B, n)) is the equality-elimination basis
    (ops/nrmp.py:condensation); with the row-layout statics in ``cfg``
    (ops/pan.py:_admm_with_elim) it selects the condensed paths, without
    either the full-space ones (module docstring). ``x0``/``y0`` default to
    zeros; ``qp.soft`` may be None (no soft rows).

    Differentiable in the QP's fields through ``x`` alone (``_SolveQP``);
    the warm start and the elimination basis receive no gradient, as in the
    JAX package (the basis duplicates information already inside ``qp``).
    """
    B, m, n = qp.A.shape
    if qp.soft is None:
        # no soft rows: an all-zero penalty marks every row hard and adds
        # exact zeros wherever the soft terms enter
        qp = qp._replace(soft=torch.zeros_like(qp.l))
    if x0 is None:
        x0 = torch.zeros((B, n), dtype=qp.A.dtype, device=qp.A.device)
    if y0 is None:
        y0 = torch.zeros((B, m), dtype=qp.A.dtype, device=qp.A.device)
    Z, xp = (None, None) if elim is None else elim
    return QPSolution(*_SolveQP.apply(cfg, *qp, x0, y0, Z, xp))


def solve_qp_batch(qp: QPData, cfg: ADMMConfig, x0: Optional[torch.Tensor] = None,
                   y0: Optional[torch.Tensor] = None) -> QPSolution:
    """Solve a batch of generic QPs (no elimination basis): every field has
    the leading batch axis, except that ``soft`` may be one (m,) vector for
    the whole batch; the warm starts default to zeros."""
    B, m, _ = qp.A.shape
    if qp.soft is not None and qp.soft.dim() == 1:
        qp = qp._replace(soft=qp.soft.expand(B, m))
    return solve_qp(qp, cfg, x0, y0)


def _solve(qp: QPData, cfg: ADMMConfig, x0, y0, elim):
    """The forward solve of ``solve_qp`` (neupan_tpu/ops/qp.py:_solve_single);
    ``qp.soft`` is a tensor."""
    if cfg.elim_n_eq is None or cfg.elim_n_hard is None:
        elim = None
    Geq_inv = None
    if elim is not None:
        # the equality Gram inverse, shared by the condensed ADMM's and every
        # polish round's equality-dual recovery
        Aeq = qp.A[:, :cfg.elim_n_eq]
        Geq_inv = spd_inverse_any(torch.bmm(Aeq, Aeq.transpose(1, 2)) + 1e-8 * torch.eye(
            cfg.elim_n_eq, dtype=qp.A.dtype, device=qp.A.device))
    if elim is not None and cfg.condense_admm:
        sol = _admm_core_condensed(qp, cfg, x0, y0, elim, Geq_inv)
    else:
        sol = _admm_core(qp, cfg, x0, y0)
    if not cfg.polish:
        return QPSolution(*sol)
    x, y = _polish(qp, cfg, sol[0], sol[1], elim, Geq_inv)
    x = _snap_variable_bounds(qp, x)
    return QPSolution(x, y, *_residuals(qp, x, y))


class _SolveQP(torch.autograd.Function):
    """``solve_qp`` with the JAX package's custom VJP
    (neupan_tpu/ops/qp.py:_solve_qp_vjp): the forward is the solve, the
    backward reads only (qp, x, y) and propagates the cotangent of x."""

    @staticmethod
    def forward(ctx, cfg, P_diag, q, A, l, u, soft, x0, y0, Z, xp):
        with matmul_precision("highest"):
            sol = _solve(QPData(P_diag, q, A, l, u, soft), cfg, x0, y0,
                         None if Z is None else (Z, xp))
        ctx.cfg = cfg
        ctx.save_for_backward(P_diag, q, A, l, u, soft, sol.x, sol.y)
        # only the cotangent of the primal solution propagates
        ctx.mark_non_differentiable(sol.y, sol.z, sol.r_prim, sol.r_dual)
        return tuple(sol)

    @staticmethod
    def backward(ctx, gx, *_):
        P_diag, q, A, l, u, soft, x, y = ctx.saved_tensors
        with matmul_precision("highest"):
            dqp = _solve_bwd_impl(ctx.cfg, QPData(P_diag, q, A, l, u, soft), x, y, gx)
        # the warm start gets zero cotangent, the elimination basis none
        return (None, *dqp, torch.zeros_like(x), torch.zeros_like(y), None, None)


def _solve_bwd_impl(cfg: ADMMConfig, qp: QPData, x, y, gx) -> QPData:
    """Implicit differentiation through the active-set KKT conditions
    (neupan_tpu/ops/qp.py:_solve_bwd_impl), batched over the leading B.

    At the solution P x + q + A' y = 0 and, for active rows, A_i x = b_i.
    Differentiating gives the adjoint system K' [dx; dnu] = [g_x; 0]; the
    parameter gradients follow the OptNet formulas for a diagonal P.
    Returns the cotangents of the QP's fields.
    """
    P, A = qp.P_diag, qp.A
    l, u = _clip_bounds(qp.l, qp.u)
    B, m, n = A.shape
    is_eq = (u - l) < 1e-9
    low_act = y < -cfg.eps_act
    up_act = y > cfg.eps_act
    active = low_act | up_act | is_eq
    d = active.to(P.dtype)
    DA = A * d[:, :, None]

    delta = cfg.polish_delta
    # Diagonal of the dual block. Hard rows: -delta if active (equality
    # A_i x = b_i), -delta-1 if inactive (y_i = 0). Soft penalty rows with
    # y_i = soft*(A_i x - l_i) < 0 satisfy the relaxed active equation
    # A_i x - y_i/soft_i = l_i, i.e. a -1/soft_i diagonal entry.
    diag2 = -delta - (1.0 - d)
    s_act = (qp.soft > 0.0) & low_act
    soft_safe = torch.clamp(qp.soft, min=1e-12)
    diag2 = torch.where(s_act, -delta - 1.0 / soft_safe, diag2)

    K = torch.zeros((B, n + m, n + m), dtype=P.dtype, device=P.device)
    K[:, :n, :n] = torch.diag_embed(P + delta)
    K[:, :n, n:] = DA.transpose(1, 2)
    K[:, n:, :n] = DA
    K[:, n:, n:] = torch.diag_embed(diag2)

    rhs = torch.cat([gx, torch.zeros((B, m), dtype=P.dtype, device=P.device)], dim=1)
    sol = torch.linalg.solve(K.transpose(1, 2), rhs[:, :, None])[:, :, 0]
    dx, dnu = sol[:, :n], sol[:, n:] * d   # inactive rows carry no sensitivity

    zero = torch.zeros_like(dnu)
    return QPData(
        P_diag=-dx * x,                    # diagonal of -(dx x' + x dx')/2 * 2
        q=-dx,
        A=-(dnu[:, :, None] * x[:, None, :] + (y * d)[:, :, None] * dx[:, None, :]),
        l=torch.where(active & ~up_act, dnu, zero),
        u=torch.where(up_act, dnu, zero),
        soft=torch.where(s_act, -dnu * y / soft_safe ** 2, zero))
