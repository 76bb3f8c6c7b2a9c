"""Batched OSQP-style ADMM QP solver, condensed path (port of ``neupan_tpu/ops/qp.py``).

Solves a batch of QPs in standard form

    minimize    1/2 x' diag(P) x + q' x  (+ 0.5 soft_i min(A_i x - l_i, 0)^2)
    subject to  l <= A x <= u

whose rows are laid out as the NRMP problem lays them out (ops/nrmp.py):
equality rows first, then hard rows (general acceleration rows, then unit
bounds on the reduced coordinates w), then soft rows. This is the path the
planner step runs (``ADMMConfig`` with the ``elim_n_*`` statics filled by
``ops/pan.py:_admm_with_elim``):

1. the equality Gram inverse (sweep kernel, n = n_eq);
2. ADMM in the equality-eliminated space x = Z w + xp, Ruiz-equilibrated,
   in two rho phases with a residual-balancing rho update between them:
   each phase inverts its normal matrix (sweep kernel) and runs its
   iterations in the ADMM kernel;
3. ``polish_rounds`` rounds of the box-eliminating active-set polish, each
   candidate solved by the polish kernel;
4. a snap of x onto the single-variable bound rows.

Every tensor carries the scenario batch as its leading axis. Shapes a
kernel does not admit (n > 96 inverses, which take the JAX package's
Cholesky route; an ADMM operator or a polish candidate too large for one
block) take the plain versions by an explicit
admission check, as the JAX package's gates do; no kernel error is caught.
The full-space ADMM, the generic polish candidates and the banded inverse
belong to later slices of the port.

``solve_qp`` is differentiable in the QP's fields (``_SolveQP``): the
backward is the JAX package's implicit differentiation of the active-set
KKT system at the solution, one batched linear solve; the forward keeps
running the kernels above.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

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
    """Solver settings of the condensed path; the defaults are the JAX
    package's qualified ones (neupan_tpu/ops/qp.py:ADMMConfig, where each
    is argued). The ``elim_n_*`` row-layout statics are filled from the
    NRMP layout by ops/pan.py:_admm_with_elim."""

    iters: int = 240
    rho: float = 1.0
    rho_updates: int = 1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    refine_steps: int = 7
    eps_act: float = 1e-5
    polish_delta: float = 1e-7
    polish_rounds: int = 5
    ruiz_iters: int = 10
    elim_n_eq: Optional[int] = None
    elim_n_hard: Optional[int] = None
    elim_n_acc: Optional[int] = None


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


def _condensed_phases_batched(cfg: ADMMConfig, Hs, qs, As, ls, us, soft_s, w0, y0):
    """The condensed-ADMM phase loop on the scaled problem.

    Each phase builds its normal matrix Hs + sigma I + As' diag(rho) As with
    one batched product, inverts it (``spd_inverse_any``) and runs its fixed
    iteration count in the ADMM kernel, or in its plain version where the
    kernel does not admit (k, m) (``admm_fits``, as the JAX package's
    ``admm_kernel_fits`` gate); the rho of the next phase comes from OSQP's
    residual balancing.
    """
    B, m, k = As.shape
    iterate = admm_iterate if admm_fits(k, m) else admm_iterate_plain
    is_eq = (us - ls) < 1e-9
    eye = torch.eye(k, dtype=Hs.dtype, device=Hs.device)

    def rebalance(base_rho, w, z, y):
        Aw, Hw, Aty = _mv(As, w), _mv(Hs, w), _mtv(As, y)
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
        M = Hs + cfg.sigma * eye + torch.bmm((As * rho[:, :, None]).transpose(1, 2), As)
        Minv = spd_inverse_any(M)
        iters = per_phase if i < n_phases - 1 else cfg.iters - per_phase * (n_phases - 1)
        w, z, y = iterate(Minv, As, qs.contiguous(), ls.contiguous(), us.contiguous(),
                          soft_s.contiguous(), rho.contiguous(), w.contiguous(),
                          z.contiguous(), y.contiguous(), iters=iters,
                          sigma=float(cfg.sigma), alpha=float(cfg.alpha))
        if i < n_phases - 1:
            base_rho = rebalance(base_rho, w, z, y)
    return w, z, y


def _admm_core_condensed(qp: QPData, cfg: ADMMConfig, x0, y0, elim, Geq_inv):
    """ADMM on the equality-eliminated problem; returns the full-space
    (x, y), the equality duals recovered from stationarity through the
    equality Gram inverse."""
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

    w, z, y = _condensed_phases_batched(cfg, Hs, qs, As, ls, us, soft_s, w0, y0_r)

    w = D * w
    y_r = E * y / c[:, None]
    x = _mv(Z, w) + xp
    r_stat = -(P * x + q + _mtv(A_r, y_r))
    y_eq = _mv(Geq_inv, _mv(A[:, :n_eq], r_stat))
    return x, torch.cat([y_eq, y_r], dim=1)


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
    ssd = torch.sqrt(qp.soft * soft_act.to(P.dtype))
    SA = A * ssd[:, :, None]
    SAtg3 = _mtv(SA, ssd * l)
    g1 = -q + SAtg3

    def soft_grad(v):
        return _mtv(SA, _mv(SA, v)) - SAtg3

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
    """
    P, q, A = qp.P_diag, qp.q, qp.A
    l, u = _clip_bounds(qp.l, qp.u)
    is_eq = (u - l) < 1e-9
    is_soft = qp.soft > 0.0
    tol_scale = torch.clamp(torch.sqrt(torch.sum(A * A, dim=2)), min=1.0)
    Z_e, xp_e = elim

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
        xc, yc, okc = _polish_candidate_condensed_box(qp, cfg, low_g, up_g, sact_g,
                                                      Z_e, xp_e, Geq_inv)
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


def solve_qp(qp: QPData, cfg: ADMMConfig, x0: torch.Tensor, y0: torch.Tensor,
             elim) -> QPSolution:
    """Solve a batch of NRMP-layout QPs on the condensed path: ADMM, the
    active-set polish, the bound snap.

    ``elim`` = (Z (B, n, k), xp (B, n)) is the equality-elimination basis
    (ops/nrmp.py:condensation); ``cfg`` must carry the row-layout statics
    (ops/pan.py:_admm_with_elim). ``qp.soft`` may be None (the no-obstacle
    problem has no soft rows).

    Differentiable in the QP's fields through ``x`` alone (``_SolveQP``);
    the warm start and the elimination basis receive no gradient, as in the
    JAX package (the basis duplicates information already inside ``qp``).
    """
    if cfg.elim_n_eq is None or cfg.elim_n_hard is None or cfg.elim_n_acc is None:
        raise NotImplementedError("only the condensed, box-eliminating solver path is ported")
    if qp.soft is None:
        # no soft rows: an all-zero penalty marks every row hard and adds
        # exact zeros wherever the soft terms enter
        qp = qp._replace(soft=torch.zeros_like(qp.l))
    return QPSolution(*_SolveQP.apply(cfg, *qp, x0, y0, *elim))


def _solve(qp: QPData, cfg: ADMMConfig, x0, y0, elim):
    """The forward solve of ``solve_qp``; ``qp.soft`` is a tensor."""
    n_eq = cfg.elim_n_eq
    Aeq = qp.A[:, :n_eq]
    Geq = torch.bmm(Aeq, Aeq.transpose(1, 2)) + 1e-8 * torch.eye(
        n_eq, dtype=qp.A.dtype, device=qp.A.device)
    Geq_inv = spd_inverse_any(Geq)
    x, y = _admm_core_condensed(qp, cfg, x0, y0, elim, Geq_inv)
    x, y = _polish(qp, cfg, x, y, elim, Geq_inv)
    x = _snap_variable_bounds(qp, x)
    l, u = _clip_bounds(qp.l, qp.u)
    Ax = _mv(qp.A, x)
    z = torch.where(qp.soft > 0.0, Ax, torch.clamp(Ax, l, u))
    viol = torch.where(qp.soft > 0.0, torch.zeros_like(Ax), torch.abs(Ax - z))
    return QPSolution(x=x, y=y, z=z, r_prim=torch.amax(viol, dim=-1),
                      r_dual=_amax(qp.P_diag * x + qp.q + _mtv(qp.A, y)))


class _SolveQP(torch.autograd.Function):
    """``solve_qp`` with the JAX package's custom VJP
    (neupan_tpu/ops/qp.py:_solve_qp_vjp): the forward is the solve, the
    backward reads only (qp, x, y) and propagates the cotangent of x."""

    @staticmethod
    def forward(ctx, cfg, P_diag, q, A, l, u, soft, x0, y0, Z, xp):
        sol = _solve(QPData(P_diag, q, A, l, u, soft), cfg, x0, y0, (Z, xp))
        ctx.cfg = cfg
        ctx.save_for_backward(P_diag, q, A, l, u, soft, sol.x, sol.y)
        # only the cotangent of the primal solution propagates
        ctx.mark_non_differentiable(sol.y, sol.z, sol.r_prim, sol.r_dual)
        return tuple(sol)

    @staticmethod
    def backward(ctx, gx, *_):
        P_diag, q, A, l, u, soft, x, y = ctx.saved_tensors
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
