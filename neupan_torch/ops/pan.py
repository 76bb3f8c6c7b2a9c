"""PAN — the proximal alternating-minimization control step, batched.

Port of ``neupan_tpu/ops/pan.py`` with the scenario batch as a leading
axis. Each of ``iter_num`` iterations runs DUNE (``ops/dune.py``: the fused
exact-selection path, or the materialized point flow with either ranking,
as ``PANSpec`` says), assembles the NRMP QP at the current nominal
trajectory (``ops/nrmp.py``) and solves it (``ops/qp.py``). With no
obstacle slots (``nrmp.K == 0``) the step is the tracking QP alone.
Convergence is a per-scenario ``done`` flag that freezes the carried
iterates, so every scenario runs the same operations. ``PANState`` carries
the convergence reference values and the QP warm start from one control
step to the next.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from neupan_torch import PRECISIONS, matmul_precision, resolve_device, same_device
from neupan_torch.ops.banded import nrmp_permutation
from neupan_torch.ops.dune import (DuneOutput, dune_forward, dune_forward_flow,
                                   generate_point_flow)
from neupan_torch.ops.nrmp import (AdjustParams, NRMPSpec, build_qp,
                                   coefficients_from_dune, condensation,
                                   unpack_solution)
from neupan_torch.ops.qp import ADMMConfig, solve_qp
from neupan_torch.robot import Robot

_INF = 1e9


@dataclasses.dataclass(frozen=True)
class PANSpec:
    robot: Robot
    nrmp: NRMPSpec
    iter_num: int = 2
    iter_threshold: float = 0.1
    dune_max_num: int = 100     # padded point capacity P
    admm: ADMMConfig = ADMMConfig()
    # ADMM budget of the PAN iterations after the first (None = admm.iters):
    # they re-solve a nearly identical QP from the previous solution
    admm_warm_iters: Optional[int] = 120
    # Matmul precision of the step's PyTorch matmuls on a card: "highest"
    # is exact float32 (the package's pin, neupan_torch/__init__.py);
    # "default" allows TF32, trading accuracy for speed, as in the JAX
    # package. The QP solve and its backward stay exact either way, and the
    # hand kernels keep their own arithmetic.
    precision: str = "highest"
    # Top-k obstacle selection: "exact" ranks points by the closed-form
    # polygon distance and runs the encoder on the K winners per frame;
    # "mlp" is the reference-parity ranking by the learned distance, which
    # pays the encoder on every point.
    dune_select: str = "exact"
    # Rank through the selection kernels (the JAX package's dune_pallas).
    # None = auto: on with dune_select="exact", on either device (a kernel
    # wrapper runs its plain version for CPU tensors). With "exact" this
    # also picks the fused path, which never materializes the point flow.
    dune_kernel: Optional[bool] = None
    # Run the encoder through the fused MLP kernel (the JAX package's
    # dune_mlp_pallas). None = auto: on for CUDA tensors while no gradient
    # is recorded (on the card the kernel beats the module at every point
    # count the paths give it, PERF.md section 6); off on the CPU, as in
    # the JAX package.
    dune_mlp_kernel: Optional[bool] = None

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(
                f'precision must be "highest" (exact float32) or "default" (TF32 matmuls '
                f'outside the QP), got {self.precision!r}')
        if self.dune_select not in ("exact", "mlp"):
            raise ValueError(f'dune_select must be "exact" or "mlp", got {self.dune_select!r}')

    def use_dune_kernel(self) -> bool:
        if self.dune_kernel is not None:
            return self.dune_kernel
        return self.dune_select == "exact"

    def use_dune_mlp_kernel(self, device=None) -> bool:
        """Whether the encoder runs through the fused MLP kernel for points
        on ``device`` (None: no device, so auto is off)."""
        if self.dune_mlp_kernel is not None:
            return self.dune_mlp_kernel
        return (device is not None and torch.device(device).type == "cuda"
                and not torch.is_grad_enabled())


class PANState(NamedTuple):
    """Cross-step memory: convergence reference values + QP warm start.
    Shapes per scenario; batched states carry a leading B."""

    prev_mu: torch.Tensor          # (T+1, E, K)
    prev_lam: torch.Tensor         # (T+1, 2, K)
    prev_s: torch.Tensor           # (3, T+1)
    prev_u: torch.Tensor           # (2, T)
    prev_valid: torch.Tensor       # () bool
    prev_has_points: torch.Tensor  # () bool
    x_warm: torch.Tensor           # (n,)
    y_warm: torch.Tensor           # (m,)


class PANOutput(NamedTuple):
    opt_s: torch.Tensor         # (B, 3, T+1)
    opt_u: torch.Tensor         # (B, 2, T)
    opt_d: Optional[torch.Tensor]  # (B, T), or None without obstacle slots
    min_distance: torch.Tensor  # (B,)
    nrmp_points: torch.Tensor   # (B, 2, K) frame-0 points fed to NRMP
    nrmp_valid: torch.Tensor    # (B, K) bool
    state: PANState


def init_state(spec: PANSpec, device=None, dtype=torch.float32) -> PANState:
    """The empty state of one scenario."""
    dev = resolve_device(device)
    T, E, K = spec.robot.T, spec.robot.edge_dim, max(spec.nrmp.K, 1)
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    f = torch.zeros((), dtype=torch.bool, device=dev)
    return PANState(prev_mu=z(T + 1, E, K), prev_lam=z(T + 1, 2, K),
                    prev_s=z(3, T + 1), prev_u=z(2, T), prev_valid=f,
                    prev_has_points=f.clone(), x_warm=z(spec.nrmp.n),
                    y_warm=z(spec.nrmp.m))


def _stop_diff(spec: PANSpec, state: PANState, s, u, dune: Optional[DuneOutput],
               has_points=None, n_valid=None):
    """Per-scenario convergence measure (reference pan.py:215-243); without
    a DUNE output, the change of the trajectory alone."""
    su_diff = (torch.sum((s - state.prev_s) ** 2, dim=(1, 2))
               + torch.sum((u - state.prev_u) ** 2, dim=(1, 2)))
    if dune is None:
        return su_diff
    K = spec.nrmp.K
    col_mask = (torch.arange(K, device=s.device)[None, :] < n_valid[:, None]).to(s.dtype)
    col_mask = col_mask[:, None, None, :]
    denom = torch.clamp(n_valid, min=1).to(s.dtype)
    mu_diff = torch.sqrt(torch.sum(((dune.mu_k - state.prev_mu) * col_mask) ** 2,
                                   dim=(1, 2, 3))) / denom
    lam_diff = torch.sqrt(torch.sum(((dune.lam_k - state.prev_lam) * col_mask) ** 2,
                                    dim=(1, 2, 3))) / denom
    mulam = mu_diff ** 2 + lam_diff ** 2
    use_mulam = has_points & state.prev_has_points & (n_valid > 0)
    return torch.where(use_mulam, mulam, su_diff)


def _admm_with_elim(spec: PANSpec) -> ADMMConfig:
    """Fill the condensed solver's row-layout statics from the NRMP layout:
    equality rows (dynamics 3T + init 3) first, then the acc rows (general),
    then unit bounds on w (speed, d box), then the soft obstacle rows; and,
    for ``inverse="banded"`` without a permutation, the horizon-interleaved
    one (``banded.nrmp_permutation``). A user's ``elim_n_eq`` wins: the
    config is then taken as it is."""
    if spec.admm.elim_n_eq is not None:
        return spec.admm
    nrmp = spec.nrmp
    extra = {}
    if spec.admm.inverse == "banded" and spec.admm.banded_perm is None:
        extra["banded_perm"] = tuple(int(i) for i in nrmp_permutation(nrmp.T, nrmp.no_obs))
    return dataclasses.replace(spec.admm, elim_n_eq=nrmp.r_acc,
                               elim_n_hard=(nrmp.m if nrmp.no_obs else nrmp.r_obs) - nrmp.r_acc,
                               elim_n_acc=nrmp.r_spd - nrmp.r_acc, **extra)


def _where(keep: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-scenario select: ``old`` where ``keep`` (B,) is set, else ``new``."""
    return torch.where(keep.reshape(-1, *([1] * (old.dim() - 1))), old, new)


def pan_forward(spec: PANSpec, encoder, vertices: torch.Tensor, G: torch.Tensor,
                h: torch.Tensor, adjust: AdjustParams,
                nom_s: torch.Tensor, nom_u: torch.Tensor, ref_s: torch.Tensor,
                ref_us: torch.Tensor, points: torch.Tensor,
                velocities: torch.Tensor, mask: torch.Tensor,
                state: PANState) -> PANOutput:
    """One PAN control step for a batch of B scenarios.

    Args:
        encoder: ObsPointNet; vertices (2, V), G (E, 2), h (E, 1): the robot.
        nom_s/ref_s (B, 3, T+1), nom_u (B, 2, T), ref_us (B, T);
        points, velocities (B, 2, P) world frame, padded; mask (B, P) bool;
        state: a batched PANState.

    Differentiable in ``adjust``: where gradients are recorded and an
    ``adjust`` tensor requires grad, the step records its graph (the JAX
    package's ``jax.grad`` through ``pan_forward``). The selection runs
    without gradients, the encoder as a module (the fused MLP kernel has no
    backward, and the auto rule of ``PANSpec.dune_mlp_kernel`` turns it
    off), and the QP's backward is the implicit differentiation of
    ``ops/qp.py:_SolveQP``; the gradient reaches the second PAN iteration
    through the first one's trajectory. Otherwise the step runs under
    ``torch.no_grad()``.

    The step's CUDA matmuls run at ``spec.precision`` (``matmul_precision``;
    the QP pins exact float32 inside it), the flag restored on return.
    """
    same_device(vertices, G, h, nom_s, nom_u, ref_s, ref_us, points, velocities,
                mask, *state, *adjust, *(p for p in encoder.parameters()))
    record = torch.is_grad_enabled() and any(t.requires_grad for t in adjust)
    with matmul_precision(spec.precision), torch.enable_grad() if record else torch.no_grad():
        if spec.nrmp.no_obs:
            return _pan_forward_no_obs(spec, adjust, nom_s, nom_u, ref_s, ref_us, state)
        return _pan_forward_obs(spec, encoder, vertices, G, h, adjust, nom_s, nom_u,
                                ref_s, ref_us, points, velocities, mask, state)


def _pan_forward_obs(spec: PANSpec, encoder, vertices, G, h, adjust: AdjustParams,
                     nom_s, nom_u, ref_s, ref_us, points, velocities, mask,
                     state: PANState) -> PANOutput:
    """The step with obstacle slots (``nrmp.K > 0``); see ``pan_forward``."""
    robot = spec.robot
    T, K = robot.T, spec.nrmp.K
    dtype = nom_s.dtype
    has_points = torch.any(mask, dim=1)
    n_valid = torch.clamp(torch.sum(mask.to(torch.int32), dim=1), max=K)

    B = nom_s.shape[0]
    done = torch.zeros((B,), dtype=torch.bool, device=nom_s.device)
    min_distance = torch.full((B,), _INF, dtype=dtype, device=nom_s.device)
    opt_d = torch.zeros((B, T), dtype=dtype, device=nom_s.device)
    nrmp_pts = torch.zeros((B, 2, K), dtype=dtype, device=nom_s.device)
    nrmp_val = torch.zeros((B, K), dtype=torch.bool, device=nom_s.device)
    cur = state

    use_kernel, mlp_kernel = spec.use_dune_kernel(), spec.use_dune_mlp_kernel(points.device)
    admm = _admm_with_elim(spec)
    admm_warm = (admm if spec.admm_warm_iters is None else
                 dataclasses.replace(admm, iters=int(spec.admm_warm_iters)))
    for it_i in range(spec.iter_num):
        admm_i = admm if it_i == 0 else admm_warm
        if use_kernel and spec.dune_select == "exact":
            # fused path: the per-frame point flow is never materialized
            dune = dune_forward_flow(encoder, G, h, points, velocities, mask, nom_s,
                                     robot.dt, K, vertices, mlp_kernel=mlp_kernel)
        else:
            pf, R_all, pts_glob = generate_point_flow(nom_s, points, velocities, robot.dt)
            dune = dune_forward(encoder, G, h, pf, R_all, pts_glob, mask, K,
                                use_kernel=use_kernel, select=spec.dune_select,
                                vertices=vertices, mlp_kernel=mlp_kernel)

        fa, fb = coefficients_from_dune(spec.nrmp, dune.mu_k, dune.lam_k,
                                        dune.points_k, dune.valid_k, h, has_points)
        A_dyn, B_dyn, C_dyn = robot.linearize(nom_s, nom_u)
        qp = build_qp(spec.nrmp, adjust, nom_s, nom_u, ref_s, ref_us,
                      A_dyn, B_dyn, C_dyn, fa, fb)
        elim = condensation(spec.nrmp, A_dyn, B_dyn, C_dyn, nom_s[:, :, 0])
        sol = solve_qp(qp, admm_i, cur.x_warm, cur.y_warm, elim)
        s_new, u_new, d_new = unpack_solution(spec.nrmp, sol.x)

        diff = _stop_diff(spec, cur, s_new, u_new, dune, has_points, n_valid)
        newly_done = (diff < spec.iter_threshold) & cur.prev_valid

        keep = done  # already converged: discard this iteration's work
        upd = lambda old, new: _where(keep, old, new)
        nom_s = upd(nom_s, s_new)
        nom_u = upd(nom_u, u_new)
        opt_d = upd(opt_d, d_new)
        min_distance = upd(min_distance, dune.min_distance)
        nrmp_pts = upd(nrmp_pts, dune.points_k[:, 0])
        nrmp_val = upd(nrmp_val, dune.valid_k[:, 0])
        cur = PANState(
            prev_mu=upd(cur.prev_mu, dune.mu_k),
            prev_lam=upd(cur.prev_lam, dune.lam_k),
            prev_s=upd(cur.prev_s, s_new),
            prev_u=upd(cur.prev_u, u_new),
            prev_valid=cur.prev_valid | ~keep,
            prev_has_points=upd(cur.prev_has_points, has_points),
            x_warm=upd(cur.x_warm, sol.x),
            y_warm=upd(cur.y_warm, sol.y),
        )
        done = done | newly_done

    return PANOutput(
        opt_s=nom_s, opt_u=nom_u, opt_d=opt_d,
        min_distance=torch.where(has_points, min_distance,
                                 torch.full_like(min_distance, _INF)),
        nrmp_points=nrmp_pts, nrmp_valid=nrmp_val, state=cur)


def _pan_forward_no_obs(spec: PANSpec, adjust: AdjustParams, nom_s, nom_u, ref_s, ref_us,
                        state: PANState) -> PANOutput:
    """The step without obstacle handling (``nrmp.K == 0``): the tracking QP
    alone, ``iter_num`` times; ``opt_d`` is None."""
    robot = spec.robot
    B, dtype, dev = nom_s.shape[0], nom_s.dtype, nom_s.device
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    cur = state
    admm = _admm_with_elim(spec)

    for _ in range(spec.iter_num):
        A_dyn, B_dyn, C_dyn = robot.linearize(nom_s, nom_u)
        qp = build_qp(spec.nrmp, adjust, nom_s, nom_u, ref_s, ref_us, A_dyn, B_dyn, C_dyn)
        elim = condensation(spec.nrmp, A_dyn, B_dyn, C_dyn, nom_s[:, :, 0])
        sol = solve_qp(qp, admm, cur.x_warm, cur.y_warm, elim)
        s_new, u_new, _ = unpack_solution(spec.nrmp, sol.x)

        diff = _stop_diff(spec, cur, s_new, u_new, None)
        newly_done = (diff < spec.iter_threshold) & cur.prev_valid

        keep = done
        upd = lambda old, new: _where(keep, old, new)
        nom_s = upd(nom_s, s_new)
        nom_u = upd(nom_u, u_new)
        cur = cur._replace(
            prev_s=upd(cur.prev_s, s_new),
            prev_u=upd(cur.prev_u, u_new),
            prev_valid=cur.prev_valid | ~keep,
            prev_has_points=cur.prev_has_points & keep,
            x_warm=upd(cur.x_warm, sol.x),
            y_warm=upd(cur.y_warm, sol.y),
        )
        done = done | newly_done

    K = max(spec.nrmp.K, 1)
    return PANOutput(
        opt_s=nom_s, opt_u=nom_u, opt_d=None,
        min_distance=torch.full((B,), _INF, dtype=dtype, device=dev),
        nrmp_points=torch.zeros((B, 2, K), dtype=dtype, device=dev),
        nrmp_valid=torch.zeros((B, K), dtype=torch.bool, device=dev), state=cur)
