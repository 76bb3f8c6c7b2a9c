"""LON — learning of navigation: online tuning of the adjust parameters.

Port of ``neupan_tpu/lon.py`` on the port's batched layout. Closed-loop
episodes differentiate a loss of the planner step through the NRMP QP
into the adjustable weights (q_s, p_u, eta, d_max, d_min): ``pan_forward``
records its graph when an ``AdjustParams`` tensor requires grad, and the
QP's backward is the implicit differentiation of ``ops/qp.py:_SolveQP``.

  * ``distance_loss`` — the reference's per-step loss shape: 50 - sum(d)
    near collision, 50 + sum(d) when stuck, else 0; scaled by 10;
  * ``tracking_losses`` — the state and speed MSE of the LON_corridor_02
    variant;
  * ``step_loss_and_grad`` — one planner step -> (loss, grads wrt adjust);
  * ``LONTuner`` — Adam on a masked subset of the fields (optax's
    defaults, written out), then the same clamps as the JAX class.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional, Sequence

import torch

from neupan_torch.ops.nrmp import AdjustParams
from neupan_torch.ops.pan import PANOutput, PANSpec, PANState, pan_forward


def distance_loss(opt_d: torch.Tensor, min_distance: torch.Tensor,
                  collision_threshold: float = 0.3,
                  stuck=False) -> torch.Tensor:
    """Reference LON loss: penalize near-collision and stuck steps.

    opt_d (..., T), min_distance (...) and ``stuck`` (a bool, or a bool
    tensor broadcasting against min_distance) give a loss of shape (...):
    one per scenario for a batch."""
    near = min_distance < collision_threshold
    total = torch.sum(opt_d, dim=-1)
    stuck = torch.as_tensor(stuck, dtype=torch.bool, device=total.device)
    zero = torch.zeros_like(total)
    base = torch.where(near, 50.0 - total, torch.where(stuck, 50.0 + total, zero))
    return 10.0 * base


def tracking_losses(out, ref_s: torch.Tensor, ref_us: torch.Tensor):
    """State and speed MSE losses of the LON_corridor_02 variant: the mean of
    (opt_s - ref_s)^2 over (3, T+1) and of (opt_u[0] - ref_us)^2 over T,
    one each per scenario (``opt_u[:, 0, :]`` is the speed row)."""
    state_loss = torch.mean((out.opt_s - ref_s) ** 2, dim=(-2, -1))
    speed_loss = torch.mean((out.opt_u[..., 0, :] - ref_us) ** 2, dim=-1)
    return state_loss, speed_loss


def _loss_fn_arity(loss_fn) -> int:
    """Arity contract: 1 (loss_fn(out)) or 4 (loss_fn(out, ref_s, ref_us,
    stuck)). Anything else is an error: a 2/3-parameter function called with
    4 positional arguments would raise late, and a signature that cannot be
    inspected must not silently drop ref_s/ref_us/stuck."""
    try:
        params = inspect.signature(loss_fn).parameters
    except (TypeError, ValueError) as e:
        raise TypeError(
            "loss_fn signature could not be inspected; wrap it in a plain "
            "def taking either (out) or (out, ref_s, ref_us, stuck)"
        ) from e
    # *args / **kwargs make the parameter count meaningless: a loss_fn
    # declared as (*args) would count as 1 and be called as loss_fn(out),
    # dropping ref_s/ref_us/stuck
    for p in params.values():
        if p.kind in (inspect.Parameter.VAR_POSITIONAL,
                      inspect.Parameter.VAR_KEYWORD):
            raise ValueError(
                "loss_fn must declare explicit positional parameters — "
                "either (out) or (out, ref_s, ref_us, stuck); *args/"
                "**kwargs signatures are ambiguous and rejected")
    n_params = len(params)
    if n_params not in (1, 4):
        raise ValueError(
            f"loss_fn must take exactly 1 argument (out) or 4 arguments "
            f"(out, ref_s, ref_us, stuck); got {n_params}")
    return n_params


def _detach(out: PANOutput) -> PANOutput:
    d = lambda t: None if t is None else t.detach()
    return PANOutput(*(d(t) for t in out[:-1]), state=PANState(*(d(t) for t in out.state)))


def step_loss_and_grad(spec: PANSpec, encoder, vertices, G, h,
                       adjust: AdjustParams,
                       nom_s, nom_u, ref_s, ref_us,
                       points, velocities, mask, state: PANState,
                       loss_fn: Optional[Callable] = None,
                       collision_threshold: float = 0.3,
                       stuck=False):
    """Differentiate one batched planner step's loss w.r.t. the adjust
    parameters.

    Takes what ``pan_forward`` takes (a batch of B scenarios). The loss is
    ``distance_loss`` of the step, or ``loss_fn(out)`` /
    ``loss_fn(out, ref_s, ref_us, stuck)`` on the batched output; one value
    per scenario. Returns (loss (B,), grads of the summed loss as
    AdjustParams, the step's output without its graph). At B=1 this is the
    JAX function. The gradient is taken with ``torch.autograd.grad`` on
    grad-requiring copies of ``adjust``, so nothing accumulates in the
    encoder's ``.grad``. Unlike the JAX function nothing is cached: the
    port records a fresh graph per call and has no trace to keep.
    """
    n_params = 1 if loss_fn is None else _loss_fn_arity(loss_fn)
    adj = AdjustParams(*(t.detach().clone().requires_grad_(True) for t in adjust))
    with torch.enable_grad():
        out = pan_forward(spec, encoder, vertices, G, h, adj, nom_s, nom_u, ref_s, ref_us,
                          points, velocities, mask, state)
        if loss_fn is None:
            loss = distance_loss(out.opt_d, out.min_distance, collision_threshold, stuck)
        elif n_params == 1:
            loss = loss_fn(out)
        else:
            loss = loss_fn(out, ref_s, ref_us, stuck)
        grads = torch.autograd.grad(loss.sum(), list(adj), allow_unused=True)
    grads = AdjustParams(*(torch.zeros_like(a) if g is None else g
                           for a, g in zip(adj, grads)))
    return loss.detach(), grads, _detach(out)


class LONTuner:
    """Adam updates on a masked subset of AdjustParams fields.

    optax's ``adam`` with its defaults (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root), written out in float32 on the fields' devices; the
    frozen fields come back unchanged. Functional like the JAX class:
    ``update(adjust, grads)`` returns new weights and keeps the moments.
    The clamps may leave d_min at exactly 0, where the step's gradient in
    d_min is the whole one and JAX's half (``torch.clamp`` against
    ``jnp.maximum`` at a tie, ``ops/nrmp.py:build_qp``).
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, adjust: AdjustParams, lr: float = 5e-3,
                 train_fields: Sequence[str] = ("p_u", "eta", "d_max")):
        self.train_fields = tuple(train_fields)
        unknown = set(self.train_fields) - set(AdjustParams._fields)
        if unknown:
            raise ValueError(f"unknown AdjustParams fields {sorted(unknown)}")
        self.lr = lr
        self.count = 0
        self.mu = {f: torch.zeros_like(getattr(adjust, f)) for f in self.train_fields}
        self.nu = {f: torch.zeros_like(getattr(adjust, f)) for f in self.train_fields}

    @torch.no_grad()
    def update(self, adjust: AdjustParams, grads: AdjustParams) -> AdjustParams:
        self.count += 1
        new = adjust._asdict()
        for f in self.train_fields:
            p, g = getattr(adjust, f), getattr(grads, f)
            self.mu[f] = (1.0 - self.b1) * g + self.b1 * self.mu[f]
            self.nu[f] = (1.0 - self.b2) * g ** 2 + self.b2 * self.nu[f]
            # the bias corrections in the moments' dtype, as optax forms them
            c1 = 1.0 - torch.tensor(self.b1, dtype=p.dtype) ** self.count
            c2 = 1.0 - torch.tensor(self.b2, dtype=p.dtype) ** self.count
            step = (self.mu[f] / c1.to(p.device)) / (
                torch.sqrt(self.nu[f] / c2.to(p.device)) + self.eps)
            new[f] = p + (-self.lr) * step
        # keep distances meaningful
        return AdjustParams(**new)._replace(
            d_max=torch.clamp(new["d_max"], min=1e-3),
            d_min=torch.clamp(new["d_min"], min=0.0),
            eta=torch.clamp(new["eta"], min=0.0))
