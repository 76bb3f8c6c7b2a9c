"""A fixed count of condensed-ADMM iterations, state kept on chip.

Replaces the TPU kernel ``neupan_tpu/ops/pallas/admm.py:admm_iterate``
(``_admm_kernel``) with ``neupan_torch/csrc/admm.cu``.

What it computes, per scenario, ``iters`` times:
    t = rho z - y;  w~ = Minv (sigma w - q + As' t);  z~ = As w~;
    w = alpha w~ + (1 - alpha) w;  z_mix = alpha z~ + (1 - alpha) z;
    v = z_mix + y / rho;  z_new = clip(v, l, u), or on soft rows the prox of
    the one-sided penalty min(l + (v - l) rho / (rho + soft) if v < l, u);
    y = y + rho (z_mix - z_new).

Bound on the H100: operations. One iteration is ~4 m k + 2 k^2 + 15 m
float operations per scenario (k=30, m=148: ~22 kFLOP), and the operator
(m k + k^2 floats, 21 KB) is reused by every iteration: at B=512 and
120 iterations that is ~1.3 GFLOP against ~13 MB of input.

Design: one block per scenario (128 threads). As, Minv and the bounds are
read into shared memory once and w, z, y stay there across all
iterations; only the final iterate is written. As' t is reduced by one
warp per output (lanes stride over m, warp shuffle), Minv rhs and As w~ by
one thread per output. Four barriers per iteration order the phases. The
wrapper raises for shapes whose operator does not fit in a block's shared
memory (the TPU package's ``admm_kernel_fits`` plays that role there).
"""

from __future__ import annotations

import torch

from neupan_torch.ops.kernels import _build


def smem_bytes(k: int, m: int) -> int:
    """Shared memory the kernel needs at (k, m); mirrors csrc/admm.cu."""
    return 4 * (m * k + k * k + 4 * k + 9 * m)


def _check_inputs(Minv, As, qs, ls, us, soft, rho, w0, z0, y0):
    dev = _build.dispatch_device(As)
    if As.dim() != 3 or As.shape[0] < 1:
        raise ValueError(f"As must be (B>=1, m, k), got {tuple(As.shape)}")
    B, m, k = As.shape
    _build.check(Minv, "Minv", (B, k, k), device=dev)
    _build.check(As, "As", (B, m, k), device=dev)
    for name, t in (("qs", qs), ("w0", w0)):
        _build.check(t, name, (B, k), device=dev)
    for name, t in (("ls", ls), ("us", us), ("soft", soft), ("rho", rho),
                    ("z0", z0), ("y0", y0)):
        _build.check(t, name, (B, m), device=dev)
    if smem_bytes(k, m) > _build.SMEM_LIMIT:
        raise ValueError(f"the ADMM operator at k={k}, m={m} does not fit in "
                         f"one block's shared memory")
    return dev, B, m, k


def admm_iterate_plain(Minv, As, qs, ls, us, soft, rho, w0, z0, y0, *,
                       iters: int, sigma: float, alpha: float):
    """The same function as ``admm_iterate`` in plain PyTorch."""
    _check_inputs(Minv, As, qs, ls, us, soft, rho, w0, z0, y0)
    inv_rho = 1.0 / rho
    soft_fac = rho / (rho + soft)
    is_soft = soft > 0.0
    AsT = As.transpose(1, 2)
    w, z, y = w0, z0, y0
    for _ in range(iters):
        t = rho * z - y
        rhs = sigma * w - qs + torch.bmm(AsT, t[:, :, None])[:, :, 0]
        w_t = torch.bmm(Minv, rhs[:, :, None])[:, :, 0]
        z_t = torch.bmm(As, w_t[:, :, None])[:, :, 0]
        w_new = alpha * w_t + (1.0 - alpha) * w
        z_mix = alpha * z_t + (1.0 - alpha) * z
        v = z_mix + y * inv_rho
        z_sf = torch.where(v >= ls, v, ls + (v - ls) * soft_fac)
        z_new = torch.where(is_soft, torch.minimum(z_sf, us), torch.clamp(v, ls, us))
        y = y + rho * (z_mix - z_new)
        w, z = w_new, z_new
    return w, z, y


def admm_iterate(Minv: torch.Tensor, As: torch.Tensor, qs: torch.Tensor,
                 ls: torch.Tensor, us: torch.Tensor, soft: torch.Tensor,
                 rho: torch.Tensor, w0: torch.Tensor, z0: torch.Tensor,
                 y0: torch.Tensor, *, iters: int, sigma: float, alpha: float):
    """Run ``iters`` condensed-ADMM iterations for a batch of QPs.

    Args (float32, batched on axis 0): Minv (B, k, k) symmetric, As (B, m, k),
    qs/w0 (B, k), ls/us/soft/rho/z0/y0 (B, m).
    Returns (w (B, k), z (B, m), y (B, m)).
    """
    dev, B, m, k = _check_inputs(Minv, As, qs, ls, us, soft, rho, w0, z0, y0)
    if dev.type == "cpu":
        return admm_iterate_plain(Minv, As, qs, ls, us, soft, rho, w0, z0, y0,
                                  iters=iters, sigma=sigma, alpha=alpha)
    w, z, y = torch.empty_like(w0), torch.empty_like(z0), torch.empty_like(y0)
    P_, I_, F_ = _build.PTR, _build.INT, _build.FLOAT
    fn = _build.function("admm_iterate_launch",
                         [P_] * 13 + [I_] * 4 + [F_] * 3 + [P_])
    _build.launch(fn, dev, *(_build.ptr(t) for t in (
        Minv, As, qs, ls, us, soft, rho, w0, z0, y0, w, z, y)),
        B, k, m, int(iters), float(sigma), float(alpha), float(1.0 - alpha))
    admm_iterate.launches += 1
    return w, z, y


admm_iterate.launches = 0
