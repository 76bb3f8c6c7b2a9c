"""A fixed count of condensed-ADMM iterations, state kept on chip.

Replaces the TPU kernel ``neupan_tpu/ops/pallas/admm.py:admm_iterate``
(``_admm_kernel``) with ``neupan_torch/csrc/admm.cu``.

What it computes, per scenario, ``iters`` times:
    t = rho z - y;  w~ = Minv (sigma w - q + As' t);  z~ = As w~;
    w = alpha w~ + (1 - alpha) w;  z_mix = alpha z~ + (1 - alpha) z;
    v = z_mix + y / rho;  z_new = clip(v, l, u), or on soft rows the prox of
    the one-sided penalty min(l + (v - l) rho / (rho + soft) if v < l, u);
    y = y + rho (z_mix - z_new).

Bound on the H100: the dependent chain of each iteration, not bytes or
operations. One iteration is ~4 m k + 2 k^2 + 15 m float operations per
scenario (k=30, m=148: ~22 kFLOP, ~0.3 ns of the card's float32 peak at
B=1), and the operator (m k + k^2 floats, 21 KB) is read once for all
iterations. What an iteration waits on is its chain: phase A (As' t),
a barrier, phase B (Minv rhs), a barrier, phase C (As w~ and the prox), so
~5 dependent steps; at B=512 also the issue slots of ~4 blocks per SM.

Design: one block per scenario, rows of As in tiles of 32 (one warp per
tile), columns in chunks of 32 (lane c: column c).

* ``admm_regs_kernel`` (k <= 32, m <= 224; the main path's k=30, m=148 and
  the K=0 step's k=20, m=38): 32 x ceil(m/32) threads. Each warp holds its
  tile of As by column in registers (lane c: As[., c]), the eight Minv rows
  of its output group, and in lane r the state of row r (z, y, l, u, rho);
  shared memory holds t, the partials, w~ and the tile by row (stride 33,
  so lane r reads row r without a bank conflict). A: lane c sums its column
  against t (float4 broadcasts, four partial sums of eight) into one
  partial per warp; B: warp g sums the partials into rhs and computes
  w~[8g..8g+7] with one reduce-scatter (9 shuffles); C: lane r sums row r
  against w~ (float4 broadcasts, four partial sums), runs the prox and dual
  update of row r and writes t. Two ``__syncthreads`` per iteration (after
  A and after B), no shuffle in A or C. Holding the row copy in registers
  too was faster at B=1 but took ~100 registers, so B=512 no longer fit
  one wave and ran slower; the main path's B=512 decided.
* ``admm_smem_kernel<NC>`` (every other admitted shape, e.g. T=30's k=90,
  m=451): the same phases and barriers with As, Minv and the row state in
  shared memory (column reads conflict-free, rows as broadcasts), up to 8
  warps; NC = 1, 2, 3 column chunks unrolled, 0 a runtime count for k > 96.

No tensor cores: every product is a matrix times one vector per scenario
and iteration, and the port keeps float32 throughout (TF32 off: reduced
precision broke the accuracy contract). ``smem_bytes`` is the admission
rule (``admm_fits``); every shape it admits fits one of the two instances
(the shared-memory one needs no more than it, with one warp).
"""

from __future__ import annotations

import torch

from neupan_torch.ops.kernels import _build


def smem_bytes(k: int, m: int) -> int:
    """Shared memory the admission rule reserves for (k, m); the kernel
    needs no more than this."""
    return 4 * (m * k + k * k + 4 * k + 9 * m)


def admm_fits(k: int, m: int) -> bool:
    """The admission rule: the kernel takes (k, m) while ``smem_bytes`` fits
    one block's shared memory. The wrapper refuses any other shape, and the
    QP (``ops/qp.py``) routes such shapes to ``admm_iterate_plain``, as the
    JAX package's ``admm_kernel_fits`` gate does."""
    return smem_bytes(k, m) <= _build.SMEM_LIMIT


def _check_inputs(Minv, As, qs, ls, us, soft, rho, w0, z0, y0, dtype=torch.float32):
    dev = _build.dispatch_device(As)
    if As.dim() != 3 or As.shape[0] < 1:
        raise ValueError(f"As must be (B>=1, m, k), got {tuple(As.shape)}")
    B, m, k = As.shape
    _build.check(Minv, "Minv", (B, k, k), dtype, device=dev)
    _build.check(As, "As", (B, m, k), dtype, device=dev)
    for name, t in (("qs", qs), ("w0", w0)):
        _build.check(t, name, (B, k), dtype, device=dev)
    for name, t in (("ls", ls), ("us", us), ("soft", soft), ("rho", rho),
                    ("z0", z0), ("y0", y0)):
        _build.check(t, name, (B, m), dtype, device=dev)
    return dev, B, m, k


def admm_iterate_plain(Minv, As, qs, ls, us, soft, rho, w0, z0, y0, *,
                       iters: int, sigma: float, alpha: float):
    """The same function as ``admm_iterate`` in plain PyTorch, at any (k, m)
    and in float64 too. Calls on CUDA tensors are counted in
    ``admm_iterate_plain.launches``."""
    dev = _check_inputs(Minv, As, qs, ls, us, soft, rho, w0, z0, y0, dtype=As.dtype)[0]
    if dev.type == "cuda":
        admm_iterate_plain.launches += 1
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
    Returns (w (B, k), z (B, m), y (B, m)). Raises, on either device, for a
    shape ``admm_fits`` does not admit.
    """
    dev, B, m, k = _check_inputs(Minv, As, qs, ls, us, soft, rho, w0, z0, y0)
    if not admm_fits(k, m):
        raise ValueError(f"the ADMM operator at k={k}, m={m} does not fit in "
                         f"one block's shared memory")
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
admm_iterate_plain.launches = 0
