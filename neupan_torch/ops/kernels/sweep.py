"""Batched SPD inverse by the symmetric sweep operator.

Replaces the TPU kernel ``neupan_tpu/ops/pallas/sweep.py:sweep_spd_inverse``
(``_sweep_body``; ``_sweep_kernel_rolled`` for n > 64) with
``neupan_torch/csrc/sweep.cu`` (the pivot loop is the device function in
``csrc/sweep.cuh``; the polish kernel runs the same arithmetic in its own
register layout).

What it computes: the inverse of a batch of Jacobi-scaled, ridged SPD
matrices, n <= 96, by n pivot steps without pivoting. Sweeping pivot j
keeps the matrix symmetric (b_jj = -1/d, b_jk = a_jk/d, b_ik = a_ik -
a_ij a_jk/d); after all pivots the buffer holds -A^{-1}.

Bound on the H100: bytes. The work is ~2 n^3 float operations per matrix
against 8 n^2 bytes in and out (n=30: 54 kFLOP against 7.2 KB), far below
the card's ~20 operations per byte; but the n pivot steps are sequential,
so what the kernel actually waits on is n barriers per matrix.

Design: one block per matrix. The matrix (36 KB at n=96) is read once into
shared memory, the n rank-1 steps run there with a barrier between steps
(256 threads, ~4 elements each at n=30), and the inverse is written once.
With B=512 matrices the 132 SMs each hold several blocks, which hides part
of the barrier latency. The reciprocal is correctly rounded and the update
uses round-to-nearest intrinsics, so the kernel equals the plain version
below operation for operation.
"""

from __future__ import annotations

import torch

from neupan_torch.ops.kernels import _build

MAX_N = 96


def _check_input(M):
    dev = _build.dispatch_device(M)
    if M.dim() != 3 or M.shape[0] < 1 or M.shape[1] != M.shape[2]:
        raise ValueError(f"M must be (B>=1, n, n), got {tuple(M.shape)}")
    n = M.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"sweep_spd_inverse takes n <= {MAX_N}, got n={n}")
    _build.check(M, "M", tuple(M.shape), device=dev)
    return dev, M.shape[0], n


def sweep_spd_inverse_plain(M: torch.Tensor) -> torch.Tensor:
    """The same function as ``sweep_spd_inverse`` in plain PyTorch."""
    n = M.shape[-1]
    A = M.clone()
    for j in range(n):
        row = A[:, j, :].clone()                  # == column j (symmetry)
        inv_d = 1.0 / row[:, j:j + 1]
        rs = row * inv_d
        A = A - row[:, :, None] * rs[:, None, :]
        A[:, j, :] = rs
        A[:, :, j] = rs
        A[:, j, j] = -inv_d[:, 0]
    return -A


def sweep_spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Invert a batch (B, n, n) of Jacobi-scaled, ridged SPD float32 matrices."""
    dev, B, n = _check_input(M)
    if dev.type == "cpu":
        return sweep_spd_inverse_plain(M)
    out = torch.empty_like(M)
    P_, I_ = _build.PTR, _build.INT
    fn = _build.function("sweep_spd_inverse_launch", [P_, P_, I_, I_, P_])
    _build.launch(fn, dev, _build.ptr(M), _build.ptr(out), B, n)
    sweep_spd_inverse.launches += 1
    return out


sweep_spd_inverse.launches = 0


def spd_inverse_scaled(M: torch.Tensor, inverse=sweep_spd_inverse) -> torch.Tensor:
    """Inverse of a batch of SPD matrices: Jacobi scaling (1/sqrt|diag|) and a
    1e-7 ridge, then ``inverse`` (the sweep), then the unscaling. Pivot-free:
    every pivot of the scaled, ridged SPD matrix is positive. The polish
    kernel scales its two inverses by this same definition."""
    n = M.shape[-1]
    dj = 1.0 / torch.sqrt(torch.abs(torch.diagonal(M, dim1=-2, dim2=-1)) + 1e-30)
    Mt = M * dj[:, :, None] * dj[:, None, :]
    Mt = Mt + 1e-7 * torch.eye(n, dtype=M.dtype, device=M.device)
    X = inverse(Mt.contiguous())
    return X * dj[:, :, None] * dj[:, None, :]
