"""Batched SPD inverse by the symmetric sweep operator.

Replaces the TPU kernel ``neupan_tpu/ops/pallas/sweep.py:sweep_spd_inverse``
(``_sweep_body``; ``_sweep_kernel_rolled`` for n > 64) with
``neupan_torch/csrc/sweep.cu`` (the element arithmetic is in
``csrc/sweep.cuh``; the polish kernel runs the same arithmetic in its own
register layout).

What it computes: the inverse of a batch of Jacobi-scaled, ridged SPD
matrices, n <= 96, by n pivot steps without pivoting. Sweeping pivot j
keeps the matrix symmetric (b_jj = -1/d, b_jk = a_jk/d, b_ik = a_ik -
a_ij a_jk/d); after all pivots the buffer holds -A^{-1}.
``spd_inverse_scaled``, which the QP's inverses call, does the Jacobi
scaling, the ridge and the unscaling in the same kernel on a card (the
TPU package runs them as XLA ops around its kernel); on the CPU it runs
them in PyTorch around the plain sweep, and with
``inverse=sweep_spd_inverse_plain`` it is the plain version of the fused
call on either device. Above n=96 (T >= 33 in the condensed QP)
``spd_inverse_any`` takes the JAX package's route there: the same scaling
and ridge around a Cholesky factorization (``cholesky_inverse``).

Bound on the H100: bytes. The work is ~2 n^3 float operations per matrix
against 8 n^2 bytes in and out (n=30: 54 kFLOP against 7.2 KB), far below
the card's ~20 operations per byte.

Design (``csrc/sweep.cu``), by n:

* n <= 32: one warp per matrix, two matrices per 64-thread block. Lane c
  holds column c in 32 registers. The pivot loop is rolled, yet every
  register index is static: the rows rotate, so the pivot row is always
  the first register and each update writes a row into the register
  below. Per pivot each lane publishes its entry of the next pivot row
  (stored twice, so each lane reads the rotated row as one contiguous
  run), one ``__syncwarp``, and the next reciprocal starts while the other
  rows update: no block barrier.
* 32 < n <= 64: the same with two warps per matrix (the 64-thread block),
  40 or 64 registers per lane, one ``__syncthreads`` per pivot.
* 64 < n <= 96 (T=30's n=90): a 256-thread block per matrix, each thread
  holding 36 elements in registers, one barrier per pivot: the thread that
  updates row j+1 writes it into the other half of the double buffer.

What bounds it on the card is the chain of n pivots, not the ~2 n^3
operations: the next pivot needs the previous one's row j+1 and its
reciprocal, so one warp per matrix is latency-bound and B=1 takes about
as long as B=512 (``PERF.md`` section 6).

The reciprocal, square root and division are correctly rounded and every
product and sum uses a round-to-nearest intrinsic, so the kernel equals
the plain versions below operation for operation.
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
    kernel scales its two inverses by this same definition.

    With the default ``inverse`` a CUDA tensor takes one launch of the sweep
    kernel that also scales, ridges and unscales (counted on
    ``sweep_spd_inverse.launches``); ``inverse=sweep_spd_inverse_plain`` is
    its plain version."""
    if inverse is sweep_spd_inverse and M.is_cuda:
        M = M.contiguous()
        dev, B, n = _check_input(M)
        out = torch.empty_like(M)
        P_, I_ = _build.PTR, _build.INT
        fn = _build.function("sweep_spd_inverse_scaled_launch", [P_, P_, I_, I_, P_])
        _build.launch(fn, dev, _build.ptr(M), _build.ptr(out), B, n)
        sweep_spd_inverse.launches += 1
        return out
    n = M.shape[-1]
    dj = 1.0 / torch.sqrt(torch.abs(torch.diagonal(M, dim1=-2, dim2=-1)) + 1e-30)
    Mt = M * dj[:, :, None] * dj[:, None, :]
    Mt = Mt + 1e-7 * torch.eye(n, dtype=M.dtype, device=M.device)
    X = inverse(Mt.contiguous())
    return X * dj[:, :, None] * dj[:, None, :]


def cholesky_inverse(Mt: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of Jacobi-scaled, ridged SPD matrices by a Cholesky
    factorization and solve (library calls): the route above ``MAX_N``, as
    ``neupan_tpu/ops/qp.py:_spd_inverse`` takes it outside any Pallas
    kernel. Calls on CUDA tensors are counted in ``cholesky_inverse.launches``."""
    L = torch.linalg.cholesky(Mt)
    eye = torch.eye(Mt.shape[-1], dtype=Mt.dtype, device=Mt.device).expand_as(Mt)
    if Mt.is_cuda:
        cholesky_inverse.launches += 1
    # LAPACK leaves the solve column-major; the kernels read row-major
    return torch.cholesky_solve(eye, L).contiguous()


cholesky_inverse.launches = 0


def spd_inverse_any(M: torch.Tensor, small=sweep_spd_inverse) -> torch.Tensor:
    """``spd_inverse_scaled`` at any n: ``small`` (the sweep kernel, or its
    plain version) up to ``MAX_N``, the Cholesky route above it."""
    return spd_inverse_scaled(M, small if M.shape[-1] <= MAX_N else cholesky_inverse)
