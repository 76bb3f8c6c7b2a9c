"""Block-tridiagonal SPD factorization for horizon-structured matrices
(port of ``neupan_tpu/ops/banded.py``), batched over a leading B.

The NRMP normal matrix M = diag(P) + A' R A is block-tridiagonal under the
time-interleaved variable order z_t = (s_t, u_t, d_t): every constraint
row couples variables at most one step apart. A blocked Cholesky over the
nb blocks costs O(nb b^3) instead of O((nb b)^3); it is the full-space
ADMM's normal-matrix inverse with ``ADMMConfig(inverse="banded")``.

The factorization and the substitutions are loops of batched (B, b, b)
library calls (``torch.linalg.cholesky_ex``, ``solve_triangular``, ``bmm``),
as the JAX package runs them as a ``lax.scan`` of XLA ops: no hand kernel
is involved. On CUDA tensors ``btd_spd_inverse.launches`` counts the
inverses and ``btd_spd_inverse.library_calls`` the library calls they
issued.

The API works on the permuted representation: callers give a permutation
(``nrmp_permutation``) mapping solver order to interleaved order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def nrmp_permutation(T: int, no_obs: bool = False) -> np.ndarray:
    """Permutation p with x_interleaved = x_solver[p].

    Solver order: s (3(T+1)), u (2T), d (T). Interleaved order: (s_t, u_t,
    d_t) for t = 0..T-1, then s_T. Returns indices of length n = 6T + 3 (or
    5T + 3 without d).
    """
    off_u = 3 * (T + 1)
    off_d = off_u + 2 * T
    idx = []
    for t in range(T):
        idx.extend(range(3 * t, 3 * t + 3))
        idx.extend(range(off_u + 2 * t, off_u + 2 * t + 2))
        if not no_obs:
            idx.append(off_d + t)
    idx.extend(range(3 * T, 3 * T + 3))
    return np.asarray(idx, dtype=np.int32)


class BTDFactor(NamedTuple):
    L_diag: torch.Tensor   # (B, nb, b, b) lower-triangular Cholesky blocks
    L_off: torch.Tensor    # (B, nb-1, b, b) sub-diagonal blocks


def _count(t: torch.Tensor, calls: int) -> None:
    if t.is_cuda:
        btd_spd_inverse.library_calls += calls


def _pad_identity(Mp: torch.Tensor, b: int) -> torch.Tensor:
    """Zero-pad (B, n, n) to a whole number of b-blocks, identity on the padding."""
    n = Mp.shape[-1]
    npad = -(-n // b) * b
    if npad == n:
        return Mp
    out = torch.zeros((Mp.shape[0], npad, npad), dtype=Mp.dtype, device=Mp.device)
    out[:, :n, :n] = Mp
    idx = torch.arange(n, npad, device=Mp.device)
    out[:, idx, idx] = 1.0
    return out


def _blocks_from_dense(Mp: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal (B, nb, b, b) and sub-diagonal (B, nb-1, b, b) blocks of a
    permuted dense SPD batch (B, n, n), the trailing partial block padded
    with the identity."""
    Mp = _pad_identity(Mp, b)
    nb = Mp.shape[-1] // b
    D = torch.stack([Mp[:, i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(nb)], dim=1)
    E = torch.stack([Mp[:, (i + 1) * b:(i + 2) * b, i * b:(i + 1) * b]
                     for i in range(nb - 1)], dim=1)
    return D, E


def _cholesky(M: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor; NaN where a matrix is not positive definite,
    as ``jnp.linalg.cholesky`` returns it (and no host synchronization)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))


def btd_cholesky(D: torch.Tensor, E: torch.Tensor) -> BTDFactor:
    """Blocked Cholesky M = L L' of a batch of block-tridiagonal SPD matrices.

    D: (B, nb, b, b) diagonal blocks, E: (B, nb-1, b, b) sub-diagonal blocks.
    L_0 = chol(D_0); B_t = E_t L_{t-1}^{-T}; L_t = chol(D_t - B_t B_t').
    """
    b = D.shape[-1]
    ridge = 1e-7 * torch.eye(b, dtype=D.dtype, device=D.device)
    L = [_cholesky(D[:, 0] + ridge)]
    Bs = []
    for t in range(1, D.shape[1]):
        # B_t = E_t L_prev^{-T}  <=>  L_prev B_t' = E_t'
        Bt = torch.linalg.solve_triangular(L[-1], E[:, t - 1].transpose(1, 2),
                                           upper=False).transpose(1, 2)
        L.append(_cholesky(D[:, t] - torch.bmm(Bt, Bt.transpose(1, 2)) + ridge))
        Bs.append(Bt)
    _count(D, 1 + 3 * len(Bs))
    return BTDFactor(L_diag=torch.stack(L, dim=1), L_off=torch.stack(Bs, dim=1))


def btd_solve(fac: BTDFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M x = rhs given the block-tridiagonal Cholesky factor.

    rhs: (B, nb*b) or (B, nb*b, r). Forward substitution L y = r, then
    backward L' x = y, each nb steps of batched (b, b) triangular solves.
    """
    B, nb, b, _ = fac.L_diag.shape
    squeeze = rhs.dim() == 2
    R = rhs.reshape(B, nb, b, -1)
    Ld, Lo = fac.L_diag, fac.L_off
    Y = [torch.linalg.solve_triangular(Ld[:, 0], R[:, 0], upper=False)]
    for t in range(1, nb):
        Y.append(torch.linalg.solve_triangular(Ld[:, t], R[:, t] - torch.bmm(Lo[:, t - 1], Y[-1]),
                                               upper=False))
    X = [torch.linalg.solve_triangular(Ld[:, -1].transpose(1, 2), Y[-1], upper=True)]
    for t in range(nb - 2, -1, -1):
        X.append(torch.linalg.solve_triangular(
            Ld[:, t].transpose(1, 2), Y[t] - torch.bmm(Lo[:, t].transpose(1, 2), X[-1]),
            upper=True))
    _count(rhs, 4 * nb - 2)
    out = torch.stack(X[::-1], dim=1).reshape(B, nb * b, -1)
    return out[:, :, 0] if squeeze else out


def btd_spd_inverse(M: torch.Tensor, perm, b: int, refine: int = 2) -> torch.Tensor:
    """Dense inverse of a batch (B, n, n) of permuted-block-tridiagonal SPD
    matrices.

    M is in solver order; ``perm`` (length n) maps solver to interleaved
    order. Jacobi scaling as the dense inverse's, the blocked factorization,
    a solve against the identity, ``refine`` guarded Hotelling sweeps
    X <- X + X(I - Mp X), and the permutation undone. The sequential blocked
    Cholesky accumulates float32 error through its Schur-complement steps
    (||MX - I||_inf ~ 13 raw at T=30), which the sweeps remove. A sweep is
    kept only where it lowers that scenario's inf-norm residual: a sweep
    that diverges on one matrix is dropped for that matrix alone, so the
    result is never worse than the raw factorization.
    """
    B, n, _ = M.shape
    perm = torch.as_tensor(np.asarray(perm, dtype=np.int64), device=M.device)
    dj = 1.0 / torch.sqrt(torch.abs(torch.diagonal(M, dim1=1, dim2=2)) + 1e-30)
    Mt = M * dj[:, :, None] * dj[:, None, :]
    Mp = Mt[:, perm][:, :, perm]                     # interleaved coordinates
    fac = btd_cholesky(*_blocks_from_dense(Mp, b))
    npad = fac.L_diag.shape[1] * b
    eye = torch.eye(npad, dtype=M.dtype, device=M.device).expand(B, npad, npad)
    Xp = btd_solve(fac, eye)                          # Mp^{-1}, padded
    Mp_pad = _pad_identity(Mp, b)
    resid = lambda X: torch.amax(torch.abs(torch.bmm(Mp_pad, X) - eye), dim=(1, 2))
    r_cur = resid(Xp)
    for _ in range(refine):
        Xn = Xp + torch.bmm(Xp, eye - torch.bmm(Mp_pad, Xp))
        r_new = resid(Xn)
        keep = r_new < r_cur
        Xp = torch.where(keep[:, None, None], Xn, Xp)
        r_cur = torch.where(keep, r_new, r_cur)
    inv_perm = torch.argsort(perm)
    X = Xp[:, inv_perm][:, :, inv_perm]              # back to solver coordinates
    if M.is_cuda:
        btd_spd_inverse.launches += 1
    return X * dj[:, :, None] * dj[:, None, :]


btd_spd_inverse.launches = 0
btd_spd_inverse.library_calls = 0
