"""One box-eliminating polish candidate solve.

Replaces the TPU kernel ``neupan_tpu/ops/pallas/polish.py:box_candidate``
(``_box_candidate_kernel`` + ``_spd_inv_inline``) with
``neupan_torch/csrc/polish.cu``.

What it computes, per scenario: the masked Hessian Hm (identity row and
column at the pinned coordinates) and its inverse; the dual Schur
complement S = DAn Hm^{-1} DAn' + diag(1 - d) + 1e-6 over the acceleration
rows and its inverse (both inverses Jacobi-scaled with a 1e-7 ridge); one
KKT solve; then ``refine`` reduced-space refinement passes against the
true Hessian (grad = C0 - Hr_true w).

Bound on the H100: the chain of dependent steps, not bytes or operations.
At k=30, na=18, refine=7 one candidate is ~0.2 MFLOP (the two inverses
~66 k, the Schur build ~52 k, each refinement pass ~12 k) against ~10 KB
of input; at B=512 that is ~0.1 GFLOP against ~5 MB, 1.7 us at the card's
float32 peak. The chain: k + na = 48 sweep pivots, two Schur products, and
6 + 7 x 9 = 69 dependent matrix-vector products of 18-30 elements.

Design (``csrc/polish.cu``): one block of 4 warps per scenario, templated on
NC = ceil(max(k, na) / 32) in 1..4, so every shape the wrapper admits
(``polish_fits``: k, na <= 128 within one block's shared memory, which
covers the horizons up to T=33) runs it. Above n=96 the plain version
inverts by Cholesky (``sweep.spd_inverse_any``); the kernel keeps its sweep,
as the TPU kernel does at every n.

* The two inverses: thread (warp w, lane c) holds rows w, w+4, ... of
  columns c, c+32, ... in registers. Pivot j reads row j (= column j) and
  1/pivot from a double-buffered shared row that the owners of row j+1
  filled during pivot j-1: one barrier per pivot (48 at the main shape), a
  branch-free update, no element loop dividing by n. The arithmetic, pivot
  order, Jacobi scale (``1/sqrtf``, not ``rsqrtf``) and 1e-7 ridge are the
  plain version's.
* The Schur build: Hm^{-1} DAn' and S, one output per thread and row, four
  partial sums per output at NC=1 (chains of 8); 2 barriers.
* The KKT solve and the refinement passes: every warp holds every vector in
  its lanes. A product A x splits its sum over j between the 4 warps (x_j
  by shuffle, lane c sums column c), the partials meet in a double-buffered
  shared array behind one barrier, and every warp adds them in the same
  order: 69 barriers at refine=7. A single warp doing the products alone,
  with no barrier, took 2.3x as long per refinement pass. DAn is stored
  with an odd row stride, so reading it by row or by column is free of
  bank conflicts.

No tensor cores: every product is a matrix times one vector, and the port
keeps float32 throughout (TF32 off).
"""

from __future__ import annotations

import torch

from neupan_torch.ops.kernels import _build
from neupan_torch.ops.kernels.sweep import spd_inverse_any, sweep_spd_inverse_plain

MAX_N = 128   # k and na: four 32-column chunks (csrc/polish.cu's NC)


def smem_bytes(k: int, na: int) -> int:
    """Shared memory the kernel takes for (k, na) (``polish_smem_bytes`` in
    ``csrc/polish.cu``)."""
    nc = -(-max(k, na) // 32)
    return 4 * (2 * 4 * 32 * nc + 2 * (32 * nc + 1) + 3 * k * k + 2 * na * (k | 1) + na * na
                + k + na)


def polish_fits(k: int, na: int) -> bool:
    """The admission rule: the kernel takes (k, na) with k, na <= MAX_N while
    ``smem_bytes`` fits one block's shared memory. The wrapper refuses any
    other shape, and the QP (``ops/qp.py``) routes such shapes to
    ``box_candidate_plain``."""
    return max(k, na) <= MAX_N and smem_bytes(k, na) <= _build.SMEM_LIMIT


def _check_inputs(Hr, Hr_true, DAn, C0, g1r, g2n, b_box, fix, d):
    dev = _build.dispatch_device(Hr)
    if DAn.dim() != 3 or DAn.shape[0] < 1:
        raise ValueError(f"DAn must be (B>=1, na, k), got {tuple(DAn.shape)}")
    B, na, k = DAn.shape
    _build.check(Hr, "Hr", (B, k, k), device=dev)
    _build.check(Hr_true, "Hr_true", (B, k, k), device=dev)
    _build.check(DAn, "DAn", (B, na, k), device=dev)
    for name, t in (("C0", C0), ("g1r", g1r), ("b_box", b_box), ("fix", fix)):
        _build.check(t, name, (B, k), device=dev)
    for name, t in (("g2n", g2n), ("d", d)):
        _build.check(t, name, (B, na), device=dev)
    return dev, B, k, na


def _mv(A, v):
    return torch.bmm(A, v[:, :, None])[:, :, 0]


def box_candidate_plain(Hr, Hr_true, DAn, C0, g1r, g2n, b_box, fix, d, *, refine: int):
    """The same function as ``box_candidate`` in plain PyTorch, at any (k, na):
    above 96 its inverses take the Cholesky route
    (``sweep.spd_inverse_any``). Calls on CUDA tensors are counted in
    ``box_candidate_plain.launches``."""
    dev = _check_inputs(Hr, Hr_true, DAn, C0, g1r, g2n, b_box, fix, d)[0]
    if dev.type == "cuda":
        box_candidate_plain.launches += 1
    free = 1.0 - fix
    Hm = Hr * free[:, :, None] * free[:, None, :] + torch.diag_embed(fix)
    Hm_inv = spd_inverse_any(Hm, sweep_spd_inverse_plain)
    DAnT = DAn.transpose(1, 2)
    HD = torch.bmm(DAn, Hm_inv)                              # rows: Hm^{-1} DAn[b]'
    S = torch.bmm(HD, DAnT) + torch.diag_embed((1.0 - d) + 1e-6)
    S_inv = spd_inverse_any(S, sweep_spd_inverse_plain)

    def kkt_solve(r1, r_fix, r2n):
        t = free * (r1 - _mv(Hr, fix * r_fix)) + fix * r_fix
        dw0 = _mv(Hm_inv, t)
        dyn = _mv(S_inv, _mv(DAn, dw0) - r2n)
        v = _mv(Hm_inv, free * _mv(DAnT, dyn))
        return dw0 - v, dyn

    w, yn = kkt_solve(g1r, b_box, g2n)
    for _ in range(refine):
        grad_r = C0 - _mv(Hr_true, w)
        r1 = grad_r - _mv(DAnT, d * yn)
        r_fix = b_box - w
        r2n = g2n - (_mv(DAn, w) + (1.0 - d) * yn)
        dw, dyn = kkt_solve(r1, fix * r_fix, r2n)
        w = w + dw
        yn = yn + dyn
    return w, yn


def box_candidate(Hr: torch.Tensor, Hr_true: torch.Tensor, DAn: torch.Tensor,
                  C0: torch.Tensor, g1r: torch.Tensor, g2n: torch.Tensor,
                  b_box: torch.Tensor, fix: torch.Tensor, d: torch.Tensor, *,
                  refine: int):
    """Batched box-eliminating polish candidate solve.

    Args (float32, batched on axis 0): Hr/Hr_true (B, k, k), DAn (B, na, k),
    C0/g1r/b_box/fix (B, k), g2n/d (B, na).
    Returns (w (B, k), yn (B, na)). Raises, on either device, for a shape
    ``polish_fits`` does not admit.
    """
    dev, B, k, na = _check_inputs(Hr, Hr_true, DAn, C0, g1r, g2n, b_box, fix, d)
    if not polish_fits(k, na):
        raise ValueError(f"box_candidate takes k, na <= {MAX_N} within one block's "
                         f"shared memory, got k={k}, na={na}")
    if dev.type == "cpu":
        return box_candidate_plain(Hr, Hr_true, DAn, C0, g1r, g2n, b_box, fix, d,
                                   refine=refine)
    w, yn = torch.empty_like(C0), torch.empty_like(g2n)
    P_, I_ = _build.PTR, _build.INT
    fn = _build.function("box_candidate_launch", [P_] * 11 + [I_] * 4 + [P_])
    _build.launch(fn, dev, *(_build.ptr(t) for t in (
        Hr, Hr_true, DAn, C0, g1r, g2n, b_box, fix, d, w, yn)), B, k, na, int(refine))
    box_candidate.launches += 1
    return w, yn


box_candidate.launches = 0
box_candidate_plain.launches = 0
