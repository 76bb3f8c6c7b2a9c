"""The hand-written CUDA kernels and the planner step on a card.

Each kernel is held against its plain PyTorch version on the same CUDA
inputs; the planner step on the card against the same step on the CPU
(plain versions), with every kernel launched as often as the step needs.
Every test skips where there is no card. This file imports nothing of JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

The input builders here are shared with tests/test_torch_kernels.py.
"""

import os

import numpy as np
import pytest
import torch

from neupan_torch.ops.kernels import admm as AD
from neupan_torch.ops.kernels import mlp as ML
from neupan_torch.ops.kernels import polish as PO
from neupan_torch.ops.kernels import select as SE
from neupan_torch.ops.kernels import sweep as SW
from neupan_torch.robot import Robot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROBOT = dict(kinematics="diff", max_speed=[8, 1], max_acce=[8, 3], length=1.6, width=2.0)
ADMM_KW = dict(iters=50, sigma=1e-6, alpha=1.6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


# -- inputs, from numpy seeds --------------------------------------------------

def t32(a, device="cpu"):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def select_inputs(B=2, Tp1=5, P=256, seed=0):
    rng = np.random.default_rng(seed)
    robot = Robot.create(receding=Tp1 - 1, step_time=0.1, **ROBOT)
    pts = rng.uniform(-6, 8, (B, 2, P)).astype(np.float32)
    vels = rng.normal(scale=0.3, size=(B, 2, P)).astype(np.float32)
    mask = np.ones((B, P), dtype=bool)
    mask[0, 200:] = False
    theta = rng.uniform(-np.pi, np.pi, (B, Tp1)).astype(np.float32)
    R = np.stack([np.stack([np.cos(theta), -np.sin(theta)], -1),
                  np.stack([np.sin(theta), np.cos(theta)], -1)], -2).astype(np.float32)
    trans = rng.uniform(-1, 1, (B, Tp1, 2)).astype(np.float32)
    geom = [robot.vertices.astype(np.float32), robot.G.astype(np.float32),
            robot.h.astype(np.float32)]
    return pts, vels, mask, R, trans, robot.dt, geom


def sweep_inputs(B, n, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, n, n))
    M = Q @ np.swapaxes(Q, 1, 2) / n + np.eye(n)[None]
    dj = 1 / np.sqrt(np.abs(np.einsum("bii->bi", M)))
    return M * dj[:, :, None] * dj[:, None, :] + 1e-7 * np.eye(n)[None]


def admm_inputs(B=16, m=148, k=30, seed=0):
    """The shapes of tests/test_pallas.py's fused-ADMM test, with the normal
    matrix inverse the phase loop would hand the kernel."""
    rng = np.random.default_rng(seed)
    Hs = rng.normal(size=(B, k, k))
    Hs = Hs @ np.swapaxes(Hs, 1, 2) / k + np.eye(k)
    As = rng.normal(size=(B, m, k)) * 0.3
    qs = rng.normal(size=(B, k))
    ls = rng.normal(size=(B, m)) - 1
    us = ls + np.abs(rng.normal(size=(B, m))) + 0.5
    soft = np.where(rng.uniform(size=(B, m)) < 0.5, 10.0, 0.0)
    us = np.where(soft > 0, 1e20, us)
    rho = np.repeat(rng.uniform(0.5, 2.0, (B, 1)), m, axis=1)   # one rho per scenario
    M = Hs + 1e-6 * np.eye(k) + np.einsum("bmi,bm,bmj->bij", As, rho, As)
    Minv = np.linalg.inv(M)
    w0 = rng.normal(size=(B, k)) * 0.1
    z0 = np.clip(np.einsum("bmk,bk->bm", As, w0), ls, us)
    y0 = rng.normal(size=(B, m)) * 0.1
    return [np.asarray(a, np.float32) for a in (Minv, As, qs, ls, us, soft, rho, w0, z0, y0)]


def polish_inputs(B=9, k=30, na=18, seed=0):
    """The shapes of tests/test_pallas.py's fused box-candidate test."""
    rng = np.random.default_rng(seed)
    Qm = rng.normal(size=(B, k, k))
    Hr = Qm @ np.swapaxes(Qm, 1, 2) / k + np.eye(k)
    Hr_ref = Hr - 1e-6 * np.eye(k)
    DAn = rng.normal(size=(B, na, k)) * 0.3
    d = (rng.uniform(size=(B, na)) < 0.6).astype(np.float64)
    DAn = DAn / np.maximum(np.linalg.norm(DAn, axis=2, keepdims=True), 1e-8) * d[:, :, None]
    C0 = rng.normal(size=(B, k))
    g1r = rng.normal(size=(B, k))
    g2n = rng.normal(size=(B, na)) * d
    fix = (rng.uniform(size=(B, k)) < 0.4).astype(np.float64)
    b_box = rng.normal(size=(B, k)) * fix
    return [np.asarray(a, np.float32) for a in (Hr, Hr_ref, DAn, C0, g1r, g2n, b_box, fix, d)]


# -- CUDA kernels vs their plain versions ----------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("B,P", [(3, 2048), (1, 100)])     # the flagship's and the facade's
def test_select_kernel_matches_plain(cuda, B, P):
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs(B=B, Tp1=11, P=P, seed=3)
    args = [torch.from_numpy(a).to(cuda) for a in (pts, vels, mask, R, trans)]
    geo = [torch.from_numpy(a).to(cuda) for a in (V, G, h)]
    n0 = SE.select_topk_flow.launches
    keys, idx = SE.select_topk_flow(*args, dt, *geo, 10)
    keys_p, idx_p = SE.select_topk_flow_plain(*args, dt, *geo, 10)
    torch.cuda.synchronize()
    assert SE.select_topk_flow.launches == n0 + 1
    assert torch.equal(idx, idx_p)
    torch.testing.assert_close(keys, keys_p, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [100, 256, 257, 2047, 2048, 2049, 5000])
@pytest.mark.parametrize("case", ["fewer than K", "all masked", "half masked"])
def test_select_kernels_keep_the_refill_rule(cuda, P, case):
    """Both kernels, at P on either side of each key layout (one key per
    thread up to 256, eight up to 2048, shared memory) and P no multiple
    of 32: with fewer than
    K unmasked points the trailing slots repeat the lowest-index 1e9 point,
    an earlier winner included, exactly as the plain version's argmin
    passes; indices and keys identical."""
    B, Tp1, K = 3, 11, 10
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs(B=B, Tp1=Tp1, P=P, seed=P)
    rng = np.random.default_rng(P + 1)
    mask[:] = True
    if case == "fewer than K":
        mask[0] = False
        mask[0, rng.choice(P, 4, replace=False)] = True     # 4 < K unmasked points
        mask[1] = False                                      # one scenario all masked
    elif case == "all masked":
        mask[:] = False
    else:
        mask[:, rng.uniform(size=P) < 0.5] = False
    args = [torch.from_numpy(a).to(cuda) for a in (pts, vels, mask, R, trans)]
    geo = [torch.from_numpy(a).to(cuda) for a in (V, G, h)]
    tf = SE.flow_tables(args[3], args[4], dt, *geo)[0]
    flow = torch.stack(SE.flow_from_tables(args[0], args[1], tf), dim=2).contiguous()
    out = {"flow": SE.select_topk_flow(*args, dt, *geo, K),
           "flow_plain": SE.select_topk_flow_plain(*args, dt, *geo, K),
           "frame": SE.select_topk(flow, args[2], *geo, K),
           "frame_plain": SE.select_topk_plain(flow, args[2], *geo, K)}
    torch.cuda.synchronize()
    keys, idx = out["flow_plain"]
    for name, (k, i) in out.items():
        assert torch.equal(i, idx), name
        assert torch.equal(k, keys), name
    if case != "half masked":
        assert bool((keys[1] == 1e9).all()) and bool((idx[1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("P", [100, 2047])
@pytest.mark.parametrize("B,Tp1", [(400, 11), (1100, 4), (2200, 1)])
def test_select_flow_kernel_ranks_two_frames_per_block_at_a_large_batch(cuda, B, Tp1, P):
    """From about two waves of blocks on, the flow kernel ranks two frames
    per block (a ragged last block at odd T+1, one frame of a pair at
    T+1=1); some scenarios have fewer than K unmasked points, one none."""
    K = 10
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs(B=B, Tp1=Tp1, P=P, seed=B + P)
    rng = np.random.default_rng(Tp1)
    mask[:] = rng.uniform(size=mask.shape) < 0.9
    mask[:7] &= (np.arange(P) % 97 == 3)[None]
    mask[7] = False
    args = [torch.from_numpy(a).to(cuda) for a in (pts, vels, mask, R, trans)]
    geo = [torch.from_numpy(a).to(cuda) for a in (V, G, h)]
    keys, idx = SE.select_topk_flow(*args, dt, *geo, K)
    keys_p, idx_p = SE.select_topk_flow_plain(*args, dt, *geo, K)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_p) and torch.equal(keys, keys_p)
    assert bool((idx[7] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("V", [3, 6])
def test_select_kernels_take_any_polygon(cuda, V):
    """The generic instance (polygon tables through the read-only cache)
    for polygons other than the four-sided ones."""
    from neupan_torch.utils import gen_inequal_from_vertex

    ang = np.linspace(0, 2 * np.pi, V, endpoint=False) + 0.3
    verts = np.stack([1.2 * np.cos(ang), 0.8 * np.sin(ang)]).astype(np.float32)
    G, h = (np.asarray(a, np.float32) for a in gen_inequal_from_vertex(verts))
    pts, vels, mask, R, trans, dt, _ = select_inputs(B=2, Tp1=5, P=700, seed=V)
    args = [torch.from_numpy(a).to(cuda) for a in (pts, vels, mask, R, trans)]
    geo = [torch.from_numpy(a).to(cuda) for a in (verts, G, h)]
    keys, idx = SE.select_topk_flow(*args, dt, *geo, 10)
    keys_p, idx_p = SE.select_topk_flow_plain(*args, dt, *geo, 10)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_p) and torch.equal(keys, keys_p)


@pytest.mark.gpu
def test_select_kernel_on_a_materialized_flow_matches_plain_and_the_flow_kernel(cuda):
    """The same frames through both selection kernels: identical indices."""
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs(B=3, Tp1=11, P=2048, seed=4)
    pts, vels, mask, R, trans = (torch.from_numpy(a).to(cuda) for a in (pts, vels, mask, R, trans))
    geo = [torch.from_numpy(a).to(cuda) for a in (V, G, h)]
    tf = SE.flow_tables(R, trans, dt, *geo)[0]
    flow = torch.stack(SE.flow_from_tables(pts, vels, tf), dim=2).contiguous()
    n0 = SE.select_topk.launches
    keys, idx = SE.select_topk(flow, mask, *geo, 10)
    keys_p, idx_p = SE.select_topk_plain(flow, mask, *geo, 10)
    keys_f, idx_f = SE.select_topk_flow(pts, vels, mask, R, trans, dt, *geo, 10)
    torch.cuda.synchronize()
    assert SE.select_topk.launches == n0 + 1
    assert torch.equal(idx, idx_p) and torch.equal(idx, idx_f)
    torch.testing.assert_close(keys, keys_p, rtol=0, atol=0)
    torch.testing.assert_close(keys, keys_f, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["diff_robot_default", "acker_robot_default",
                                   "polygon_robot"])
@pytest.mark.parametrize("N", [1, 77, 300, 56320, 1000003])
def test_mlp_kernel_matches_plain_and_the_module(cuda, model, N):
    """The ragged end included (N is no multiple of the block).

    In a million points a few leave a LayerNorm 32 nearly equal activations,
    where it amplifies float32 rounding to about 1e-5 in any evaluation
    order, so how far a float32 evaluation sits from float64 grows with the
    number of points: for the acker checkpoint on points uniform in
    [-10, 10]^2 the kernel reads 7.5e-6 at 1,000,003 points and 1.3e-5 at
    8,000,000 (scripts/exp_mlp_float32_noise.py, H100). The absolute 1e-5
    against float64 below therefore holds for the sizes of this test and
    not beyond about a million points. The bound that holds at any size is
    the relative one: the kernel is no further from float64 than twice the
    plain version or the nn.Sequential route, which are float32 evaluations
    themselves, and within 1e-5 of each of them once their own distance
    from float64 is allowed for."""
    from neupan_torch.models import load_checkpoint

    enc = load_checkpoint(os.path.join(ROOT, "examples/model", model, "model.npz"), cuda)
    rng = np.random.default_rng(N)
    pts = t32(rng.uniform(-10, 10, (N, 2)), cuda)
    n0 = ML.dune_mlp.launches
    with torch.no_grad():
        out = ML.dune_mlp(enc, pts)
        packed = ML.pack_weights(enc)
        ref = ML.dune_mlp_plain(packed, pts, out.shape[-1])
        ref64 = ML.dune_mlp_plain(packed.double(), pts.double(), out.shape[-1])
        mod = enc(pts)
    torch.cuda.synchronize()
    assert ML.dune_mlp.launches == n0 + 1
    err = lambda a, b: float((a.double() - b.double()).abs().max())
    errs = dict(kernel_f64=err(out, ref64), plain_f64=err(ref, ref64), module_f64=err(mod, ref64),
                kernel_plain=err(out, ref), kernel_module=err(out, mod))
    assert errs["kernel_f64"] <= 1e-5, errs
    assert errs["kernel_f64"] <= 1e-6 + 2.0 * max(errs["plain_f64"], errs["module_f64"]), errs
    assert errs["kernel_plain"] <= 1e-5 + errs["plain_f64"], errs
    assert errs["kernel_module"] <= 1e-5 + errs["module_f64"], errs


@pytest.mark.gpu
@pytest.mark.parametrize("E", [1, 3, 5, 8])
def test_mlp_kernel_takes_other_head_widths(cuda, E):
    """A polygon with E edges gives the head E columns; only E=4 stores 16 bytes at once."""
    from neupan_torch.models import ObsPointNet

    enc = ObsPointNet.seeded(2, E, seed=E, device=cuda)
    pts = t32(np.random.default_rng(E).uniform(-6, 6, (5, 1001, 2)), cuda)
    with torch.no_grad():
        out = ML.dune_mlp(enc, pts)
        ref = ML.dune_mlp_plain(ML.pack_weights(enc), pts, E)
    torch.cuda.synchronize()
    assert out.shape == (5, 1001, E)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_mlp_kernel_refuses_a_gradient_and_a_foreign_encoder(cuda):
    """No backward pass: points or encoder parameters that require a
    gradient while one is recorded raise instead of losing it."""
    from neupan_torch.models import load_checkpoint

    ckpt = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")
    pts = torch.zeros((4, 2), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ML.dune_mlp(load_checkpoint(ckpt, cuda), pts)
    with pytest.raises(ValueError, match="encoder is on"):
        ML.dune_mlp(load_checkpoint(ckpt, "cpu"), pts.detach())
    enc = load_checkpoint(ckpt, cuda)                 # its parameters require a gradient
    n0 = ML.dune_mlp.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ML.dune_mlp(enc, pts.detach())
    with torch.no_grad():
        ML.dune_mlp(enc, pts.detach())
    enc.requires_grad_(False)
    out = ML.dune_mlp(enc, pts.detach())
    torch.cuda.synchronize()
    assert ML.dune_mlp.launches == n0 + 2 and out.grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("N", [15, 16, 17, 127, 128, 129, 4095, 4097, 33791, 33793])
def test_mlp_kernel_at_tile_block_and_wave_boundaries(cuda, N):
    """A warp carries 16 points, a block of 8 warps 128; 33,792 points fill
    one wave of two blocks on each of 132 SMs, one more sends a warp round
    its grid-stride loop again. The ragged end and the second pass agree
    with the plain version on the same card."""
    from neupan_torch.models import load_checkpoint

    enc = load_checkpoint(os.path.join(ROOT, "examples/model/diff_robot_default/model.npz"), cuda)
    pts = t32(np.random.default_rng(N).uniform(-10, 10, (N, 2)), cuda)
    with torch.no_grad():
        out = ML.dune_mlp(enc, pts)
        packed = ML.pack_weights(enc)
        ref = ML.dune_mlp_plain(packed, pts, 4)
        ref64 = ML.dune_mlp_plain(packed.double(), pts.double(), 4)
    torch.cuda.synchronize()
    plain_f64 = float((ref.double() - ref64).abs().max())
    assert float((out.double() - ref64).abs().max()) <= 1e-5
    assert float((out - ref).abs().max()) <= 1e-5 + plain_f64


@pytest.mark.gpu
def test_mlp_kernel_through_a_strided_caller(cuda):
    """The DUNE paths hand the kernel a transposed view of the point flow;
    the wrapper refuses it as it is, and the paths' copy gives the kernel's
    answer on a contiguous tensor."""
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.dune import _run_encoder

    enc = load_checkpoint(os.path.join(ROOT, "examples/model/diff_robot_default/model.npz"), cuda)
    pf = t32(np.random.default_rng(3).uniform(-8, 8, (3, 5, 2, 10)), cuda)
    view = pf.transpose(2, 3)
    assert not view.is_contiguous()
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            ML.dune_mlp(enc, view)
        n0 = ML.dune_mlp.launches
        out = _run_encoder(enc, view, True)
        direct = ML.dune_mlp(enc, view.contiguous())
        ref = ML.dune_mlp_plain(ML.pack_weights(enc), view, 4)
    torch.cuda.synchronize()
    assert ML.dune_mlp.launches == n0 + 2 and out.shape == (3, 5, 10, 4)
    assert torch.equal(out, direct)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_mlp_kernel_refuses_misaligned_points(cuda):
    """The kernel reads a point as one 8-byte word: a contiguous view at an
    odd float offset must raise in the wrapper, not fault on the card."""
    from neupan_torch.models import load_checkpoint

    enc = load_checkpoint(os.path.join(ROOT, "examples/model/diff_robot_default/model.npz"), cuda)
    buf = torch.zeros(2 * 64 + 1, device=cuda)
    odd = buf[1:].view(-1, 2)
    assert odd.is_contiguous() and odd.data_ptr() % 8 == 4
    n0 = ML.dune_mlp.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="8-byte"):
            ML.dune_mlp(enc, odd)
        out = ML.dune_mlp(enc, odd.clone())          # and the card still answers
    torch.cuda.synchronize()
    assert ML.dune_mlp.launches == n0 + 1 and bool(torch.isfinite(out).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,n", [(1, 30), (5, 33), (3, 90), (2, 96),
                                 (4, 48), (4, 63)])      # generic polish's S, full-space M
def test_sweep_kernel_matches_plain(cuda, B, n):
    Mt = t32(sweep_inputs(B, n), cuda)
    X, Xp = SW.sweep_spd_inverse(Mt), SW.sweep_spd_inverse_plain(Mt)
    torch.cuda.synchronize()
    assert float((X - Xp).abs().max() / Xp.abs().max()) < 3e-5


def unscaled_spd(B, n, seed=0):
    """SPD matrices whose diagonal spans four decades, as the QP's are
    before the Jacobi scaling."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, n, n))
    s = 10.0 ** rng.uniform(-2, 2, (B, n, 1))
    M = s * (Q @ np.swapaxes(Q, 1, 2) / n + np.eye(n)[None]) * np.swapaxes(s, 1, 2)
    return (M + np.swapaxes(M, 1, 2)) / 2


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 30, 32, 33, 64, 65, 90, 96])   # each layout and its edges
@pytest.mark.parametrize("B", [1, 513])                            # one matrix; more than a wave
def test_sweep_kernel_at_every_layout_boundary(cuda, B, n):
    """The unscaled kernel against its plain version, and the scaled one
    (spd_inverse_scaled, what the QP launches) against the plain version of
    the fused call; both keep the plain versions' arithmetic, so they agree
    to rounding noise, one launch each."""
    Mt = t32(sweep_inputs(B, n, seed=n), cuda)
    M = t32(unscaled_spd(B, n, seed=n), cuda)
    n0 = SW.sweep_spd_inverse.launches
    X, Xs = SW.sweep_spd_inverse(Mt), SW.spd_inverse_scaled(M)
    torch.cuda.synchronize()
    assert SW.sweep_spd_inverse.launches == n0 + 2
    Xp, Xsp = SW.sweep_spd_inverse_plain(Mt), SW.spd_inverse_scaled(M, SW.sweep_spd_inverse_plain)
    assert float((X - Xp).abs().max() / Xp.abs().max()) < 3e-5
    assert float(((Xs - Xsp).abs() / Xsp.abs().amax(dim=(1, 2), keepdim=True)).max()) < 3e-5


@pytest.mark.gpu
def test_sweep_scaled_kernel_takes_a_strided_input(cuda):
    """The QP hands spd_inverse_scaled products that may be transposed views."""
    M = t32(unscaled_spd(4, 30), cuda).transpose(1, 2)
    assert not M.is_contiguous()
    X = SW.spd_inverse_scaled(M)
    Xp = SW.spd_inverse_scaled(M, SW.sweep_spd_inverse_plain)
    torch.cuda.synchronize()
    assert float((X - Xp).abs().max() / Xp.abs().max()) < 3e-5


@pytest.mark.gpu
@pytest.mark.parametrize("B,k,m", [(1, 30, 148), (16, 30, 148), (513, 30, 148),  # main path
                                   (4, 20, 38),                               # the K=0 step
                                   (2, 90, 451),                              # T=30
                                   (16, 63, 181), (512, 63, 181)])            # full space
def test_admm_kernel_matches_plain(cuda, B, k, m):
    """Every instance of the kernel: registers (k <= 32, m <= 256) and shared
    memory (T=30's operator, 212 KB); one scenario and more than one wave."""
    args = [t32(a, cuda) for a in admm_inputs(B=B, m=m, k=k)]
    n0 = AD.admm_iterate.launches
    out, ref = AD.admm_iterate(*args, **ADMM_KW), AD.admm_iterate_plain(*args, **ADMM_KW)
    torch.cuda.synchronize()
    assert AD.admm_iterate.launches == n0 + 1
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(out[1], ref[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(out[2], ref[2], rtol=1e-2, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,k,na,case", [(1, 30, 18, "random"), (9, 30, 18, "random"),
                                         (513, 30, 18, "random"),   # main path, > one wave
                                         (4, 20, 18, "random"),     # the K=0 step
                                         (2, 90, 58, "random"),     # T=30
                                         (2, 99, 64, "random"),     # T=33, four chunks
                                         (2, 128, 10, "random"),    # the largest k
                                         (265, 90, 58, "random"),   # > two waves at one block an SM
                                         (3, 30, 18, "all fixed"), (3, 30, 18, "d zero"),
                                         (2, 90, 58, "all fixed"), (2, 90, 58, "d zero"),
                                         (2, 99, 64, "all fixed"), (2, 99, 64, "d zero")])
def test_polish_kernel_matches_plain(cuda, B, k, na, case):
    """"all fixed": every coordinate pinned (fix = 1, the TPU wrapper's
    padded lanes), so Hm is the identity; "d zero": no active acc row, so
    DAn = 0 and S = (1 + 1e-6) I."""
    args = polish_inputs(B=B, k=k, na=na)
    if case == "all fixed":
        args[7] = np.ones_like(args[7])
        args[6] = np.random.default_rng(1).normal(size=args[6].shape).astype(np.float32)
    elif case == "d zero":
        args[8], args[2], args[5] = (np.zeros_like(args[i]) for i in (8, 2, 5))
    args = [t32(a, cuda) for a in args]
    n0 = PO.box_candidate.launches
    out = PO.box_candidate(*args, refine=7)
    ref = PO.box_candidate_plain(*args, refine=7)
    torch.cuda.synchronize()
    assert PO.box_candidate.launches == n0 + 1
    for o, r in zip(out, ref):
        assert float((o - r).abs().max() / r.abs().max().clamp(min=1e-9)) < 2e-4


@pytest.mark.gpu
def test_polish_kernel_rows_are_independent_and_repeat(cuda):
    """A (265, 90, 58) launch, more than two waves at one block an SM: a
    second launch repeats it and each row equals a launch of that scenario
    alone, bit for bit (no atomics, every sum in a fixed order). 12 warps
    serve (90, 58), 4 serve (30, 18)."""
    args = [t32(a, cuda) for a in polish_inputs(B=265, k=90, na=58, seed=2)]
    by_warps = PO.box_candidate.launches_by_warps
    n4, n12 = by_warps[4], by_warps[12]
    w, yn = PO.box_candidate(*args, refine=7)
    w2, yn2 = PO.box_candidate(*args, refine=7)
    assert torch.equal(w, w2) and torch.equal(yn, yn2)
    for b in range(265):
        wb, ynb = PO.box_candidate(*(a[b:b + 1] for a in args), refine=7)
        assert torch.equal(wb[0], w[b]) and torch.equal(ynb[0], yn[b]), b
    assert (by_warps[4], by_warps[12]) == (n4, n12 + 267)
    PO.box_candidate(*(t32(a, cuda) for a in polish_inputs(B=3, k=30, na=18)), refine=7)
    torch.cuda.synchronize()
    assert (by_warps[4], by_warps[12]) == (n4 + 1, n12 + 267)


@pytest.mark.gpu
@pytest.mark.parametrize("select,use_kernel,counts", [("exact", True, [1, 1]), ("mlp", True, [0, 1]),
                                                      ("exact", False, [0, 0])])
def test_dune_forward_on_the_card_matches_cpu(cuda, select, use_kernel, counts):
    """The materialized DUNE paths: the card launches the kernels the
    switches name and agrees with the CPU on one point flow."""
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.dune import dune_forward, generate_point_flow

    pts, vels, mask, _, _, dt, _ = select_inputs(B=3, Tp1=5, P=256, seed=5)
    robot = Robot.create(receding=4, step_time=dt, **ROBOT)
    rng = np.random.default_rng(6)
    nom_s = t32(rng.uniform(-0.5, 0.5, (3, 3, 5)))
    ckpt = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")
    with torch.no_grad():
        pf, R, pg = generate_point_flow(nom_s.to(cuda), t32(pts, cuda), t32(vels, cuda), dt)
        before = [SE.select_topk.launches, ML.dune_mlp.launches]
        out = dune_forward(load_checkpoint(ckpt, cuda), *robot.tensors(cuda)[1:], pf, R, pg,
                           torch.from_numpy(mask).to(cuda), 6, use_kernel=use_kernel,
                           select=select, vertices=robot.tensors(cuda)[0])
        torch.cuda.synchronize()
        assert [SE.select_topk.launches - before[0], ML.dune_mlp.launches - before[1]] == counts
        ref = dune_forward(load_checkpoint(ckpt, "cpu"), *robot.tensors("cpu")[1:], pf.cpu(),
                           R.cpu(), pg.cpu(), torch.from_numpy(mask), 6, use_kernel=use_kernel,
                           select=select, vertices=robot.tensors("cpu")[0])
    assert torch.equal(out.valid_k.cpu(), ref.valid_k)
    torch.testing.assert_close(out.dist_k.cpu(), ref.dist_k, rtol=0, atol=1e-5)
    torch.testing.assert_close(out.mu_k.cpu().sum(-1), ref.mu_k.sum(-1), rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["corridor", "pf"])
def test_facade_plans_on_the_card_by_default(cuda, config):
    """Three ticks on the card (a batch of one; with "pf" the K=0 step and
    the tracking QP's sizes) against a CPU planner fed the same inputs."""
    from neupan_torch import NeuPan

    path = os.path.join(ROOT, "examples", config, "diff", "planner.yaml")
    planner, on_cpu = NeuPan.init_from_yaml(path), NeuPan.init_from_yaml(path, device="cpu")
    assert planner.G.is_cuda
    state = np.array(planner.ipath.waypoints[0][:3], dtype=np.float64).reshape(3, 1)
    wall = state[:2] + np.array([[5.0, 7.0, 3.0], [2.4, -2.2, 2.1]])
    for _ in range(3):
        action, info = planner(state, wall)
        action_c, _ = on_cpu(state, wall)
        assert info["state_tensor"].is_cuda and np.isfinite(action).all()
        assert (info["distance_tensor"] is None) == (config == "pf")
        np.testing.assert_allclose(action, action_c, rtol=0, atol=5e-4)
        assert abs(planner.min_distance - on_cpu.min_distance) <= 1e-4
        v, w, th = action[0, 0], action[1, 0], state[2, 0]
        state = state + planner.dt * np.array([[v * np.cos(th)], [v * np.sin(th)], [w]])


@pytest.mark.gpu
def test_step_on_the_card_matches_cpu_and_launches_every_kernel(cuda):
    """The planner-step golden's first call, on the card and on the CPU."""
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
    from neupan_torch.ops.pan import PANSpec
    from neupan_torch.parallel import batched_init_state, batched_planner_step

    with np.load(os.path.join(ROOT, "tests", "golden", "torch", "planner_step.npz")) as g:
        g = {k: torch.from_numpy(g[k]) for k in g.files}
    T, P, K, B = (int(g[k]) for k in "TPKB")
    robot = Robot.create(receding=T, step_time=0.1, **ROBOT)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P)
    ckpt = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")
    args = [g[k] for k in ("nom_s", "nom_u", "ref_s", "ref_us", "pts1", "vels1", "mask1")]
    adjust = AdjustParams(*(torch.tensor(v) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))
    ref = batched_planner_step(spec, load_checkpoint(ckpt, "cpu"), *robot.tensors("cpu"),
                               adjust, *args, batched_init_state(spec, B, "cpu"))
    wrappers = (SE.select_topk_flow, SW.sweep_spd_inverse, AD.admm_iterate, PO.box_candidate,
                ML.dune_mlp)
    before = [w.launches for w in wrappers]
    out = batched_planner_step(spec, load_checkpoint(ckpt, cuda), *robot.tensors(cuda),
                               AdjustParams(*(t.to(cuda) for t in adjust)),
                               *(a.to(cuda) for a in args), batched_init_state(spec, B, cuda))
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, before)] == [2, 6, 4, 10, 2]
    assert float((out.opt_u.cpu() - ref.opt_u).abs().max()) <= 5e-4
    assert torch.equal(out.nrmp_valid.cpu(), ref.nrmp_valid)


@pytest.mark.gpu
@pytest.mark.parametrize("iter_num", [1, 2])
def test_differentiated_step_on_the_card_matches_cpu(cuda, iter_num):
    """LON's differentiated step (the planner-step golden's first call, the
    near branch of the distance loss forced): loss and grads w.r.t.
    AdjustParams on the card within 1e-3 (relative to the largest grad) of
    the CPU's; the forward launches the selection and QP kernels and not the
    fused MLP, which has no backward."""
    from neupan_torch.lon import step_loss_and_grad
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
    from neupan_torch.ops.pan import PANSpec
    from neupan_torch.parallel import batched_init_state

    with np.load(os.path.join(ROOT, "tests", "golden", "torch", "planner_step.npz")) as g:
        g = {k: torch.from_numpy(g[k]) for k in g.files}
    T, P, K, B = (int(g[k]) for k in "TPKB")
    robot = Robot.create(receding=T, step_time=0.1, **ROBOT)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P, iter_num=iter_num)
    ckpt = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")
    args = [g[k] for k in ("nom_s", "nom_u", "ref_s", "ref_us", "pts1", "vels1", "mask1")]
    adjust = AdjustParams(*(torch.tensor(v) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))

    def run(dev):
        return step_loss_and_grad(spec, load_checkpoint(ckpt, dev), *robot.tensors(dev),
                                  AdjustParams(*(t.to(dev) for t in adjust)),
                                  *(a.to(dev) for a in args), batched_init_state(spec, B, dev),
                                  collision_threshold=10.0)

    loss_c, grads_c, _ = run("cpu")
    wrappers = (SE.select_topk_flow, SW.sweep_spd_inverse, AD.admm_iterate, PO.box_candidate,
                ML.dune_mlp)
    before = [w.launches for w in wrappers]
    loss, grads, out = run(cuda)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, before)] == [
        iter_num, 3 * iter_num, 2 * iter_num, 5 * iter_num, 0]
    assert out.opt_u.is_cuda and not out.opt_u.requires_grad
    torch.testing.assert_close(loss.cpu(), loss_c, rtol=1e-3, atol=0)
    scale = max(float(t.abs().max()) for t in grads_c)
    for f, a, b in zip(AdjustParams._fields, grads, grads_c):
        assert a.is_cuda
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * scale, f


@pytest.mark.gpu
@pytest.mark.parametrize("T,K", [(30, 12), (33, 10)])
def test_long_horizon_step_on_the_card_takes_the_admitted_routes(cuda, T, K):
    """A batched step where the kernels do not admit every shape (T=30 with
    K=12: the ADMM operator; T=33: the inverses above n=96 and the ADMM
    operator, while the polish kernel takes k=99): each QP stage takes the
    kernel or its plain route as ops/qp.py's admission checks say, and
    opt_u agrees with the CPU within chip_smoke.py's long-horizon bounds."""
    import chip_smoke
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
    from neupan_torch.ops.pan import PANSpec
    from neupan_torch.parallel import batched_init_state, batched_planner_step
    from scripts.make_torch_goldens import step_inputs

    B, P = 8, 128
    robot = Robot.create(receding=T, step_time=0.1, **ROBOT)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P)
    inp = {k: torch.from_numpy(v) for k, v in step_inputs(3, T, P, K, B).items()}
    args = [inp[k] for k in ("nom_s", "nom_u", "ref_s", "ref_us", "pts1", "vels1", "mask1")]
    adjust = AdjustParams(*(torch.tensor(v) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))
    ckpt = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")
    ref = batched_planner_step(spec, load_checkpoint(ckpt, "cpu"), *robot.tensors("cpu"),
                               adjust, *args, batched_init_state(spec, B, "cpu"))
    k, m, na, n_eq = 3 * T, nrmp.m - nrmp.r_acc, nrmp.r_spd - nrmp.r_acc, nrmp.r_acc
    counters = {"sweep": SW.sweep_spd_inverse, "cholesky": SW.cholesky_inverse,
                "admm": AD.admm_iterate, "admm_plain": AD.admm_iterate_plain,
                "polish": PO.box_candidate, "polish_plain": PO.box_candidate_plain}
    before = {name: c.launches for name, c in counters.items()}
    out = batched_planner_step(spec, load_checkpoint(ckpt, cuda), *robot.tensors(cuda),
                               AdjustParams(*(t.to(cuda) for t in adjust)),
                               *(a.to(cuda) for a in args), batched_init_state(spec, B, cuda))
    torch.cuda.synchronize()
    small = (n_eq <= SW.MAX_N) + 2 * (k <= SW.MAX_N)
    admm_k, polish_k = 2 * AD.admm_fits(k, m), 5 * PO.polish_fits(k, na)
    # a plain polish candidate inverts Hm (k) and S (na) itself, by Cholesky above 96
    polish_plain = 2 * (5 - polish_k)
    want = {"sweep": 2 * small,
            "cholesky": 2 * (3 - small) + polish_plain * ((k > SW.MAX_N) + (na > SW.MAX_N)),
            "admm": 2 * admm_k, "admm_plain": 2 * (2 - admm_k), "polish": 2 * polish_k,
            "polish_plain": polish_plain}
    assert {name: c.launches - before[name] for name, c in counters.items()} == want
    assert want["admm_plain"] == 4 and want["polish"] == 10
    assert T == 30 or (want["cholesky"], polish_plain) == (6, 0)
    # chip_smoke.py's long-horizon bounds, where they are argued
    d = (out.opt_u.cpu() - ref.opt_u).abs().amax(dim=(1, 2))
    print(f"T={T} K={K}: opt_u card vs CPU max {float(d.max())}, median {float(d.median())}, "
          f"above 5e-4 {int((d > 5e-4).sum())} of {B}")
    assert float(d.median()) <= chip_smoke.LONG_HORIZON_MEDIAN
    assert float(d.max()) <= chip_smoke.LONG_HORIZON_MAX
    assert int((d > 5e-4).sum()) <= chip_smoke.LONG_HORIZON_ABOVE


@pytest.mark.gpu
def test_corridor_ticks_through_the_sim_on_the_card(cuda):
    """examples/corridor/diff in the port's Sim2D: three closed-loop ticks
    planned on the card, each against a CPU planner given the same state,
    scan points and carried state."""
    from neupan_torch import NeuPan
    from neupan_torch.ops.pan import PANState
    from neupan_torch.sim.env_loader import load_env

    base = os.path.join(ROOT, "examples", "corridor", "diff")
    planner = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"))
    on_cpu = NeuPan.init_from_yaml(os.path.join(base, "planner.yaml"), device="cpu")
    env = load_env(os.path.join(base, "env.yaml"), planner.robot)
    for _ in range(3):
        state = env.get_robot_state()
        pts = planner.scan_to_point(state, env.get_lidar_scan())
        on_cpu.pan_state = PANState(*(t.cpu() for t in planner.pan_state))
        on_cpu.cur_vel_array = planner.cur_vel_array.copy()
        action, info = planner(state, pts)
        action_c, _ = on_cpu(state, pts)
        assert info["state_tensor"].is_cuda and pts.shape[1] > 10
        np.testing.assert_allclose(action, action_c, rtol=0, atol=5e-4)
        assert abs(planner.min_distance - on_cpu.min_distance) <= 1e-4
        env.step(action)
    assert not env.collided and env.steps == 3


# -- DUNE training on the card ---------------------------------------------------

def _dune_data(dev, n=6000, seed=0):
    """Seeded points in [-25, 25]^2 with their labels (on the CPU, moved)."""
    from neupan_torch.training import polygon_distance_labels

    robot = Robot.create(receding=10, step_time=0.1, **ROBOT)
    G, h = (t32(a) for a in (robot.G, robot.h))
    pts = t32(np.random.default_rng(seed).uniform(-25, 25, (n, 2)))
    mu, d = polygon_distance_labels(G, h, pts)
    return [a.to(dev) for a in (G, h, pts, mu, d)]


@pytest.mark.gpu
def test_dune_labels_on_the_card_match_cpu(cuda):
    """d to 1e-5 (1 + d); the same active faces on every point; mu to 1e-5."""
    from neupan_torch.training.labels import polygon_labels

    G, h, pts, mu_c, d_c = _dune_data("cpu", n=100000, seed=1)
    _, _, act_c = polygon_labels(G, h, pts)
    mu, d, act = (a.cpu() for a in polygon_labels(G.to(cuda), h.to(cuda), pts.to(cuda)))
    assert bool(((d - d_c).abs() <= 1e-5 * (1 + d_c)).all())
    assert torch.equal(act, act_c)
    torch.testing.assert_close(mu, mu_c, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_twenty_training_steps_on_the_card_match_cpu(cuda):
    """20 adam_l2 updates at batch 256, lr 5e-5, from the same init on the
    same permutation and rotations: loss terms to 1e-4 relative; weights
    within 1e-3 lr x steps (1e-6), at most 1% beyond, all within 0.1 lr x
    steps (chip_smoke.py's train path states the same bound for an epoch)."""
    from neupan_torch.models import ObsPointNet, to_jax_params
    from neupan_torch.training.dune_train import run_epoch
    from neupan_torch.training.optim import Adam, exponential_decay

    rng = np.random.default_rng(2)
    perm = torch.as_tensor(rng.permutation(6000)[:20 * 256])
    thetas = t32(rng.uniform(0, 2 * np.pi, 20))
    out = {}
    for dev in ("cpu", cuda):
        G, h, pts, mu, d = _dune_data(dev)
        net = ObsPointNet.seeded(2, 4, seed=0, device=dev)
        opt = Adam(list(net.parameters()), exponential_decay(5e-5, 1500 * 20, 0.5))
        terms = run_epoch(net, opt, (pts, mu, d), perm.to(dev), thetas.to(dev), G, h)
        out[str(dev)] = (terms.cpu(), to_jax_params(net))
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=0)
    scale = 5e-5 * 20
    diff = np.concatenate([np.abs(out["cuda"][1][k] - out["cpu"][1][k]).ravel()
                           for k in out["cpu"][1]])
    assert (diff > 1e-3 * scale).sum() <= 0.01 * diff.size and diff.max() <= 0.1 * scale


@pytest.mark.gpu
def test_fused_mlp_kernel_on_freshly_trained_weights(cuda, tmp_path):
    """After two short epochs on the card the kernel (repacked: the
    parameters' versions moved) equals the module to 1e-5, and
    DuneTrainer.test runs it."""
    from neupan_torch.models import ObsPointNet
    from neupan_torch.training import DuneTrainer

    robot = Robot.create(receding=10, step_time=0.1, **ROBOT)
    trainer = DuneTrainer(robot.G, robot.h, str(tmp_path))
    enc = ObsPointNet.seeded(2, 4, seed=0, device=cuda)
    pts = t32(np.random.default_rng(3).uniform(-25, 25, (50000, 2)), cuda)
    with torch.no_grad():
        before = ML.dune_mlp(enc, pts)
    trainer.start(enc, data_size=5000, epoch=1, batch_size=256, lr=1e-3)
    n0 = ML.dune_mlp.launches
    with torch.no_grad():
        out, ref = ML.dune_mlp(enc, pts), enc(pts)
    torch.cuda.synchronize()
    assert ML.dune_mlp.launches == n0 + 1
    assert float((out - ref).abs().max()) <= 1e-5
    assert float((out - before).abs().max()) > 1e-3
    res = trainer.test(enc, data_size_list=(1000,))
    assert res[0]["kernel_vs_module_max_abs"] <= 1e-5 and res[0]["device"].startswith("cuda")


@pytest.mark.gpu
def test_train_dune_then_a_facade_tick_runs_the_trained_weights(cuda, tmp_path):
    """NeuPan.train_dune on the card, then one tick: the tick launches the
    fused MLP kernel, and its duals on the tick's points are the trained
    module's (to 1e-5), not the seeded init's."""
    import copy

    import neupan_torch.ops.dune as D
    from neupan_torch import NeuPan

    yaml_file = os.path.join(ROOT, "examples", "dune_train", "dune_train_diff.yaml")
    planner = NeuPan.init_from_yaml(yaml_file, ipath={"waypoints": [[0, 0, 0], [20, 0, 0]]})
    seeded = copy.deepcopy(planner.encoder)
    planner.train_dune(epoch=1, data_size=5000, lr=1e-3, checkpoint_dir=str(tmp_path))
    seen = []
    mlp = ML.dune_mlp

    def spy(encoder, points):
        seen.append(points.detach().clone())
        return mlp(encoder, points)

    n0 = mlp.launches
    D.dune_mlp, saved = spy, D.dune_mlp
    try:
        action, _ = planner(np.zeros((3, 1)), np.array([[3.0, 4.0, 5.0], [0.5, -0.5, 1.0]]))
    finally:
        D.dune_mlp = saved
    torch.cuda.synchronize()
    assert mlp.launches > n0 and seen and np.isfinite(action).all()
    with torch.no_grad():
        for pts in seen:
            got = mlp(planner.encoder, pts)
            assert float((got - planner.encoder(pts)).abs().max()) <= 1e-5
            assert float((got - seeded(pts)).abs().max()) > 1e-4


# -- the solver paths off the main path --------------------------------------------

def _solver_step(T, K, B, admm, seed=3):
    """A batched planner step at horizon T under ``admm``: (spec, inputs,
    encoder checkpoint, weights), from step_inputs' numpy seed."""
    from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
    from neupan_torch.ops.pan import PANSpec
    from scripts.make_torch_goldens import step_inputs

    P = 128
    robot = Robot.create(receding=T, step_time=0.1, **ROBOT)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P, admm=admm)
    inp = {k: torch.from_numpy(v) for k, v in step_inputs(seed, T, P, K, B).items()}
    args = [inp[k] for k in ("nom_s", "nom_u", "ref_s", "ref_us", "pts1", "vels1", "mask1")]
    adjust = AdjustParams(*(torch.tensor(v) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))
    return spec, robot, args, adjust, os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")


def _run_step(spec, robot, args, adjust, ckpt, dev, sl=slice(None)):
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.nrmp import AdjustParams
    from neupan_torch.parallel import batched_init_state, batched_planner_step

    args = [a[sl].to(dev) for a in args]
    return batched_planner_step(spec, load_checkpoint(ckpt, dev), *robot.tensors(dev),
                                AdjustParams(*(t.to(dev) for t in adjust)), *args,
                                batched_init_state(spec, args[0].shape[0], dev))


def _route_counters():
    import chip_smoke

    return {**chip_smoke.wrappers(), **chip_smoke.twins()}


def _noise_gated(setup, out, n):
    """chip_smoke.py's noise_gate on the first n scenarios: opt_u card vs CPU
    against the CPU's own under a 1e-6 change of ref_s."""
    import chip_smoke

    ref = _run_step(*setup, "cpu", sl=slice(0, n))
    args = list(setup[2])
    args[2] = args[2] * (1.0 + 1e-6)
    noisy = _run_step(*setup[:2], args, *setup[3:], "cpu", sl=slice(0, n))
    per = lambda a, b: (a.opt_u[:n].cpu() - b.opt_u).abs().amax(dim=(1, 2))
    return chip_smoke.noise_gate("step", per(out, ref), per(noisy, ref))


@pytest.mark.gpu
def test_fullspace_step_at_b512_matches_cpu(cuda):
    """ADMMConfig(condense_admm=False) at the flagship shapes, B=512: the
    full-space ADMM runs its (63, 181) iterations in the admm kernel and its
    normal matrix through the sweep. The planner's output moves far more
    than 5e-4 under float32 rounding on this path, so opt_u card vs CPU on
    32 scenarios is held to the CPU's own spread (chip_smoke.py:noise_gate)."""
    from neupan_torch.ops.qp import ADMMConfig

    setup = _solver_step(10, 10, 512, ADMMConfig(condense_admm=False))
    counters = _route_counters()
    before = {k: c.launches for k, c in counters.items()}
    out = _run_step(*setup, cuda)
    torch.cuda.synchronize()
    got = {k: c.launches - before[k] for k, c in counters.items()}
    assert got == {"select": 2, "select_topk": 0, "mlp": 2, "sweep": 6, "admm": 4, "polish": 10,
                   "admm_plain": 0, "polish_plain": 0, "cholesky": 0, "banded": 0}
    assert bool(torch.isfinite(out.opt_u).all())
    _noise_gated(setup, out, 32)


@pytest.mark.gpu
def test_banded_t30_step_matches_cpu(cuda):
    """ADMMConfig(condense_admm=False, inverse="banded") at T=30, B=16: the
    normal matrix through the block-tridiagonal route (library calls), the
    (183, 541) iterations on the plain version; opt_u card vs CPU held to
    the CPU's own spread (chip_smoke.py:noise_gate)."""
    import chip_smoke
    from neupan_torch.ops.pan import _admm_with_elim
    from neupan_torch.ops.qp import ADMMConfig

    setup = _solver_step(30, 10, 16, ADMMConfig(condense_admm=False, inverse="banded"))
    counters = _route_counters()
    before = {k: c.launches for k, c in counters.items()}
    out = _run_step(*setup, cuda)
    torch.cuda.synchronize()
    got = {k: c.launches - before[k] for k, c in counters.items()}
    want = chip_smoke.qp_routes(setup[0].nrmp, _admm_with_elim(setup[0]), 2)
    assert want["banded"] == 4 and want["admm_plain"] == 4
    assert got == {"select": 2, "select_topk": 0, "mlp": 2, **want}
    assert bool(torch.isfinite(out.opt_u).all())
    _noise_gated(setup, out, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("polish", [True, False])
def test_solve_qp_batch_on_the_card_matches_cpu(cuda, soft, polish):
    """solve_qp_batch on tests/test_qp.py's generic QPs (chip_smoke.py's
    generic_qps), B=64: x within 5e-4 of the CPU's, the full-space phases
    and polish candidates through the sweep and admm kernels."""
    import chip_smoke
    from neupan_torch.ops.qp import ADMMConfig, solve_qp_batch

    qp = chip_smoke.generic_qps(torch, 64, 5, soft)
    cfg = ADMMConfig(iters=200, polish=polish)
    ref = solve_qp_batch(qp, cfg)
    n0, a0 = SW.sweep_spd_inverse.launches, AD.admm_iterate.launches
    sol = solve_qp_batch(type(qp)(*(None if t is None else t.to(cuda) for t in qp)), cfg)
    torch.cuda.synchronize()
    assert SW.sweep_spd_inverse.launches - n0 == 2 + (10 if polish else 0)
    assert AD.admm_iterate.launches - a0 == 2
    assert float((sol.x.cpu() - ref.x).abs().max()) <= 5e-4


# -- the scenario mesh, precision="default" and profile_trace on the card ----------

def _golden_step(dev, **spec_kw):
    """The planner-step golden's first call (B=4) as arguments on ``dev``."""
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
    from neupan_torch.ops.pan import PANSpec
    from neupan_torch.parallel import batched_init_state

    with np.load(os.path.join(ROOT, "tests", "golden", "torch", "planner_step.npz")) as g:
        g = {k: torch.from_numpy(g[k]) for k in g.files}
    T, P, K, B = (int(g[k]) for k in "TPKB")
    robot = Robot.create(receding=T, step_time=0.1, **ROBOT)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, dune_max_num=P, **spec_kw)
    enc = load_checkpoint(os.path.join(ROOT, "examples/model/diff_robot_default/model.npz"), dev)
    adjust = AdjustParams(*(torch.tensor(v, device=dev) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))
    args = [g[k].to(dev) for k in ("nom_s", "nom_u", "ref_s", "ref_us", "pts1", "vels1", "mask1")]
    return spec, enc, robot.tensors(dev), adjust, args, batched_init_state(spec, B, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_step_on_one_card_matches_the_batched_step(cuda, shards):
    """Mesh((cuda,) * shards): each kernel launches ``shards`` times as often
    as in the batched step; each shard equals the batched step on its own
    scenarios; opt_u and min_distance equal the batched step's on one
    shard, at tests/test_parallel.py's bound on four; the outputs stay
    split."""
    from neupan_torch.parallel import Mesh, batched_planner_step, gather, sharded_planner_step

    spec, enc, geom, adjust, args, state = _golden_step(cuda)
    ref = batched_planner_step(spec, enc, *geom, adjust, *args, state)
    wrappers = (SE.select_topk_flow, SW.sweep_spd_inverse, AD.admm_iterate, PO.box_candidate,
                ML.dune_mlp)
    before = [w.launches for w in wrappers]
    out = sharded_planner_step(spec, Mesh((cuda,) * shards), enc, *geom, adjust, *args, state)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, before)] == [shards * c for c in
                                                                  (2, 6, 4, 10, 2)]
    assert len(out.opt_u) == shards and len(out.state.x_warm) == shards
    for q in range(shards):      # each shard is the batched step on its own scenarios
        b = len(args[0]) // shards
        part = batched_planner_step(spec, enc, *geom, adjust, *(a[q * b:(q + 1) * b] for a in args),
                                    type(state)(*(v[q * b:(q + 1) * b] for v in state)))
        assert torch.equal(out.opt_u.shards[q], part.opt_u)
        assert torch.equal(out.state.y_warm.shards[q], part.state.y_warm)
    got = gather(out)
    for name in ("opt_u", "min_distance"):
        a, b = getattr(got, name), getattr(ref, name)
        if shards == 1:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_make_mesh_takes_every_card(cuda):
    from neupan_torch.parallel import make_mesh

    mesh = make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    with pytest.raises(ValueError, match="present"):
        make_mesh(torch.cuda.device_count() + 1)


@pytest.mark.gpu
def test_precision_default_turns_tf32_on_outside_the_qp_only(cuda, monkeypatch):
    """A "default" step allows TF32 in its assembly (a matmul there differs
    from the exact one), not in the QP's solve, and leaves the flag off."""
    import neupan_torch.ops.pan as PAN
    import neupan_torch.ops.qp as QP
    from neupan_torch.parallel import batched_planner_step

    flags = torch.backends.cuda.matmul
    a = torch.randn((512, 512), device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    exact, seen = a @ a, []
    build_qp, solve = PAN.build_qp, QP._solve

    def spy_build(*x, **k):
        seen.append(("qp", flags.allow_tf32, bool(torch.equal(a @ a, exact))))
        return build_qp(*x, **k)

    def spy_solve(*x, **k):
        seen.append(("solve", flags.allow_tf32, None))
        return solve(*x, **k)

    monkeypatch.setattr(PAN, "build_qp", spy_build)
    monkeypatch.setattr(QP, "_solve", spy_solve)
    spec, enc, geom, adjust, args, state = _golden_step(cuda, precision="default")
    out = batched_planner_step(spec, enc, *geom, adjust, *args, state)
    assert flags.allow_tf32 is False and bool(torch.isfinite(out.opt_u).all())
    assert {s for s in seen if s[0] == "qp"} == {("qp", True, False)}
    assert {s for s in seen if s[0] == "solve"} == {("solve", False, None)}


@pytest.mark.gpu
def test_profile_trace_of_a_card_step_names_the_hand_kernels(cuda, tmp_path):
    import json

    from neupan_torch.parallel import batched_planner_step
    from neupan_torch.utils import profile_trace

    spec, enc, geom, adjust, args, state = _golden_step(cuda)
    with profile_trace(str(tmp_path)) as where:
        batched_planner_step(spec, enc, *geom, adjust, *args, state)
    (name,) = [f for f in os.listdir(where) if f.endswith(".pt.trace.json")]
    with open(os.path.join(where, name)) as fh:
        kernels = {e["name"] for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"}
    for entry in ("select_flow_kernel", "dune_mlp_kernel", "box_candidate_kernel"):
        assert any(entry in k for k in kernels), entry
    assert any("admm_" in k for k in kernels) and any("sweep_" in k for k in kernels)


@pytest.mark.gpu
def test_data_parallel_update_on_four_shards_of_the_card(cuda):
    """chip_smoke.py's data-parallel DUNE update, batch 256 over four shards
    of card 0, against the update on the whole batch: gradients to 1e-5 of
    the largest, weights to 1e-3 of lr on all but 1%, 0.1 of lr on all."""
    import chip_smoke
    from neupan_torch.models import ObsPointNet
    from neupan_torch.parallel import Mesh
    from neupan_torch.training.dune_train import _loss_terms, rotation
    from neupan_torch.training.optim import Adam, exponential_decay

    G, h, pts, mu, d = _dune_data(cuda, n=256)
    R = rotation(torch.tensor(0.7, device=cuda))
    nets = [ObsPointNet.seeded(2, 4, seed=0, device=cuda) for _ in range(2)]
    opts = [Adam(list(n.parameters()), exponential_decay(5e-5, 0, 1.0)) for n in nets]
    params = list(nets[0].parameters())
    ref = torch.autograd.grad(sum(_loss_terms(nets[0], pts, mu, d, G, h, R)), params)
    opts[0].step(params, ref)
    got = chip_smoke.data_parallel_update(torch, nets[1], opts[1], Mesh((cuda,) * 4),
                                          (pts, mu, d), G, h, R)
    scale = max(float(g.abs().max()) for g in ref)
    assert max(float((a - b).abs().max()) for a, b in zip(got, ref)) <= 1e-5 * scale
    diff = torch.cat([(a - b).detach().abs().flatten()
                      for a, b in zip(nets[0].parameters(), nets[1].parameters())])
    assert int((diff > 1e-3 * 5e-5).sum()) <= 0.01 * diff.numel() and float(diff.max()) <= 5e-6
