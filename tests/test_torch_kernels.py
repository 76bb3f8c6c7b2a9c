"""The port's six kernels: plain versions vs the JAX Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel it replaces, run in interpret mode
as tests/test_pallas.py runs it. The CUDA kernels are held against their
plain versions in tests/test_torch_gpu.py, on a card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neupan_tpu.models import obs_point_net as jnet
from neupan_tpu.ops.pallas.admm import admm_iterate as j_admm
from neupan_tpu.ops.pallas.mlp import dune_mlp_pallas as j_mlp
from neupan_tpu.ops.pallas.polish import box_candidate as j_box
from neupan_tpu.ops.pallas.select import select_topk_flow_pallas as j_select
from neupan_tpu.ops.pallas.select import select_topk_pallas as j_select_flowless
from neupan_torch.models import ObsPointNet
from neupan_torch.ops.kernels import admm as AD
from neupan_torch.ops.kernels import mlp as ML
from neupan_torch.ops.kernels import polish as PO
from neupan_torch.ops.kernels import select as SE
from neupan_torch.ops.kernels import sweep as SW
from tests.test_torch_gpu import (ADMM_KW, admm_inputs, polish_inputs, select_inputs,
                                  sweep_inputs, t32, unscaled_spd)


# -- plain versions vs the Pallas kernels (CPU) ---------------------------------

def test_select_plain_matches_pallas_interpret():
    """Identical indices (ties to the lower index) at T+1=5, P=256, K=6,
    with a mask that leaves fewer valid points than a full frame."""
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs()
    K = 6
    keys, idx = SE.select_topk_flow(torch.from_numpy(pts), torch.from_numpy(vels),
                                    torch.from_numpy(mask), torch.from_numpy(R),
                                    torch.from_numpy(trans), dt, torch.from_numpy(V),
                                    torch.from_numpy(G), torch.from_numpy(h), K)
    for b in range(pts.shape[0]):
        kj, ij = j_select(jnp.asarray(pts[b]), jnp.asarray(vels[b]), jnp.asarray(mask[b]),
                          jnp.asarray(R[b]), jnp.asarray(trans[b]), dt, jnp.asarray(V),
                          jnp.asarray(G), jnp.asarray(h), K, interpret=True)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ij))
        np.testing.assert_allclose(keys[b].numpy(), np.asarray(kj), rtol=1e-6, atol=1e-6)
    assert idx.dtype == torch.int32 and keys.shape == (2, 5, K)


def test_select_masked_slots_repeat_the_reference_tie_rule():
    """With fewer valid points than K the trailing slots carry the 1e9 key
    and the lowest-index 1e9 point, as the reference's argmin passes do."""
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs(B=1)
    mask[:] = False
    mask[0, [5, 9]] = True
    keys, idx = SE.select_topk_flow(*(torch.from_numpy(a) for a in (pts, vels, mask, R, trans)),
                                    dt, *(torch.from_numpy(a) for a in (V, G, h)), 4)
    kj, ij = j_select(*(jnp.asarray(a[0]) for a in (pts, vels, mask, R, trans)), dt,
                      *(jnp.asarray(a) for a in (V, G, h)), 4, interpret=True)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ij))
    assert (keys[0, :, :2] < 5e8).all() and (keys[0, :, 2:] == 1e9).all()


def _flow_inputs(Tp1, P, n_valid, length=1.6, width=2.0, span=8.0, seed=0, B=2):
    """A materialized point flow as tests/test_pallas.py draws it, batched."""
    from neupan_torch.robot import Robot

    robot = Robot.create(receding=Tp1 - 1, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=length, width=width)
    rng = np.random.default_rng(seed)
    pf = rng.uniform(-span, span, (B, Tp1, 2, P)).astype(np.float32)
    mask = np.broadcast_to(np.arange(P) < n_valid, (B, P)).copy()
    geom = [np.asarray(a, np.float32) for a in (robot.vertices, robot.G, robot.h)]
    return pf, mask, geom


@pytest.mark.parametrize("Tp1,P,n_valid,K,kw", [
    (5, 256, 200, 6, {}),                                   # tests/test_pallas.py:33-59
    (3, 128, 3, 5, dict(length=1.0, width=1.0, span=5.0, seed=1)),   # :62-79, masked slots
])
def test_select_topk_plain_matches_pallas_interpret(Tp1, P, n_valid, K, kw):
    """The materialized-flow selection: identical indices and keys to the
    Pallas kernel in interpret mode; masked slots carry the 1e9 key and the
    lowest-index masked point."""
    pf, mask, (V, G, h) = _flow_inputs(Tp1, P, n_valid, **kw)
    keys, idx = SE.select_topk(*(torch.from_numpy(a) for a in (pf, mask, V, G, h)), K)
    assert idx.dtype == torch.int32 and keys.shape == (pf.shape[0], Tp1, K)
    for b in range(pf.shape[0]):
        kj, ij = j_select_flowless(jnp.asarray(pf[b]), jnp.asarray(mask[b]), jnp.asarray(V),
                                   jnp.asarray(G), jnp.asarray(h), K, interpret=True)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ij))
        np.testing.assert_allclose(keys[b].numpy(), np.asarray(kj), rtol=1e-6, atol=1e-6)
    valid = keys.numpy() < 5e8
    assert valid[:, :, :min(n_valid, K)].all() and not valid[:, :, n_valid:].any()
    assert (np.diff(keys.numpy(), axis=-1) >= 0).all()


def test_both_selections_pick_the_same_points_from_the_same_frames():
    """select_topk on the flow that select_topk_flow builds in registers."""
    pts, vels, mask, R, trans, dt, geom = select_inputs()
    t = [torch.from_numpy(a) for a in (pts, vels, mask, R, trans)]
    geo = [torch.from_numpy(a) for a in geom]
    keys_f, idx_f = SE.select_topk_flow(*t, dt, *geo, 6)
    tf = SE.flow_tables(t[3], t[4], dt, *geo)[0]
    flow = torch.stack(SE.flow_from_tables(t[0], t[1], tf), dim=2).contiguous()
    keys, idx = SE.select_topk(flow, t[2], *geo, 6)
    assert torch.equal(idx, idx_f) and torch.equal(keys, keys_f)


CKPTS = ["diff_robot_default", "acker_robot_default", "polygon_robot"]


@pytest.mark.parametrize("model", CKPTS)
@pytest.mark.parametrize("N,tile", [(300, 128), (77, 64)])
def test_mlp_plain_matches_pallas_interpret_and_the_jax_forward(model, N, tile):
    """The three shipped checkpoints through from_jax_params, at N=300 and
    the ragged N=77 of tests/test_pallas.py:12-30. rtol 1e-5, atol 1e-5:
    float32 noise through three LayerNorms sits above atol 1e-6."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = jnet.load_checkpoint(os.path.join(root, "examples/model", model, "model.npz"))
    enc = ObsPointNet.from_jax_params({k: np.asarray(v) for k, v in params.items()}, "cpu")
    pts = np.random.default_rng(N).uniform(-5, 5, (N, 2)).astype(np.float32)
    n0 = ML.dune_mlp.launches
    with torch.no_grad():
        out = ML.dune_mlp(enc, torch.from_numpy(pts))
        mod = enc(torch.from_numpy(pts))
    assert ML.dune_mlp.launches == n0 and out.shape == (N, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_mlp(params, jnp.asarray(pts), tile=tile,
                                                             interpret=True)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.forward(params, jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), mod.numpy(), rtol=1e-5, atol=1e-5)


def test_mlp_packed_weights_follow_the_module():
    """Packed once and kept; repacked after an update in place, after new
    parameters and for another head width; leading axes are kept."""
    enc = ObsPointNet.seeded(2, 5, seed=3, device="cpu")
    packed = ML.pack_weights(enc)
    assert packed.shape == (ML.PACKED_SIZE,) and ML.pack_weights(enc) is packed
    pts = torch.from_numpy(np.random.default_rng(0).uniform(-4, 4, (3, 7, 2)).astype(np.float32))
    with torch.no_grad():
        out = ML.dune_mlp(enc, pts)
        assert out.shape == (3, 7, 5)
        torch.testing.assert_close(out, enc(pts), rtol=1e-5, atol=1e-5)
        enc.MLP[13].bias.add_(1.0)
        assert ML.pack_weights(enc) is not packed
        torch.testing.assert_close(ML.dune_mlp(enc, pts), enc(pts), rtol=1e-5, atol=1e-5)
    enc.load_state_dict(ObsPointNet.seeded(2, 5, seed=4, device="cpu").state_dict())
    with torch.no_grad():
        torch.testing.assert_close(ML.dune_mlp(enc, pts), enc(pts), rtol=1e-5, atol=1e-5)
    # gradients reach the points through the plain version on the CPU
    p = pts.clone().requires_grad_(True)
    ML.dune_mlp(enc, p).sum().backward()
    assert p.grad is not None and bool(p.grad.abs().sum() > 0)


def test_mlp_plain_carries_the_weight_gradients_on_the_cpu():
    """With gradients recorded the plain route reads the live parameters, so
    every weight's gradient equals the module's; under no_grad it reads the
    packed buffer."""
    enc = ObsPointNet.seeded(2, 4, seed=5, device="cpu")
    pts = torch.from_numpy(np.random.default_rng(5).uniform(-6, 6, (257, 2)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(6).normal(size=(257, 4)).astype(np.float32))
    (ML.dune_mlp(enc, pts) * w).sum().backward()
    got = {n: p.grad.clone() for n, p in enc.named_parameters()}
    enc.zero_grad()
    (enc(pts) * w).sum().backward()
    for n, p in enc.named_parameters():
        assert float(p.grad.abs().max()) > 0, n
        torch.testing.assert_close(got[n], p.grad, rtol=1e-5, atol=1e-5, msg=n)
    with torch.no_grad():
        assert ML.dune_mlp(enc, pts).grad_fn is None
    assert ML.dune_mlp(enc, pts).grad_fn is not None


def test_mlp_packed_split_weights_sum_to_the_weights_and_the_plain_version_ignores_them():
    """The kernel's section: w0, biases and LayerNorm parameters as they are,
    then every product's weights as TF32 high and low parts (13 low bits
    zero) in B-fragment order, hi + lo within 2^-23 of the float32 weight.
    The plain version reads the plain section only."""
    enc = ObsPointNet.seeded(2, 3, seed=7, device="cpu")
    packed = ML.pack_weights(enc)
    kern = packed[ML.PLAIN_SIZE:]
    assert packed.numel() == ML.PLAIN_SIZE + ML.KERNEL_SIZE and kern.numel() == 9128
    small = 2 * 32 + 11 * 32 + 8
    blocks = ML._plain_blocks(enc)
    torch.testing.assert_close(kern[:64], blocks["w0"].reshape(-1), rtol=0, atol=0)
    torch.testing.assert_close(kern[416:419], blocks["b5"][:3], rtol=0, atol=0)
    frags, off = kern[small:], 0
    for i, nt in zip(range(1, 6), (4, 4, 4, 4, 1)):
        f = frags[off:off + 4 * nt * 32 * 4].reshape(4, nt, 8, 4, 4)     # kk, j, g, t, slot
        off += f.numel()
        assert not bool((f.contiguous().view(torch.int32) & 0x1FFF).any())
        # lane (g, t) of k-step kk, n-tile j holds rows 8kk + 2t (+1) of column 8j + g
        hi = f[..., :2].permute(0, 3, 4, 1, 2).reshape(32, 8 * nt).double()
        lo = f[..., 2:].permute(0, 3, 4, 1, 2).reshape(32, 8 * nt).double()
        w = blocks[f"w{i}"].double()
        assert bool(((hi + lo - w).abs() <= 2.0 ** -23 * w.abs()).all()), i
    pts = torch.from_numpy(np.random.default_rng(7).uniform(-6, 6, (100, 2)).astype(np.float32))
    spoiled = packed.clone()
    spoiled[ML.PLAIN_SIZE:] = float("nan")
    torch.testing.assert_close(ML.dune_mlp_plain(spoiled, pts, 3), ML.dune_mlp_plain(packed, pts, 3),
                               rtol=0, atol=0)


_LANE = torch.arange(32)
_QG, _QT = _LANE // 4, _LANE % 4          # lane 4g + t


def _toward_zero(x64):
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _emulate_mlp_kernel(packed, pts, E):
    """csrc/mlp.cu's arithmetic on the CPU, fragment by fragment, 16 points
    a tile: the kernel's section of the packed weights read by the lane
    mapping of mma.sync m16n8k8 TF32 (B fragment b0 = B[t][g], b1 = B[t+4][g];
    A fragment A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4] taken from the
    previous accumulator's registers 0, 2, 1, 3; accumulator D[g][2t],
    D[g][2t+1], D[g+8][2t], D[g+8][2t+1]); activations split into TF32 high
    and low parts by bit masking; each mma's sum exact, then rounded toward
    zero; the hi*hi tiles of the layers before a ReLU and of the head added
    to the accumulator rounding to nearest, those before a LayerNorm carried
    in it."""
    kern = packed[ML.PLAIN_SIZE:]
    vec = lambda k, n=32: kern[k:k + n]
    w0, b0 = vec(0, 64).reshape(2, 32), vec(64)
    ln = [(vec(96), vec(128)), (vec(224), vec(256)), (vec(352), vec(384))]
    bias = [vec(160), vec(192), vec(288), vec(320), vec(416, 8)]
    frags, off = [], 424
    for nt in (4, 4, 4, 4, 1):
        frags.append(kern[off:off + 4 * nt * 32 * 4].reshape(4, nt, 32, 4))
        off += 4 * nt * 32 * 4
    N = pts.shape[0]
    tiles = -(-N // 16)
    p = torch.zeros(tiles * 16, 2)
    p[:N] = pts
    p = p.reshape(tiles, 16, 2)

    def a_matrix(regs):                     # (tiles, lane, 4) -> (tiles, 16, 8)
        A = regs.new_zeros(tiles, 16, 8)
        A[:, _QG, _QT], A[:, _QG + 8, _QT], A[:, _QG, _QT + 4], A[:, _QG + 8, _QT + 4] = \
            regs.unbind(-1)
        return A.double()

    def b_matrix(b0_, b1_):
        B = b0_.new_zeros(8, 8)
        B[_QT, _QG], B[_QT + 4, _QG] = b0_, b1_
        return B.double()

    def c_registers(D):                     # (tiles, 16, 8) -> (tiles, lane, 4)
        return torch.stack([D[:, _QG, 2 * _QT], D[:, _QG, 2 * _QT + 1],
                            D[:, _QG + 8, 2 * _QT], D[:, _QG + 8, 2 * _QT + 1]], -1)

    def dense(X, frag, b, nearest):         # X (tiles, lane, 4 blocks, 4 registers)
        nt = frag.shape[1]
        y = torch.zeros(tiles, 16, 8 * nt) + b
        cross = torch.zeros(tiles, 16, 8 * nt)
        for kk in range(4):
            regs = X[:, :, kk][:, :, [0, 2, 1, 3]]
            hi = ML.tf32_round(regs)
            Ah, Al = a_matrix(hi), a_matrix(ML.tf32_round(regs - hi))
            for j in range(nt):
                Bh, Bl = b_matrix(frag[kk, j, :, 0], frag[kk, j, :, 1]), \
                    b_matrix(frag[kk, j, :, 2], frag[kk, j, :, 3])
                sl = slice(8 * j, 8 * j + 8)
                cross[:, :, sl] = _toward_zero(cross[:, :, sl].double() + Al @ Bh)
                cross[:, :, sl] = _toward_zero(cross[:, :, sl].double() + Ah @ Bl)
                if nearest:
                    y[:, :, sl] = y[:, :, sl] + _toward_zero(Ah @ Bh)
                else:
                    y[:, :, sl] = _toward_zero(y[:, :, sl].double() + Ah @ Bh)
        D = y + cross
        return torch.stack([c_registers(D[:, :, 8 * j:8 * j + 8]) for j in range(nt)], 2)

    def ln_tanh(X, scale, shift):           # a row's 32 features: 8 per lane, 4 lanes
        X = X.clone()
        feat = 8 * torch.arange(4)[None, :, None] + 2 * _QT[:, None, None] + torch.arange(2)
        for r in range(2):
            v = X[..., 2 * r:2 * r + 2]
            quad = lambda s: s.reshape(tiles, 8, 4).sum(2, keepdim=True).expand(-1, -1, 4) \
                .reshape(tiles, 32)
            mean = quad(v.sum((2, 3))) / 32
            d = v - mean[:, :, None, None]
            inv = torch.rsqrt(quad((d * d).sum((2, 3))) / 32 + 1e-5)
            X[..., 2 * r:2 * r + 2] = torch.tanh(d * inv[:, :, None, None] * scale[feat]
                                                 + shift[feat])
        return X

    X = torch.empty(tiles, 32, 4, 4)
    for j in range(4):
        for r in range(2):
            for q in range(2):
                f = 8 * j + 2 * _QT + q
                x, y = p[:, _QG + 8 * r, 0], p[:, _QG + 8 * r, 1]
                X[:, :, j, 2 * r + q] = (b0[f] + x * w0[0, f]) + y * w0[1, f]
    X = ln_tanh(X, *ln[0])
    X = torch.relu(dense(X, frags[0], bias[0], True))
    X = ln_tanh(dense(X, frags[1], bias[1], False), *ln[1])
    X = torch.relu(dense(X, frags[2], bias[2], True))
    X = ln_tanh(dense(X, frags[3], bias[3], False), *ln[2])
    Y = torch.relu(dense(X, frags[4], bias[4], True))[:, :, 0]
    out = torch.empty(tiles, 16, 8)
    out[:, _QG, 2 * _QT], out[:, _QG, 2 * _QT + 1], out[:, _QG + 8, 2 * _QT], \
        out[:, _QG + 8, 2 * _QT + 1] = Y.unbind(-1)
    return out.reshape(-1, 8)[:N, :E]


@pytest.mark.parametrize("model", CKPTS)
def test_mlp_kernel_arithmetic_emulated_matches_float64(model):
    """The tensor-core design checked before the card: 10^5 points of each
    shipped checkpoint through the emulation of its fragments, TF32 splits
    and roundings are within the card tests' 1e-5 of float64, as close as
    the plain float32 version is give or take 1e-6, and a wrong fragment
    mapping would not be (the mapping read with b0 and b1 swapped)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from neupan_torch.models import load_checkpoint

    enc = load_checkpoint(os.path.join(root, "examples/model", model, "model.npz"), "cpu")
    pts = torch.from_numpy(np.random.default_rng(11).uniform(-10, 10, (100_000, 2))
                           .astype(np.float32))
    with torch.no_grad():
        packed = ML.pack_weights(enc)
        ref = ML.dune_mlp_plain(packed.double(), pts.double(), 4)
        emu = float((_emulate_mlp_kernel(packed, pts, 4).double() - ref).abs().max())
        plain = float((ML.dune_mlp_plain(packed, pts, 4).double() - ref).abs().max())
        swapped = packed.clone()
        frag = swapped[ML.PLAIN_SIZE + 424:].view(-1, 4)
        frag[:, [0, 1, 2, 3]] = frag[:, [1, 0, 3, 2]].clone()
        wrong = float((_emulate_mlp_kernel(swapped, pts[:2000], 4).double() - ref[:2000]).abs().max())
    assert emu <= 1e-5 and emu <= plain + 1e-6, (emu, plain)
    assert wrong > 1e-2


@pytest.mark.parametrize("B,n", [(4, 30), (130, 18), (7, 33)])
def test_sweep_plain_matches_f64_inverse(B, n):
    Mt = sweep_inputs(B, n)
    X = SW.sweep_spd_inverse(t32(Mt)).numpy()
    X64 = np.linalg.inv(Mt)
    rel = np.abs(X - X64).max() / np.abs(X64).max()
    assert rel < 3e-5, rel


@pytest.mark.parametrize("n", [1, 30, 33, 90])
def test_spd_inverse_scaled_on_the_cpu_is_its_plain_version(n):
    """On a card spd_inverse_scaled folds the scaling, ridge and unscaling
    into one sweep launch; on the CPU it runs them around the plain sweep,
    which is the fused call's plain version: the same numbers, no launch,
    and a strided input taken as it is. Against float64 the error is
    measured as |X - X64| / sqrt(X64_rr X64_cc), free of the diagonal's
    four decades of scale."""
    M = t32(unscaled_spd(3, n, seed=n))
    n0 = SW.sweep_spd_inverse.launches
    X = SW.spd_inverse_scaled(M)
    assert SW.sweep_spd_inverse.launches == n0
    torch.testing.assert_close(X, SW.spd_inverse_scaled(M, SW.sweep_spd_inverse_plain),
                               rtol=0, atol=0)
    Mt = M.transpose(1, 2)                       # the same matrices, symmetric
    torch.testing.assert_close(SW.spd_inverse_scaled(Mt), SW.spd_inverse_scaled(Mt.contiguous()),
                               rtol=0, atol=0)
    X64 = np.linalg.inv(M.double().numpy())
    d = np.sqrt(np.abs(np.einsum("bii->bi", X64)))
    assert (np.abs(X.double().numpy() - X64) / (d[:, :, None] * d[:, None, :])).max() < 3e-5


def test_admm_plain_matches_pallas_interpret():
    """w, z to f32 tightness; y to the level set by 50 iterations of
    reordered float32 accumulation (tests/test_pallas.py's tolerances)."""
    args = admm_inputs()
    w, z, y = AD.admm_iterate(*(t32(a) for a in args), **ADMM_KW)
    wj, zj, yj = j_admm(*(jnp.asarray(a) for a in args), has_soft=True, interpret=True,
                        **ADMM_KW)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-2, atol=1e-3)


def test_polish_plain_matches_pallas_interpret():
    """At k=16, na=8 the interpret-mode kernel compiles in a few seconds;
    the main-path shape (k=30, na=18) is held on the card, plain vs CUDA."""
    args = polish_inputs(k=16, na=8)
    out = PO.box_candidate(*(t32(a) for a in args), refine=7)
    ref = j_box(*(jnp.asarray(a) for a in args), refine=7, interpret=True)
    for o, r in zip(out, ref):
        o, r = o.numpy(), np.asarray(r)
        assert np.abs(o - r).max() / max(np.abs(r).max(), 1e-9) < 2e-4


# -- wrappers: checks, no fallback, launch counts ----------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    M = t32(sweep_inputs(2, 8))
    with pytest.raises(ValueError, match="n <= 96"):
        SW.sweep_spd_inverse(torch.zeros((1, 97, 97)))
    with pytest.raises(TypeError):
        SW.sweep_spd_inverse(M.double())
    with pytest.raises(ValueError, match="contiguous"):
        SW.sweep_spd_inverse(M.transpose(1, 2))
    with pytest.raises(ValueError):
        SW.sweep_spd_inverse(torch.zeros((0, 4, 4)))
    # a device that is neither the CPU nor a card raises instead of falling back
    with pytest.raises(ValueError, match="unsupported device"):
        SW.sweep_spd_inverse(torch.zeros((1, 4, 4), device="meta"))
    args = [t32(a) for a in admm_inputs(B=2, m=20, k=6)]
    with pytest.raises(ValueError, match="shape"):
        AD.admm_iterate(args[0], *args[1:5], args[5][:, :3], *args[6:], **ADMM_KW)
    with pytest.raises(ValueError, match="shared memory"):
        big = [torch.zeros(s) for s in ((1, 96, 96), (1, 600, 96))]
        AD.admm_iterate(big[0], big[1], torch.zeros(1, 96), *[torch.zeros(1, 600)] * 4,
                        torch.zeros(1, 96), torch.zeros(1, 600), torch.zeros(1, 600), **ADMM_KW)
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs(B=1, P=16)
    with pytest.raises(ValueError, match="k must be"):
        SE.select_topk_flow(*(torch.from_numpy(a) for a in (pts, vels, mask, R, trans)), dt,
                            *(torch.from_numpy(a) for a in (V, G, h)), 17)
    with pytest.raises(TypeError, match="bool"):
        SE.select_topk_flow(*(torch.from_numpy(a) for a in (pts, vels)),
                            torch.from_numpy(mask).float(),
                            *(torch.from_numpy(a) for a in (R, trans)), dt,
                            *(torch.from_numpy(a) for a in (V, G, h)), 4)
    pf, fmask, geom = _flow_inputs(3, 16, 16, B=1)
    flow, fmask, *geo = (torch.from_numpy(a) for a in (pf, fmask, *geom))
    with pytest.raises(ValueError, match="k must be"):
        SE.select_topk(flow, fmask, *geo, 17)
    with pytest.raises(ValueError, match="contiguous"):
        SE.select_topk(flow.transpose(2, 3).contiguous().transpose(2, 3), fmask, *geo, 4)
    with pytest.raises(ValueError, match="point_flow must be"):
        SE.select_topk(flow[0], fmask, *geo, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        SE.select_topk(flow.to("meta"), fmask.to("meta"), *(g.to("meta") for g in geo), 4)
    enc = ObsPointNet.seeded(2, 4, device="cpu")
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        ML.dune_mlp(enc, torch.zeros(5, 3))
    with pytest.raises(TypeError):
        ML.dune_mlp(enc, torch.zeros(5, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ML.dune_mlp(enc, torch.zeros(2, 5).t())
    with pytest.raises(ValueError, match="E <= 8"):
        ML.dune_mlp(ObsPointNet.seeded(2, 9, device="cpu"), torch.zeros(5, 2))
    with pytest.raises(ValueError, match="written for 2 -> 32"):
        ML.dune_mlp(ObsPointNet(2, 4, hidden_dim=16), torch.zeros(5, 2))
    with pytest.raises(TypeError, match="ObsPointNet"):
        ML.dune_mlp(torch.nn.Linear(2, 4), torch.zeros(5, 2))


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    wrappers = (SE.select_topk_flow, SE.select_topk, ML.dune_mlp, SW.sweep_spd_inverse,
                AD.admm_iterate, PO.box_candidate)
    before = [w.launches for w in wrappers]
    pf, fmask, geom = _flow_inputs(3, 32, 20, B=1)
    args = [torch.from_numpy(a) for a in (pf, fmask, *geom)]
    for o, p in zip(SE.select_topk(*args, 4), SE.select_topk_plain(*args, 4)):
        assert torch.equal(o, p)
    M = t32(sweep_inputs(3, 12))
    torch.testing.assert_close(SW.sweep_spd_inverse(M), SW.sweep_spd_inverse_plain(M),
                               rtol=0, atol=0)
    args = [t32(a) for a in polish_inputs(B=2, k=8, na=3)]
    for o, p in zip(PO.box_candidate(*args, refine=2), PO.box_candidate_plain(*args, refine=2)):
        torch.testing.assert_close(o, p, rtol=0, atol=0)
    assert [w.launches for w in wrappers] == before
