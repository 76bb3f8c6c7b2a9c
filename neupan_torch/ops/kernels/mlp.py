"""The DUNE point encoder as one fused kernel.

Replaces the TPU kernel ``neupan_tpu/ops/pallas/mlp.py:dune_mlp_pallas``
(``_mlp_kernel``) with ``neupan_torch/csrc/mlp.cu``.

What it computes: ``ObsPointNet`` on N points, (N, 2) -> (N, E):
2 -> 32 [LayerNorm, tanh] -> 32 [ReLU] -> 32 [LayerNorm, tanh] -> 32 [ReLU]
-> 32 [LayerNorm, tanh] -> E [ReLU], every intermediate kept on chip.

Bound on the H100: operations, against 8 bytes read and 4E written per
point. A point needs 4,288 multiply-adds at E=4 (the four 32x32 products,
the 2x32 and 32xE ones), three LayerNorms and 96 tanh; a tanh costs two
MUFU operations and nine float32 ones on the card, so counted at its cost
and not as one operation the elementwise work is a third of the products'.
``chip_smoke.py:mlp_bounds`` gives two bounds: float32 on the CUDA cores
(every product an FMA, 1.96 ms at 11.5M points) and the tensor-core design
(three TF32 passes of the products against the elementwise work at the
float32 and MUFU rates, 0.60 ms, taking the TF32 rate of the warpgroup
mma). This kernel is the tensor-core design on ``mma.sync``, which reaches
about a third of that rate on Hopper: that, with the elementwise work
around the products, holds it to four times the bound.

Design (``csrc/mlp.cu``): a warp carries 16 points at a time through the
network in registers, the products on the tensor cores as TF32
``mma.sync`` at float32 accuracy by error-compensated TF32 (each operand a
TF32 high and low part; hi*hi + hi*lo + lo*hi). A point's 32 features lie
across the four lanes of a quad, as the accumulator fragment leaves them;
LayerNorm reduces over the quad with two shuffles. The packing permutes
each weight matrix's rows so that one layer's accumulator fragment is the
next one's A fragment as it stands. ``pack_weights`` splits the weights
and lays them out as B fragments once per module; the kernel copies them
(36.5 KB) into shared memory once per block. The tensor cores round their
sums toward zero; the layers before a ReLU and the head therefore add each
k-step's hi*hi tile rounding to nearest, while before a LayerNorm the
common drift leaves with the mean. The normalization is ``rsqrtf`` with one
Newton step, the activation the accurate ``tanhf``. The kernel is written
for a hidden width of 32, two inputs and E <= 8.
"""

from __future__ import annotations

import torch

from neupan_torch.ops.kernels import _build

HIDDEN = 32
MAX_E = 8        # head columns of the packed layout (zero padded)
_LN_EPS = 1e-5
_LINEAR_IDX = (0, 3, 5, 8, 10, 13)
_LN_AFTER = {0: 1, 2: 6, 4: 11}   # linear layer number -> its LayerNorm's index


def _layout():
    """(name, shape as packed) of each block of the plain section, in order:
    w_i stored (in, out), the head zero-padded to MAX_E columns."""
    H = HIDDEN
    blocks = []
    for i in range(6):
        d_in = 2 if i == 0 else H
        d_out = MAX_E if i == 5 else H
        blocks += [(f"w{i}", (d_in, d_out)), (f"b{i}", (d_out,))]
        if i in _LN_AFTER:
            blocks += [(f"ln{i // 2}_scale", (H,)), (f"ln{i // 2}_bias", (H,))]
    return blocks


PLAIN_SIZE = sum(int(torch.Size(shape).numel()) for _, shape in _layout())      # 4,776
# the kernel's section: w0, the biases and LayerNorm parameters, then the B
# fragments of the five tensor-core products (32x32 x4, 32xMAX_E)
_FRAG_SIZE = 4 * (HIDDEN * HIDDEN * 2) + HIDDEN * MAX_E * 2
KERNEL_SIZE = 2 * HIDDEN + 11 * HIDDEN + MAX_E + _FRAG_SIZE                      # 9,128
PACKED_SIZE = PLAIN_SIZE + KERNEL_SIZE


def _check_encoder(encoder) -> int:
    """The head width E of an encoder the kernel takes; raises otherwise."""
    seq = getattr(encoder, "MLP", None)
    if seq is None:
        raise TypeError("dune_mlp takes an ObsPointNet (a module with an MLP Sequential)")
    lin = [seq[i] for i in _LINEAR_IDX]
    E = lin[-1].out_features
    dims = [(lin[0].in_features, lin[0].out_features)] + [
        (layer.in_features, layer.out_features) for layer in lin[1:-1]] + [(lin[-1].in_features,)]
    want = [(2, HIDDEN)] + [(HIDDEN, HIDDEN)] * 4 + [(HIDDEN,)]
    if dims != want:
        raise ValueError(f"the fused MLP kernel is written for 2 -> {HIDDEN} x5 -> E, got {dims}")
    if not 1 <= E <= MAX_E:
        raise ValueError(f"the fused MLP kernel takes E <= {MAX_E} output columns, got {E}")
    for idx in _LN_AFTER.values():
        if seq[idx].eps != _LN_EPS:
            raise ValueError(f"the fused MLP kernel is written for LayerNorm eps {_LN_EPS}")
    return E


def _plain_blocks(encoder):
    """The plain section's blocks from the live parameters, by name
    (differentiable in them)."""
    E = encoder.MLP[_LINEAR_IDX[-1]].out_features
    seq, blocks = encoder.MLP, {}
    for i, idx in enumerate(_LINEAR_IDX):
        w, b = seq[idx].weight.t().float(), seq[idx].bias.float()   # (in, out)
        if i == 5:
            w = torch.nn.functional.pad(w, (0, MAX_E - E))
            b = torch.nn.functional.pad(b, (0, MAX_E - E))
        blocks[f"w{i}"], blocks[f"b{i}"] = w, b
        if i in _LN_AFTER:
            ln = seq[_LN_AFTER[i]]
            blocks[f"ln{i // 2}_scale"], blocks[f"ln{i // 2}_bias"] = ln.weight.float(), ln.bias.float()
    return blocks


def _plain_section(blocks) -> torch.Tensor:
    return torch.cat([blocks[name].reshape(-1) for name, _ in _layout()])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def b_fragments(w: torch.Tensor) -> torch.Tensor:
    """A (32, 8 NT) weight (in, out) as the kernel's B fragments, flat:
    [k-step kk][n-tile j][lane 4g + t] x (hi of row 8kk + 2t, hi of row
    8kk + 2t + 1, lo of the same two), column 8j + g. Rows 2t and 2t + 1 of
    a k-step are the columns t and t + 4 of its A fragment, which is where
    the previous layer's accumulator fragment holds those two features."""
    NT = w.shape[1] // 8
    frag = lambda x: x.reshape(4, 4, 2, NT, 8).permute(0, 3, 4, 1, 2)   # (kk, j, g, t, row parity)
    hi = tf32_round(w)
    return torch.cat([frag(hi), frag(tf32_round(w - hi))], dim=-1).reshape(-1)


def pack_weights(encoder) -> torch.Tensor:
    """The encoder's parameters as the one contiguous float32 buffer the
    kernel reads, on the parameters' device: the plain section (what
    ``dune_mlp_plain`` reads), then the kernel's (``csrc/mlp.cu``). Packed
    once per module and kept on it; repacked when a parameter was updated,
    replaced or moved."""
    _check_encoder(encoder)
    params = list(encoder.parameters())
    stamp = tuple((p.data_ptr(), p._version, p.device, p.dtype) for p in params)
    cached = getattr(encoder, "_dune_mlp_packed", None)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    with torch.no_grad():
        w = _plain_blocks(encoder)
        small = [w["w0"].reshape(-1), w["b0"], w["ln0_scale"], w["ln0_bias"], w["b1"], w["b2"],
                 w["ln1_scale"], w["ln1_bias"], w["b3"], w["b4"], w["ln2_scale"],
                 w["ln2_bias"], w["b5"]]
        frags = [b_fragments(w[f"w{i}"]) for i in range(1, 6)]
        packed = torch.cat([_plain_section(w)] + small + frags).contiguous()
    assert packed.numel() == PACKED_SIZE
    encoder._dune_mlp_packed = (stamp, packed)
    return packed


def _unpack(packed: torch.Tensor):
    out, off = {}, 0
    for name, shape in _layout():
        n = int(torch.Size(shape).numel())
        out[name] = packed[off:off + n].reshape(shape)
        off += n
    return out


def dune_mlp_plain(packed: torch.Tensor, points: torch.Tensor, E: int) -> torch.Tensor:
    """The same function as the kernel in plain PyTorch, written out layer
    by layer from the plain section of the packed weights (the kernel's
    section is not read): points (..., 2) -> (..., E)."""
    w = _unpack(packed)

    def ln(x, j):
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + _LN_EPS) * w[f"ln{j}_scale"] + w[f"ln{j}_bias"]

    x = torch.tanh(ln(points @ w["w0"] + w["b0"], 0))
    x = torch.relu(x @ w["w1"] + w["b1"])
    x = torch.tanh(ln(x @ w["w2"] + w["b2"], 1))
    x = torch.relu(x @ w["w3"] + w["b3"])
    x = torch.tanh(ln(x @ w["w4"] + w["b4"], 2))
    return torch.relu(x @ w["w5"][:, :E] + w["b5"][:E])


def dune_mlp(encoder, points: torch.Tensor) -> torch.Tensor:
    """Evaluate the encoder on points (..., 2) float32 -> duals (..., E).

    On a CUDA tensor this launches the fused kernel, which has no backward
    pass (the TPU kernel has none either): while gradients are recorded it
    raises for points or encoder parameters that require one. On the CPU
    the plain version carries both gradients: it reads the live parameters
    then, as ``encoder(points)`` does. The encoder must sit on the points'
    device.
    """
    dev = _build.dispatch_device(points)
    if points.dim() < 1 or points.shape[-1] != 2:
        raise ValueError(f"points must be (..., 2), got {tuple(points.shape)}")
    _build.check(points, "points", tuple(points.shape), device=dev)
    E = _check_encoder(encoder)
    wdev = next(encoder.parameters()).device
    if wdev != dev:
        raise ValueError(f"the encoder is on {wdev}, the points on {dev}")
    grads = torch.is_grad_enabled() and (
        points.requires_grad or any(p.requires_grad for p in encoder.parameters()))
    if dev.type == "cpu":
        packed = _plain_section(_plain_blocks(encoder)) if grads else pack_weights(encoder)
        return dune_mlp_plain(packed, points, E)
    if grads:
        raise RuntimeError("the fused MLP kernel has no backward pass; run it under "
                           "torch.no_grad() or use the encoder module")
    packed = pack_weights(encoder)
    N = points.numel() // 2
    out = torch.empty((*points.shape[:-1], E), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    # the kernel reads a point as one 8-byte word and the weights in 16-byte words
    if points.data_ptr() % 8 or packed.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("points must start on an 8-byte boundary (a view at an odd float "
                         "offset does not: clone it), the packed weights on a 16-byte one")
    size_fn = _build.function("dune_mlp_packed_size", [])
    if size_fn() != PACKED_SIZE:
        raise RuntimeError("the packed weight layout differs from the kernel's")
    P_ = _build.PTR
    fn = _build.function("dune_mlp_launch", [P_, P_, P_, _build.LONG, _build.INT, P_])
    _build.launch(fn, dev, _build.ptr(points), _build.ptr(packed), _build.ptr(out), N, E)
    dune_mlp.launches += 1
    return out


dune_mlp.launches = 0
