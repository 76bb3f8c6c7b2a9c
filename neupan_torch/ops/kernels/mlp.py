"""The DUNE point encoder as one fused kernel.

Replaces the TPU kernel ``neupan_tpu/ops/pallas/mlp.py:dune_mlp_pallas``
(``_mlp_kernel``) with ``neupan_torch/csrc/mlp.cu``.

What it computes: ``ObsPointNet`` on N points, (N, 2) -> (N, E):
2 -> 32 [LayerNorm, tanh] -> 32 [ReLU] -> 32 [LayerNorm, tanh] -> 32 [ReLU]
-> 32 [LayerNorm, tanh] -> E [ReLU], every intermediate kept on chip.

Bound on the H100: operations. A point costs ~8.6 kFLOP (four 32x32
products, the 2x32 and 32xE ones, three LayerNorms, 96 tanh) against 8
bytes read and 4E written: at N = 11.5M points and E = 4 that is ~99 GFLOP
(~1.5 ms at the card's float32 rate) against ~280 MB (~0.08 ms). At the
winners-only N = 56,320 both are microseconds and the launch dominates.

Design: one thread per point. The point's hidden state (32 floats) stays in
the thread's registers; the weights (4,776 floats, 19 KB) are packed once
per module into one buffer, copied by each block into shared memory and
read there as 16-byte broadcasts; LayerNorm is a per-thread mean and
variance with no cross-thread reduction; blocks walk the points with a grid
stride and the ragged end is a predicate in the kernel, so nothing is
padded or copied. Float32 FMAs: TF32 on the tensor cores keeps three digits
and the contract against the plain version is 1e-5. The normalization is
``1 / sqrtf`` (correctly rounded), the activation the accurate ``tanhf``.
The kernel is written for a hidden width of 32, two inputs and E <= 8.
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
    """(name, shape as packed) of each block of the packed weights, in order:
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


PACKED_SIZE = sum(int(torch.Size(shape).numel()) for _, shape in _layout())


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


def pack_weights(encoder) -> torch.Tensor:
    """The encoder's parameters as the one contiguous float32 buffer the
    kernel reads, on the parameters' device. Packed once per module and kept
    on it; repacked when a parameter was updated, replaced or moved."""
    E = _check_encoder(encoder)
    params = list(encoder.parameters())
    stamp = tuple((p.data_ptr(), p._version, p.device, p.dtype) for p in params)
    cached = getattr(encoder, "_dune_mlp_packed", None)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    seq = encoder.MLP
    parts = []
    with torch.no_grad():
        for i, idx in enumerate(_LINEAR_IDX):
            w, b = seq[idx].weight.t().float(), seq[idx].bias.float()   # (in, out)
            if i == 5:
                w = torch.nn.functional.pad(w, (0, MAX_E - E))
                b = torch.nn.functional.pad(b, (0, MAX_E - E))
            parts += [w.reshape(-1), b]
            if i in _LN_AFTER:
                ln = seq[_LN_AFTER[i]]
                parts += [ln.weight.float(), ln.bias.float()]
        packed = torch.cat(parts).contiguous()
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
    by layer from the packed weights: points (..., 2) -> (..., E)."""
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
    pass (the TPU kernel has none either): it raises for points that
    require a gradient while gradients are recorded. The encoder must sit
    on the points' device.
    """
    dev = _build.dispatch_device(points)
    if points.dim() < 1 or points.shape[-1] != 2:
        raise ValueError(f"points must be (..., 2), got {tuple(points.shape)}")
    _build.check(points, "points", tuple(points.shape), device=dev)
    packed = pack_weights(encoder)
    if packed.device != dev:
        raise ValueError(f"the encoder is on {packed.device}, the points on {dev}")
    E = encoder.MLP[_LINEAR_IDX[-1]].out_features
    if dev.type == "cpu":
        return dune_mlp_plain(packed, points, E)
    if torch.is_grad_enabled() and points.requires_grad:
        raise RuntimeError("the fused MLP kernel has no backward pass; "
                           "run it under torch.no_grad() or use the encoder module")
    N = points.numel() // 2
    out = torch.empty((*points.shape[:-1], E), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    # the kernel reads a point as one 8-byte word and a weight row in 16-byte words
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
