"""neupan_torch — the NeuPAN engine in PyTorch, with hand-written Hopper kernels.

A port of ``neupan_tpu`` (JAX/Pallas) to PyTorch and CUDA C++. The layout
mirrors the JAX package module for module; the code inside is PyTorch
idiom: ``nn.Module``s and plain functions on tensors, the scenario batch
as a written-out leading axis, explicit ``device`` arguments.

Entry points run on the card: every function that creates tensors takes
``device=None``, which means ``"cuda"``, and raises when no card is
present unless the caller passes ``device="cpu"``. On the CPU each kernel
wrapper runs its plain PyTorch version (``neupan_torch/ops/kernels``).

The package pins exact float32 arithmetic, as the JAX package does
(``neupan_tpu/ops/pan.py``, ``ops/qp.py``): reduced-precision matmuls
break the solver's accuracy contract. ``PANSpec(precision="default")``
lets a planner step's CUDA matmuls use TF32 (``matmul_precision``); the
QP switches back to exact float32 inside it.
"""

from __future__ import annotations

import contextlib

__version__ = "0.1.0"

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point creates its tensors on.

    ``None`` means the card. With no card present it raises rather than
    running on the CPU without being asked.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "neupan_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def same_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` sit on; raises if they differ."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs sit on different devices: {sorted(map(str, devices))}")
    return devices.pop()


PRECISIONS = ("highest", "default")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Run the block with the CUDA float32 matmuls exact (``"highest"``) or
    with TF32 allowed (``"default"``): the JAX package's
    ``jax.default_matmul_precision`` scope. The flag is process-global, so
    it is restored on exit, also when the block raises. Only the CUDA
    matmul flag is set: the CPU's matmuls, and the hand kernels' own
    arithmetic, stay as they are.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = precision == "default"
    try:
        yield
    finally:
        flags.allow_tf32 = before


# the facade imports the modules above it, so it comes last
from neupan_torch.planner import NeuPan, neupan  # noqa: E402,F401
