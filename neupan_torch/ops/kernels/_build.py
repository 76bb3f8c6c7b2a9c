"""Build and load the CUDA kernels of ``neupan_torch/csrc``.

Every ``csrc/*.cu`` is compiled by one ``nvcc`` call into one shared
library, ``libneupan.so``, with a plain C interface, loaded with
``ctypes``. The build runs at first use, into
``build/neupan_torch/<hash>/`` at the root of the checkout; the hash covers
every file in ``csrc/`` and the flags, so a changed source builds anew and
an unchanged one is loaded as it is.

Flags: ``sm_90a`` (Hopper), ``-O3``, C++17, no fast-math; ``--threads 0``
compiles the sources side by side (the fully unrolled MLP kernel alone takes
about as long as the others together). ``nvcc``'s
resource report (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``libneupan.log``.

Nothing here runs at import time: this module is imported by the CPU
tests, where there is no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "neupan_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--threads", "0")

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``libneupan.so`` unless this source hash has it; return its path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libneupan.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libneupan.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    (out_dir / "libneupan.log").write_bytes(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout.decode(errors="replace"))
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.neupan_error_string.argtypes = [ctypes.c_int]
    lib.neupan_error_string.restype = ctypes.c_char_p
    return lib


def function(fn_name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C launcher ``fn_name`` of the library, built on first use."""
    fn = getattr(_library(), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(fn, device: torch.device, *args) -> None:
    """Call a C launcher on ``device``'s current stream; raise if it failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        msg = _library().neupan_error_string(rc).decode()
        raise RuntimeError(f"{fn.__name__} failed: {msg} (code {rc})")


# ctypes argument kinds for the launchers' signatures
PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(t, name: str, shape: Sequence[int], dtype=torch.float32,
          device: torch.device = None, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a tensor of ``shape``/``dtype`` on ``device``,
    contiguous where the kernel reads it directly."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dispatch_device(t: torch.Tensor) -> torch.device:
    """The device a wrapper serves: the CPU (plain version) or a CUDA card."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device
