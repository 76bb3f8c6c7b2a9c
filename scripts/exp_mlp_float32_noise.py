"""How far three float32 evaluations of the DUNE encoder sit from float64.

    python3 scripts/exp_mlp_float32_noise.py        # needs one CUDA card

For each shipped checkpoint and N = 1,000,003 and 8,000,000 points uniform
in [-10, 10]^2 (numpy seed N), the largest absolute difference from a
float64 evaluation of the same weights for: the fused CUDA kernel
(``ops/kernels/mlp.py:dune_mlp``), its plain PyTorch version and the
``nn.Sequential`` module; and the kernel's largest difference from the
other two. Prints one JSON line per case, the card's name and power limit
last. It shows what tolerance a float32 comparison of this network can
hold at a given number of points, whichever code evaluates it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from neupan_torch.models import load_checkpoint  # noqa: E402
from neupan_torch.ops.kernels import mlp as ML  # noqa: E402

MODELS = ("diff_robot_default", "acker_robot_default", "polygon_robot")
CHUNK = 1 << 20


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("exp_mlp_float32_noise: no CUDA device is available")
    for model in MODELS:
        enc = load_checkpoint(os.path.join(ROOT, "examples/model", model, "model.npz"), "cuda")
        E = enc.MLP[13].out_features
        for N in (1_000_003, 8_000_000):
            pts = torch.tensor(np.random.default_rng(N).uniform(-10, 10, (N, 2)),
                               dtype=torch.float32, device="cuda")
            with torch.no_grad():
                packed = ML.pack_weights(enc)
                outs = {"kernel": ML.dune_mlp(enc, pts),
                        "plain": ML.dune_mlp_plain(packed, pts, E), "module": enc(pts)}
                err = dict.fromkeys(outs, 0.0)
                for lo in range(0, N, CHUNK):
                    sl = slice(lo, lo + CHUNK)
                    ref = ML.dune_mlp_plain(packed.double(), pts[sl].double(), E)
                    for name, out in outs.items():
                        err[name] = max(err[name], float((out[sl] - ref).abs().max()))
            print(json.dumps({
                "model": model, "N": N, "max_abs_err_vs_float64": err,
                "kernel_vs_plain": float((outs["kernel"] - outs["plain"]).abs().max()),
                "kernel_vs_module": float((outs["kernel"] - outs["module"]).abs().max())}))
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
