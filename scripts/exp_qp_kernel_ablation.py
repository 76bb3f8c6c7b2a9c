"""Where the time of the admm and polish kernels goes, by CUDA events.

    python3 scripts/exp_qp_kernel_ablation.py [--variant NAME]   # needs one CUDA card

``ncu`` and ``nsys`` are not available everywhere the card is, so this
splits each kernel's time by running it with less work and taking
differences, at the main path's shapes and at B=1 and B=512:

* admm (k=30, m=148): 0, 1 and 120 iterations; the 0-iteration launch is
  the fixed cost (reading the operator, writing the iterate), and
  (t120 - t0) / 120 the cost of one iteration;
* polish (k=30, na=18): refine = 0 and 7; the 0-refine launch is the
  loads, both inverses, the Schur build and one KKT solve, and
  (t7 - t0) / 7 the cost of one refinement pass (a KKT solve and three
  products).

Inputs come from the card tests' seeded builders. Each time is device
time: 50 launches captured in a CUDA graph and replayed between CUDA events
(``chip_smoke.py:graph_ms``). ``--variant`` builds an edited copy of
``neupan_torch/csrc`` under ``build/kernel_variants/`` instead, to split
polish by phase (the kernel returns after a phase; its outputs are then
meaningless, only its time counts):

* ``polish_stop_loads``: after reading the inputs into shared memory;
* ``polish_stop_hm_inverse``: after the masked Hessian's inverse;
* ``polish_stop_s_inverse``: after the Schur complement and its inverse;
* ``polish_no_pivot_barrier``: the sweep without its barrier per pivot
  (wrong results; what the barriers cost).

Prints one JSON line, then the card's name, power limit and SM clock (read
while the card runs a queue of launches).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from chip_smoke import graph_ms  # noqa: E402
from neupan_torch.ops.kernels import _build  # noqa: E402
from neupan_torch.ops.kernels import admm as AD  # noqa: E402
from neupan_torch.ops.kernels import polish as PO  # noqa: E402
from test_torch_gpu import admm_inputs, polish_inputs, t32  # noqa: E402


# name -> (file, anchor text, replacement) applied to a copy of csrc/
VARIANTS = {
    "polish_stop_loads": ("polish.cu", "  // masked Hessian (identity row/column",
                          "  return;\n  // masked Hessian (identity row/column"),
    "polish_stop_hm_inverse": ("polish.cu", "  // dual Schur complement over the acc rows",
                               "  return;\n  // dual Schur complement over the acc rows"),
    "polish_stop_s_inverse": ("polish.cu", "ss, sbuf, na);\n  __syncthreads();\n",
                              "ss, sbuf, na);\n  __syncthreads();\n  return;\n"),
    "polish_no_pivot_barrier": ("polish.cu",
                                "    __syncthreads();\n  }\n#pragma unroll\n  for (int rr",
                                "  }\n#pragma unroll\n  for (int rr"),
}


def variant_csrc(name: str) -> pathlib.Path:
    """A copy of csrc/ with one edit, under build/kernel_variants/NAME."""
    fname, anchor, new = VARIANTS[name]
    out = pathlib.Path(ROOT) / "build" / "kernel_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    text = (out / fname).read_text()
    if text.count(anchor) != 1:
        raise SystemExit(f"variant {name}: anchor not found once in {fname}")
    (out / fname).write_text(text.replace(anchor, new))
    return out


def time_ms(fn) -> float:
    return graph_ms(torch, fn)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="time an edited copy of the kernels instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_qp_kernel_ablation: no CUDA device is available")
    if args.variant:
        _build.CSRC = variant_csrc(args.variant)
    dev = torch.device("cuda")
    out = {"variant": args.variant}
    for B in (1, 512):
        ad = [t32(a, dev) for a in admm_inputs(B=B, m=148, k=30)]
        t = {n: time_ms(lambda: AD.admm_iterate(*ad, iters=n, sigma=1e-6, alpha=1.6))
             for n in (0, 1, 120)}
        out[f"admm_B{B}"] = dict(ms_by_iters=t, fixed_ms=t[0],
                                 us_per_iteration=(t[120] - t[0]) / 120 * 1e3)
        po = [t32(a, dev) for a in polish_inputs(B=B, k=30, na=18)]
        t = {n: time_ms(lambda: PO.box_candidate(*po, refine=n)) for n in (0, 7)}
        out[f"polish_B{B}"] = dict(ms_by_refine=t, setup_and_one_solve_ms=t[0],
                                   us_per_refine_pass=(t[7] - t[0]) / 7 * 1e3)
    # the SM clock under load: queue launches, read the clock while they run
    for _ in range(2000):
        AD.admm_iterate(*ad, iters=120, sigma=1e-6, alpha=1.6)
    clock = smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    print(json.dumps(out))
    print(f"{smi('name,power.limit')}, SM clock under load {clock}")


if __name__ == "__main__":
    main()
