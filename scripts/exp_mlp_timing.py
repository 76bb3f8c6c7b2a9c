#!/usr/bin/env python3
"""Device time of the fused DUNE MLP kernel, split by phase, beside another checkout's.

    python3 scripts/exp_mlp_timing.py [--parent PATH] [--no-accuracy]   # needs one CUDA card

Builds ``neupan_torch/csrc/mlp.cu`` alone into a library of its own under
``build/mlp_variants/``: this checkout's, the one of ``--parent PATH``
(another checkout of the repo, for example the parent commit unpacked with
``git archive`` into a directory that .gitignore lists) and edited copies
of this checkout's, all ``nvcc`` calls started together. Every library is
called through its C launcher on the same packed weights (the plain
section, which an older kernel reads, leads the buffer) and timed as
device time: 50 launches (10 at the largest N) captured in a CUDA graph, replayed between CUDA
events (``chip_smoke.py:graph_ms``), at N = 11,534,336 (the
``dune_select="mlp"`` path, B=512), 56,320 (the winners, B=512) and 110
(the facade's winners, B=1). ``encoder(points)`` is timed the same way.

The variants (``--variants``, names joined by "+" combine) split the time by
phase, where outputs mean nothing and only the time counts:

* ``one_pass``: the two compensating passes hi*lo and lo*hi removed (two
  thirds of the mma instructions, with the low parts' splits);
* ``no_tanh``: tanh replaced by the identity;

and weigh design choices, each computing the function:

* ``tc_accumulate``: every hi*hi tile carried in the tensor cores'
  accumulator, none added rounding to nearest;
* ``all_nearest``: every layer's hi*hi tiles added rounding to nearest;
* ``exact_rsqrt``: LayerNorm's 1 / sqrtf correctly rounded instead of
  rsqrtf and a Newton step;
* ``fast_tanh``: tanh as 1 - 2 / (exp(2|x|) + 1) by ``ex2.approx`` and
  ``rcp.approx`` with one Newton step, an odd polynomial below 0.55;
* ``cvt_split``: the high part by ``cvt.rna.tf32.f32``;
* ``lo_masked``: the low part's 13 low bits cleared as well;
* ``mt1``/``mt2``: 16 or 32 points per warp step; ``threads128``/
  ``threads256``: the block size.

Unless ``--no-accuracy``, each library that computes the function is held
against a float64 evaluation of the same weights on the 11,534,336 points
(a point flow as the planner builds it) with the diff and acker
checkpoints, beside the plain version and the module. The SASS opcode
counts of each library's kernel come from ``cuobjdump -sass`` and its
registers and spills from ``nvcc -Xptxas -v``. Prints one JSON line, then
the card's name, power limit and SM clock under load.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import graph_ms, ptxas_usage  # noqa: E402
from neupan_torch.models import load_checkpoint  # noqa: E402
from neupan_torch.ops.kernels import _build  # noqa: E402
from neupan_torch.ops.kernels import mlp as ML  # noqa: E402

OUT = pathlib.Path(ROOT) / "build" / "mlp_variants"
SIZES = (11_534_336, 56_320, 110)

FAST_TANH = """__device__ __forceinline__ float act(float v) {
  const float ax = fabsf(v);
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(ax * 2.885390081777927f));
  const float d = e + 1.0f;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  r = fmaf(r, fmaf(-d, r, 1.0f), r);
  float y = fmaf(-2.0f, r, 1.0f);
  const float s = v * v;
  float p = fmaf(fmaf(fmaf(-6.282479761e-3f, s, 2.107776305e-2f), s, -5.385385908e-2f), s,
                 1.333260170e-1f);
  p = fmaf(p, s, -3.333331805e-1f) * s;
  y = ax < 0.55f ? fmaf(p, ax, ax) : y;
  return copysignf(y, v);
}"""

# name -> (pattern, replacement) applied once to a copy of this checkout's mlp.cu;
# a name joined by "+" applies each edit in turn
VARIANTS = {
    "one_pass": (r"        mma\(cross\[m\]\[j\], lo\[m\], bh0, bh1\);\n        mma\(cross\[m\]\[j\], hi\[m\], bl0, bl1\);\n", ""),
    "no_tanh": (r"float act\(float v\) \{ return tanhf\(v\); \}", "float act(float v) { return v; }"),
    "fast_tanh": (r"__device__ __forceinline__ float act\(float v\) \{ return tanhf\(v\); \}", FAST_TANH),
    "tc_accumulate": (r"dense<(\d), true>", r"dense<\1, false>"),
    "all_nearest": (r"dense<(\d), false>", r"dense<\1, true>"),
    "exact_rsqrt": (r"      const float r0 = rsqrtf\(var\);[^\n]*\n      inv\[r\] = [^\n]*\n",
                    "      inv[r] = 1.0f / sqrtf(var);\n"),
    "cvt_split": (r"  return \(__float_as_uint\(x\) \+ 0x1000u\) & 0xffffe000u;",
                  '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;'),
    "mt1": (r"constexpr int MT = \d+;", "constexpr int MT = 1;"),
    "mt2": (r"constexpr int MT = \d+;", "constexpr int MT = 2;"),
    "threads128": (r"constexpr int kThreads = \d+;", "constexpr int kThreads = 128;"),
    "threads256": (r"constexpr int kThreads = \d+;", "constexpr int kThreads = 256;"),
    "lo_masked": (r"tf32_operand\(v - ", "tf32(v - "),
}
DEFAULT = "no_tanh,one_pass,tc_accumulate,all_nearest,exact_rsqrt,fast_tanh,threads128,mt2+threads128"
PHASE_CUTS = ("no_tanh", "one_pass")   # variants whose outputs mean nothing


def variant_source(name: str) -> pathlib.Path:
    src = OUT / name / "src"
    if src.exists():
        shutil.rmtree(src)
    src.mkdir(parents=True)
    for f in ("mlp.cu", "common.cuh"):
        shutil.copy(_build.CSRC / f, src / f)
    text = (src / "mlp.cu").read_text()
    for part in name.split("+"):
        pattern, new = VARIANTS[part]
        text, n = re.subn(pattern, lambda m: m.expand(new), text)
        if n == 0:
            raise SystemExit(f"variant {part}: pattern not found in mlp.cu")
    (src / "mlp.cu").write_text(text)
    return src


def tanh_per_step(src: pathlib.Path) -> int:
    """tanh a thread evaluates per warp step: 16 values per m-tile, three LayerNorms."""
    mt = int(re.search(r"constexpr int MT = (\d+);", (src / "mlp.cu").read_text()).group(1))
    return 16 * mt * 3


def build_all(sources: dict) -> dict:
    """name -> (library, ptxas log); one nvcc per library, all at once."""
    procs = {}
    for name, src in sources.items():
        lib = OUT / name / "libmlp.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o", str(lib), str(src / "mlp.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, log)
    return built


def launcher(lib: pathlib.Path):
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.dune_mlp_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(points, packed, out):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(points.data_ptr(), packed.data_ptr(), out.data_ptr(), points.numel() // 2,
                out.shape[-1], stream)
        if rc != 0:
            raise RuntimeError(f"{lib}: launch failed with code {rc}")
    return run


def sass_counts(lib: pathlib.Path) -> dict:
    cuobjdump = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "dune_mlp_kernel" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1).split(".")[0]] += 1
    return dict(counts.most_common())


def flow_points(N: int, dev) -> torch.Tensor:
    """Points in the robot frames of a planner's horizon: uniform in [-4, 9]^2,
    advanced by a velocity and rotated and shifted per frame (B=512, T+1=11)."""
    rng = np.random.default_rng(0)
    P = N // (512 * 11)
    pts = rng.uniform(-4.0, 9.0, (512, 1, P, 2))
    vel = rng.normal(scale=0.3, size=(512, 1, P, 2))
    th = rng.uniform(-np.pi, np.pi, (512, 11, 1))
    tr = rng.uniform(-1.0, 1.0, (512, 11, 1, 2))
    g = pts + 0.1 * np.arange(11)[None, :, None, None] * vel - tr
    c, s = np.cos(th), np.sin(th)
    flow = np.stack([c * g[..., 0] + s * g[..., 1], -s * g[..., 0] + c * g[..., 1]], -1)
    return torch.tensor(flow.reshape(-1, 2), dtype=torch.float32, device=dev)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repo whose mlp.cu is timed too")
    ap.add_argument("--no-accuracy", action="store_true")
    ap.add_argument("--variants", default=DEFAULT, help="comma-separated, from: " + ", ".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_mlp_timing: no CUDA device is available")
    dev = torch.device("cuda")
    sources = {"this": _build.CSRC}
    if args.parent:
        sources["parent"] = pathlib.Path(args.parent).resolve() / "neupan_torch" / "csrc"
    sources.update({name: variant_source(name) for name in args.variants.split(",") if name})
    built = build_all(sources)
    run = {name: launcher(lib) for name, (lib, _) in built.items()}
    res = {"ptxas": {name: ptxas_usage(log).get("dune_mlp_kernel") for name, (_, log) in built.items()},
           "sass": {name: sass_counts(lib) for name, (lib, _) in built.items()}}
    if "no_tanh" in built:
        delta = collections.Counter(res["sass"]["this"])
        delta.subtract(res["sass"]["no_tanh"])
        res["sass_per_tanh"] = {k: v / tanh_per_step(_build.CSRC) for k, v in delta.items() if v}

    models = {m: load_checkpoint(os.path.join(ROOT, f"examples/model/{m}/model.npz"), dev)
              for m in ("diff_robot_default", "acker_robot_default")}
    enc = models["diff_robot_default"]
    big = flow_points(SIZES[0], dev)
    res["ms"] = {}
    with torch.no_grad():
        packed = ML.pack_weights(enc)
        for N in SIZES:
            pts = big[:N].contiguous()
            out = torch.empty((N, 4), device=dev)
            reps = 10 if N > 1e6 else 50
            row = {name: graph_ms(torch, lambda r=r: r(pts, packed, out), reps=reps)
                   for name, r in run.items()}
            row["library"] = graph_ms(torch, lambda: enc(pts), reps=reps)
            row["plain"] = graph_ms(torch, lambda: ML.dune_mlp_plain(packed, pts, 4), reps=reps)
            res["ms"][N] = row
        if not args.no_accuracy:
            res["err_vs_f64"] = {}
            for mname, m in models.items():
                pk = ML.pack_weights(m)
                outs = {}
                for name in (n for n in run if n not in PHASE_CUTS):
                    outs[name] = torch.empty((SIZES[0], 4), device=dev)
                    run[name](big, pk, outs[name])
                outs["plain"], outs["module"] = ML.dune_mlp_plain(pk, big, 4), m(big)
                err = dict.fromkeys(outs, 0.0)
                for lo in range(0, SIZES[0], 1 << 20):
                    sl = slice(lo, lo + (1 << 20))
                    ref = ML.dune_mlp_plain(pk.double(), big[sl].double(), 4)
                    for name, o in outs.items():
                        err[name] = max(err[name], float((o[sl] - ref).abs().max()))
                err["this_vs_plain"] = float((outs["this"] - outs["plain"]).abs().max())
                res["err_vs_f64"][mname] = err
                del outs
        out = torch.empty((SIZES[0], 4), device=dev)
        for _ in range(200):
            run["this"](big, packed, out)
        clock = smi("clocks.sm,clocks.max.sm")
        torch.cuda.synchronize()
    print(json.dumps(res))
    print(f"{smi('name,power.limit')}, SM clock under load {clock}")


if __name__ == "__main__":
    main()
