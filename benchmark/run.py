"""The benchmark of ``neupan_torch``: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the program at the cell's configuration, makes the cell's traffic on
the card from the seed, warms up the chain, measures for ``--seconds``
seconds, and then checks a seeded sample of the window's results against
the plain reference (``benchmark/reference``). With ``--trace 1`` a few more
steps run under ``torch.profiler`` and the per-layer metrics are reported
instead of the end-to-end ones. The last line of standard output is one
JSON object; the numbers that decide ``correct`` are also the last lines of
standard error.

It refuses to run without as many CUDA cards as the cell asks for, and
never falls back to the CPU. ``--control tf32`` runs the program at
``precision="default"`` (TF32 matmuls), the lower-precision control that
the check has to fail; ``--fault`` breaks the timed path on purpose;
``--verdicts N`` judges the N scenario-steps whose actions part most in
float64 (``harness/verdict.py``). The benchmark's own runs use none.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "neupan_tpu")
CACHES = {"TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": "build/bench_cache/triton"}
# Python's bytecode of torch and the rest: where the machine forbids writing it
# beside the sources (PYTHONDONTWRITEBYTECODE), every run would compile them anew
PYCACHE = "build/bench_cache/pycache"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--verdicts", type=int, default=0,
                    help="judge up to this many scenario-steps past u_flip in float64")
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({type(err).__name__})"
    return "; ".join(out.stdout.strip().splitlines()) or "not read"


def measure(root, cell, seed, seconds, trace, device, precision=None, fault=None,
            t_start=None, log=print, verdicts=0, phases=None):
    """One run of ``cell`` on ``device``; returns the result object. The
    caller has checked the device (the harness's tests pass the CPU)."""
    import numpy as np
    import torch

    from benchmark.harness import cells as C
    from benchmark.harness import check as K
    from benchmark.harness import runner as D
    from benchmark.harness import traffic as TR
    from benchmark.harness.trace import traced
    from benchmark.reference import step as R
    from benchmark.work import counts as W

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg, mix = cell.config, cell.mix
    phases = dict(phases or {})
    phases["imports"] = time.perf_counter() - t_start - sum(phases.values())
    program = D.Program(root, cfg, device, precision=precision, fault=fault)
    lanes = TR.Lanes(seed, int(mix["batch"]), int(cfg["pan"]["dune_max_num"]),
                     int(cfg["receding"]), float(cfg["step_time"]), float(cfg["ref_speed"]),
                     mix["field"], device)
    runner = D.Runner(program, lanes, mix, seed)
    phases["program"] = time.perf_counter() - t_start - sum(phases.values())
    for i in range(int(mix["warmup_steps"])):
        runner.run(count=1)
        phases[f"warm{i}"] = time.perf_counter() - t_start - sum(phases.values())
    setup_s = time.perf_counter() - t_start
    win = runner.run(seconds=seconds)
    mem = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr = traced(runner, int(mix["trace_steps"])) if trace else None

    # the program's state is freed before the reference runs
    records = runner.records
    del runner, program
    if cuda:
        torch.cuda.empty_cache()
    pb = R.problem_from_config(cfg, root)
    t_ref = time.perf_counter()
    gaps, where, trails = K.run_reference(pb, lanes, records, device, int(mix["check"]["block"]))
    chain = K.run_chain(pb, lanes, records, device, int(mix["check"]["chain"]))
    ref_s = time.perf_counter() - t_ref
    nums = K.numbers(gaps, float(cell.limits["u_flip"]), chain)
    correct, checks = K.judge(nums, cell.limits)

    run = {"batch": lanes.batch, "chips": 1, "setup_s": setup_s,
           "window": win, "trace": tr, "shapes": W.Shapes(cfg)}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = C.reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(mem)}
    result = {"correct": bool(correct), "attempted": int(win.steps * lanes.batch),
              "failed": int(win.nonfinite), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        result["breakdown"] = {"device_ops": top(tr["by_name"]), "idle_gaps": top(tr["gaps"])}
    result["checks"] = checks

    log(f"window: {win.steps} steps in {win.seconds:.3f} s; setup {setup_s:.3f} s; "
        f"reference {ref_s:.3f} s over {nums['n']} scenario-steps and a chain of "
        f"{nums['chain_n']}; card {power_limit() if cuda else '-'}", file=sys.stderr)
    log("setup phases (s): " + json.dumps({k: round(v, 3) for k, v in phases.items()}),
        file=sys.stderr)
    log("seen: " + json.dumps({k: v for k, v in nums.items()}), file=sys.stderr)
    flips = np.nonzero(gaps["u"] > float(cell.limits["u_flip"]))[0]
    flips = flips[np.argsort(-gaps["u"][flips], kind="stable")]     # the largest first
    for i in flips[:12]:
        log("past u_flip: " + json.dumps(_flip(i, gaps, where, trails, mix, pb)), file=sys.stderr)
    if verdicts:
        from benchmark.harness import verdict as V
        flat = [(rec, i) for rec in records for i in range(len(rec.ids))]
        chunk = [flat[i] for i in flips[:verdicts]]
        for v in V.judge(pb, lanes, chunk, device, gaps["u"][flips[:verdicts]],
                         pb.iter_threshold) if chunk else []:
            log("verdict: " + json.dumps(v), file=sys.stderr)
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result


def _flip(i, gaps, where, trails, mix, pb):
    """What the reference saw at one scenario-step whose actions part: its
    stop measure after the first PAN iteration, and whether the program's
    final QP solution lies nearer the reference's first or last iteration."""
    import torch
    block = int(mix["check"]["block"])
    t = trails[i // block]
    j = i % block
    got = t["got_x"][j]
    first, last = t["x"][0][j], t["x"][-1][j]
    return {"step": where[i][0], "scenario": where[i][1],
            **{f: float(gaps[f][i]) for f in ("u", "mu", "yw", "pts")},
            "ref_stop_measure_it0": float(t["diff"][0][j]), "threshold": pb.iter_threshold,
            "got_vs_ref_it0": float(torch.max(torch.abs(got - first))),
            "got_vs_ref_last": float(torch.max(torch.abs(got - last)))}


def main(argv=None) -> int:
    args = parse(argv)
    for var, rel in CACHES.items():
        os.environ[var] = os.path.join(ROOT, rel)
    sys.pycache_prefix = os.path.join(ROOT, PYCACHE)
    sys.dont_write_bytecode = False
    sys.path.insert(0, ROOT)
    import torch
    phases = {"torch": time.perf_counter() - T_START}

    from benchmark.harness import cells as C

    cell = C.resolve(ROOT, args.workload)
    if cell.chips != 1:
        print(f"{args.workload} asks for {cell.chips} cards; this harness drives one: not measured",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {have} available: not measured",
              file=sys.stderr)
        return 2
    phases["cuda"] = time.perf_counter() - T_START - phases["torch"]
    result = measure(ROOT, cell, args.seed, args.seconds, args.trace, torch.device("cuda", 0),
                     precision="default" if args.control == "tf32" else None,
                     fault=args.fault, t_start=T_START, verdicts=args.verdicts, phases=phases)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"the process holds {found}: no result", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
