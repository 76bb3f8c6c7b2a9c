"""Closed-loop sweep of the PyTorch port over every shipped scenario config.

The counterpart of ``scripts/sweep_scenarios.py`` for ``neupan_torch``:
each ``examples/*/*/{env,planner}.yaml`` pair is driven through the port's
planner and ``Sim2D`` (``examples/run_exp_torch.py``) and must arrive
without a latched collision and with zero contact steps, the same gate as
the JAX sweep. Writes ``sweep_results_torch.json`` at the root of the
checkout (never ``sweep_results.json``, the JAX package's record), with the
device, and on a card its name and power limit; exits nonzero on any
failure. Imports no JAX.

    python scripts/sweep_scenarios_torch.py [max_steps] [--device cpu] [--only corridor/diff ...]

The planner runs on the CUDA card unless ``--device`` names another device.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples"))

import run_exp_torch  # noqa: E402


def card_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def main(max_steps=700, device=None, only=None, out=None):
    import torch

    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device is available; pass --device cpu to sweep on the CPU")
    results = {}
    for pf in sorted(glob.glob(os.path.join(REPO, "examples/*/*/planner.yaml"))):
        d = os.path.dirname(pf)
        scen, kin = d.split(os.sep)[-2:]
        if only and f"{scen}/{kin}" not in only:
            continue
        t0 = time.time()
        pv = scen.startswith("dyna")             # dynamic scenes use -v
        rev = scen == "reverse" and kin == "diff"
        try:
            r = run_exp_torch.main(os.path.join(d, "env.yaml"), pf, point_vel=pv,
                                   max_steps=max_steps, reverse=rev, quiet=True,
                                   device=str(dev))
        except Exception:   # recorded as a failed scenario; the sweep exits nonzero
            traceback.print_exc()
            r = dict(arrived=False, collided=False, steps=0, contacts=0,
                     error=traceback.format_exc(limit=3)[-400:])
        r["wall_s"] = round(time.time() - t0, 1)
        results[f"{scen}/{kin}"] = r
        print(f"{scen}/{kin}: {r}", flush=True)

    ok = sum(1 for r in results.values() if r["arrived"] and not r["collided"])
    print(f"\n{ok}/{len(results)} scenarios arrived without collision")
    bad_contacts = {k: r["contacts"] for k, r in results.items() if r["contacts"] > 0}
    for k, c in bad_contacts.items():
        print(f"CONTACT GATE FAIL: {k} has {c} contact steps (allowed 0)")
    if not bad_contacts:
        print("contact gate: PASS")

    record = {"device": str(dev), "max_steps": max_steps, "scenarios": results}
    if dev.type == "cuda":
        record["card"] = card_name_and_power()
    with open(out or os.path.join(REPO, "sweep_results_torch.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0 if (ok == len(results) and not bad_contacts) else 1


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("max_steps", nargs="?", type=int, default=700)
    parser.add_argument("--device", default=None,
                        help="torch device of the planners (default: the CUDA card)")
    parser.add_argument("--only", nargs="*", default=None,
                        help="scenario/kinematics names to run (default: all)")
    parser.add_argument("--out", default=None, help="results file (default: "
                        "sweep_results_torch.json at the root of the checkout)")
    args = parser.parse_args()
    sys.exit(main(args.max_steps, args.device, args.only, args.out))
