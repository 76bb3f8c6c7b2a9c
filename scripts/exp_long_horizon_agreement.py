"""How far the planner step on the card and on the CPU can differ, by horizon.

    python3 scripts/exp_long_horizon_agreement.py [--B 64] [--steps 2]

Runs ``chip_smoke.py``'s flagship batch (diff robot, P=2048 seeded points,
B scenarios, chained steps) on the card and the same scenarios on the CPU
(the kernels' plain versions), for T=10 and T=30 with K=10 (every QP stage
on its kernel), T=30 with K=12 and T=33 with K=10 (stages on their plain
routes by admission, ``ops/qp.py``), each with the shipped budget of the
second PAN iteration's warm solve (``admm_warm_iters=120``) and with the
full one (240, as the first iteration). Prints one JSON line per case: the
largest and median |opt_u| difference over scenarios and the count of
scenarios above 5e-4. Where the difference comes from the warm solve
stopping short of the optimum, the full budget shrinks it. Needs one CUDA
card; prints the card's name and power limit.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

CASES = ((10, 10), (30, 10), (30, 12), (33, 10))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--B", type=int, default=64)
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        CS.fail("no CUDA device is available")
    import neupan_torch  # noqa: F401  (pins float32 precision)

    dev = torch.device("cuda", 0)
    for T, K in CASES:
        for warm in (120, None):
            spec, encoder, geom, adjust, data = CS.flagship(torch, dev, args.B, T=T, K=K,
                                                            admm_warm_iters=warm)
            outs = CS.run_chain(torch, spec, encoder, geom, adjust, data, dev=dev,
                                steps=args.steps)
            outs_cpu = CS.run_chain(torch, spec, *CS.to_cpu(encoder, geom, adjust), data,
                                    dev=torch.device("cpu"), steps=args.steps)
            per_step = []
            for o, oc in zip(outs, outs_cpu):
                d = (o.opt_u.cpu() - oc.opt_u).abs().amax(dim=(1, 2))
                per_step.append({"max": float(d.max()), "median": float(d.median()),
                                 "above_5e-4": int((d > 5e-4).sum())})
            print(json.dumps({"T": T, "K": K, "B": args.B,
                              "admm_warm_iters": 240 if warm is None else warm,
                              "opt_u_card_vs_cpu_by_step": per_step}), flush=True)
    print(CS.card_name_and_power())


if __name__ == "__main__":
    main()
