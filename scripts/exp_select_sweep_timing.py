#!/usr/bin/env python3
"""Device time of the selection and sweep kernels of this checkout, on one card.

    python3 scripts/exp_select_sweep_timing.py [--label NAME]

Times, as device time (50 launches captured in a CUDA graph, replayed
between CUDA events, as chip_smoke.py's ``graph_ms``): the flow selection
(``select_from_tables``) and the materialized one
(``select_topk_from_tables``) at the flagship shape (B=512, T+1=11,
P=2048, K=10) and the facade's (B=1, P=100), the flow selection also
with K=1 (the key pass and a single extraction round); the sweep on pre-scaled
input (``sweep_spd_inverse``) at n=30, 33, 90 with B=512, n=30 with
B=1, and n=1 and 16 with B=512 (the time per pivot and the fixed cost); and ``spd_inverse_scaled``, what the QP calls, at the same shapes.
It reads only functions that every version of the port has, so copies of
two commits can be timed in turns in one call (unpack the other commit
with ``git archive`` into a directory that .gitignore lists and run its
copy of this script). Prints one JSON line with the card's name and power
limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def graph_ms(torch, fn, reps: int = 50, replays: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=os.path.basename(ROOT))
    label = ap.parse_args().label

    import torch

    if not torch.cuda.is_available():
        sys.exit("exp_select_sweep_timing: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from neupan_torch.ops.kernels import select as SE
    from neupan_torch.ops.kernels import sweep as SW
    from neupan_torch.robot import Robot

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    out = {"label": label}

    T, K = 10, 10
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    verts, G, h = robot.tensors(dev)
    for B, P in ((512, 2048), (1, 100)):
        pts = f(rng.uniform(-4.0, 9.0, (B, 2, P)))
        vels = f(rng.normal(scale=0.3, size=(B, 2, P)))
        mask = torch.tensor(rng.uniform(size=(B, P)) < 0.95, device=dev)
        theta = f(rng.uniform(-np.pi, np.pi, (B, T + 1)))
        c, s = torch.cos(theta), torch.sin(theta)
        R_all = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
        trans = f(rng.uniform(-1.0, 1.0, (B, T + 1, 2)))
        tab = (pts, vels, mask, *SE.flow_tables(R_all, trans, robot.dt, verts, G, h), K)
        flow = torch.stack(SE.flow_from_tables(pts, vels, tab[3]), dim=2).contiguous()
        flow_args = (flow, mask, *tab[4:])
        idx, idx_p = SE.select_from_tables(*tab)[1], SE.select_from_tables_plain(*tab)[1]
        idx5 = SE.select_topk_from_tables(*flow_args)[1]
        torch.cuda.synchronize()
        if not (torch.equal(idx, idx_p) and torch.equal(idx5, idx_p)):
            sys.exit(f"exp_select_sweep_timing: select indices differ from the plain version (B={B})")
        out[f"select_B{B}_P{P}_ms"] = graph_ms(torch, lambda: SE.select_from_tables(*tab))
        one = (*tab[:-1], 1)          # one extraction round: the key pass and one argmin
        out[f"select_B{B}_P{P}_K1_ms"] = graph_ms(torch, lambda: SE.select_from_tables(*one))
        out[f"select_topk_B{B}_P{P}_ms"] = graph_ms(torch, lambda: SE.select_topk_from_tables(*flow_args))

    for B, n in ((512, 30), (512, 33), (512, 90), (1, 30), (512, 1), (512, 16)):
        Q = rng.normal(size=(B, n, n))
        sc = 10.0 ** rng.uniform(-2, 2, (B, n, 1))
        M = sc * (Q @ np.swapaxes(Q, 1, 2) / n + np.eye(n)[None]) * np.swapaxes(sc, 1, 2)
        M = (M + np.swapaxes(M, 1, 2)) / 2
        dj = 1 / np.sqrt(np.einsum("bii->bi", M))
        Mt, M = f(M * dj[:, :, None] * dj[:, None, :] + 1e-7 * np.eye(n)[None]), f(M)
        U, Up = SW.sweep_spd_inverse(Mt), SW.sweep_spd_inverse_plain(Mt)
        torch.cuda.synchronize()
        rel = float((U - Up).abs().max() / Up.abs().max())
        if not rel < 3e-5:
            sys.exit(f"exp_select_sweep_timing: sweep n={n} relative error {rel}")
        out[f"sweep_B{B}_n{n}_ms"] = graph_ms(torch, lambda: SW.sweep_spd_inverse(Mt))
        out[f"spd_inverse_scaled_B{B}_n{n}_ms"] = graph_ms(torch, lambda: SW.spd_inverse_scaled(M))

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    out["card"] = card.stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
