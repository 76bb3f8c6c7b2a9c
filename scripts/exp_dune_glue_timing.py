#!/usr/bin/env python3
"""Device time of four forms of the DUNE glue ``ops/dune.py:_lam_and_distance``.

    python3 scripts/exp_dune_glue_timing.py        # needs one CUDA card

lam = -R G' mu and d = mu'(G p0 - h) of the encoder's duals mu
(B, T+1, N, E) at the robot-frame points p0 (B, T+1, 2, N), written as:
batched einsums (cuBLAS runs the (2 x E)(E x N) products as a gemv),
broadcast products summed over E and over the two coordinates (the form
``_lam_and_distance`` takes), sums of E broadcast slices, and one matmul
of mu by [G | h] followed by elementwise steps. Each is timed as device
time (``chip_smoke.py:graph_ms``) at B=512, T+1=11, E=4 with N = 2048
(``dune_select="mlp"``, every point) and N = 10 (the fused path's K
winners), and held against a float64 evaluation. Prints one line per form
and the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import graph_ms  # noqa: E402
from neupan_torch.ops.dune import _lam_and_distance  # noqa: E402
from neupan_torch.robot import Robot  # noqa: E402


def einsum_form(mu, pf, R_all, G, h):
    RG = torch.einsum("ntab,eb->ntae", R_all, G)
    lam = -torch.einsum("ntae,ntke->ntak", RG, mu)
    Gp = torch.einsum("eb,ntbk->ntek", G, pf) - h.reshape(1, 1, -1, 1)
    return lam, torch.einsum("ntke,ntek->ntk", mu, Gp)


def slices_form(mu, pf, R_all, G, h):
    E = G.shape[0]
    g0 = sum(mu[..., e] * G[e, 0] for e in range(E))
    g1 = sum(mu[..., e] * G[e, 1] for e in range(E))
    mh = sum(mu[..., e] * h[e, 0] for e in range(E))
    lam = -(R_all[..., 0:1] * g0[:, :, None] + R_all[..., 1:2] * g1[:, :, None])
    return lam, g0 * pf[:, :, 0] + g1 * pf[:, :, 1] - mh


def matmul_form(mu, pf, R_all, G, h):
    g0, g1, mh = (mu @ torch.cat([G, h.reshape(-1, 1)], 1)).unbind(-1)
    lam = -(R_all[..., 0:1] * g0[:, :, None] + R_all[..., 1:2] * g1[:, :, None])
    return lam, g0 * pf[:, :, 0] + g1 * pf[:, :, 1] - mh


FORMS = {"einsum": einsum_form, "broadcast (_lam_and_distance)": _lam_and_distance,
         "slices": slices_form, "matmul": matmul_form}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("exp_dune_glue_timing: no CUDA device is available")
    import neupan_torch  # noqa: F401  (pins float32 matmuls)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    B, Tp1, P = 512, 11, 2048
    robot = Robot.create(receding=Tp1 - 1, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    _, G, h = robot.tensors(dev)
    mu = torch.rand(B, Tp1, P, G.shape[0], generator=gen).to(dev)
    pf = (torch.rand(B, Tp1, 2, P, generator=gen) * 10).to(dev)
    th = torch.rand(B, Tp1, generator=gen).to(dev) * 6.3
    c, s = torch.cos(th), torch.sin(th)
    R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    with torch.no_grad():
        ref = einsum_form(mu.double(), pf.double(), R.double(), G.double(), h.double())
        for name, fn in FORMS.items():
            lam, d = fn(mu, pf, R, G, h)
            err = max(float((lam - ref[0]).abs().max()), float((d - ref[1]).abs().max()))
            ms = graph_ms(torch, lambda: fn(mu, pf, R, G, h), reps=10)
            k_mu, k_pf = mu[:, :, :10].contiguous(), pf[..., :10].contiguous()
            ms_k = graph_ms(torch, lambda: fn(k_mu, k_pf, R, G, h))
            print(f"{name}: N={P} {ms:.4f} ms, N=10 {ms_k:.5f} ms, max error vs float64 {err:.3g}")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
