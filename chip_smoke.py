#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold it to account.

    python3 chip_smoke.py        # needs one CUDA card

1. Build: compiles every kernel of ``neupan_torch/csrc`` from the sources
   in this checkout (one nvcc call, one library).
2. Kernel phase: each hand-written kernel runs at the main path's shapes
   with B=512 on seeded inputs, is held against its plain PyTorch version
   on the same inputs, and is timed with CUDA events beside its plain
   version, its bound and, where one PyTorch call computes the same
   function, that call.
3. Slice phase: the flagship planner batch (diff robot, T=10, P=2048,
   K=10, B=512, the deployed diff checkpoint) runs three chained
   ``batched_planner_step`` calls on the card with every launch counter
   set to 0 just before; each kernel must have been launched exactly as
   often as one step launches it, times three. The first 32 scenarios are
   rerun on the CPU (plain versions): opt_u must agree to 5e-4, nrmp_valid
   exactly. Then ms/step and solves/s at B=512 and B=1, and a
   torch.profiler pass over the three steps for the device's busy time
   (its per-kernel table goes to standard error).

Prints the kernels' JSON line, the step-time JSON line, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result line, when no card is present or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

B_MAIN = 512
B_CPU = 32
STEPS = 3
PEAK_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
# launches of each kernel in one planner step at the default config
# (2 PAN iterations): select 1 per iteration; sweep 1 equality Gram + 2 ADMM
# phases per QP; admm 2 phases per QP; polish 5 rounds per QP
PER_STEP = {"select": 2, "sweep": 6, "admm": 4, "polish": 10}
REPLACES = {
    "select": "neupan_tpu/ops/pallas/select.py:170",
    "sweep": "neupan_tpu/ops/pallas/sweep.py:93",
    "admm": "neupan_tpu/ops/pallas/admm.py:94",
    "polish": "neupan_tpu/ops/pallas/polish.py:136",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float):
    """Least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


# -- work counts from the shapes (float operations, compares included) -------

def select_work(B, Tp1, P, V, E, K):
    per_point = 12 + 20 * V + 5 * E + 2 + K   # flow, edges, faces, key, extraction
    ops = B * Tp1 * P * per_point
    nbytes = B * P * (2 * 4 + 2 * 4 + 1) + B * 5 * Tp1 * 4 + 2 * B * Tp1 * K * 4
    return ops, nbytes


def sweep_work(B, n):
    return B * n * (2 * n * n + n), 2 * B * n * n * 4


def admm_work(B, k, m, iters):
    per_iter = 4 * m * k + 2 * k * k + 16 * m + 6 * k
    floats = k * k + m * k + 3 * k + 8 * m
    return B * iters * per_iter, B * floats * 4


def polish_work(B, k, na, refine):
    inv = lambda n: 2 * n * n * 2 + 2 * n + 2 * n ** 3 + n * n
    kkt = 6 * k * k + 4 * na * k + 2 * na * na + 6 * k + na
    ops = (3 * k * k + inv(k) + 2 * na * k * k + 2 * na * na * k + na + inv(na) + kkt
           + refine * (2 * k * k + 4 * na * k + 4 * k + 6 * na + kkt))
    floats = 2 * k * k + na * k + 4 * k + 2 * na + k + na
    return B * ops, B * floats * 4


# -- phases -------------------------------------------------------------------

def kernel_phase(torch, dev):
    from neupan_torch.ops.kernels import admm as AD
    from neupan_torch.ops.kernels import polish as PO
    from neupan_torch.ops.kernels import select as SE
    from neupan_torch.ops.kernels import sweep as SW
    from neupan_torch.ops.qp import _spd_inverse
    from neupan_torch.robot import Robot

    rng = np.random.default_rng(0)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    B = B_MAIN
    res = {}

    # select: P=2048, T+1=11, K=10 on the flagship diff robot
    T, P, K = 10, 2048, 10
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    verts, G, h = robot.tensors(dev)
    pts = f(rng.uniform(-4.0, 9.0, (B, 2, P)))
    vels = f(rng.normal(scale=0.3, size=(B, 2, P)))
    mask = torch.tensor(rng.uniform(size=(B, P)) < 0.95, device=dev)
    theta = f(rng.uniform(-np.pi, np.pi, (B, T + 1)))
    c, s = torch.cos(theta), torch.sin(theta)
    R_all = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    trans = f(rng.uniform(-1.0, 1.0, (B, T + 1, 2)))
    args = (pts, vels, mask, R_all, trans, robot.dt, verts, G, h, K)
    keys, idx = SE.select_topk_flow(*args)
    keys_p, idx_p = SE.select_topk_flow_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(idx, idx_p), "select: kernel indices differ from the plain version")
    err = float((keys - keys_p).abs().max())
    ops, nbytes = select_work(B, T + 1, P, verts.shape[1], G.shape[0], K)
    # the transform tables are built once, so the timed call is the kernel alone
    tab_args = (pts, vels, mask, *SE.flow_tables(R_all, trans, robot.dt, verts, G, h), K)
    res["select"] = dict(
        shape=f"B={B} T+1={T + 1} P={P} K={K}", max_abs_err=err,
        ms=time_ms(torch, lambda: SE.select_from_tables(*tab_args), 50),
        plain_ms=time_ms(torch, lambda: SE.select_from_tables_plain(*tab_args), 5),
        library_ms=None, bound=bound(ops, nbytes))

    # sweep: the Jacobi-scaled, ridged SPD matrices at n=30, 33 (main path), 90
    sweep_err = 0.0
    for n in (30, 33, 90):
        Q = rng.normal(size=(B, n, n))
        M = Q @ np.swapaxes(Q, 1, 2) / n + np.eye(n)[None]
        dj = 1 / np.sqrt(np.einsum("bii->bi", M))
        Mt = f(M * dj[:, :, None] * dj[:, None, :] + 1e-7 * np.eye(n)[None])
        X, Xp = SW.sweep_spd_inverse(Mt), SW.sweep_spd_inverse_plain(Mt)
        torch.cuda.synchronize()
        e = float((X - Xp).abs().max())
        rel = e / float(Xp.abs().max())
        check(rel < 3e-5, f"sweep n={n}: relative error {rel} against the plain version")
        sweep_err = max(sweep_err, e)
        if n == 30:
            ops, nbytes = sweep_work(B, n)
            res["sweep"] = dict(
                shape=f"B={B} n={n}",
                ms=time_ms(torch, lambda: SW.sweep_spd_inverse(Mt), 50),
                plain_ms=time_ms(torch, lambda: SW.sweep_spd_inverse_plain(Mt), 5),
                library_ms=time_ms(torch, lambda: torch.linalg.inv(Mt), 20),
                bound=bound(ops, nbytes))
        res.setdefault("sweep_by_n", {})[n] = dict(
            ms=time_ms(torch, lambda: SW.sweep_spd_inverse(Mt), 20),
            library_ms=time_ms(torch, lambda: torch.linalg.inv(Mt), 10))
    res["sweep"]["max_abs_err"] = sweep_err

    # admm: k=30, m=148, 120 iterations (the first PAN iteration's phase)
    k, m, iters = 30, 148, 120
    Hs = rng.normal(size=(B, k, k))
    Hs = Hs @ np.swapaxes(Hs, 1, 2) / k + np.eye(k)
    As = rng.normal(size=(B, m, k)) * 0.3
    ls = rng.normal(size=(B, m)) - 1
    soft = np.where(rng.uniform(size=(B, m)) < 0.5, 10.0, 0.0)
    us = np.where(soft > 0, 1e20, ls + np.abs(rng.normal(size=(B, m))) + 0.5)
    # one rho per scenario, as the condensed phases set it (no equality rows
    # remain after the condensation)
    rho = np.repeat(rng.uniform(0.5, 2.0, (B, 1)), m, axis=1)
    Hs_t, As_t, rho_t = f(Hs), f(As), f(rho)
    M = Hs_t + 1e-6 * torch.eye(k, device=dev) + torch.bmm(
        (As_t * rho_t[:, :, None]).transpose(1, 2), As_t)
    Minv = _spd_inverse(M)
    ad_args = (Minv, As_t, f(rng.normal(size=(B, k))), f(ls), f(us), f(soft), rho_t,
               f(rng.normal(size=(B, k)) * 0.1), f(np.clip(rng.normal(size=(B, m)), ls, us)),
               f(rng.normal(size=(B, m)) * 0.1))
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    out, outp = AD.admm_iterate(*ad_args, **kw), AD.admm_iterate_plain(*ad_args, **kw)
    torch.cuda.synchronize()
    e_wz = max(float((out[i] - outp[i]).abs().max()) for i in (0, 1))
    e_y = float((out[2] - outp[2]).abs().max())
    check(e_wz <= 1e-4, f"admm: w/z differ from the plain version by {e_wz}")
    check(bool(((out[2] - outp[2]).abs() <= 1e-3 + 1e-2 * outp[2].abs()).all()),
          f"admm: y differs from the plain version by {e_y}")
    ops, nbytes = admm_work(B, k, m, iters)
    res["admm"] = dict(
        shape=f"B={B} k={k} m={m} iters={iters}", max_abs_err=max(e_wz, e_y),
        ms=time_ms(torch, lambda: AD.admm_iterate(*ad_args, **kw), 20),
        plain_ms=time_ms(torch, lambda: AD.admm_iterate_plain(*ad_args, **kw), 3),
        library_ms=None, bound=bound(ops, nbytes))

    # polish: k=30, na=18, refine=7
    na, refine = 18, 7
    Qm = rng.normal(size=(B, k, k))
    Hr = Qm @ np.swapaxes(Qm, 1, 2) / k + np.eye(k)
    DAn = rng.normal(size=(B, na, k)) * 0.3
    d = (rng.uniform(size=(B, na)) < 0.6).astype(np.float64)
    DAn = DAn / np.maximum(np.linalg.norm(DAn, axis=2, keepdims=True), 1e-8) * d[:, :, None]
    fix = (rng.uniform(size=(B, k)) < 0.4).astype(np.float64)
    po_args = (f(Hr), f(Hr - 1e-6 * np.eye(k)), f(DAn), f(rng.normal(size=(B, k))),
               f(rng.normal(size=(B, k))), f(rng.normal(size=(B, na)) * d),
               f(rng.normal(size=(B, k)) * fix), f(fix), f(d))
    out, outp = PO.box_candidate(*po_args, refine=refine), PO.box_candidate_plain(
        *po_args, refine=refine)
    torch.cuda.synchronize()
    e = max(float((o - p).abs().max()) for o, p in zip(out, outp))
    rel = max(float((o - p).abs().max() / p.abs().max().clamp(min=1e-9))
              for o, p in zip(out, outp))
    check(rel < 2e-4, f"polish: relative error {rel} against the plain version")
    ops, nbytes = polish_work(B, k, na, refine)
    res["polish"] = dict(
        shape=f"B={B} k={k} na={na} refine={refine}", max_abs_err=e,
        ms=time_ms(torch, lambda: PO.box_candidate(*po_args, refine=refine), 50),
        plain_ms=time_ms(torch, lambda: PO.box_candidate_plain(*po_args, refine=refine), 5),
        library_ms=None, bound=bound(ops, nbytes))
    return res


def flagship(torch, dev, B, seed=0):
    """bench.py's flagship spec and batch, built by the port itself."""
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
    from neupan_torch.ops.pan import PANSpec
    from neupan_torch.robot import Robot

    T, P, K = 10, 2048, 10
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, iter_num=2, iter_threshold=0.1, dune_max_num=P)
    rng = np.random.default_rng(seed)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    ref_line = np.linspace([0, 0, 0], [4, 0, 0], T + 1).T[None]
    data = dict(
        nom_u=torch.zeros((B, 2, T), device=dev),
        ref_s=f(np.repeat(ref_line, B, 0)), ref_us=torch.full((B, T), 4.0, device=dev),
        pts=[f(rng.uniform(1.0, 9.0, (B, 2, P))) for _ in range(STEPS)],
        vels=torch.zeros((B, 2, P), device=dev),
        mask=torch.ones((B, P), dtype=torch.bool, device=dev))
    data["nom_s"] = robot.rollout(torch.zeros((B, 3), device=dev), data["nom_u"])
    encoder = load_checkpoint(os.path.join(ROOT, "examples/model/diff_robot_default/model.npz"),
                              device=dev)
    adjust = AdjustParams(*(torch.tensor(v, device=dev) for v in (1.0, 1.0, 10.0, 1.0, 0.1)))
    return spec, encoder, robot.tensors(dev), adjust, data


def run_chain(torch, spec, encoder, geom, adjust, data, sl=slice(None), dev=None):
    """STEPS chained planner steps; returns the outputs of each step."""
    from neupan_torch.parallel import batched_init_state, batched_planner_step

    mv = lambda t: t[sl].to(dev)
    nom_s, nom_u = mv(data["nom_s"]), mv(data["nom_u"])
    B = nom_s.shape[0]
    state = batched_init_state(spec, B, dev)
    outs = []
    for i in range(STEPS):
        out = batched_planner_step(spec, encoder, *geom, adjust, nom_s, nom_u,
                                   mv(data["ref_s"]), mv(data["ref_us"]), mv(data["pts"][i]),
                                   mv(data["vels"]), mv(data["mask"]), state)
        outs.append(out)
        nom_s, nom_u, state = out.opt_s, out.opt_u, out.state
    return outs


def step_ms(torch, spec, encoder, geom, adjust, data, B, reps):
    """Host-clock ms per chained planner step at batch B, ending in a sync."""
    from neupan_torch.parallel import batched_init_state, batched_planner_step

    sl = slice(0, B)
    args = [data[k][sl] for k in ("nom_s", "nom_u", "ref_s", "ref_us")]
    pts, vels, mask = data["pts"][0][sl], data["vels"][sl], data["mask"][sl]
    state = batched_init_state(spec, B, pts.device)

    def one(nom_s, nom_u, state):
        out = batched_planner_step(spec, encoder, *geom, adjust, nom_s, nom_u, args[2],
                                   args[3], pts, vels, mask, state)
        return out.opt_s, out.opt_u, out.state

    nom_s, nom_u = args[0], args[1]
    for _ in range(2):
        nom_s, nom_u, state = one(nom_s, nom_u, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        nom_s, nom_u, state = one(nom_s, nom_u, state)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def slice_phase(torch, dev):
    from neupan_torch.ops.kernels.admm import admm_iterate
    from neupan_torch.ops.kernels.polish import box_candidate
    from neupan_torch.ops.kernels.select import select_topk_flow
    from neupan_torch.ops.kernels.sweep import sweep_spd_inverse

    wrappers = {"select": select_topk_flow, "sweep": sweep_spd_inverse,
                "admm": admm_iterate, "polish": box_candidate}
    spec, encoder, geom, adjust, data = flagship(torch, dev, B_MAIN)

    for w in wrappers.values():
        w.launches = 0
    outs = run_chain(torch, spec, encoder, geom, adjust, data, dev=dev)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    for name, per in PER_STEP.items():
        check(launches[name] == per * STEPS,
              f"{name}: {launches[name]} launches in {STEPS} steps, expected {per * STEPS}")

    for out in outs:
        check(tuple(out.opt_u.shape) == (B_MAIN, 2, spec.robot.T), "opt_u shape")
        check(bool(torch.isfinite(out.opt_u).all() & torch.isfinite(out.opt_s).all()),
              "non-finite planner output on the card")

    # the same chained inputs, first B_CPU scenarios, through the plain versions
    cpu = torch.device("cpu")
    enc_cpu = encoder.to(cpu)
    geom_cpu = tuple(t.to(cpu) for t in geom)
    adj_cpu = type(adjust)(*(t.to(cpu) for t in adjust))
    outs_cpu = run_chain(torch, spec, enc_cpu, geom_cpu, adj_cpu, data,
                         sl=slice(0, B_CPU), dev=cpu)
    encoder.to(dev)
    du = []
    for i, (o, oc) in enumerate(zip(outs, outs_cpu)):
        d = float((o.opt_u[:B_CPU].cpu() - oc.opt_u).abs().max())
        du.append(d)
        check(d <= 5e-4, f"step {i}: opt_u card vs CPU differ by {d} > 5e-4")
        check(torch.equal(o.nrmp_valid[:B_CPU].cpu(), oc.nrmp_valid),
              f"step {i}: nrmp_valid differs between card and CPU")

    ms_main = step_ms(torch, spec, encoder, geom, adjust, data, B_MAIN, 10)
    ms_one = step_ms(torch, spec, encoder, geom, adjust, data, 1, 10)
    steps = {"B": B_MAIN, "ms_per_step": ms_main, "solves_per_s": B_MAIN / ms_main * 1e3,
             "B1_ms_per_step": ms_one, "B1_solves_per_s": 1e3 / ms_one,
             "opt_u_card_vs_cpu_max": max(du), "cpu_scenarios": B_CPU}
    prof, table = profile_step(torch, spec, encoder, geom, adjust, data)
    print(table, file=sys.stderr)
    steps.update(prof, device_idle_share=1.0 - prof["device_busy_ms_per_step"] / ms_main)
    return launches, steps


def profile_step(torch, spec, encoder, geom, adjust, data):
    """Device kernel time over the chained B=512 steps (torch.profiler).

    Returns the device's kernel-busy time and kernel count per step, and a
    table of device time by kernel name.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_chain(torch, spec, encoder, geom, adjust, data, dev=data["pts"][0].device)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ours = ("select_flow_kernel", "sweep_kernel", "admm_kernel", "box_candidate_kernel")
    ours_us = sum(t for n, t in by_name.items() if any(k in n for k in ours))
    lines = [f"device kernels over {STEPS} steps, by name (us, share of busy time)"]
    lines += [f"{t:12.1f} {t / busy_us:7.2%}  {name[:140]}"
              for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:30]]
    summary = {"device_busy_ms_per_step": busy_us / 1e3 / STEPS,
               "device_kernels_per_step": len(kernels) / STEPS,
               "hand_kernels_ms_per_step": ours_us / 1e3 / STEPS}
    return summary, "\n".join(lines)


def card_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    import neupan_torch  # noqa: F401  (pins float32 precision)
    from neupan_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    with open(lib.with_suffix(".log")) as fh:
        usage = [ln.strip() for ln in fh if "entry function" in ln or "registers" in ln]
    print("build: " + "\n  ".join(usage), file=sys.stderr)

    kern = kernel_phase(torch, dev)
    launches, steps = slice_phase(torch, dev)

    entries = []
    for name in ("select", "sweep", "admm", "polish"):
        r = kern[name]
        entries.append({
            "name": name, "route": "cuda", "source": f"neupan_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"build_s": build_s, "sweep_by_n": kern["sweep_by_n"], "step": steps}))
    print(card_name_and_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
