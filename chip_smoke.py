#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold it to account.

    python3 chip_smoke.py        # needs one CUDA card

1. Build: compiles every kernel of ``neupan_torch/csrc`` from the sources
   in this checkout (one nvcc call, one library).
2. Kernel phase: each of the six hand-written kernels runs at the shapes
   its path gives it with B=512 on seeded inputs, is held against its
   plain PyTorch version on the same inputs, and is timed on the card
   beside its plain version, its bound and, where one PyTorch call computes
   the same function, that call: the kernels by CUDA events around a CUDA
   graph of 50 launches (``graph_ms``: the wrappers' Python would otherwise
   be what is timed), as is ``encoder(points)`` beside the fused MLP; the
   plain versions and the other PyTorch routes launch by launch. The two
   selection kernels must return identical indices on the same frames,
   also at the facade's shape (B=1, P=100) and where 64
   scenarios have fewer than K unmasked points and one has none (the
   trailing slots repeat the lowest-index 1e9 point); the sweep is timed
   as the QP calls it (``spd_inverse_scaled``, the scaling in the kernel)
   and on pre-scaled input, each held to 3e-5 of its plain version at
   n=30, 33, 48, 63 and 90 (48 and 63 also beside the plain version's
   time); admm also runs at the full-space flagship shape (n=63, m=181,
   33 equality rows) against its plain version; the fused MLP is also held
   against a float64 evaluation of the same weights, with the diff
   checkpoint and, at full width, with the acker one; its bound is given
   twice, for float32 on the CUDA cores and for the tensor-core design
   (``mlp_bounds``). select, select_topk,
   sweep, admm and polish are also timed at B=1, the facade's batch. Each
   kernel's registers and spills come from nvcc's resource report
   (``libneupan.log``).
3. Paths, each on the flagship batch (diff robot, T=10, P=2048, K=10,
   B=512, the deployed diff checkpoint) with every launch counter set to 0
   just before and read just after; each kernel must have been launched
   exactly as often as the path launches it:
   * fused: three chained ``batched_planner_step`` calls on the default
     path (selection with the point flow built in the kernel, the fused MLP
     on the winners). The first 32 scenarios are rerun on the CPU (plain
     versions): opt_u must agree to 5e-4, nrmp_valid exactly. Then ms/step
     at B=512 and B=1 and a torch.profiler pass for the device's busy time.
   * dune: ``generate_point_flow`` + ``dune_forward(select="exact")`` with
     both kernel switches on (the materialized-flow selection kernel and
     the fused MLP on the winners), against the same call on the CPU.
   * mlp: three chained steps with ``dune_select="mlp"`` and the fused MLP
     kernel on all P points, the reference-parity ranking; CPU comparison,
     ms/step and profiler pass as for the fused path. The profiler passes
     also give the device time of ``ops/dune.py:_lam_and_distance`` per
     DUNE call.
   * facade: a ``NeuPan`` planner built from kwargs for the corridor/diff
     configuration plans five ticks on seeded points on the card, and a
     planner without obstacle slots (K=0) three; a CPU planner of each
     kind is fed the same states and points and must return the same
     actions to 5e-4 and the same min_distance to 1e-4, tick by tick.
   * closed loop: the full examples/corridor/diff episode in the port's
     Sim2D through ``examples/run_exp_torch.py:run_loop`` (planner and
     world built from ``CONFIGS``, dicts equal to the YAML files): it must
     arrive with no collision and 0 contact steps; ticks to arrival beside
     the JAX package's record, host ms per tick (median, p90) and the
     device's busy ms per tick (a profiled window of 20 ticks).
   * parity: 15 closed-loop ticks on the card of corridor/acker,
     corridor/omni, polygon_robot/diff, corridor_long/diff (T=30) and
     dyna_obs/diff (moving obstacles, point velocities), each from a start
     before the obstacles; a CPU planner is fed each tick's state, points,
     velocities and the state the card's planner carried into it: actions
     to 5e-4, min_distance to 1e-4, flags equal.
   * long horizon: chained batched steps at T=30 with K=12 and at T=33
     (B=64), where some QP stages take their plain routes by admission
     (``ops/qp.py``: the ADMM operator at both, the inverses above n=96 at
     T=33; the polish kernel takes k=90 and 99): the counters must show
     exactly those routes, and opt_u is held against the CPU
     (``LONG_HORIZON_MEDIAN``, ``_MAX``, ``_ABOVE``).
   * solvers: the QP's paths off the main path (``solvers_path``): three
     chained B=512 steps with ``ADMMConfig(condense_admm=False)`` (the
     full-space ADMM on the admm kernel) and one with the generic condensed
     polish (``elim_n_acc=None``), each against the CPU on 32 scenarios;
     B=64 steps at T=30 in the full space with the dense and the banded
     inverse (admm on its plain version); ``solve_qp_batch`` at B=512 on
     generic QPs, polish on and off, every scenario against the CPU (5e-4);
     and the facade built with ``pan.admm = {"condense_admm": false}``, 5
     ticks against a CPU planner. The full-space planner's output moves with
     float32 rounding, so those cases are held to the CPU's own spread under
     a 1e-6 change of their inputs (``noise_gate``), the facade to
     FACADE_FULLSPACE_TOL; the generic polish and the batch to 5e-4. Each
     reports host ms, device busy ms and kernels per step, and each QP
     stage's route, counted (kernel, plain, Cholesky, banded).
   * lon: the differentiated planner step and LON's tuning loop
     (``examples/LON/LON_corridor_torch.py:run_episode``): 10 corridor/diff
     tuning ticks with the near branch of the loss forced, each tick's
     grads w.r.t. AdjustParams held against a CPU planner's from the card's
     carried inputs (``GRAD_RTOL``); one 120-tick tuning episode (host ms
     per tuning tick, the CPU's grads beside the card's on every tick with
     a nonzero loss, the final weights beside the JAX record); one
     differentiated B=512 flagship step (forward and backward ms by CUDA
     events, each one's device time by the profiler, the KKT solve alone
     at its B=512 shape and at T=30's, peak memory, and 32 scenarios'
     loss and summed grads against the CPU). The forward launches select,
     sweep, admm and polish, and the facade's ticks the fused MLP.
   * train: DUNE training at full width (``train_path``: 100,000 labeled
     points, batch 256, the full encoder): the labels and one epoch on the
     card against the CPU, two more epochs whose loss must fall, ms per
     epoch and device time per update, a checkpoint loaded back and
     ``DuneTrainer.test`` through the fused MLP, and ``NeuPan.train_dune``
     followed by a tick that must run the fused MLP on the trained weights.
   * sharded: the scenario axis split over a mesh (``sharded_path``):
     three chained steps through ``sharded_planner_step`` on a mesh of
     every card and on four shards of 128 on card 0: each shard equal bit
     for bit to the batched step on its own scenarios, against the batched
     step on all 512 opt_u to 5e-4 and min_distance to 1e-4 relative and
     1e-5 absolute (32 scenarios also against the CPU), each kernel
     launched exactly len(mesh) times as often as in the batched step; host ms, device busy ms and kernels per step beside
     the batched step's at B=512, and at one scenario per shard beside
     B=1; one step inside ``neupan_torch.utils.profile_trace``, whose trace
     must name every hand kernel. Then the data-parallel DUNE training
     update at full width (``train_data_parallel``: batch 256 over four
     shards, the gradients summed on card 0, one Adam step) against the
     single-device update.
   * precision_default: three chained steps with
     ``PANSpec(precision="default")`` beside ``"highest"``
     (``precision_path``): TF32 on in the assembly and off in the QP, the
     flag back off after each step, the opt_u gap and both device times.

Prints the kernels' JSON line, the paths' JSON line, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``; the
profilers' per-kernel tables go to standard error. Exits non-zero, with no
result line, when no card is present or any check fails.
"""

from __future__ import annotations

import argparse
import collections
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
PEAK_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores (an FMA counts 2)
PEAK_TF32 = 495e12     # H100 SXM TF32 on the tensor cores, dense
PEAK_MUFU = PEAK_FLOPS / 16   # 16 special-function results per clock per SM, 128 FMA lanes
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
# tanhf as nvcc compiles it for sm_90a: 9 float32 instructions (6 FFMA, 2 FMUL,
# 1 FADD) and 2 MUFU, besides 4 compares, selects and logic ops on the integer
# pipe (scripts/exp_mlp_timing.py, "sass_per_tanh")
TANH_FP32, TANH_MUFU = 9, 2
# launches of each kernel in one planner step (2 PAN iterations): one DUNE
# call per iteration, which is 1 select (the flow-building selection kernel,
# default path) and 1 mlp (the fused encoder, on by default on the card: on
# the K winners per frame, or on all P points with dune_select="mlp") and
# never select_topk (the materialized-flow selection kernel, which only
# dune_forward(select="exact", use_kernel=True) launches); sweep 1 equality
# Gram + 2 ADMM phases per QP; admm 2 phases per QP; polish 5 rounds per QP
QP_PER_STEP = {"sweep": 6, "admm": 4, "polish": 10}
PER_STEP = {"select": 2, "select_topk": 0, "mlp": 2, **QP_PER_STEP}
PER_STEP_MLP = {"select": 0, "select_topk": 0, "mlp": 2, **QP_PER_STEP}
PER_STEP_NO_OBS = {"select": 0, "select_topk": 0, "mlp": 0, **QP_PER_STEP}
PER_DUNE_CALL = {"select": 0, "select_topk": 1, "mlp": 1, "sweep": 0, "admm": 0, "polish": 0}
KERNELS = ("select", "sweep", "admm", "polish", "select_topk", "mlp")
SOURCE = {"select": "select.cu", "sweep": "sweep.cu", "admm": "admm.cu", "polish": "polish.cu",
          "select_topk": "select.cu", "mlp": "mlp.cu"}
REPLACES = {
    "select": "neupan_tpu/ops/pallas/select.py:170",
    "sweep": "neupan_tpu/ops/pallas/sweep.py:93",
    "admm": "neupan_tpu/ops/pallas/admm.py:94",
    "polish": "neupan_tpu/ops/pallas/polish.py:136",
    "select_topk": "neupan_tpu/ops/pallas/select.py:120",
    "mlp": "neupan_tpu/ops/pallas/mlp.py:54",
}
# the kernel entry points (ptxas names) behind each wrapper
ENTRIES = {"select": ("select_flow_kernel",), "select_topk": ("select_kernel",),
           "mlp": ("dune_mlp_kernel",), "sweep": ("sweep_regs_kernel", "sweep_tiled_kernel"),
           "admm": ("admm_regs_kernel", "admm_smem_kernel"), "polish": ("box_candidate_kernel",)}
FACADE_TICKS, NO_OBS_TICKS = 5, 3
FLAGS = ("stop", "arrive", "collision")
CLOSED_LOOP_MAX_TICKS, PROFILE_TICKS = 400, 20
JAX_CORRIDOR_STEPS = 233   # the JAX package's corridor/diff episode (sweep_results.json)
# config -> (the robot's start, the planner's waypoints from there): a few metres
# before the obstacles, as tests/golden/torch/loop_*.npz start
PARITY_CONFIGS = {
    "corridor/acker": ((2.0, 20.0, 0.0), [[60, 20, 0]]),
    "corridor/omni": ((4.0, 20.76, 0.188), [[10, 21.9, 0], [17, 20.5, 0], [23, 17.3, 0],
                                            [30, 20, 0], [36, 22, 0], [43, 20, 0],
                                            [50, 17.7, 0], [60, 20, 0]]),
    "polygon_robot/diff": ((6.0, 0.0, 0.0), [[40, 0, 0]]),
    "corridor_long/diff": ((2.0, 20.0, 0.0), [[60, 20, 0]]),
    "dyna_obs/diff": ((8.0, 0.0, 0.0), [[40, 0, 0]]),
}
PARITY_TICKS = 15
LONG_HORIZON_CASES = ((30, 12), (33, 10))   # (T, K)
B_LONG, LONG_HORIZON_STEPS = 64, 2
# opt_u card vs CPU at T >= 30, over the B_LONG x LONG_HORIZON_STEPS scenario-steps
# of a case: the median to 2e-4, the largest to 3e-3, and at most 4 of them above
# 5e-4. At these horizons the polish's tolerance-driven active set flips on
# float32 rounding in a few scenarios whichever routes the QP takes
# (scripts/exp_long_horizon_agreement.py, B=64: T=30 with every stage on its
# kernel 7.8e-4 with 3 above 5e-4, T=30 K=12 2.5e-3 with 2, T=33 6.8e-4 with 4;
# medians 5.7e-5 to 8.4e-5; T=10 at most 1.5e-4 and none above). The same
# scenarios flip from run to run: the phase reports them.
LONG_HORIZON_MEDIAN, LONG_HORIZON_MAX, LONG_HORIZON_ABOVE = 2e-4, 3e-3, 4
GLUE = "dune._lam_and_distance"   # the profiler's range around that glue
# facade actions card vs CPU with condense_admm=False, each tick from the card's
# carried state: the full-space ADMM's float32 iterate, and which polish candidate
# wins, move with rounding (the JAX package against itself with another inverse
# route parts by 4.8e-3 on corridor/diff ticks: scripts/exp_fullspace_spread.py),
# so the bound of tests/test_torch_solvers.py's facade test against JAX
FACADE_FULLSPACE_TOL = 1e-2
# the differentiated step (LON): the forward runs the kernels but the encoder as a
# module (the fused MLP kernel has no backward); the backward launches none
PER_GRAD_STEP = dict(PER_STEP, mlp=0)
LON_NEAR = 10.0           # a collision threshold that forces the near branch of the loss
LON_TICKS = 10            # B=1 tuning ticks held against the CPU
LON_EPISODE_TICKS, LON_THRESHOLD, LON_LR = 120, 0.4, 5e-3   # LON_corridor_torch.py's
LON_SLICE = 32            # scenarios of the B=512 differentiated step rerun on the CPU
# card vs CPU grads w.r.t. AdjustParams, each field relative to the largest
# magnitude of the whole gradient: the ROADMAP's bar for the port against JAX
GRAD_RTOL = 1e-3
# the train path: DUNE training at full width (the JAX trainer's defaults)
TRAIN_POINTS, TRAIN_BATCH, TRAIN_LR = 100000, 256, 5e-5
TRAIN_EPOCHS_CARD = 3          # epoch 0 held against the CPU, then two more on the card
TRAIN_PROFILE_STEPS = 50
TRAIN_TEST_SIZES = (1000, 10000, 100000)
TRAIN_FACADE_POINTS = 20000
# labels card vs CPU: d to 1e-5 (1 + d) everywhere, mu to 1e-5 where the active
# faces agree; a point whose projection sits on the 1e-4 (1 + |h|) threshold of a
# second face may flip on a rounding, at most this many of the 100,000
TRAIN_LABEL_FLIPS = 10
# one full-width epoch card vs CPU (312 adam_l2 updates at lr 5e-5 from the same
# init on the same draws). The port held against JAX on the CPU
# (tests/test_torch_training.py, 24 updates at lr 1e-3) agrees to 3e-7 relative in
# the loss terms and to 5e-6 of lr x steps in the weights; an epoch is 13 times as
# many updates and the card sums in other orders, so: the loss terms to 1e-4
# relative, the weights to 1e-3 of lr x steps, with at most 1% of them beyond it
# (a gradient element rounding across zero turns Adam's sign-like step) and none
# beyond 0.1 of lr x steps
TRAIN_LOSS_RTOL, TRAIN_W_TIGHT, TRAIN_W_CAP, TRAIN_W_BEYOND = 1e-4, 1e-3, 0.1, 0.01
# the fused MLP against the module on trained weights: the mlp path's bound
TRAIN_MLP_ATOL = 1e-5
# the sharded path: the scenario axis split over a mesh of every card and over four
# shards on card 0, held against the batched step at tests/test_parallel.py's bound
# (a shard's smaller batch blocks the library matmuls otherwise, so rounding moves)
SHARDS = 4
SHARDED_RTOL, SHARDED_ATOL = 1e-4, 1e-5
SHARDED_REPS = 5
# the sentinel matmul of the precision path: TF32 rounds its inputs to 10 bits of
# mantissa, so a 1024-long float32 product moves by far more than float32 rounding
SENTINEL_N = 1024
# examples/dune_train/dune_train_diff.yaml (held equal by tests/test_torch_training.py)
DUNE_TRAIN_DIFF = {
    "robot": {"kinematics": "diff", "max_speed": [8, 1], "max_acce": [8, 3], "length": 1.6,
              "width": 2.0},
    "pan": {"dune_max_num": 100, "nrmp_max_num": 10},
    "train": {"direct_train": True, "model_name": "diff_robot_default", "data_size": 100000,
              "data_range": [-25, -25, 25, 25], "batch_size": 256, "epoch": 5000,
              "valid_freq": 100, "save_freq": 500, "lr": "5e-5", "lr_decay": 0.5,
              "decay_freq": 1500}}


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


def graph_ms(torch, fn, reps: int = 50, replays: int = 3) -> float:
    """Mean device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events. A wrapper
    costs tens of microseconds of Python per call, more than a small kernel
    takes on the card, so timing launches issued one by one (``time_ms``)
    measures the host; the graph replays only the kernels."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(ops: float, nbytes: float):
    """Least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def ptxas_usage(log_text: str) -> dict:
    """Registers and spilled bytes (stores + loads) of each kernel entry in
    nvcc's ``-Xptxas -v`` report, by name (``name<N,M>`` for a template
    instance, a bool argument as 0 or 1)."""
    import re

    usage, current = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            n = re.search(r"([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            args = re.findall(r"L[ib](\d+)E", n.group(2) or "") if n else []
            current = None if n is None else n.group(1) + (f"<{','.join(args)}>" if args else "")
            if current is not None:
                usage.setdefault(current, {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[current]["registers"] = int(m.group(1))
    return usage


# -- work counts from the shapes (float operations, compares included) -------

def select_work(B, Tp1, P, V, E, K):
    per_point = 12 + 20 * V + 5 * E + 2 + K   # flow, edges, faces, key, extraction
    ops = B * Tp1 * P * per_point
    nbytes = B * P * (2 * 4 + 2 * 4 + 1) + B * 5 * Tp1 * 4 + 2 * B * Tp1 * K * 4
    return ops, nbytes


def select_topk_work(B, Tp1, P, V, E, K):
    per_point = 20 * V + 5 * E + 2 + K         # edges, faces, key, extraction
    ops = B * Tp1 * P * per_point
    nbytes = B * Tp1 * 2 * P * 4 + B * P + 2 * B * Tp1 * K * 4
    return ops, nbytes


def mlp_work(N, E, H=32):
    """Per call: multiply-adds of the six products, float32 instructions of
    the rest (three LayerNorms at 5 per feature: sum, centre, square,
    normalize, affine; ReLUs; 96 tanh at TANH_FP32 each), MUFU operations
    (TANH_MUFU per tanh, one reciprocal square root per LayerNorm) and bytes
    (points read, duals written, the kernel's weights read once)."""
    from neupan_torch.ops.kernels.mlp import KERNEL_SIZE

    macs = 2 * H + 4 * H * H + H * E
    elementwise = 3 * 5 * H + 2 * H + E + 3 * H * TANH_FP32
    mufu = 3 * H * TANH_MUFU + 3
    return dict(macs=N * macs, fp32=N * elementwise, mufu=N * mufu,
                bytes=N * (2 + E) * 4 + KERNEL_SIZE * 4)


def mlp_bounds(N, E):
    """The fused MLP's least time, (ms, what bounds it), for two designs:
    float32 on the CUDA cores (every product an FMA, beside the elementwise
    work on the same pipe) and the tensor cores (the products three TF32
    passes at the TF32 rate, the elementwise work at the float32 rate, the
    MUFU work at its own; the largest wins)."""
    w = mlp_work(N, E)
    t_bytes = w["bytes"] / PEAK_BYTES
    t_mufu = w["mufu"] / PEAK_MUFU
    cuda_core = {"operations": max(2 * (w["macs"] + w["fp32"]) / PEAK_FLOPS, t_mufu), "bytes": t_bytes}
    tensor_core = {"operations": max(3 * 2 * w["macs"] / PEAK_TF32, 2 * w["fp32"] / PEAK_FLOPS, t_mufu),
                   "bytes": t_bytes}
    pick = lambda t: (max(t.values()) * 1e3, max(t, key=t.get))
    return {"cuda_core": pick(cuda_core), "tensor_core": pick(tensor_core)}


def sweep_work(B, n):
    """The scaled sweep: the Jacobi scales, scaling and ridge, n pivots, the unscaling."""
    return B * (n * (2 * n * n + n) + 4 * n + 5 * n * n), 2 * B * n * n * 4


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

def wrappers():
    """name -> the wrapper that counts that kernel's launches."""
    from neupan_torch.ops.kernels.admm import admm_iterate
    from neupan_torch.ops.kernels.mlp import dune_mlp
    from neupan_torch.ops.kernels.polish import box_candidate
    from neupan_torch.ops.kernels.select import select_topk, select_topk_flow
    from neupan_torch.ops.kernels.sweep import sweep_spd_inverse

    return {"select": select_topk_flow, "select_topk": select_topk, "mlp": dune_mlp,
            "sweep": sweep_spd_inverse, "admm": admm_iterate, "polish": box_candidate}


def twins():
    """name -> the counter of a route that a QP stage takes on a card besides
    its kernel: where the kernel does not admit the shape (``ops/qp.py``'s
    admission checks) the ADMM and polish twins and the Cholesky inverse
    above n=96, and the full-space normal matrix's block-tridiagonal inverse
    with ``ADMMConfig(inverse="banded")`` (library calls, as in JAX)."""
    from neupan_torch.ops.banded import btd_spd_inverse
    from neupan_torch.ops.kernels.admm import admm_iterate_plain
    from neupan_torch.ops.kernels.polish import box_candidate_plain
    from neupan_torch.ops.kernels.sweep import cholesky_inverse

    return {"admm_plain": admm_iterate_plain, "polish_plain": box_candidate_plain,
            "cholesky": cholesky_inverse, "banded": btd_spd_inverse}


def qp_routes(nrmp, cfg, qps):
    """Launches of each QP stage's route over ``qps`` planner QPs of the NRMP
    layout ``nrmp`` solved under ``cfg`` (row-layout statics filled), as
    ``ops/qp.py``'s admission checks route them: the equality Gram inverse;
    two ADMM phases, condensed (k = n - n_eq, m - n_eq rows) or full-space
    (n, m), each an inverse (sweep up to MAX_N, Cholesky above, or banded)
    and the iterations (kernel where ``admm_fits``, else plain); and
    ``polish_rounds`` candidates, box-eliminating (kernel where
    ``polish_fits``, else plain, which inverts k and na by Cholesky above
    MAX_N) or generic condensed (two inverses each, k and n_hard)."""
    from neupan_torch.ops.kernels.admm import admm_fits
    from neupan_torch.ops.kernels.polish import polish_fits
    from neupan_torch.ops.kernels.sweep import MAX_N

    n_eq, n_hard, na = cfg.elim_n_eq, cfg.elim_n_hard, cfg.elim_n_acc
    n, m = nrmp.n, nrmp.m
    k = n - n_eq
    r = dict.fromkeys(("sweep", "cholesky", "banded", "admm", "admm_plain", "polish",
                       "polish_plain"), 0)

    def invert(size, times=1):
        r["sweep" if size <= MAX_N else "cholesky"] += times

    invert(n_eq)
    if cfg.condense_admm:
        invert(k, 2)
        fits = admm_fits(k, m - n_eq)
    else:
        if cfg.inverse == "banded" and cfg.banded_perm is not None:
            r["banded"] += 2
        else:
            invert(n, 2)
        fits = admm_fits(n, m)
    r["admm" if fits else "admm_plain"] += 2
    rounds = cfg.polish_rounds if cfg.polish else 0
    if na is None:
        invert(k, rounds)
        invert(n_hard, rounds)
    elif polish_fits(k, na):
        r["polish"] += rounds
    else:
        r["polish_plain"] += rounds
        r["cholesky"] += rounds * ((k > MAX_N) + (na > MAX_N))
    return {key: qps * v for key, v in r.items()}


def counted(torch, name, expected, run):
    """Run one path with every launch count (kernels and plain routes) set to
    0 just before and read just after; fail unless each name in ``expected``
    (a dict, or a function of the path's result giving one) was launched
    that many times. A plain route not named must not have run."""
    ws = {**wrappers(), **twins()}
    for w in ws.values():
        w.launches = 0
    result = run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in ws.items()}
    expected = expected(result) if callable(expected) else expected
    expected = {**{k: 0 for k in twins()}, **expected}
    for k, want in expected.items():
        check(launches[k] == want, f"{name} path: {k} launched {launches[k]} times, expected {want}")
    return result, launches


def kernel_phase(torch, dev):
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.kernels import admm as AD
    from neupan_torch.ops.kernels import mlp as ML
    from neupan_torch.ops.kernels import polish as PO
    from neupan_torch.ops.kernels import select as SE
    from neupan_torch.ops.kernels import sweep as SW
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
    # the facade's shape: one scenario, P=100 (examples/corridor/diff), K=10
    P1 = 100
    tab1 = (pts[:1, :, :P1].contiguous(), vels[:1, :, :P1].contiguous(), mask[:1, :P1].contiguous(),
            tab_args[3][:1].contiguous(), *tab_args[4:])
    idx1, idx1_p = SE.select_from_tables(*tab1)[1], SE.select_from_tables_plain(*tab1)[1]
    check(torch.equal(idx1, idx1_p), "select B=1: kernel indices differ from the plain version")
    res["select"] = dict(
        shape=f"B={B} T+1={T + 1} P={P} K={K}", max_abs_err=err,
        ms=graph_ms(torch, lambda: SE.select_from_tables(*tab_args)),
        ms_B1=graph_ms(torch, lambda: SE.select_from_tables(*tab1)),
        plain_ms=time_ms(torch, lambda: SE.select_from_tables_plain(*tab_args), 5),
        library_ms=None, bound=bound(ops, nbytes),
        bound_B1=bound(*select_work(1, T + 1, P1, verts.shape[1], G.shape[0], K)))

    # the refill rule: fewer than K unmasked points in 64 scenarios, none in one;
    # the trailing slots repeat the lowest-index 1e9 point, earlier winners included
    sparse = mask.clone()
    sparse[:64] &= torch.arange(P, device=dev) % 409 == 7          # 5 candidates, some masked
    sparse[64] = False
    sp_args = (pts, vels, sparse, *tab_args[3:])
    sp_flow = torch.stack(SE.flow_from_tables(pts, vels, tab_args[3]), dim=2).contiguous()
    sp = {"select": SE.select_from_tables(*sp_args),
          "select plain": SE.select_from_tables_plain(*sp_args),
          "select_topk": SE.select_topk_from_tables(sp_flow, sparse, *tab_args[4:]),
          "select_topk plain": SE.select_topk_from_tables_plain(sp_flow, sparse, *tab_args[4:])}
    torch.cuda.synchronize()
    for name, (k_, i_) in sp.items():
        check(torch.equal(i_, sp["select plain"][1]) and torch.equal(k_, sp["select plain"][0]),
              f"{name}: fewer than K unmasked points, indices or keys differ from the plain version")
    check(bool((sp["select"][1][64] == 0).all()), "select: an all-masked frame must repeat point 0")
    res["select_refill"] = dict(scenarios_fewer_than_K=64, all_masked=1,
                                trailing_slots=int((sp["select"][0] == 1e9).sum()))
    del sp, sp_flow

    # select_topk: the same frames as a materialized flow (B, T+1, 2, P), built in
    # the flow kernel's expression order, so both kernels must pick the same points
    flow = torch.stack(SE.flow_from_tables(pts, vels, tab_args[3]), dim=2).contiguous()
    keys5, idx5 = SE.select_topk(flow, mask, verts, G, h, K)
    keys5_p, idx5_p = SE.select_topk_plain(flow, mask, verts, G, h, K)
    torch.cuda.synchronize()
    check(torch.equal(idx5, idx5_p), "select_topk: kernel indices differ from the plain version")
    check(torch.equal(idx5, idx), "select_topk: indices differ from the flow kernel's")
    ops, nbytes = select_topk_work(B, T + 1, P, verts.shape[1], G.shape[0], K)
    flow_args = (flow, mask, *tab_args[4:])
    flow1 = flow[:1, :, :, :P1].contiguous()
    flow1_args = (flow1, mask[:1, :P1].contiguous(), *tab_args[4:])
    check(torch.equal(SE.select_topk_from_tables(*flow1_args)[1], idx1),
          "select_topk B=1: indices differ from the flow kernel's")
    res["select_topk"] = dict(
        shape=f"B={B} T+1={T + 1} P={P} K={K}", max_abs_err=float((keys5 - keys5_p).abs().max()),
        ms=graph_ms(torch, lambda: SE.select_topk_from_tables(*flow_args)),
        ms_B1=graph_ms(torch, lambda: SE.select_topk_from_tables(*flow1_args)),
        plain_ms=time_ms(torch, lambda: SE.select_topk_from_tables_plain(*flow_args), 5),
        library_ms=None, bound=bound(ops, nbytes),
        bound_B1=bound(*select_topk_work(1, T + 1, P1, verts.shape[1], G.shape[0], K)))

    # mlp: the deployed diff encoder on every point of that flow (what
    # dune_select="mlp" gives it) and on the K winners per frame (what the
    # exact paths give it); library_ms is the nn.Sequential route
    model = lambda name: load_checkpoint(
        os.path.join(ROOT, f"examples/model/{name}/model.npz"), device=dev)
    encoder = model("diff_robot_default")
    E = G.shape[0]
    packed = ML.pack_weights(encoder)
    all_pts = flow.transpose(2, 3).contiguous()                          # (B, T+1, P, 2)
    win = torch.gather(flow, 3, idx5.long()[:, :, None, :].expand(-1, -1, 2, -1))

    def mlp_errors(enc, mlp_pts):
        """Largest distance of the kernel from its plain version, and of the
        kernel, the plain version and the module from float64 on the same
        weights (a million points at a time)."""
        pk, N = ML.pack_weights(enc), mlp_pts.numel() // 2
        outs = {"kernel": ML.dune_mlp(enc, mlp_pts), "plain": ML.dune_mlp_plain(pk, mlp_pts, E),
                "module": enc(mlp_pts)}
        torch.cuda.synchronize()
        e64 = dict.fromkeys(outs, 0.0)
        flat = mlp_pts.reshape(-1, 2)
        for lo in range(0, N, 1 << 20):
            sl = slice(lo, lo + (1 << 20))
            ref = ML.dune_mlp_plain(pk.double(), flat[sl].double(), E)
            for k, o in outs.items():
                e64[k] = max(e64[k], float((o.reshape(-1, E)[sl] - ref).abs().max()))
        return float((outs["kernel"] - outs["plain"]).abs().max()), e64

    res["mlp_by_n"] = {}
    with torch.no_grad():
        for mlp_pts in (all_pts, win.transpose(2, 3).contiguous()):
            N = mlp_pts.numel() // 2
            err, e64 = mlp_errors(encoder, mlp_pts)
            check(err <= 1e-5, f"mlp N={N}: kernel differs from the plain version by {err} "
                  f"(from float64: {e64})")
            bounds = mlp_bounds(N, E)
            reps = 10 if N > 1e6 else 50
            r = dict(shape=f"N={N} E={E}", max_abs_err=err, err_vs_f64=e64["kernel"],
                     plain_err_vs_f64=e64["plain"],
                     ms=graph_ms(torch, lambda: ML.dune_mlp(encoder, mlp_pts), reps),
                     plain_ms=time_ms(torch, lambda: ML.dune_mlp_plain(packed, mlp_pts, E), 3),
                     library_ms=graph_ms(torch, lambda: encoder(mlp_pts), reps),
                     bound=bounds["tensor_core"], bound_cuda_core=bounds["cuda_core"])
            res["mlp_by_n"][N] = {k: v for k, v in r.items() if not k.startswith("bound")}
            res["mlp_by_n"][N].update(bound_ms=r["bound"][0], bound_by=r["bound"][1],
                                      bound_ms_cuda_core=r["bound_cuda_core"][0])
            if "mlp" not in res:     # the full-width shape stands in the kernels' line
                res["mlp"] = r
        res["mlp"]["max_abs_err"] = max(v["max_abs_err"] for v in res["mlp_by_n"].values())

        # the acker checkpoint on the same 11.5M points: some points there leave a
        # LayerNorm 32 nearly equal activations, whose float32 rounding it amplifies
        # past 1e-5 in any evaluation order. So the kernel is held to the other two
        # float32 evaluations' own distance from float64, not to an absolute 1e-5.
        err, e64 = mlp_errors(model("acker_robot_default"), all_pts)
        noise = max(e64["plain"], e64["module"])
        check(e64["kernel"] <= 1e-6 + 2.0 * noise and err <= 1e-5 + e64["plain"],
              f"mlp, acker checkpoint: kernel {err} from the plain version; from float64: {e64}")
        res["mlp_acker"] = dict(shape=f"N={all_pts.numel() // 2} E={E}", max_abs_err=err,
                                err_vs_f64=e64)
    del all_pts, win, flow

    # sweep: what the QP launches, spd_inverse_scaled (the Jacobi scaling, ridge and
    # unscaling in the kernel), at n=30, 33 (main path), 48 (the generic condensed
    # polish's Schur complement over the hard rows), 63 (the full-space normal
    # matrix and polish Hessian) and 90 (T=30), against the plain version of the
    # fused call on SPD matrices whose diagonal spans four decades; and the
    # unscaled kernel on the same matrices scaled beforehand
    sweep_err = 0.0
    res["sweep_by_n"] = {}
    for n in (30, 33, 48, 63, 90):
        Q = rng.normal(size=(B, n, n))
        sc = 10.0 ** rng.uniform(-2, 2, (B, n, 1))
        M = sc * (Q @ np.swapaxes(Q, 1, 2) / n + np.eye(n)[None]) * np.swapaxes(sc, 1, 2)
        M = (M + np.swapaxes(M, 1, 2)) / 2
        dj = 1 / np.sqrt(np.einsum("bii->bi", M))
        Mt = f(M * dj[:, :, None] * dj[:, None, :] + 1e-7 * np.eye(n)[None])
        M = f(M)
        X, Xp = SW.spd_inverse_scaled(M), SW.spd_inverse_scaled(M, SW.sweep_spd_inverse_plain)
        U, Up = SW.sweep_spd_inverse(Mt), SW.sweep_spd_inverse_plain(Mt)
        torch.cuda.synchronize()
        # |X_rc| <= sqrt(X_rr X_cc) for an SPD inverse: the scale-free error
        d = torch.sqrt(torch.diagonal(Xp, dim1=1, dim2=2).abs())
        rel = float(((X - Xp).abs() / (d[:, :, None] * d[:, None, :])).max())
        rel_u = float((U - Up).abs().max() / Up.abs().max())
        check(rel < 3e-5 and rel_u < 3e-5,
              f"sweep n={n}: relative error {rel} (scaled), {rel_u} (unscaled) against the plain version")
        sweep_err = max(sweep_err, float((X - Xp).abs().max()), float((U - Up).abs().max()))
        ops, nbytes = sweep_work(B, n)
        r = dict(rel_err=rel, rel_err_unscaled=rel_u, ms=graph_ms(torch, lambda: SW.spd_inverse_scaled(M), 20),
                 ms_unscaled=graph_ms(torch, lambda: SW.sweep_spd_inverse(Mt), 20),
                 library_ms=time_ms(torch, lambda: torch.linalg.inv(M), 10), bound_ms=bound(ops, nbytes)[0])
        if n in (48, 63):
            r["plain_ms"] = time_ms(torch, lambda: SW.spd_inverse_scaled(M, SW.sweep_spd_inverse_plain), 5)
        if n == 30:
            one = M[:1].contiguous()
            r.update(ms_B1=graph_ms(torch, lambda: SW.spd_inverse_scaled(one)),
                     ms_unscaled_B1=graph_ms(torch, lambda: SW.sweep_spd_inverse(Mt[:1].contiguous())))
            res["sweep"] = dict(
                shape=f"B={B} n={n}", ms=r["ms"], ms_B1=r["ms_B1"],
                plain_ms=time_ms(torch, lambda: SW.spd_inverse_scaled(M, SW.sweep_spd_inverse_plain), 5),
                library_ms=r["library_ms"], bound=bound(ops, nbytes), bound_B1=bound(*sweep_work(1, n)))
        res["sweep_by_n"][n] = r
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
    Minv = SW.spd_inverse_any(M)
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
    one = [a[:1] for a in ad_args]
    res["admm"] = dict(
        shape=f"B={B} k={k} m={m} iters={iters}", max_abs_err=max(e_wz, e_y),
        ms=graph_ms(torch, lambda: AD.admm_iterate(*ad_args, **kw)),
        ms_B1=graph_ms(torch, lambda: AD.admm_iterate(*one, **kw)),
        plain_ms=time_ms(torch, lambda: AD.admm_iterate_plain(*ad_args, **kw), 3),
        library_ms=None, bound=bound(ops, nbytes), bound_B1=bound(*admm_work(1, k, m, iters)))

    # admm at the full-space shape of the flagship QP (condense_admm=False): n=63
    # variables, m=181 rows. Its 33 equality rows carry rho x 1e3: rhs and the
    # dual step cancel terms ~1e3 times their result, so one float32 iteration
    # already parts from float64 by ~3e-3 of y's magnitude, in the plain loop as
    # in the kernel (sums in another order), and 120 iterations amplify it
    # (PERF.md section 6). So on that data the kernel must be as accurate
    # as the plain version against the plain loop in float64 (one iteration, the
    # largest error of each output within 2x the plain's plus 1e-6 of its
    # magnitude); 120 iterations on the same shape with one rho per scenario are
    # held to the main path's bounds; the stiff call is timed.
    n_f, m_f, eq_f = 63, 181, 33
    Af = rng.normal(size=(B, m_f, n_f)) * 0.3
    lf = rng.normal(size=(B, m_f)) - 1
    softf = np.where(rng.uniform(size=(B, m_f)) < 0.4, 10.0, 0.0)
    softf[:, :eq_f] = 0.0
    uf = np.where(softf > 0, 1e20, lf + np.abs(rng.normal(size=(B, m_f))) + 0.5)
    uf[:, :eq_f] = lf[:, :eq_f]
    rho_one = np.repeat(rng.uniform(0.5, 2.0, (B, 1)), m_f, axis=1)
    rho_eq = rho_one.copy()
    rho_eq[:, :eq_f] *= 1e3
    Af_t, Pf = f(Af), f(rng.uniform(0.1, 2.0, (B, n_f)))

    def full_args(rho):
        rho_t = f(rho)
        Mf = torch.diag_embed(Pf + 1e-6) + torch.bmm((Af_t * rho_t[:, :, None]).transpose(1, 2),
                                                     Af_t)
        return (SW.spd_inverse_any(Mf), Af_t, f(rng.normal(size=(B, n_f))), f(lf), f(uf),
                f(softf), rho_t, f(rng.normal(size=(B, n_f)) * 0.1),
                f(np.clip(rng.normal(size=(B, m_f)), lf, uf)), f(rng.normal(size=(B, m_f)) * 0.1))

    adf_stiff, adf_one = full_args(rho_eq), full_args(rho_one)

    def against_f64(iters_):
        k_ = dict(kw, iters=iters_)
        ref = AD.admm_iterate_plain(*(a.double() for a in adf_stiff), **k_)
        err = lambda out_: [float((a.double() - r).abs().max()) for a, r in zip(out_, ref)]
        return (err(AD.admm_iterate(*adf_stiff, **k_)), err(AD.admm_iterate_plain(*adf_stiff, **k_)),
                [float(r.abs().max()) for r in ref])

    e1_k, e1_p, mag = against_f64(1)
    e120_k, e120_p, _ = against_f64(iters)
    out120 = AD.admm_iterate(*adf_one, **kw)
    outp120 = AD.admm_iterate_plain(*adf_one, **kw)
    torch.cuda.synchronize()
    e_wz = max(float((out120[i] - outp120[i]).abs().max()) for i in (0, 1))
    e_y = float((out120[2] - outp120[2]).abs().max())
    check(all(k_ <= 2 * p_ + 1e-6 * m_ for k_, p_, m_ in zip(e1_k, e1_p, mag)),
          f"admm at n={n_f}, m={m_f}, one stiff iteration: kernel {e1_k} from float64, "
          f"plain {e1_p}")
    check(e_wz <= 1e-4, f"admm at n={n_f}, m={m_f}: w/z differ from the plain version by {e_wz}")
    check(bool(((out120[2] - outp120[2]).abs() <= 1e-3 + 1e-2 * outp120[2].abs()).all()),
          f"admm at n={n_f}, m={m_f}: y differs from the plain version by {e_y}")
    res["admm_fullspace"] = dict(
        shape=f"B={B} k={n_f} m={m_f} iters={iters}", max_abs_err=max(e_wz, e_y),
        stiff_f64_err_wzy={"iters_1": {"kernel": e1_k, "plain": e1_p},
                           f"iters_{iters}": {"kernel": e120_k, "plain": e120_p}},
        smem_bytes=AD.smem_bytes(n_f, m_f),
        ms=graph_ms(torch, lambda: AD.admm_iterate(*adf_stiff, **kw)),
        plain_ms=time_ms(torch, lambda: AD.admm_iterate_plain(*adf_stiff, **kw), 3),
        bound_ms=bound(*admm_work(B, n_f, m_f, iters))[0])

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
    one = [a[:1] for a in po_args]
    res["polish"] = dict(
        shape=f"B={B} k={k} na={na} refine={refine}", max_abs_err=e,
        ms=graph_ms(torch, lambda: PO.box_candidate(*po_args, refine=refine)),
        ms_B1=graph_ms(torch, lambda: PO.box_candidate(*one, refine=refine)),
        bound_B1=bound(*polish_work(1, k, na, refine)),
        plain_ms=time_ms(torch, lambda: PO.box_candidate_plain(*po_args, refine=refine), 5),
        library_ms=None, bound=bound(ops, nbytes))

    # polish at T=33's shape (k=99, na=64, B=B_LONG: four 32-column chunks); above
    # n=96 the plain version inverts by Cholesky, the kernel by its sweep
    Bl, k, na = B_LONG, 99, 64
    Qm = rng.normal(size=(Bl, k, k))
    Hr = Qm @ np.swapaxes(Qm, 1, 2) / k + np.eye(k)
    DAn = rng.normal(size=(Bl, na, k)) * 0.3
    d = (rng.uniform(size=(Bl, na)) < 0.6).astype(np.float64)
    DAn = DAn / np.maximum(np.linalg.norm(DAn, axis=2, keepdims=True), 1e-8) * d[:, :, None]
    fix = (rng.uniform(size=(Bl, k)) < 0.4).astype(np.float64)
    po_args = (f(Hr), f(Hr - 1e-6 * np.eye(k)), f(DAn), f(rng.normal(size=(Bl, k))),
               f(rng.normal(size=(Bl, k))), f(rng.normal(size=(Bl, na)) * d),
               f(rng.normal(size=(Bl, k)) * fix), f(fix), f(d))
    out, outp = PO.box_candidate(*po_args, refine=refine), PO.box_candidate_plain(
        *po_args, refine=refine)
    torch.cuda.synchronize()
    rel = max(float((o - p).abs().max() / p.abs().max().clamp(min=1e-9))
              for o, p in zip(out, outp))
    check(rel < 2e-4, f"polish k={k}: relative error {rel} against the plain version")
    res["polish_k99"] = dict(
        shape=f"B={Bl} k={k} na={na} refine={refine}", rel_err=rel,
        max_abs_err=max(float((o - p).abs().max()) for o, p in zip(out, outp)),
        ms=graph_ms(torch, lambda: PO.box_candidate(*po_args, refine=refine)),
        plain_ms=time_ms(torch, lambda: PO.box_candidate_plain(*po_args, refine=refine), 5),
        bound_ms=bound(*polish_work(Bl, k, na, refine))[0])
    return res


def flagship(torch, dev, B, seed=0, T=10, K=10, **spec_kw):
    """bench.py's flagship spec and batch, built by the port itself (at
    another horizon T or obstacle count K where given)."""
    from neupan_torch.models import load_checkpoint
    from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
    from neupan_torch.ops.pan import PANSpec
    from neupan_torch.robot import Robot

    P = 2048
    robot = Robot.create(receding=T, step_time=0.1, kinematics="diff", max_speed=[8, 1],
                         max_acce=[8, 3], length=1.6, width=2.0)
    nrmp = NRMPSpec(T=T, K=K, kinematics="diff", speed_bound=tuple(robot.speed_bound[:, 0]),
                    acce_bound=tuple(robot.acce_bound[:, 0]))
    spec = PANSpec(robot=robot, nrmp=nrmp, iter_num=2, iter_threshold=0.1, dune_max_num=P,
                   **spec_kw)
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


def run_chain(torch, spec, encoder, geom, adjust, data, sl=slice(None), dev=None, steps=STEPS):
    """``steps`` chained planner steps; returns the outputs of each step."""
    from neupan_torch.parallel import batched_init_state, batched_planner_step

    mv = lambda t: t[sl].to(dev)
    nom_s, nom_u = mv(data["nom_s"]), mv(data["nom_u"])
    B = nom_s.shape[0]
    state = batched_init_state(spec, B, dev)
    outs = []
    for i in range(steps):
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


def to_cpu(encoder, geom, adjust):
    """Copies of the shared encoder, geometry and weights on the CPU."""
    import copy

    cpu = copy.deepcopy(encoder).to("cpu")
    return cpu, tuple(t.cpu() for t in geom), type(adjust)(*(t.cpu() for t in adjust))


def perturbed(data, eps=1e-6):
    """The chained inputs with the reference trajectory scaled by 1 + eps, a
    change the size of float32 rounding."""
    return dict(data, ref_s=data["ref_s"] * (1.0 + eps))


def noise_gate(name, d_card, d_noise):
    """Where a path's output moves with float32 rounding (the full-space
    ADMM: PERF.md section 6), the per-scenario differences card vs CPU
    ``d_card`` are held to the CPU's own under a 1e-6 change of ref_s
    (``perturbed``), ``d_noise``, on the same scenario-steps: the median
    within twice the noise's plus 1e-4, the 90th percentile within twice
    the noise's plus 5e-4. Returns the numbers."""
    q = lambda d, p: float(d.flatten().float().quantile(p))
    med_c, med_n, q90_c, q90_n = q(d_card, 0.5), q(d_noise, 0.5), q(d_card, 0.9), q(d_noise, 0.9)
    check(med_c <= 2 * med_n + 1e-4 and q90_c <= 2 * q90_n + 5e-4,
          f"{name}: card vs CPU median {med_c}, 90th percentile {q90_c}; the CPU against itself "
          f"perturbed: {med_n}, {q90_n}")
    return {"card_vs_cpu_median": med_c, "card_vs_cpu_q90": q90_c,
            "card_vs_cpu_max": float(d_card.max()), "cpu_vs_perturbed_median": med_n,
            "cpu_vs_perturbed_q90": q90_n, "cpu_vs_perturbed_max": float(d_noise.max()),
            "compared": d_card.numel()}


def chain_path(torch, dev, name, per_step, reps, with_b1, steps=STEPS, chaotic=False,
               **spec_kw):
    """``steps`` chained B=512 steps of one PANSpec variant with the launch
    counts checked, the first B_CPU scenarios against the CPU, ms/step and
    the profiler's device time.

    ``chaotic``: the variant's planner output moves by far more than 5e-4
    under a float32-sized change of its inputs (the full-space ADMM,
    ``solvers_path``), so opt_u card vs CPU is held by ``noise_gate``."""
    spec, encoder, geom, adjust, data = flagship(torch, dev, B_MAIN, **spec_kw)
    outs, launches = counted(
        torch, name, {k: v * steps for k, v in per_step.items()},
        lambda: run_chain(torch, spec, encoder, geom, adjust, data, dev=dev, steps=steps))
    for out in outs:
        check(tuple(out.opt_u.shape) == (B_MAIN, 2, spec.robot.T), "opt_u shape")
        check(bool(torch.isfinite(out.opt_u).all() & torch.isfinite(out.opt_s).all()),
              f"{name} path: non-finite planner output on the card")

    # the same chained inputs, first B_CPU scenarios, through the plain versions
    cpu = to_cpu(encoder, geom, adjust)
    outs_cpu = run_chain(torch, spec, *cpu, data, sl=slice(0, B_CPU), dev=torch.device("cpu"),
                         steps=steps)
    du = [float((o.opt_u[:B_CPU].cpu() - oc.opt_u).abs().max()) for o, oc in zip(outs, outs_cpu)]
    report = {"B": B_MAIN, "opt_u_card_vs_cpu_max": max(du), "cpu_scenarios": B_CPU}
    if chaotic:
        noisy = run_chain(torch, spec, *cpu, perturbed(data), sl=slice(0, B_CPU),
                          dev=torch.device("cpu"), steps=steps)
        per = lambda a, b: (a.opt_u[:B_CPU].cpu() - b.opt_u).abs().amax(dim=(1, 2))
        d_card = torch.stack([per(o, oc) for o, oc in zip(outs, outs_cpu)])
        d_noise = torch.stack([per(o, oc) for o, oc in zip(noisy, outs_cpu)])
        report["opt_u"] = noise_gate(f"{name} path", d_card, d_noise)
    else:
        for i, (d, o, oc) in enumerate(zip(du, outs, outs_cpu)):
            check(d <= 5e-4, f"{name} path, step {i}: opt_u card vs CPU differ by {d} > 5e-4")
            check(torch.equal(o.nrmp_valid[:B_CPU].cpu(), oc.nrmp_valid),
                  f"{name} path, step {i}: nrmp_valid differs between card and CPU")

    ms_main = step_ms(torch, spec, encoder, geom, adjust, data, B_MAIN, reps)
    report.update(ms_per_step=ms_main, solves_per_s=B_MAIN / ms_main * 1e3)
    if with_b1:
        ms_one = step_ms(torch, spec, encoder, geom, adjust, data, 1, reps)
        report.update(B1_ms_per_step=ms_one, B1_solves_per_s=1e3 / ms_one)
    prof, table = profile_step(torch, spec, encoder, geom, adjust, data, steps)
    print(f"[{name} path] " + table, file=sys.stderr)
    report.update(prof, device_idle_share=1.0 - prof["device_busy_ms_per_step"] / ms_main)
    return launches, report


def dune_path(torch, dev):
    """The materialized exact path with both kernel switches on, at the
    flagship shape: one call launches select_topk once and the fused MLP
    once (on the winners). Both devices read the card's point flow, so the
    ranking sees the same coordinates and picks the same points."""
    from neupan_torch.ops.dune import dune_forward, generate_point_flow

    spec, encoder, geom, adjust, data = flagship(torch, dev, B_MAIN)
    verts, G, h = geom
    K = spec.nrmp.K

    def run():
        with torch.no_grad():
            pf, R_all, pts_glob = generate_point_flow(data["nom_s"], data["pts"][0],
                                                      data["vels"], spec.robot.dt)
            return pf, R_all, pts_glob, dune_forward(
                encoder, G, h, pf, R_all, pts_glob, data["mask"], K, use_kernel=True,
                select="exact", vertices=verts, mlp_kernel=True)

    (pf, R_all, pts_glob, out), launches = counted(torch, "dune", PER_DUNE_CALL, run)
    check(tuple(out.mu_k.shape) == (B_MAIN, spec.robot.T + 1, G.shape[0], K), "mu_k shape")
    check(bool(out.valid_k.all() & torch.isfinite(out.mu_k).all()), "dune path: bad output")

    enc_cpu, (verts_c, G_c, h_c), _ = to_cpu(encoder, geom, adjust)
    c = lambda t: t[:B_CPU].cpu()
    with torch.no_grad():
        ref = dune_forward(enc_cpu, G_c, h_c, c(pf), c(R_all), c(pts_glob), c(data["mask"]), K,
                           use_kernel=True, select="exact", vertices=verts_c, mlp_kernel=True)
    check(torch.equal(c(out.valid_k), ref.valid_k), "dune path: valid_k card vs CPU")
    e_dist = float((c(out.dist_k) - ref.dist_k).abs().max())
    # slots are sorted by the learned distance: where two of a frame's distances
    # lie within 1e-4, a 1e-6 difference between the devices may swap the slots
    apart = (ref.dist_k[..., 1:] - ref.dist_k[..., :-1]).min(dim=-1).values > 1e-4
    e_mu = float(((c(out.mu_k) - ref.mu_k).abs().amax(dim=(2, 3)) * apart).max())
    e_mu_sum = float((c(out.mu_k).sum(-1) - ref.mu_k.sum(-1)).abs().max())
    check(e_dist <= 1e-4, f"dune path: dist_k card vs CPU differ by {e_dist}")
    check(e_mu <= 1e-4 and e_mu_sum <= 1e-4,
          f"dune path: mu_k card vs CPU differ by {e_mu} (slot sums {e_mu_sum})")
    ms = time_ms(torch, lambda: run(), 5)
    return launches, {"B": B_MAIN, "ms_per_call": ms, "dist_k_card_vs_cpu_max": e_dist,
                      "mu_k_card_vs_cpu_max": e_mu, "frames_compared_slotwise": int(apart.sum()),
                      "frames": int(apart.numel()), "cpu_scenarios": B_CPU}


# examples/<name>/{planner,env}.yaml as dicts: the card's machine is not promised
# pyyaml. tests/test_torch_loop.py holds each dict equal to yaml.safe_load of its file.
_LIDAR_HALF = {"type": "lidar2d", "range_min": 0, "range_max": 10, "angle_range": 3.1415926,
               "number": 100}
_CORRIDOR_WALLS = [{"name": "rectangle", "length": 70, "width": 2}] * 2 + [
    {"name": "rectangle", "length": 5, "width": 2}, {"name": "rectangle", "length": 5, "width": 2},
    {"name": "rectangle", "length": 6, "width": 2}, {"name": "rectangle", "length": 5, "width": 2}]


def _corridor_env(kinematics, shape, goal, goal_threshold, lidar, states):
    return {"world": {"height": 23, "width": 70, "step_time": 0.1},
            "robot": [{"kinematics": {"name": kinematics}, "shape": shape,
                       "state": [-5, 20, 0], "goal": goal, "goal_threshold": goal_threshold,
                       "sensors": [lidar]}],
            "obstacle": [{"number": 6, "shape": _CORRIDOR_WALLS, "state": states}]}


def _open_env(kinematics, shape, obstacles):
    return {"world": {"height": 20, "width": 50, "step_time": 0.1},
            "robot": [{"kinematics": {"name": kinematics}, "shape": shape, "state": [0, 0, 0],
                       "goal": [40, 0, 0], "goal_threshold": 0.5, "sensors": [_LIDAR_HALF]}],
            "obstacle": [obstacles]}


_RECT_16_20 = {"name": "rectangle", "length": 1.6, "width": 2.0}
_CORRIDOR_DIFF_PLANNER = {
    "receding": 10, "step_time": 0.1, "ref_speed": 4, "time_print": False,
    "collision_threshold": 0.1,
    "robot": {"kinematics": "diff", "max_speed": [8, 1], "max_acce": [8, 3], "length": 1.6,
              "width": 2.0},
    "ipath": {"waypoints": [[0, 20, 0], [60, 20, 0]], "curve_style": "line", "min_radius": 4.0,
              "loop": False, "arrive_threshold": 0.1, "close_threshold": 0.1, "ind_range": 10,
              "arrive_index_threshold": 1},
    "pan": {"iter_num": 2, "dune_max_num": 100, "nrmp_max_num": 10, "iter_threshold": 0.1,
            "dune_checkpoint": "examples/model/diff_robot_default/model.npz"},
    "adjust": {"q_s": 1.0, "p_u": 1.0, "eta": 15.0, "d_max": 1.0, "d_min": 0.25}}
_CORRIDOR_DIFF_ENV = _corridor_env(
    "diff", _RECT_16_20, [40, 40, 0], 0.3, _LIDAR_HALF,
    [[30, 25, 0], [30, 15, 0], [10, 18.5, 1.57], [27, 22.4, 1.57], [36, 17, 2.1], [50, 22, 4.3]])
_PAN_DIFF = {"iter_num": 2, "dune_max_num": 100, "nrmp_max_num": 10, "iter_threshold": 0.1,
             "dune_checkpoint": "examples/model/diff_robot_default/model.npz"}
_OPEN_IPATH = {"waypoints": [[0, 0, 0], [40, 0, 0]], "curve_style": "line", "loop": False}
CONFIGS = {
    "corridor/diff": {"planner": _CORRIDOR_DIFF_PLANNER, "env": _CORRIDOR_DIFF_ENV},
    "corridor/acker": {
        "planner": {
            "receding": 10, "step_time": 0.2, "ref_speed": 4, "collision_threshold": 0.1,
            "robot": {"kinematics": "acker", "max_speed": [8, 1.0], "max_acce": [8, 0.5],
                      "wheelbase": 3.0, "length": 4.6, "width": 1.6},
            "ipath": {"waypoints": [[0, 20, 0], [60, 20, 0]], "curve_style": "dubins",
                      "min_radius": 3.0, "loop": False},
            "pan": {"iter_num": 2, "dune_max_num": 100, "nrmp_max_num": 10, "iter_threshold": 0.1,
                    "dune_checkpoint": "examples/model/acker_robot_default/model.npz"},
            "adjust": {"q_s": 1.0, "p_u": 1.0, "eta": 15.0, "d_max": 1.0, "d_min": 0.1,
                       "bk": 1.0}},
        "env": _corridor_env(
            "acker", {"name": "rectangle", "length": 4.6, "width": 1.6, "wheelbase": 3.0},
            [55, 20, 0], 0.5, _LIDAR_HALF,
            [[30, 25.5, 0], [30, 14.5, 0], [10, 18, 1.57], [23, 22, 1.57], [36, 16.5, 2.1],
             [50, 22.5, 4.3]])},
    "corridor/omni": {
        "planner": {
            "receding": 10, "step_time": 0.1, "ref_speed": 3, "collision_threshold": 0.1,
            "robot": {"kinematics": "omni", "max_speed": [8, 6.28], "max_acce": [3, 3],
                      "length": 1.6, "width": 2.0},
            "ipath": {"waypoints": [[0, 20, 0], [10, 21.9, 0], [17, 20.5, 0], [23, 17.3, 0],
                                    [30, 20, 0], [36, 22, 0], [43, 20, 0], [50, 17.7, 0],
                                    [60, 20, 0]],
                      "curve_style": "line", "loop": False},
            "pan": _PAN_DIFF,
            "adjust": {"q_s": 1.0, "p_u": 1.0, "eta": 15.0, "d_max": 0.5, "d_min": 0.1}},
        "env": _corridor_env(
            "omni", _RECT_16_20, [40, 40, 0], 0.3, dict(_LIDAR_HALF, angle_range=6.28),
            [[30, 25, 0], [30, 15, 0], [10, 18, 1.57], [23, 22, 1.57], [36, 17, 2.1],
             [50, 22, 4.3]])},
    "polygon_robot/diff": {
        "planner": {
            "receding": 10, "step_time": 0.1, "ref_speed": 3, "collision_threshold": 0.1,
            "robot": {"kinematics": "diff", "max_speed": [8, 3], "max_acce": [8, 3],
                      "vertices": [[-0.8, -1.0], [-1.8, 1.0], [1.8, 1.0], [0.8, -1.0]]},
            "ipath": _OPEN_IPATH,
            "pan": dict(_PAN_DIFF, dune_checkpoint="examples/model/polygon_robot/model.npz"),
            "adjust": {"q_s": 1.0, "p_u": 1.0, "eta": 10.0, "d_max": 1.0, "d_min": 0.1}},
        "env": _open_env("diff", {"name": "polygon"}, {
            "number": 3,
            "shape": [{"name": "circle", "radius": 1.0},
                      {"name": "rectangle", "length": 3, "width": 1.5},
                      {"name": "circle", "radius": 0.8}],
            "state": [[12, 1.5, 0], [22, -1.8, 0.5], [32, 1.2, 0]]})},
    "corridor_long/diff": {"planner": dict(_CORRIDOR_DIFF_PLANNER, receding=30),
                           "env": _CORRIDOR_DIFF_ENV},
    "dyna_obs/diff": {
        "planner": {
            "receding": 10, "step_time": 0.1, "ref_speed": 3, "collision_threshold": 0.1,
            "robot": {"kinematics": "diff", "max_speed": [8, 1], "max_acce": [8, 3],
                      "length": 1.6, "width": 2.0},
            "ipath": _OPEN_IPATH, "pan": _PAN_DIFF,
            "adjust": {"q_s": 1.0, "p_u": 1.0, "eta": 10.0, "d_max": 1.0, "d_min": 0.1}},
        "env": _open_env("diff", _RECT_16_20, {
            "number": 3,
            "shape": [{"name": "circle", "radius": 0.8}, {"name": "circle", "radius": 0.8},
                      {"name": "rectangle", "length": 2, "width": 1.5}],
            "state": [[15, 4, 0], [25, -5, 0], [35, 5, 0]],
            "velocity": [[0.0, -0.4], [0.0, 0.5], [-0.3, -0.3]]})},
}


def against_cpu(name, kwargs, trace, tol=5e-4):
    """Feed a CPU planner built from ``kwargs`` the card's states, points and
    velocities tick by tick (each ``trace`` entry: state, points, velocities,
    action, min_distance, flags, and where it holds one, ``carry``: what the
    card's planner carried into the tick, which the CPU planner then starts
    the tick from): actions must agree to ``tol``, min_distance to 1e-4, the
    stop/arrive/collision flags exactly. Returns the largest action and
    min_distance differences."""
    from neupan_torch import NeuPan
    from neupan_torch.ops.pan import PANState

    on_cpu = NeuPan(**kwargs, device="cpu")
    d_act = d_min = 0.0
    for i, t in enumerate(trace):
        if "carry" in t:
            on_cpu.pan_state = PANState(*t["carry"][0])
            on_cpu.cur_vel_array = t["carry"][1].copy()
        action_c, info_c = on_cpu(t["state"], t["points"], t["velocities"])
        d_a = float(np.abs(t["action"] - action_c).max())
        d_m = abs(t["min_distance"] - on_cpu.min_distance)
        check(d_a <= tol, f"{name}, tick {i}: action card vs CPU differ by {d_a} > {tol}")
        check(d_m <= 1e-4, f"{name}, tick {i}: min_distance card vs CPU differ by {d_m} > 1e-4")
        check(t["flags"] == tuple(bool(info_c[k]) for k in FLAGS),
              f"{name}, tick {i}: flags card {t['flags']} vs CPU differ")
        d_act, d_min = max(d_act, d_a), max(d_min, d_m)
    return d_act, d_min


def tick(planner, state, points, velocities=None):
    """One planner tick, recorded for ``against_cpu``."""
    action, info = planner(state, points, velocities)
    check(action.shape == (2, 1) and bool(np.isfinite(action).all()),
          f"tick returned {action!r}")
    return dict(state=state, points=points, velocities=velocities, action=action.copy(),
                min_distance=planner.min_distance, flags=tuple(bool(info[k]) for k in FLAGS))


def facade_path(torch):
    """A NeuPan planner built from kwargs (examples/corridor/diff's values)
    plans FACADE_TICKS ticks on seeded wall points on the card, closing the
    loop through the exact kinematics; a planner without obstacle slots
    (examples/pf/diff's values) plans NO_OBS_TICKS. These ticks run the
    kernels at a batch of one and at the tracking QP's sizes, so a second
    planner of each kind on the CPU (plain versions) is fed the card's
    states and points tick by tick: actions must agree to 5e-4 and
    min_distance to 1e-4."""
    from neupan_torch import NeuPan
    from neupan_torch.config import planner_kwargs

    def drive(planner, ticks, start, points_of):
        state, trace, times = np.array(start, dtype=np.float64).reshape(3, 1), [], []
        for i in range(ticks):
            t0 = time.perf_counter()
            trace.append(tick(planner, state, points_of(i)))
            times.append((time.perf_counter() - t0) * 1e3)
            check(not any(trace[-1]["flags"][:2]), f"facade: tick {i} stopped")
            for key in ("state_tensor", "vel_tensor", "ref_state_tensor"):
                check(planner.info[key].is_cuda, f"facade: info[{key!r}] is not on the card")
            v, w, th = trace[-1]["action"][0, 0], trace[-1]["action"][1, 0], state[2, 0]
            state = state + planner.dt * np.array([[v * np.cos(th)], [v * np.sin(th)], [w]])
        return trace, times

    rng = np.random.default_rng(0)
    walls = [np.stack([rng.uniform(0.0, 14.0, 90),
                       20.0 + rng.choice([-1.0, 1.0], 90) * rng.uniform(1.8, 4.0, 90)])
             for _ in range(FACADE_TICKS)]
    corridor_kwargs = planner_kwargs(CONFIGS["corridor/diff"]["planner"])
    planner = NeuPan(**corridor_kwargs)           # no device named: the card
    check(planner.G.is_cuda and all(t.is_cuda for t in planner.pan_state)
          and next(planner.encoder.parameters()).is_cuda, "facade: planner state not on the card")
    (trace, times), launches = counted(
        torch, "facade", {k: v * FACADE_TICKS for k, v in PER_STEP.items()},
        lambda: drive(planner, FACADE_TICKS, [0.0, 20.0, 0.0], lambda i: walls[i]))
    actions = [t["action"][:, 0].tolist() for t in trace]
    check(actions[-1][0] > 0.5 and planner.min_distance < 10.0,
          f"facade: the planner does not drive ({actions[-1]}, min_distance {planner.min_distance})")
    check(planner.info["distance_tensor"].is_cuda, "facade: distance_tensor is not on the card")
    d_act, d_min = against_cpu("facade", corridor_kwargs, trace)

    no_obs_kwargs = dict(corridor_kwargs, ipath_kwargs=dict(waypoints=[[0, 0, 0], [40, 0, 0]],
                                                            curve_style="line", loop=False),
                         pan_kwargs=dict(iter_num=2, dune_max_num=0, nrmp_max_num=0,
                                         iter_threshold=0.1),
                         adjust_kwargs=dict(q_s=1.0, p_u=1.0))
    follower = NeuPan(**no_obs_kwargs)
    (trace0, times0), launches0 = counted(
        torch, "no-obstacle facade", {k: v * NO_OBS_TICKS for k, v in PER_STEP_NO_OBS.items()},
        lambda: drive(follower, NO_OBS_TICKS, [0.0, 0.0, 0.0], lambda i: None))
    actions0 = [t["action"][:, 0].tolist() for t in trace0]
    check(follower.info["distance_tensor"] is None and actions0[-1][0] > 0.5,
          f"no-obstacle facade: unexpected output {actions0[-1]}")
    d_act0, d_min0 = against_cpu("no-obstacle facade", no_obs_kwargs, trace0)
    for k in launches:
        launches[k] += launches0[k]
    # the first tick of each planner pays one-time set-up (library load, cuBLAS handles)
    return launches, {"ticks": FACADE_TICKS, "ms_per_tick": float(np.mean(times[1:])),
                      "first_tick_ms": times[0], "actions": actions,
                      "min_distance": planner.min_distance,
                      "action_card_vs_cpu_max": d_act, "min_distance_card_vs_cpu_max": d_min,
                      "no_obs_ticks": NO_OBS_TICKS, "no_obs_ms_per_tick": float(np.mean(times0[1:])),
                      "no_obs_actions": actions0, "no_obs_action_card_vs_cpu_max": d_act0}


def sim_planner(name, start=None, waypoints=None):
    """The port's planner (on the card) and Sim2D world of CONFIGS[name],
    from the dicts; with ``start``, the robot starts there and the planner's
    path runs from it through ``waypoints``."""
    from neupan_torch import NeuPan
    from neupan_torch.config import planner_kwargs
    from neupan_torch.sim.env_loader import build_env

    cfg = CONFIGS[name]["planner"]
    if waypoints is not None:
        cfg = dict(cfg, ipath=dict(cfg["ipath"], waypoints=waypoints))
    kwargs = planner_kwargs(cfg)
    planner = NeuPan(**kwargs)
    env = build_env(CONFIGS[name]["env"], planner.robot)
    if start is not None:
        env.state = np.asarray(start, dtype=np.float64).reshape(3, 1)
    return planner, env, kwargs


def closed_loop_path(torch):
    """The full corridor/diff episode on the card: the port's NeuPan in the
    port's Sim2D through ``examples/run_exp_torch.py:run_loop``, up to
    CLOSED_LOOP_MAX_TICKS ticks. It must arrive without a collision and
    with 0 contact steps; its tick count is printed beside the JAX
    package's record (sweep_results.json), not gated: arrival is chaotic in
    1e-3 action changes. Host ms per planner tick (median, p90) over the
    episode, and the device's busy ms per tick from a profiled window of
    PROFILE_TICKS ticks of a fresh episode."""
    from neupan_torch import native

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from run_exp_torch import run_loop

    planner, env, _ = sim_planner("corridor/diff")
    forward, times = planner.forward, []

    def timed(*args):
        t0 = time.perf_counter()
        out = forward(*args)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    planner.forward = timed
    # every tick but the last (the arrival check returns before the step) runs one step
    result, launches = counted(
        torch, "closed loop", lambda r: {k: v * r["steps"] for k, v in PER_STEP.items()},
        lambda: run_loop(planner, env, False, CLOSED_LOOP_MAX_TICKS))
    check(result["arrived"] and not result["collided"] and result["contacts"] == 0,
          f"closed loop: corridor/diff did not arrive cleanly: {result}")
    steady = np.asarray(times[1:-1])     # without the set-up tick and the arrival tick

    planner, env, _ = sim_planner("corridor/diff")
    busy_us, n_kernels = profile_kernels(
        torch, lambda: run_loop(planner, env, False, PROFILE_TICKS))
    return launches, {
        **result, "jax_steps": JAX_CORRIDOR_STEPS, "lidar": "native" if native.available() else "numpy",
        "ms_per_tick_median": float(np.median(steady)),
        "ms_per_tick_p90": float(np.percentile(steady, 90)), "first_tick_ms": times[0],
        "device_busy_ms_per_tick": busy_us / 1e3 / PROFILE_TICKS,
        "device_kernels_per_tick": n_kernels / PROFILE_TICKS, "profiled_ticks": PROFILE_TICKS}


def parity_path(torch):
    """PARITY_TICKS closed-loop ticks on the card of each of PARITY_CONFIGS
    (acker, omni, the trapezoid robot, T=30, moving obstacles with point
    velocities), in the port's Sim2D from a start before the obstacles; a
    CPU planner of each is fed, tick by tick, the card's states, points and
    velocities and what the card's planner carried into the tick
    (``against_cpu``): carrying its own warm start instead compounds float32
    differences (tests/test_torch_loop.py)."""
    launches, report = {}, {}
    for name, (start, waypoints) in PARITY_CONFIGS.items():
        planner, env, kwargs = sim_planner(name, start, waypoints)
        point_vel = name.startswith("dyna")

        def drive():
            trace = []
            for _ in range(PARITY_TICKS):
                state, scan = env.get_robot_state(), env.get_lidar_scan()
                if point_vel:
                    pts, vels = planner.scan_to_point_velocity(state, scan)
                else:
                    pts, vels = planner.scan_to_point(state, scan), None
                carry = (tuple(t.cpu() for t in planner.pan_state), planner.cur_vel_array.copy())
                trace.append(dict(tick(planner, state, pts, vels), carry=carry))
                check(not env.collided, f"{name}: collision")
                env.step(trace[-1]["action"])
            return trace

        trace, counts = counted(torch, name, {k: v * PARITY_TICKS for k, v in PER_STEP.items()},
                                drive)
        d_act, d_min = against_cpu(name, kwargs, trace)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        report[name] = {"ticks": PARITY_TICKS, "action_card_vs_cpu_max": d_act,
                        "min_distance_card_vs_cpu_max": d_min,
                        "min_distance_last": trace[-1]["min_distance"],
                        "points_last": 0 if trace[-1]["points"] is None
                        else int(trace[-1]["points"].shape[1])}
    return launches, report


def long_horizon_gates(name, d):
    """opt_u (or QP-level u) card vs CPU over the scenario-steps of a case,
    d (steps, B): each step's median to LONG_HORIZON_MEDIAN and largest to
    LONG_HORIZON_MAX, at most LONG_HORIZON_ABOVE above 5e-4 (returned)."""
    above = []
    for i, di in enumerate(d):
        check(float(di.median()) <= LONG_HORIZON_MEDIAN and float(di.max()) <= LONG_HORIZON_MAX,
              f"{name}, step {i}: u card vs CPU differ by {float(di.max())} (median "
              f"{float(di.median())})")
        above += [[i, int(b), float(di[b])] for b in (di > 5e-4).nonzero()[:, 0]]
    check(len(above) <= LONG_HORIZON_ABOVE,
          f"{name}: {len(above)} scenario-steps above 5e-4 card vs CPU: {above}")
    return above


def horizon_case(torch, dev, name, T, K, measure=False, chaotic=False, **spec_kw):
    """LONG_HORIZON_STEPS chained batched steps at horizon T with K obstacle
    slots, B=B_LONG, ``spec_kw`` PANSpec fields, against the same steps on
    the CPU under ``long_horizon_gates`` (the scenario-steps above 5e-4 are
    reported). The counters must show exactly the routes ``qp_routes``
    gives. ``chaotic`` (the full-space ADMM): ``noise_gate`` instead. With
    ``measure``, also the host ms of one step and its device busy ms and
    kernel count (torch.profiler)."""
    from neupan_torch.ops.pan import _admm_with_elim

    spec, encoder, geom, adjust, data = flagship(torch, dev, B_LONG, T=T, K=K, **spec_kw)
    nrmp, cfg = spec.nrmp, _admm_with_elim(spec)
    routes = qp_routes(nrmp, cfg, 2 * LONG_HORIZON_STEPS)   # two PAN iterations per step
    want = {"select": 2 * LONG_HORIZON_STEPS, "select_topk": 0, "mlp": 2 * LONG_HORIZON_STEPS,
            **routes}
    outs, counts = counted(torch, name, want, lambda: run_chain(
        torch, spec, encoder, geom, adjust, data, dev=dev, steps=LONG_HORIZON_STEPS))
    cpu = to_cpu(encoder, geom, adjust)
    outs_cpu = run_chain(torch, spec, *cpu, data, dev=torch.device("cpu"),
                         steps=LONG_HORIZON_STEPS)
    for o in outs:
        check(bool(torch.isfinite(o.opt_u).all()), f"{name}: non-finite opt_u on the card")
    d = torch.stack([(o.opt_u.cpu() - oc.opt_u).abs().amax(dim=(1, 2))
                     for o, oc in zip(outs, outs_cpu)])
    n_eq = cfg.elim_n_eq
    report = {"B": B_LONG, "steps": LONG_HORIZON_STEPS, "k": nrmp.n - n_eq, "m": nrmp.m - n_eq,
              "n": nrmp.n, "m_full": nrmp.m, "n_eq": n_eq, "na": cfg.elim_n_acc,
              "opt_u_card_vs_cpu_max": float(d.max()),
              "opt_u_card_vs_cpu_median": float(d.median(dim=1).values.max()),
              "routes": {key: counts[key] for key in routes}}
    if chaotic:
        noisy = run_chain(torch, spec, *cpu, perturbed(data), dev=torch.device("cpu"),
                          steps=LONG_HORIZON_STEPS)
        d_noise = torch.stack([(o.opt_u - oc.opt_u).abs().amax(dim=(1, 2))
                               for o, oc in zip(noisy, outs_cpu)])
        report["opt_u"] = noise_gate(name, d, d_noise)
    else:
        above = long_horizon_gates(name, d)
        report.update({"scenario_steps_above_5e-4": len(above), "above_5e-4": above})
    if measure:
        one = lambda: run_chain(torch, spec, encoder, geom, adjust, data, dev=dev, steps=1)
        report.update(host_and_device(torch, one, reps=2))
    print(f"{name}: routes {report['routes']}", file=sys.stderr)
    return counts, report


def host_and_device(torch, run, reps):
    """Host-clock ms of ``run`` (mean of ``reps``, each ending in a sync, after
    one warm-up) and its device busy ms and kernel count (torch.profiler)."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    busy_us, n_kernels = profile_kernels(torch, run)
    return {"ms_per_step": ms, "device_busy_ms_per_step": busy_us / 1e3,
            "device_kernels_per_step": n_kernels}


def long_horizon_path(torch, dev):
    """The shapes that take the plain routes on the card (fault F1 of the
    port), ``horizon_case`` at T=30, K=12 (the ADMM operator does not fit
    one block: its plain version) and at T=33 (n=99 > 96: the Cholesky
    inverses, and the polish's plain version)."""
    launches, report = {}, {}
    for T, K in LONG_HORIZON_CASES:
        name = f"T={T} K={K}"
        counts, report[name] = horizon_case(torch, dev, name, T, K)
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v
    return launches, report


def generic_qps(torch, B, seed, soft):
    """A batch of tests/test_qp.py's generic QPs from a numpy seed: random
    QPs (n=12, m=20, two equality rows), or with ``soft`` its soft-row form
    (n=10, eight hard rows of which two equalities, six one-sided penalty
    rows). Float32 QPData on the CPU."""
    from neupan_torch.ops.qp import QPData

    rng = np.random.default_rng(seed)
    if soft:
        n, m_h, m_s = 10, 8, 6
    else:
        n, m_h, m_s = 12, 20, 0
    P = rng.uniform(0.5, 2.0, (B, n))
    q = rng.normal(size=(B, n))
    Ah = rng.normal(size=(B, m_h, n))
    mid = np.einsum("bmn,bn->bm", Ah, rng.normal(size=(B, n))) * 0.1
    half = 1.0 if soft else rng.uniform(0.5, 2.0, (B, m_h))
    lh, uh = mid - half, mid + half
    lh[:, :2] = uh[:, :2] = mid[:, :2]
    As = rng.normal(size=(B, m_s, n))
    ls = np.einsum("bmn,bn->bm", As, rng.normal(size=(B, n))) * 0.1 + rng.uniform(-0.5, 0.5, (B, m_s))
    w = rng.uniform(5.0, 50.0, (B, m_s))
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    return QPData(t(P), t(q), t(np.concatenate([Ah, As], axis=1)), t(np.concatenate([lh, ls], 1)),
                  t(np.concatenate([uh, np.full((B, m_s), 1e20)], 1)),
                  soft=t(np.concatenate([np.zeros((B, m_h)), w], 1)) if soft else None)


def solvers_path(torch, dev):
    """The QP solver's paths off the main path, each counted (every launch
    count set to 0 just before it, read just after) and held against the
    port on the CPU fed the same inputs:

    (a) three chained flagship steps at B=512 with ``condense_admm=False``:
        the full-space ADMM, admm at (63, 181) on its kernel; the planner's
        output there moves by up to 0.7 under a 1e-6 change of its inputs
        (on the CPU alone), so opt_u card vs CPU on B_CPU scenarios is held
        to that spread (``noise_gate``);
    (b) one flagship B=512 step with the generic condensed polish (layout
        statics given with ``elim_n_acc=None``), opt_u to 5e-4;
    (c) B_LONG steps at T=30 (corridor_long/diff: K=10) in the full space,
        dense and ``inverse="banded"``: admm at (183, 541) on its plain
        version, the inverses by Cholesky or the block-tridiagonal route
        (whose library calls are counted); ``noise_gate`` as in (a), on
        every scenario;
    (d) ``solve_qp_batch`` at B=512 on tests/test_qp.py's generic QPs
        (``generic_qps``), polish on and off, x to 5e-4 on every scenario;
    (e) the facade at examples/corridor/diff with ``pan.admm =
        {"condense_admm": false}``: FACADE_TICKS ticks, each tick of the CPU
        planner from the card's carried state, actions to
        FACADE_FULLSPACE_TOL.

    Each reports ms per step on the host clock, device busy ms and kernels
    per step (torch.profiler), and each QP stage's route, counted."""
    from neupan_torch import NeuPan
    from neupan_torch.config import planner_kwargs
    from neupan_torch.ops.banded import btd_spd_inverse
    from neupan_torch.ops.nrmp import NRMPSpec
    from neupan_torch.ops.qp import ADMMConfig, solve_qp_batch

    launches, report = {}, {}

    def add(counts):
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v

    full = ADMMConfig(condense_admm=False)
    counts, report["fullspace"] = chain_path(torch, dev, "solvers fullspace", PER_STEP, 5, False,
                                             chaotic=True, admm=full)
    add(counts)
    report["fullspace"]["routes"] = {k: counts[k] for k in (*QP_PER_STEP, *twins())}

    nrmp = NRMPSpec(T=10, K=10, kinematics="diff", speed_bound=(8.0, 1.0), acce_bound=(8.0, 3.0))
    generic = ADMMConfig(elim_n_eq=nrmp.r_acc, elim_n_hard=nrmp.r_obs - nrmp.r_acc)
    routes = qp_routes(nrmp, generic, 2)           # one step: two PAN iterations
    counts, report["generic_polish"] = chain_path(
        torch, dev, "solvers generic polish", {"select": 2, "select_topk": 0, "mlp": 2, **routes},
        3, False, steps=1, admm=generic)
    add(counts)
    report["generic_polish"]["routes"] = {k: counts[k] for k in routes}

    T, K = 30, CONFIGS["corridor_long/diff"]["planner"]["pan"]["nrmp_max_num"]
    for name, cfg in (("T30_dense", full), ("T30_banded", ADMMConfig(condense_admm=False,
                                                                      inverse="banded"))):
        btd_spd_inverse.library_calls = 0
        counts, report[name] = horizon_case(torch, dev, f"solvers {name}", T, K, measure=True,
                                            chaotic=True, admm=cfg)
        add(counts)
        if counts["banded"]:   # both counters run on through the measured steps
            report[name]["banded_library_calls_per_inverse"] = (
                btd_spd_inverse.library_calls / btd_spd_inverse.launches)

    for soft in (False, True):
        qp_cpu = generic_qps(torch, B_MAIN, 11 + soft, soft)
        qp = type(qp_cpu)(*(None if t is None else t.to(dev) for t in qp_cpu))
        n, m = qp.A.shape[2], qp.A.shape[1]
        for polish in (True, False):
            cfg = ADMMConfig(iters=200, polish=polish)
            name = f"batch_{'soft' if soft else 'random'}_{'polish' if polish else 'nopolish'}"
            rounds = cfg.polish_rounds if polish else 0
            # no basis: two full-space phases, then per round the full-space
            # candidate's two inverses (Hp at n, S at m)
            sol, counts = counted(torch, f"solvers {name}",
                                  {**dict.fromkeys(KERNELS, 0), "sweep": 2 + 2 * rounds, "admm": 2},
                                  lambda: solve_qp_batch(qp, cfg))
            add(counts)
            ref = solve_qp_batch(qp_cpu, cfg)
            check(bool(torch.isfinite(sol.x).all()), f"solvers {name}: non-finite x on the card")
            dx = float((sol.x.cpu() - ref.x).abs().max())
            check(dx <= 5e-4, f"solvers {name}: x card vs CPU differ by {dx} > 5e-4")
            report[name] = {"B": B_MAIN, "n": n, "m": m, "x_card_vs_cpu_max": dx,
                            "r_prim_max": float(sol.r_prim.max()),
                            "routes": {k: counts[k] for k in (*QP_PER_STEP, *twins())},
                            **host_and_device(torch, lambda: solve_qp_batch(qp, cfg), reps=3)}

    kwargs = planner_kwargs(CONFIGS["corridor/diff"]["planner"])
    kwargs["pan_kwargs"] = dict(kwargs["pan_kwargs"], admm={"condense_admm": False})
    planner = NeuPan(**kwargs)
    check(not planner.spec.admm.condense_admm, "solvers facade: pan.admm did not reach the spec")
    rng = np.random.default_rng(0)
    walls = [np.stack([rng.uniform(0.0, 14.0, 90),
                       20.0 + rng.choice([-1.0, 1.0], 90) * rng.uniform(1.8, 4.0, 90)])
             for _ in range(FACADE_TICKS)]

    def drive():
        state, trace, times = np.array([[0.0], [20.0], [0.0]]), [], []
        for i in range(FACADE_TICKS):
            carry = (tuple(t.cpu() for t in planner.pan_state), planner.cur_vel_array.copy())
            t0 = time.perf_counter()
            trace.append(dict(tick(planner, state, walls[i]), carry=carry))
            times.append((time.perf_counter() - t0) * 1e3)
            v, w, th = trace[-1]["action"][0, 0], trace[-1]["action"][1, 0], state[2, 0]
            state = state + planner.dt * np.array([[v * np.cos(th)], [v * np.sin(th)], [w]])
        return trace, times

    (trace, times), counts = counted(torch, "solvers facade",
                                     {k: v * FACADE_TICKS for k, v in PER_STEP.items()}, drive)
    add(counts)
    d_act, d_min = against_cpu("solvers facade", kwargs, trace, tol=FACADE_FULLSPACE_TOL)
    busy_us, n_kernels = profile_kernels(torch, lambda: tick(planner, trace[-1]["state"],
                                                             walls[-1]))
    report["facade"] = {"ticks": FACADE_TICKS, "ms_per_tick": float(np.mean(times[1:])),
                        "device_busy_ms_per_tick": busy_us / 1e3,
                        "device_kernels_per_tick": n_kernels,
                        "action_card_vs_cpu_max": d_act, "min_distance_card_vs_cpu_max": d_min,
                        "routes": {k: counts[k] for k in (*QP_PER_STEP, *twins())}}
    print(f"[solvers] {json.dumps(report)}", file=sys.stderr)
    return launches, report


def grad_rel(grads, ref):
    """Largest difference over the fields of two AdjustParams gradients,
    relative to the largest magnitude of ``ref``."""
    scale = max(float(g.abs().max()) for g in ref)
    return max(float((a.cpu() - b).abs().max()) for a, b in zip(grads, ref)) / max(scale, 1e-30)


def grad_list(grads):
    return {f: g.cpu().tolist() for f, g in zip(grads._fields, grads)}


def lon_path(torch, dev):
    """LON on the card: the differentiated planner step and the tuning loop
    (examples/LON/LON_corridor_torch.py:run_episode, planner and world from
    CONFIGS).

    1. LON_TICKS corridor/diff tuning ticks with the near branch forced:
       each tick's grads w.r.t. AdjustParams against a CPU planner's from
       the card's carried inputs and weights, to GRAD_RTOL.
    2. One tuning episode of LON_EPISODE_TICKS ticks (threshold 0.4, lr
       5e-3): host ms per tuning tick (facade tick, differentiated step,
       Adam), median and p90; on each tick with a nonzero loss the CPU's
       grads from the card's inputs beside the card's; the final weights
       beside the JAX record's epoch 0 (examples/LON/results_corridor.txt:2).
    3. One differentiated flagship step at B=512 with the near branch
       forced: forward and backward ms (CUDA events), the device's busy time
       and kernel count (profiler), the KKT solve's own time (torch.linalg.
       solve on the step's own matrices, and at T=30's size from a B=64
       step), peak memory; the loss and summed grads of LON_SLICE scenarios
       against the CPU, to GRAD_RTOL.
    """
    from neupan_torch import NeuPan
    from neupan_torch.lon import LONTuner, distance_loss, step_loss_and_grad
    from neupan_torch.ops.nrmp import AdjustParams
    from neupan_torch.ops.pan import PANState, pan_forward
    from neupan_torch.parallel import batched_init_state

    sys.path.insert(0, os.path.join(ROOT, "examples", "LON"))
    import LON_corridor_torch as L

    def episode(ticks, threshold, on_tick):
        planner, env, kwargs = sim_planner("corridor/diff")
        planner.stuck_enabled = False
        L.MAX_STEPS, L.COLLISION_THRESHOLD = ticks, threshold
        tuner = LONTuner(planner.adjust, lr=LON_LR)
        counts = {"ticks": 0}
        forward = planner.forward

        def tick_counted(*args):
            counts["ticks"] += 1
            counts["t0"] = time.perf_counter()
            return forward(*args)

        planner.forward = tick_counted
        (losses, _), launches = counted(
            torch, f"lon ({ticks} ticks)", lambda r: {
                k: counts["ticks"] * PER_STEP[k] + len(r[0]) * PER_GRAD_STEP[k] for k in PER_STEP},
            lambda: L.run_episode(planner, tuner, None, env=env,
                                  on_tick=lambda *a: on_tick(counts["t0"], *a)))
        return planner, kwargs, losses, launches

    def cpu_grads(cpu, rec, threshold):
        """The CPU planner's step from the card's inputs, carried state and
        weights of one tuning tick."""
        inputs, state_in, adjust_in = rec[:3]
        loss, grads, _ = step_loss_and_grad(
            cpu.spec, cpu.encoder, cpu.vertices, cpu.G, cpu.h,
            AdjustParams(*(t.cpu() for t in adjust_in)), *(t.cpu() for t in inputs),
            PANState(*(t.cpu() for t in state_in)), collision_threshold=threshold)
        return loss, grads

    # 1. B=1 ticks, near branch forced, against the CPU
    recs = []
    planner, kwargs, losses, launches = episode(
        LON_TICKS, LON_NEAR, lambda t0, *rec: recs.append(rec))
    check(len(recs) == LON_TICKS and all(v > 0 for v in losses), f"lon ticks: losses {losses}")
    tick_err, cpu = [], NeuPan(**kwargs, device="cpu")
    for i, rec in enumerate(recs):
        loss_c, grads_c = cpu_grads(cpu, rec, LON_NEAR)
        e_loss = abs(float(rec[3]) - float(loss_c)) / abs(float(loss_c))
        e = grad_rel(rec[4], grads_c)
        check(e <= GRAD_RTOL and e_loss <= GRAD_RTOL,
              f"lon tick {i}: grads card vs CPU differ by {e} (loss {e_loss}) > {GRAD_RTOL}: "
              f"{grad_list(rec[4])} vs {grad_list(grads_c)}")
        tick_err.append(e)
    report = {"ticks": {"n": LON_TICKS, "threshold": LON_NEAR,
                        "grad_card_vs_cpu_max": max(tick_err), "losses": losses,
                        "grads_last": grad_list(recs[-1][4])}}

    # 2. one tuning episode on the card
    times, nonzero = [], []

    def on_tick(t0, *rec):
        times.append((time.perf_counter() - t0) * 1e3)
        if float(rec[3]) > 0:
            nonzero.append((len(times) - 1, rec))

    planner, _, losses, counts = episode(LON_EPISODE_TICKS, LON_THRESHOLD, on_tick)
    for k, v in counts.items():
        launches[k] += v
    beside = []
    for i, rec in nonzero:
        loss_c, grads_c = cpu_grads(cpu, rec, LON_THRESHOLD)
        beside.append({"tick": i, "loss": float(rec[3]), "loss_cpu": float(loss_c),
                       "card": grad_list(rec[4]), "cpu": grad_list(grads_c),
                       "rel": grad_rel(rec[4], grads_c)})
    steady = np.asarray(times[1:])
    with open(os.path.join(ROOT, "examples", "LON", "results_corridor.txt")) as fh:
        jax_epoch0 = fh.read().splitlines()[1]
    final = {f: float(getattr(planner.adjust, f)) for f in ("p_u", "eta", "d_max")}
    report["episode"] = {
        "ticks": len(losses), "threshold": LON_THRESHOLD, "lr": LON_LR,
        "episode_loss": float(np.sum(losses)), "nonzero_loss_ticks": len(nonzero),
        "ms_per_tuning_tick_median": float(np.median(steady)),
        "ms_per_tuning_tick_p90": float(np.percentile(steady, 90)),
        "first_tick_ms": times[0], "final": final, "jax_record_epoch0": jax_epoch0,
        "grad_card_vs_cpu_max": max((b["rel"] for b in beside), default=0.0),
        "nonzero_ticks_card_vs_cpu": beside}
    print(f"[lon episode] final {final} | JAX record: {jax_epoch0}", file=sys.stderr)

    # 3. the differentiated flagship step at B=512
    spec, encoder, geom, adjust, data = flagship(torch, dev, B_MAIN)
    args = lambda sl, d: ([data[k][sl].to(d) for k in ("nom_s", "nom_u", "ref_s", "ref_us")]
                          + [data["pts"][0][sl].to(d), data["vels"][sl].to(d),
                             data["mask"][sl].to(d)])
    state = batched_init_state(spec, B_MAIN, dev)
    adj = AdjustParams(*(t.clone().requires_grad_(True) for t in adjust))
    solves = []
    solve = torch.linalg.solve

    def spy(A, b):
        solves.append((A, b))
        return solve(A, b)

    def forward():
        out = pan_forward(spec, encoder, *geom, adj, *args(slice(None), dev), state)
        return distance_loss(out.opt_d, out.min_distance, LON_NEAR).sum()

    def backward(loss):
        return AdjustParams(*torch.autograd.grad(loss, list(adj)))

    def fwd_bwd():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = forward()
        ev[1].record()
        grads = backward(loss)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), grads

    def kkt_of(run):
        solves.clear()
        torch.linalg.solve = spy
        try:
            run()
        finally:
            torch.linalg.solve = solve
        return solves[0]

    (_, _, grads512), step_counts = counted(
        torch, "lon B=512 step", PER_GRAD_STEP, fwd_bwd)
    for k, v in step_counts.items():
        launches[k] += v
    check(all(bool(torch.isfinite(g).all()) for g in grads512), "lon B=512: non-finite grads")
    torch.cuda.reset_peak_memory_stats()
    runs = [fwd_bwd() for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    busy_fwd_us, n_fwd = profile_kernels(torch, forward)
    loss = forward()
    torch.cuda.synchronize()
    busy_bwd_us, n_bwd = profile_kernels(torch, lambda: backward(loss))
    K512, rhs512 = kkt_of(fwd_bwd)
    spec30, enc30, geom30, adjust30, data30 = flagship(torch, dev, 64, T=30, K=10)
    adj30 = AdjustParams(*(t.clone().requires_grad_(True) for t in adjust30))

    def fwd_bwd30():
        out = pan_forward(spec30, enc30, *geom30, adj30,
                          *[data30[k] for k in ("nom_s", "nom_u", "ref_s", "ref_us")],
                          data30["pts"][0], data30["vels"], data30["mask"],
                          batched_init_state(spec30, 64, dev))
        torch.autograd.grad(distance_loss(out.opt_d, out.min_distance, LON_NEAR).sum(),
                            list(adj30))

    K30, rhs30 = kkt_of(fwd_bwd30)
    # host-clock ms per call (CUDA events around 10 calls: torch.linalg.solve
    # checks its result on the host, so each call waits for the card) and the
    # device's kernel time of one call (profiler)
    kkt = {}
    for K, b in ((K512, rhs512), (K30, rhs30)):
        busy_us, n = profile_kernels(torch, lambda K=K, b=b: solve(K, b))
        kkt[str(tuple(K.shape))] = {"ms": time_ms(torch, lambda K=K, b=b: solve(K, b), 10),
                                    "device_ms": busy_us / 1e3, "device_kernels": n}

    # the loss and summed grads of a slice, card against CPU
    sl = slice(0, LON_SLICE)
    enc_c, geom_c, adjust_c = to_cpu(encoder, geom, adjust)
    state_c = batched_init_state(spec, LON_SLICE, "cpu")
    loss_g, grads_g, _ = step_loss_and_grad(spec, encoder, *geom, adjust, *args(sl, dev),
                                            batched_init_state(spec, LON_SLICE, dev),
                                            collision_threshold=LON_NEAR)
    loss_c, grads_c, _ = step_loss_and_grad(spec, enc_c, *geom_c, adjust_c,
                                            *args(sl, torch.device("cpu")), state_c,
                                            collision_threshold=LON_NEAR)
    e_slice = grad_rel(grads_g, grads_c)
    e_loss = float(((loss_g.cpu() - loss_c).abs() / loss_c.abs()).max())
    check(e_slice <= GRAD_RTOL and e_loss <= GRAD_RTOL,
          f"lon B={LON_SLICE} slice: grads card vs CPU differ by {e_slice} (loss {e_loss}): "
          f"{grad_list(grads_g)} vs {grad_list(grads_c)}")
    fwd_ms = float(np.median([r[0] for r in runs]))
    bwd_ms = float(np.median([r[1] for r in runs]))
    report["step_B512"] = {
        "B": B_MAIN, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "forward_device_busy_ms": busy_fwd_us / 1e3, "forward_device_kernels": n_fwd,
        "backward_device_busy_ms": busy_bwd_us / 1e3, "backward_device_kernels": n_bwd,
        "device_idle_share": 1.0 - (busy_fwd_us + busy_bwd_us) / 1e3 / (fwd_ms + bwd_ms),
        "kkt_solve_ms": kkt, "peak_memory_bytes": peak, "grads": grad_list(grads512),
        "slice": LON_SLICE, "slice_grad_card_vs_cpu": e_slice,
        "slice_loss_card_vs_cpu": e_loss, "slice_grads_card": grad_list(grads_g),
        "slice_grads_cpu": grad_list(grads_c)}
    print(f"[lon] {json.dumps(report['step_B512'])}", file=sys.stderr)
    return launches, report


def train_path(torch, dev):
    """DUNE training on the card at full width (``neupan_torch/training``):
    the diff robot's labels, epochs of batch 256 over 80,000 of 100,000
    points with adam_l2 at lr 5e-5, the full encoder (2 -> 32 x5 -> 4).

    a. Labels of 100,000 seeded points on the card and on the CPU: d to
       1e-5 (1 + d), points with other active faces counted (at most
       TRAIN_LABEL_FLIPS), mu to 1e-5 on the rest; the labels' device time.
    b. One epoch (312 updates) from ObsPointNet.seeded on the card and on
       the CPU with the same permutation and rotations (drawn on the card):
       loss terms and weights to TRAIN_LOSS_RTOL and TRAIN_W_*; two more
       epochs on the card, whose summed loss must fall from epoch 0 to 2.
    c. ms per epoch (host clock, ending in the epoch's one read), device
       busy ms and kernels per update (a profiled window of
       TRAIN_PROFILE_STEPS updates, run with ``torch.cuda``'s sync debug
       mode at "error": no update may wait for the card), the idle share.
    d. The trained encoder saved and loaded back (load_checkpoint), then
       ``DuneTrainer.test`` at 1,000, 10,000 and 100,000 points: the fused
       MLP kernel against the module to TRAIN_MLP_ATOL.
    e. A planner built from dune_train_diff.yaml's values (direct_train)
       runs ``train_dune(epoch=1, data_size=20000)`` and plans one tick: the
       tick must launch the fused MLP, and on the tick's points the kernel
       must equal the trained module (and differ from the seeded init).

    The launch counts cover DuneTrainer.test and the facade's tick; the
    comparisons of the kernel with the module run after them.
    """
    import copy
    import shutil
    import tempfile

    from neupan_torch import NeuPan
    from neupan_torch.config import planner_kwargs
    from neupan_torch.models import ObsPointNet, load_checkpoint, save_checkpoint, to_jax_params
    from neupan_torch.ops import dune as D
    from neupan_torch.ops.kernels.mlp import dune_mlp
    from neupan_torch.robot import Robot
    from neupan_torch.training import DuneTrainer
    from neupan_torch.training.dune_train import run_epoch
    from neupan_torch.training.labels import polygon_labels
    from neupan_torch.training.optim import Adam, exponential_decay

    cpu = torch.device("cpu")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(ROOT, "build"))
    robot = Robot.create(receding=10, step_time=0.1, **DUNE_TRAIN_DIFF["robot"])
    trainer = DuneTrainer(robot.G, robot.h, tmp, device=dev)
    G, h = trainer.G, trainer.h
    report = {}

    # a. labels
    pts_c = torch.tensor(np.random.default_rng(0).uniform(-25, 25, (TRAIN_POINTS, 2)),
                         dtype=torch.float32)
    pts = pts_c.to(dev)
    mu_c, d_c, act_c = polygon_labels(G.cpu(), h.cpu(), pts_c)
    mu, d, act = polygon_labels(G, h, pts)
    torch.cuda.synchronize()
    mu, d, act = mu.cpu(), d.cpu(), act.cpu()
    d_err = float(((d - d_c).abs() / (1 + d_c)).max())
    same = (act == act_c).all(dim=1)
    flips = int((~same).sum())
    mu_err = float((mu - mu_c)[same].abs().max())
    check(d_err <= 1e-5 and flips <= TRAIN_LABEL_FLIPS and mu_err <= 1e-5,
          f"train labels card vs CPU: d {d_err} (of 1 + d), mu {mu_err}, {flips} points "
          f"with other active faces")
    busy_us, n_kernels = profile_kernels(torch, lambda: polygon_labels(G, h, pts))
    report["labels"] = {"points": TRAIN_POINTS, "d_card_vs_cpu_rel": d_err,
                        "mu_card_vs_cpu": mu_err, "active_set_flips": flips,
                        "ms": time_ms(torch, lambda: polygon_labels(G, h, pts), 5),
                        "device_busy_ms": busy_us / 1e3, "device_kernels": n_kernels}

    # b. one epoch card vs CPU, then two more on the card
    n_train = int(0.8 * TRAIN_POINTS)
    nb = n_train // TRAIN_BATCH
    data_c = tuple(a[:n_train] for a in (pts_c, mu_c, d_c))
    data = tuple(a.to(dev) for a in data_c)
    sched = exponential_decay(TRAIN_LR, 1500 * nb, 0.5)
    gen = torch.Generator(device=dev).manual_seed(0)
    net, net_c = (ObsPointNet.seeded(2, G.shape[0], seed=0, device=d_) for d_ in (dev, cpu))
    opt, opt_c = Adam(list(net.parameters()), sched), Adam(list(net_c.parameters()), sched)
    epochs, epoch_ms = [], []
    for e in range(TRAIN_EPOCHS_CARD):
        perm, thetas, _ = trainer.draws(gen, n_train, nb, TRAIN_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terms = run_epoch(net, opt, data, perm, thetas, G, h).cpu()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        epochs.append(terms)
        if e == 0:
            w0 = to_jax_params(net)
            t0 = time.perf_counter()
            terms_c = run_epoch(net_c, opt_c, data_c, perm.cpu(), thetas.cpu(), G.cpu(), h.cpu())
            cpu_epoch_ms = (time.perf_counter() - t0) * 1e3
    loss_rel = float(((epochs[0] - terms_c).abs() / terms_c.abs()).max())
    w_cpu = to_jax_params(net_c)
    diff = np.concatenate([np.abs(w0[k] - w_cpu[k]).ravel() for k in w_cpu])
    scale = TRAIN_LR * nb
    beyond = int((diff > TRAIN_W_TIGHT * scale).sum())
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train epoch 0: loss terms card vs CPU differ by "
          f"{loss_rel} relative: {epochs[0].tolist()} vs {terms_c.tolist()}")
    check(beyond <= TRAIN_W_BEYOND * diff.size and float(diff.max()) <= TRAIN_W_CAP * scale,
          f"train epoch 0: weights card vs CPU differ by up to {float(diff.max())} "
          f"({beyond} of {diff.size} beyond {TRAIN_W_TIGHT * scale})")
    sums = [float(t.sum()) for t in epochs]
    check(sums[-1] < sums[0], f"train: the summed loss did not fall over the epochs: {sums}")

    # c. device time of TRAIN_PROFILE_STEPS updates, which must not wait for the
    # card: any synchronizing call among them raises under the sync debug mode
    perm, thetas, _ = trainer.draws(gen, n_train, TRAIN_PROFILE_STEPS, TRAIN_BATCH)

    def window():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run_epoch(net, opt, data, perm, thetas, G, h)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    busy_us, n_kernels = profile_kernels(torch, window)
    ms_epoch = float(np.median(epoch_ms))
    busy_step = busy_us / 1e3 / TRAIN_PROFILE_STEPS
    report["epoch"] = {
        "updates": nb, "batch": TRAIN_BATCH, "lr": TRAIN_LR, "ms_per_epoch": epoch_ms,
        "ms_per_epoch_median": ms_epoch, "cpu_ms_per_epoch": cpu_epoch_ms,
        "loss_terms": [t.tolist() for t in epochs], "loss_terms_cpu_epoch0": terms_c.tolist(),
        "loss_card_vs_cpu_rel": loss_rel, "weights_card_vs_cpu_max": float(diff.max()),
        "weights_beyond_tight": beyond, "weights": int(diff.size),
        "weights_tight_bound": TRAIN_W_TIGHT * scale,
        "device_busy_ms_per_update": busy_step, "sync_free_updates": TRAIN_PROFILE_STEPS,
        "device_kernels_per_update": n_kernels / TRAIN_PROFILE_STEPS,
        "device_idle_share": 1.0 - busy_step * nb / ms_epoch,
        "extrapolated_5000_epochs_h": ms_epoch * 5001 / 3.6e6}

    # d. checkpoint round trip, DuneTrainer.test through the fused MLP
    path = os.path.join(tmp, "model_chip_smoke.npz")
    save_checkpoint(path, net)
    loaded = load_checkpoint(path, device=dev)
    back = to_jax_params(loaded)
    check(all(np.array_equal(back[k], v) for k, v in to_jax_params(net).items()),
          "train: the checkpoint did not load back bit for bit")

    # e. the facade: train_dune, then one tick with the trained weights
    planner = NeuPan(**planner_kwargs(DUNE_TRAIN_DIFF, ipath=dict(_OPEN_IPATH)))
    seeded = copy.deepcopy(planner.encoder)
    tick_points = []

    def spy(encoder, points):
        tick_points.append(points.detach().clone())
        return dune_mlp(encoder, points)

    def run():
        results = trainer.test(loaded, data_size_list=TRAIN_TEST_SIZES)
        t0 = time.perf_counter()
        planner.train_dune(epoch=1, data_size=TRAIN_FACADE_POINTS,
                           checkpoint_dir=os.path.join(tmp, "facade"))
        torch.cuda.synchronize()
        train_dune_s = time.perf_counter() - t0
        n0 = dune_mlp.launches
        D.dune_mlp = spy
        try:
            action = tick(planner, np.zeros((3, 1)),
                          np.array([[3.0, 4.0, 5.0, 6.0], [0.5, -0.5, 1.0, -1.5]]))["action"]
        finally:
            D.dune_mlp = dune_mlp
        return results, train_dune_s, dune_mlp.launches - n0, action

    (results, train_dune_s, tick_mlp, action), launches = counted(
        torch, "train", dict(PER_STEP, mlp=PER_STEP["mlp"] + 12 * len(TRAIN_TEST_SIZES)), run)
    check(tick_mlp == PER_STEP["mlp"] and len(tick_points) == PER_STEP["mlp"],
          f"train: the facade's tick launched the fused MLP {tick_mlp} times")
    errs = [r["kernel_vs_module_max_abs"] for r in results]
    check(max(errs) <= TRAIN_MLP_ATOL,
          f"train: DuneTrainer.test, kernel vs module {errs} > {TRAIN_MLP_ATOL}")
    tick_err, tick_seeded = 0.0, float("inf")
    with torch.no_grad():
        for p in tick_points:
            got = dune_mlp(planner.encoder, p)
            tick_err = max(tick_err, float((got - planner.encoder(p)).abs().max()))
            tick_seeded = min(tick_seeded, float((got - seeded(p)).abs().max()))
    check(tick_err <= TRAIN_MLP_ATOL and tick_seeded > TRAIN_MLP_ATOL,
          f"train: the tick's duals are {tick_err} from the trained module and "
          f"{tick_seeded} from the seeded init")
    report["test"] = results
    report["facade"] = {"train_dune_s": train_dune_s, "points": TRAIN_FACADE_POINTS,
                        "tick_mlp_launches": tick_mlp, "action": action[:, 0].tolist(),
                        "kernel_vs_trained_module": tick_err,
                        "kernel_vs_seeded_init_min": tick_seeded}
    shutil.rmtree(tmp)
    print(f"[train] {json.dumps(report)}", file=sys.stderr)
    return launches, report


def run_sharded_chain(torch, spec, mesh, encoder, geom, adjust, data, sl=slice(None),
                      steps=STEPS):
    """``steps`` chained ``sharded_planner_step`` calls over ``mesh``, the
    trajectory and the state carried as the step returns them (sharded);
    returns the outputs of each step."""
    from neupan_torch.parallel import batched_init_state, sharded_planner_step

    nom_s, nom_u = data["nom_s"][sl], data["nom_u"][sl]
    state = batched_init_state(spec, nom_s.shape[0], nom_s.device)
    outs = []
    for i in range(steps):
        out = sharded_planner_step(spec, mesh, encoder, *geom, adjust, nom_s, nom_u,
                                   data["ref_s"][sl], data["ref_us"][sl], data["pts"][i][sl],
                                   data["vels"][sl], data["mask"][sl], state)
        outs.append(out)
        nom_s, nom_u, state = out.opt_s, out.opt_u, out.state
    return outs


def one_step(torch, spec, encoder, geom, adjust, data, B, mesh=None):
    """A call of one planner step on the first B scenarios of ``data``
    (batched, or sharded over ``mesh``), for timing."""
    from neupan_torch.parallel import batched_init_state, batched_planner_step, \
        scenario_sharding, sharded_planner_step

    sl = slice(0, B)
    args = [data[k][sl] for k in ("nom_s", "nom_u", "ref_s", "ref_us")]
    args += [data["pts"][0][sl], data["vels"][sl], data["mask"][sl]]
    state = batched_init_state(spec, B, args[0].device)
    if mesh is None:
        return lambda: batched_planner_step(spec, encoder, *geom, adjust, *args, state)
    # placed once, as a chained step finds its inputs
    split = scenario_sharding(mesh)
    args, state = [split.put(a) for a in args], split.put(state)
    return lambda: sharded_planner_step(spec, mesh, encoder, *geom, adjust, *args, state)


def _fields(out, ref):
    """(name, out's tensor, ref's tensor) of every output and carried field."""
    from neupan_torch.ops.pan import PANOutput, PANState

    return ([(f, getattr(out, f), getattr(ref, f)) for f in PANOutput._fields[:-1]]
            + [(f"state.{f}", getattr(out.state, f), getattr(ref.state, f))
               for f in PANState._fields])


def shards_vs_parts(torch, name, outs, parts):
    """Each shard q of each chained sharded step against the batched step
    run on that shard's scenarios alone, chained the same (``parts[q]``):
    every field and the carried state equal, bit for bit. The per-shard
    computation is the batched step, so nothing else may differ."""
    from neupan_torch.ops.pan import PANState

    for i, out in enumerate(outs):
        for q, part in enumerate(parts):
            shard = type(out)(*(None if f is None else f.shards[q] for f in out[:-1]),
                              PANState(*(f.shards[q] for f in out.state)))
            for field, a, b in _fields(shard, part[i]):
                check(torch.equal(a.to(b.device), b), f"{name}, step {i}, shard {q}: {field} "
                      "differs from the batched step on the shard's scenarios")


def sharded_vs_batched(torch, name, outs, refs):
    """Chained sharded outputs against the batched step on the whole batch:
    opt_u within the cross-backend 5e-4, min_distance at SHARDED_RTOL/ATOL.
    Returns the largest difference of each field and the opt_u elements
    beyond SHARDED_RTOL/ATOL: the batched step itself moves by that much
    between a batch of 512 and of 128 (library matmuls block by batch)."""
    from neupan_torch.parallel import gather

    worst, beyond = {}, 0
    for i, (out, ref) in enumerate(zip(outs, refs)):
        out = gather(out, ref.opt_u.device)
        for field, a, b in _fields(out, ref):
            if a.dtype != torch.bool:
                worst[field] = max(worst.get(field, 0.0), float((a - b).abs().max()))
        du = float((out.opt_u - ref.opt_u).abs().max())
        check(du <= 5e-4, f"{name}, step {i}: opt_u differs from the batched step by {du}")
        check(bool(torch.isclose(out.min_distance, ref.min_distance, rtol=SHARDED_RTOL,
                                 atol=SHARDED_ATOL).all()),
              f"{name}, step {i}: min_distance differs from the batched step")
        beyond += int((~torch.isclose(out.opt_u, ref.opt_u, rtol=SHARDED_RTOL,
                                      atol=SHARDED_ATOL)).sum())
    return {"max_abs": worst, "opt_u_beyond_rtol_atol": beyond,
            "opt_u_elements": sum(r.opt_u.numel() for r in refs)}


def trace_phase(torch, run):
    """``neupan_torch.utils.profile_trace`` around ``run``: the trace file
    must exist and name every hand kernel that the run launches (``ENTRIES``
    of each kernel with launches in PER_STEP)."""
    import shutil
    import tempfile

    from neupan_torch.utils import profile_trace

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_", dir=os.path.join(ROOT, "build"))
    with profile_trace(tmp) as where:
        run()
    files = [f for f in os.listdir(where) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"profile_trace wrote {os.listdir(where)}, not one trace")
    path = os.path.join(where, files[0])
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {k: sorted({n for n in names for entry in ENTRIES[k] if entry in n})[:2]
             for k, n_per in PER_STEP.items() if n_per}
    missing = [k for k, v in found.items() if not v]
    check(not missing, f"profile_trace: the trace names no entry of {missing}")
    report = {"trace_bytes": os.path.getsize(path), "events": len(events),
              "kernel_events": len(kernels), "hand_kernel_entries": found}
    shutil.rmtree(tmp)
    return report


def sharded_path(torch, dev):
    """The scenario axis split over a mesh (``neupan_torch.parallel``), at the
    flagship batch B=512 (diff robot, T=10, P=2048, K=10):

    a. a mesh of every card (``make_mesh()``; one on a one-card machine):
       three chained steps, launches counted (len(mesh) times the batched
       step's); each shard bit for bit the batched step on card 0 on its
       own scenarios (the whole batch on one card), and against the
       batched step on the whole batch opt_u to 5e-4 and min_distance to
       SHARDED_RTOL/ATOL (``sharded_vs_batched``: a batch of 128 rounds
       otherwise than one of 512, so opt_u moves by up to ~1e-4 between
       them with no sharding at all);
    b. ``Mesh((cuda:0,) * 4)``, four shards of 128 on card 0: the same,
       with the first B_CPU scenarios also against the CPU (opt_u to 5e-4,
       nrmp_valid equal), and host ms, device busy ms and kernels per step
       beside the batched step's, at B=512 and at B=4 (one scenario per
       shard) beside B=1; the same for a. where it has more than one card;
    c. one four-shard step inside ``profile_trace``: its trace must name
       each hand kernel's entries.
    """
    from neupan_torch.parallel import Mesh, gather, make_mesh

    spec, encoder, geom, adjust, data = flagship(torch, dev, B_MAIN)
    refs = run_chain(torch, spec, encoder, geom, adjust, data, dev=dev)
    meshes = {"every_card": make_mesh(), "card0_x4": Mesh((dev,) * SHARDS)}
    print(f"[sharded] a mesh of every card: {len(meshes['every_card'])} device(s), "
          f"{[str(d) for d in meshes['every_card'].devices]}", file=sys.stderr)
    total, report = dict.fromkeys(KERNELS, 0), {}
    for key, mesh in meshes.items():
        n = len(mesh)
        outs, launches = counted(
            torch, f"sharded ({key})", {k: v * STEPS * n for k, v in PER_STEP.items()},
            lambda: run_sharded_chain(torch, spec, mesh, encoder, geom, adjust, data))
        for k in KERNELS:
            total[k] += launches[k]
        for out in outs:
            check(all(len(f) == n for f in (*out[:-1], *out.state)),
                  f"sharded ({key}): an output is not split into {n} shards")
        b = B_MAIN // n
        parts = [refs] if n == 1 else [
            run_chain(torch, spec, encoder, geom, adjust, data, sl=slice(q * b, (q + 1) * b),
                      dev=dev) for q in range(n)]
        shards_vs_parts(torch, f"sharded ({key})", outs, parts)
        rep = {"devices": [str(d) for d in mesh.devices], "B": B_MAIN, "B_per_shard": b,
               "launches": {k: launches[k] for k in KERNELS}, "shards_equal_batched_parts": True,
               "vs_batched_B512": sharded_vs_batched(torch, f"sharded ({key})", outs, refs)}
        if key == "card0_x4":
            cpu = to_cpu(encoder, geom, adjust)
            outs_cpu = run_chain(torch, spec, *cpu, data, sl=slice(0, B_CPU),
                                 dev=torch.device("cpu"))
            du = []
            for i, (o, oc) in enumerate(zip(outs, outs_cpu)):
                o = gather(o, dev)
                du.append(float((o.opt_u[:B_CPU].cpu() - oc.opt_u).abs().max()))
                check(du[-1] <= 5e-4, f"sharded ({key}), step {i}: opt_u card vs CPU differ by "
                      f"{du[-1]} > 5e-4")
                check(torch.equal(o.nrmp_valid[:B_CPU].cpu(), oc.nrmp_valid),
                      f"sharded ({key}), step {i}: nrmp_valid differs between card and CPU")
            rep.update(opt_u_card_vs_cpu_max=max(du), cpu_scenarios=B_CPU)
        if n > 1:
            timed = lambda B, m: host_and_device(
                torch, one_step(torch, spec, encoder, geom, adjust, data, B, m), SHARDED_REPS)
            rep["batched_B512"], rep["sharded_B512"] = timed(B_MAIN, None), timed(B_MAIN, mesh)
            rep["batched_B1"], rep[f"sharded_B{n}"] = timed(1, None), timed(n, mesh)
        report[key] = rep
    report["profile_trace"] = trace_phase(
        torch, one_step(torch, spec, encoder, geom, adjust, data, B_MAIN, meshes["card0_x4"]))
    print(f"[sharded] {json.dumps(report)}", file=sys.stderr)
    return total, report


def precision_path(torch, dev):
    """``PANSpec(precision="default")`` beside ``"highest"``: three chained
    flagship steps each, launches counted. A sentinel matmul
    (SENTINEL_N square) must differ from the exact one inside
    ``matmul_precision("default")``; inside the default step the NRMP
    assembly (``ops/pan.py:build_qp``) must see TF32 allowed and compute the
    sentinel as far from the exact product as the scope did, the QP's solve (``ops/qp.py:_solve``) must see it
    off, and the flag must read off again after each step. Reports the opt_u
    difference of the two precisions (median, max), both paths' device busy
    ms and ms per step, and the library kernels one step launches at one
    precision and not at the other (names and launches).
    No accuracy gate beyond finite outputs: the JAX package offers the
    option as a trade of accuracy for speed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import neupan_torch.ops.pan as PAN
    import neupan_torch.ops.qp as QP
    from neupan_torch import matmul_precision

    flags = torch.backends.cuda.matmul
    check(flags.allow_tf32 is False, "the package did not pin exact float32 CUDA matmuls")
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randn((SENTINEL_N, SENTINEL_N), device=dev, generator=gen) for _ in range(2))
    exact = a @ b
    with matmul_precision("default"):
        tf32 = a @ b
    check(flags.allow_tf32 is False, "matmul_precision left TF32 on")
    sentinel = float((tf32 - exact).abs().max())
    check(sentinel > 0, "matmul_precision('default') did not change a float32 matmul")

    runs, by_path, names = {}, {}, {}
    for prec in ("highest", "default"):
        spec, encoder, geom, adjust, data = flagship(torch, dev, B_MAIN, precision=prec)
        seen = {"build_qp": set(), "_solve": set(), "sentinel": set()}
        build_qp, solve = PAN.build_qp, QP._solve

        def spy_build(*args, **kw):
            seen["build_qp"].add(flags.allow_tf32)
            seen["sentinel"].add(float((a @ b - exact).abs().max()) > sentinel / 2)
            return build_qp(*args, **kw)

        def spy_solve(*args, **kw):
            seen["_solve"].add(flags.allow_tf32)
            return solve(*args, **kw)

        PAN.build_qp, QP._solve = spy_build, spy_solve
        try:
            outs, launches = counted(
                torch, f"precision {prec}", {k: v * STEPS for k, v in PER_STEP.items()},
                lambda: run_chain(torch, spec, encoder, geom, adjust, data, dev=dev))
        finally:
            PAN.build_qp, QP._solve = build_qp, solve
        tf = prec == "default"
        check(seen["build_qp"] == {tf} and seen["sentinel"] == {tf} and seen["_solve"] == {False},
              f"precision {prec}: flags seen inside the step {seen}")
        check(flags.allow_tf32 is False, f"precision {prec}: the step left TF32 on")
        for out in outs:
            check(bool(torch.isfinite(out.opt_u).all() & torch.isfinite(out.opt_s).all()),
                  f"precision {prec}: non-finite planner output")
        prof, _ = profile_step(torch, spec, encoder, geom, adjust, data)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            one_step(torch, spec, encoder, geom, adjust, data, B_MAIN)()
            torch.cuda.synchronize()
        names[prec] = collections.Counter(
            e.name for e in p.events() if e.device_type == DeviceType.CUDA)
        runs[prec] = {"outs": outs, "ms_per_step": step_ms(torch, spec, encoder, geom, adjust,
                                                            data, B_MAIN, 5),
                      "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                      "device_kernels_per_step": prof["device_kernels_per_step"]}
        by_path[prec] = launches
    du = torch.stack([(o.opt_u - r.opt_u).abs().amax(dim=(1, 2)) for o, r in
                      zip(runs["default"].pop("outs"), runs["highest"].pop("outs"))])
    # the library kernels that the scope swapped in: launched in the default
    # step and not in the exact one, and the other way round
    swapped = {f"only_{a}": {n[:120]: c for n, c in (names[a] - names[b]).most_common(6)}
               for a, b in (("default", "highest"), ("highest", "default"))}
    report = {"sentinel_max_abs_diff": sentinel, "B": B_MAIN, **runs, **swapped,
              "opt_u_default_vs_highest_median": float(du.median()),
              "opt_u_default_vs_highest_max": float(du.max()),
              "opt_u_default_vs_highest_per_step_max": du.amax(dim=1).tolist()}
    print(f"[precision] {json.dumps(report)}", file=sys.stderr)
    return by_path["default"], report


def train_data_parallel(torch, dev):
    """The data-parallel DUNE training update at full width (``__graft_entry__.py``'s
    dry run): a batch of TRAIN_BATCH labelled points in dune_train_diff.yaml's
    range, the deployed diff encoder, one adam_l2 update at TRAIN_LR, split
    over ``Mesh((cuda:0,) * 4)`` (four shards of 64) and over a mesh of every
    card (``data_parallel_update``), against the same update on the whole
    batch on one device: the summed gradients to 1e-5 of the largest, the
    updated weights to the train path's bound (TRAIN_W_TIGHT of lr, at most
    TRAIN_W_BEYOND of them beyond it, none beyond TRAIN_W_CAP of lr); host
    ms, device busy ms and kernels of one update, sharded and not."""
    from neupan_torch.models import load_checkpoint
    from neupan_torch.parallel import Mesh, make_mesh
    from neupan_torch.robot import Robot
    from neupan_torch.training.dune_train import _loss_terms, rotation
    from neupan_torch.training.labels import polygon_distance_labels
    from neupan_torch.training.optim import Adam, exponential_decay

    robot = Robot.create(receding=10, step_time=0.1, **DUNE_TRAIN_DIFF["robot"])
    G, h = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (robot.G, robot.h))
    rng = np.random.default_rng(0)
    lo, hi = DUNE_TRAIN_DIFF["train"]["data_range"][:2], DUNE_TRAIN_DIFF["train"]["data_range"][2:]
    pts = torch.tensor(rng.uniform(lo, hi, (TRAIN_BATCH, 2)), dtype=torch.float32, device=dev)
    mu, d = polygon_distance_labels(G, h, pts)
    R = rotation(torch.tensor(rng.uniform(0, 2 * np.pi), dtype=torch.float32, device=dev))
    ckpt = os.path.join(ROOT, "examples/model/diff_robot_default/model.npz")

    def fresh():
        net = load_checkpoint(ckpt, device=dev)
        return net, Adam(list(net.parameters()), exponential_decay(TRAIN_LR, 0, 1.0))

    def single(net, opt):
        params = list(net.parameters())
        grads = torch.autograd.grad(sum(_loss_terms(net, pts, mu, d, G, h, R)), params)
        opt.step(params, grads)
        return grads

    net_ref, opt_ref = fresh()
    ref = single(net_ref, opt_ref)
    scale = max(float(g.abs().max()) for g in ref)
    timed = fresh()
    report = {"batch": TRAIN_BATCH, "lr": TRAIN_LR,
              "single": host_and_device(torch, lambda: single(*timed), SHARDED_REPS)}
    for key, mesh in (("card0_x4", Mesh((dev,) * SHARDS)), ("every_card", make_mesh())):
        net, opt = fresh()
        grads = data_parallel_update(torch, net, opt, mesh, (pts, mu, d), G, h, R)
        g_rel = max(float((g.to(dev) - r).abs().max()) for g, r in zip(grads, ref)) / scale
        diff = torch.cat([(p - q).detach().abs().flatten()
                          for p, q in zip(net.parameters(), net_ref.parameters())])
        beyond = int((diff > TRAIN_W_TIGHT * TRAIN_LR).sum())
        check(g_rel <= 1e-5, f"train data-parallel ({key}): summed gradients differ from the "
              f"single update's by {g_rel} of the largest")
        check(beyond <= TRAIN_W_BEYOND * diff.numel() and float(diff.max()) <= TRAIN_W_CAP * TRAIN_LR,
              f"train data-parallel ({key}): weights differ by up to {float(diff.max())} "
              f"({beyond} of {diff.numel()} beyond {TRAIN_W_TIGHT * TRAIN_LR})")
        report[key] = {"shards": len(mesh), "grad_rel_max": g_rel,
                       "weights_max_abs_diff": float(diff.max()), "weights_beyond_tight": beyond,
                       "update": host_and_device(
                           torch, lambda: data_parallel_update(torch, *timed, mesh,
                                                               (pts, mu, d), G, h, R),
                           SHARDED_REPS)}
    print(f"[train data-parallel] {json.dumps(report)}", file=sys.stderr)
    return report


def data_parallel_update(torch, net, opt, mesh, batch, G, h, R):
    """One data-parallel DUNE training update (``__graft_entry__.py``'s
    dry run): the batch ``(points, mu, d)`` split over ``mesh``, the
    encoder replicated; each shard's replica takes the gradient of its
    share of the loss (``dune_train._loss_terms`` weighted by the shard's
    size over the batch's, so the shares sum to the batch's mean), the
    gradients are summed on the mesh's first device, where ``net`` lies,
    and ``opt`` updates ``net`` there once. Returns the summed gradients."""
    from neupan_torch.parallel import replicated_sharding, scenario_sharding
    from neupan_torch.training.dune_train import _loss_terms

    p, mu, d = (scenario_sharding(mesh).put(t) for t in batch)
    nets, Gs, hs, Rs = (replicated_sharding(mesh).put(x) for x in (net, G, h, R))
    total = None
    for i in range(len(mesh)):
        terms = _loss_terms(nets[i], p.shards[i], mu.shards[i], d.shards[i], Gs[i], hs[i], Rs[i])
        share = p.shards[i].shape[0] / p.shape[0]
        grads = torch.autograd.grad(sum(terms) * share, list(nets[i].parameters()))
        grads = [g.to(mesh.devices[0]) for g in grads]
        total = grads if total is None else [a + g for a, g in zip(total, grads)]
    opt.step(list(net.parameters()), total)
    return total


def profile_kernels(torch, run):
    """Device kernel time (us) and kernel count over one call of ``run``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels), len(kernels)


def profile_step(torch, spec, encoder, geom, adjust, data, steps=STEPS):
    """Device kernel time over the chained B=512 steps (torch.profiler).

    Returns the device's kernel-busy time and kernel count per step, the
    fused MLP's and ``_lam_and_distance``'s device time per DUNE call, and
    a table of device time by kernel name.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from neupan_torch.ops import dune as D

    glue, calls = D._lam_and_distance, [0]

    def lam_and_distance(*args):
        calls[0] += 1
        with record_function(GLUE):
            return glue(*args)

    D._lam_and_distance = lam_and_distance
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_chain(torch, spec, encoder, geom, adjust, data, dev=data["pts"][0].device,
                      steps=steps)
            torch.cuda.synchronize()
    finally:
        D._lam_and_distance = glue
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name != GLUE]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    # the kernels that ran inside the glue's ranges on the device timeline
    spans = [e.time_range for e in events if e.device_type == DeviceType.CUDA and e.name == GLUE]
    glue_us = sum(k.time_range.elapsed_us() for k in kernels
                  if any(r.start <= k.time_range.start and k.time_range.end <= r.end for r in spans))
    if not spans:   # no device-side ranges: the host ranges' device time
        glue_us = sum(getattr(e, "device_time_total", 0.0) for e in events
                      if e.device_type == DeviceType.CPU and e.name == GLUE)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ours = tuple(e for names in ENTRIES.values() for e in names)
    ours_us = sum(t for n, t in by_name.items() if any(k in n for k in ours))
    lines = [f"device kernels over {steps} steps, by name (us, share of busy time)"]
    lines += [f"{t:12.1f} {t / busy_us:7.2%}  {name[:140]}"
              for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:30]]
    mlp_us = sum(t for n, t in by_name.items() if any(k in n for k in ENTRIES["mlp"]))
    summary = {"device_busy_ms_per_step": busy_us / 1e3 / steps,
               "device_kernels_per_step": len(kernels) / steps,
               "hand_kernels_ms_per_step": ours_us / 1e3 / steps,
               "mlp_kernel_ms_per_dune_call": mlp_us / 1e3 / calls[0],
               "lam_and_distance_ms_per_dune_call": glue_us / 1e3 / calls[0]}
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
        usage = ptxas_usage(fh.read())
    print(f"build: {json.dumps(usage)}", file=sys.stderr)

    kern = kernel_phase(torch, dev)
    by_path, report = {}, {}
    by_path["fused"], report["step"] = chain_path(torch, dev, "fused", PER_STEP, 10, True)
    by_path["dune"], report["dune_exact_kernels"] = dune_path(torch, dev)
    by_path["mlp"], report["step_mlp"] = chain_path(
        torch, dev, "mlp", PER_STEP_MLP, 5, False, dune_select="mlp", dune_mlp_kernel=True)
    by_path["facade"], report["facade"] = facade_path(torch)
    by_path["closed_loop"], report["closed_loop"] = closed_loop_path(torch)
    print(f"[closed loop] {json.dumps(report['closed_loop'])}", file=sys.stderr)
    by_path["parity"], report["closed_loop_card_vs_cpu"] = parity_path(torch)
    print(f"[parity] {json.dumps(report['closed_loop_card_vs_cpu'])}", file=sys.stderr)
    by_path["long_horizon"], report["long_horizon"] = long_horizon_path(torch, dev)
    by_path["solvers"], report["solvers"] = solvers_path(torch, dev)
    check(report["solvers"]["fullspace"]["routes"]["admm"] > 0
          and report["solvers"]["T30_dense"]["routes"]["admm_plain"] > 0,
          "solvers path: admm did not take its kernel at T=10 and its plain version at T=30")
    by_path["lon"], report["lon"] = lon_path(torch, dev)
    for name in ("select", "sweep", "admm", "polish"):
        check(by_path["lon"][name] > 0, f"lon path: {name} was not launched")
    by_path["train"], report["train"] = train_path(torch, dev)
    check(by_path["train"]["mlp"] > 0, "train path: mlp was not launched")
    by_path["sharded"], report["sharded"] = sharded_path(torch, dev)
    report["train_data_parallel"] = train_data_parallel(torch, dev)
    by_path["precision_default"], report["precision_default"] = precision_path(torch, dev)
    card = card_name_and_power()

    entries = []
    for name in KERNELS:
        r = kern[name]
        launches = {path: counts[name] for path, counts in by_path.items()}
        check(sum(launches.values()) > 0, f"{name}: no path launched it")
        entries.append({
            "name": name, "route": "cuda", "source": f"neupan_torch/csrc/{SOURCE[name]}",
            "replaces": REPLACES[name], "launches": sum(launches.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": r["shape"], "launches_by_path": launches,
            "ptxas": {e: u for e, u in usage.items() if e.split("<")[0] in ENTRIES[name]}})
        if "ms_B1" in r:
            entries[-1].update(ms_B1=r["ms_B1"], bound_ms_B1=r["bound_B1"][0])
        if name == "polish":
            entries[-1]["at_T33"] = kern["polish_k99"]
        if name == "admm":
            entries[-1]["at_fullspace"] = kern["admm_fullspace"]
        if "bound_cuda_core" in r:
            entries[-1].update(bound_design="tensor_core",
                               bound_ms_cuda_core=r["bound_cuda_core"][0])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"build_s": build_s, "sweep_by_n": kern["sweep_by_n"],
                      "select_refill": kern["select_refill"],
                      "mlp_by_n": kern["mlp_by_n"], "mlp_acker": kern["mlp_acker"], **report,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
