"""Work counted from shapes, and the published peaks of one H100.

Frozen copies of ``chip_smoke.py``'s ``select_work``, ``mlp_work``,
``sweep_work``, ``admm_work``, ``polish_work``, ``bound`` and ``PEAK_*``
(float operations, an FMA counting two and compares included; bytes with
each input read once and each output written once), so that a change to
the program cannot change the yardstick. ``launches_per_step`` and
``step_flops`` add what the benchmark needs: the kernels' launches in one
planner step, and the float operations of the whole step counted for the
algorithm, not for any kernel. Both follow from the configuration alone.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores (an FMA counts 2)
PEAK_TF32 = 495e12     # H100 SXM TF32 on the tensor cores, dense
PEAK_MUFU = PEAK_FLOPS / 16   # 16 special-function results per clock per SM, 128 FMA lanes
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
TANH_FP32, TANH_MUFU = 9, 2   # tanhf as nvcc compiles it for sm_90a
MLP_KERNEL_FLOATS = 9128      # the fused encoder's packed weights that the kernel reads
HIDDEN = 32


def bound(ops: float, nbytes: float):
    """Least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def select_work(B, Tp1, P, V, E, K):
    per_point = 12 + 20 * V + 5 * E + 2 + K   # flow, edges, faces, key, extraction
    ops = B * Tp1 * P * per_point
    nbytes = B * P * (2 * 4 + 2 * 4 + 1) + B * 5 * Tp1 * 4 + 2 * B * Tp1 * K * 4
    return ops, nbytes


def mlp_work(N, E, H=HIDDEN):
    """Multiply-adds of the six products, float32 instructions of the rest
    (three LayerNorms at 5 per feature, ReLUs, 96 tanh), MUFU operations and
    bytes of one encoder call on N points."""
    macs = 2 * H + 4 * H * H + H * E
    elementwise = 3 * 5 * H + 2 * H + E + 3 * H * TANH_FP32
    mufu = 3 * H * TANH_MUFU + 3
    return dict(macs=N * macs, fp32=N * elementwise, mufu=N * mufu,
                bytes=N * (2 + E) * 4 + MLP_KERNEL_FLOATS * 4)


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


class Shapes:
    """The step's sizes from a ``benchmark/configs`` file."""

    def __init__(self, cfg: dict):
        pan, solver = cfg["pan"], cfg["solver"]
        self.T, self.K, self.P = int(cfg["receding"]), int(pan["nrmp_max_num"]), int(pan["dune_max_num"])
        self.V = self.E = 4                      # the rectangular robot
        self.iter_num = int(pan["iter_num"])
        self.iters, self.warm = int(solver["iters"]), int(solver["admm_warm_iters"])
        self.phases = int(solver["rho_updates"]) + 1
        self.rounds, self.refine = int(solver["polish_rounds"]), int(solver["refine_steps"])
        self.ruiz = int(solver["ruiz_iters"])
        T, K = self.T, self.K
        self.n = 6 * T + 3                       # x = (s, u, d)
        self.n_eq = 3 * T + 3                    # dynamics and initial rows
        self.m = 8 * T + 1 + T * K
        self.k = 3 * T                           # w = (u, d)
        self.mr = self.m - self.n_eq             # rows of the condensed problem
        self.na = 2 * (T - 1)                    # acceleration rows

    def admm_iters(self):
        """The iteration count of each ADMM launch of one step."""
        out = []
        for it in range(self.iter_num):
            total = self.iters if it == 0 else self.warm
            per = max(total // self.phases, 1)
            out += [per] * (self.phases - 1) + [total - per * (self.phases - 1)]
        return out


def launches_per_step(sh: Shapes) -> dict:
    """Launches of each hand kernel in one step (one DUNE call and one QP per
    PAN iteration; every scenario runs every iteration)."""
    qps = sh.iter_num
    return {"select": qps, "mlp": qps, "sweep": qps * (1 + sh.phases),
            "admm": qps * sh.phases, "polish": qps * sh.rounds}


def kernel_bounds_ms(sh: Shapes, B: int) -> dict:
    """Least time of one step's launches of admm and polish at batch B, ms."""
    admm = sum(bound(*admm_work(B, sh.k, sh.mr, it))[0] for it in sh.admm_iters())
    polish = sh.iter_num * sh.rounds * bound(*polish_work(B, sh.k, sh.na, sh.refine))[0]
    return {"admm": admm, "polish": polish}


def step_flops(sh: Shapes) -> dict:
    """Float operations of one scenario's planner step by part, counted for
    the algorithm: the selection over every point and frame, the encoder and
    the duals on the K winners of each frame, the QP's assembly products
    (the nullspace basis, the condensed Hessian and rows, Ruiz scaling, the
    normal matrices), the SPD inverses, the ADMM iterations, and each polish
    round's assembly, candidate solve and error checks."""
    T, K, P, E = sh.T, sh.K, sh.P, sh.E
    n, n_eq, k, mr, na, m = sh.n, sh.n_eq, sh.k, sh.mr, sh.na, sh.m
    N = (T + 1) * K
    mlp = mlp_work(N, E)
    per_iter = {
        "select": select_work(1, T + 1, P, sh.V, E, K)[0],
        "encoder": 2 * mlp["macs"] + mlp["fp32"] + N * 10 * E,
        "assembly": (36 * T * T + 2 * n * k * k + 2 * mr * n * k + sh.ruiz * 4 * (mr * k + k * k)
                     + sh.phases * (2 * mr * k * k + mr * k)),
        "inverses": sweep_work(1, n_eq)[0] + sh.phases * sweep_work(1, k)[0],
        "polish": sh.rounds * (2 * m * n * k + 2 * m * k * k + 4 * n * k * k + 2 * na * n * k
                               + polish_work(1, k, na, sh.refine)[0] + 6 * m * n
                               + 2 * n_eq * n_eq + 2 * n_eq * n),
    }
    out = {name: sh.iter_num * v for name, v in per_iter.items()}
    out["admm"] = sum(admm_work(1, k, mr, it)[0] for it in sh.admm_iters())
    return out
