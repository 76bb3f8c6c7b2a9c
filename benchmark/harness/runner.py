"""One run of a cell: the program built from the configuration, its warm-up
steps, the measured window, the traced steps and the sampled results.

The loop is a central fleet planner's or a host simulator's: one step for
every robot per control tick through ``neupan_torch.parallel.
batched_planner_step``, the carried ``PANState`` going from step to step as
the program returns it, and every step's actions (``opt_u``) read back to
the host before the next step is issued. Each step is timed from handing
its inputs to the entry point until its actions are on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from benchmark.harness import traffic as TR

FAULTS = ("state", "half", "answer")
OUT_FIELDS = ("opt_s", "opt_u", "opt_d", "min_distance", "nrmp_points", "nrmp_valid")


class Program:
    """The system under test at the configuration's settings, on ``device``.
    ``precision`` overrides the configuration's (the lower-precision
    control); ``fault`` breaks the timed path on purpose (the harness's own
    tests and the faults' readings)."""

    def __init__(self, root: str, cfg: dict, device, precision: Optional[str] = None,
                 fault: Optional[str] = None):
        import neupan_torch  # noqa: F401  (pins exact float32 matmuls)
        from neupan_torch.models import load_checkpoint
        from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
        from neupan_torch.ops.pan import PANSpec
        from neupan_torch.ops.qp import ADMMConfig
        from neupan_torch.robot import Robot

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault must be one of {FAULTS}")
        self.device = torch.device(device)
        self.fault = fault
        pan = cfg["pan"]
        robot = Robot.create(receding=cfg["receding"], step_time=cfg["step_time"], **cfg["robot"])
        nrmp = NRMPSpec(T=robot.T, K=int(pan["nrmp_max_num"]), kinematics=robot.kinematics,
                        speed_bound=tuple(robot.speed_bound[:, 0]),
                        acce_bound=tuple(robot.acce_bound[:, 0]), **cfg["nrmp"])
        solver = dict(cfg["solver"])
        warm = solver.pop("admm_warm_iters")
        self.spec = PANSpec(robot=robot, nrmp=nrmp, iter_num=int(pan["iter_num"]),
                            iter_threshold=float(pan["iter_threshold"]),
                            dune_max_num=int(pan["dune_max_num"]), admm=ADMMConfig(**solver),
                            admm_warm_iters=warm, precision=precision or pan["precision"],
                            dune_select=pan["dune_select"])
        self.encoder = load_checkpoint(os.path.join(root, pan["dune_checkpoint"]),
                                       device=self.device)
        self.geom = robot.tensors(self.device)
        self.adjust = AdjustParams(*(torch.tensor(float(cfg["adjust"][k]), device=self.device)
                                     for k in ("q_s", "p_u", "eta", "d_max", "d_min")))

    def init_state(self, lanes: TR.Lanes):
        from neupan_torch.parallel import batched_init_state
        return batched_init_state(self.spec, lanes.batch, self.device)

    def step(self, points: torch.Tensor, fixed, state):
        from neupan_torch.parallel import batched_planner_step

        if self.fault == "half":
            return self._half(points, fixed, state)
        out = batched_planner_step(self.spec, self.encoder, *self.geom, self.adjust,
                                   *fixed[:4], points, *fixed[4:], state)
        if self.fault == "state":
            out = out._replace(state=state)
        elif self.fault == "answer":
            u = out.opt_u.clone()
            u[:, 0, 0] += 0.01
            out = out._replace(opt_u=u)
        return out

    def _half(self, points, fixed, state):
        """The step on the first half of the scenarios; the second half
        returns the first half's results."""
        from neupan_torch.ops.pan import PANState

        cut = lambda t: t[: t.shape[0] // 2]
        twice = lambda t: None if t is None else torch.cat([t, t])
        saved, self.fault = self.fault, None
        try:
            out = self.step(cut(points), tuple(cut(f) for f in fixed),
                            PANState(*(cut(v) for v in state)))
        finally:
            self.fault = saved
        return type(out)(*(twice(v) for v in out[:-1]), PANState(*(twice(v) for v in out.state)))


@dataclasses.dataclass
class Record:
    """The sampled scenarios of one step: their carried state going in (None
    at step 0, which starts from the empty state) and what the step returned."""
    step: int
    ids: np.ndarray
    state_in: Optional[tuple]
    out: dict


def record(n: int, ids, state_in, out) -> Record:
    rows = torch.as_tensor(ids, device=out.opt_u.device)
    take = lambda x: x.index_select(0, rows)
    st = None if state_in is None else tuple(take(v) for v in state_in)
    got = {f: take(getattr(out, f)) for f in OUT_FIELDS}
    got["state"] = tuple(take(v) for v in out.state)
    return Record(n, ids, st, got)


class Spans:
    """The harness's own host spans (traffic, issue, read-back, check), as
    ``record_function`` ranges while a profiler runs and free otherwise."""

    def __init__(self):
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiling:
            with torch.profiler.record_function(f"bench.{name}"):
                yield
        else:
            yield


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    steps: int = 0
    seconds: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    issue_s: list = dataclasses.field(default_factory=list)
    nonfinite: int = 0


class Runner:
    """Drives the chain: ``run(count or seconds)`` issues steps from the
    current step number on, samples results for the check, and keeps the
    state for the next call. The first ``chain`` steps record step 0's
    sampled scenarios, which the reference follows with its own state."""

    def __init__(self, program: Program, lanes: TR.Lanes, mix: dict, seed: int):
        self.p, self.lanes, self.seed = program, lanes, seed
        self.fixed = lanes.fixed(lanes.batch, program.device)
        self.state = program.init_state(lanes)
        self.n = 0
        self.records: List[Record] = []
        self.spans = Spans()
        check = mix["check"]
        self.every, self.per_step = int(check["every"]), int(check["scenarios"])
        self.chain = int(check["chain"])
        self.chain_ids = TR.sampled_scenarios(seed, 0, lanes.batch, self.per_step)
        self.sampling = True

    def one(self, win: Window):
        n = self.n
        with self.spans("traffic"):
            pts = self.lanes.points(n)
        t0 = time.perf_counter()
        with self.spans("issue"):
            out = self.p.step(pts, self.fixed, self.state)
        t1 = time.perf_counter()
        with self.spans("readback"):
            host = out.opt_u.cpu()
        t2 = time.perf_counter()
        win.step_s.append(t2 - t0)
        win.issue_s.append(t1 - t0)
        win.nonfinite += int((~np.isfinite(host.numpy()).all(axis=(1, 2))).sum())
        if self.sampling and (n < self.chain or TR.is_sampled(self.lanes.key, n, self.every)):
            with self.spans("check"):
                ids = (self.chain_ids if n < self.chain else
                       TR.sampled_scenarios(self.seed, n, self.lanes.batch, self.per_step))
                self.records.append(record(n, ids, None if n == 0 else self.state, out))
        self.state = out.state
        self.n += 1
        win.steps += 1

    def run(self, count: Optional[int] = None, seconds: Optional[float] = None) -> Window:
        """``count`` steps, or steps until ``seconds`` have passed; ends once
        the card is done."""
        win = Window()
        t_start = time.perf_counter()
        while True:
            self.one(win)
            if count is not None and win.steps >= count:
                break
            if seconds is not None and time.perf_counter() - t_start >= seconds:
                break
        sync(self.p.device)
        win.seconds = time.perf_counter() - t_start
        return win
