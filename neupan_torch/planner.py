"""NeuPan planner facade — the user-facing API (port of ``neupan_tpu/planner.py``).

The surface of the reference ``neupan`` class: ``init_from_yaml``,
``forward(state, points, velocities)``, ``scan_to_point[_velocity]``, path
setters, ``update_adjust_parameters``, ``reset``, and the read-only
properties (min_distance / dune_points / nrmp_points / initial_path /
adjust_parameters / waypoints / opt_trajectory / ref_trajectory), and
``train_dune``, which trains the planner's encoder in place
(``neupan_torch/training``).

The tick itself runs without gradients (the fused MLP kernel on the card);
LON (``neupan_torch/lon.py``, ``examples/LON/*_torch.py``) differentiates
the same step after a tick from ``pan_state``, ``cur_vel_array`` and
``_pad_points`` and installs the tuned weights with
``set_adjust_parameters``.

This class is a thin host shell around the batched PAN step
(``ops/pan.py:pan_forward``) at a batch of one. The robot geometry, the
encoder, the adjustable weights and the ``PANState`` live on the planner's
device (``device=None`` is the card; an unknown or absent device raises).
Per control tick it

  1. runs the host-side initial-path logic (numpy),
  2. pads/decimates the obstacle points to the static capacity P,
  3. moves the nominal/reference arrays and the padded points up, runs the
     step, and brings the optimized trajectory, the minimum distance and
     the NRMP points down (one synchronization per tick),
  4. post-processes the action (collision stop, omni conversion).
"""

from __future__ import annotations

import os
from math import cos, sin
from typing import Optional

import numpy as np
import torch

from neupan_torch import resolve_device, utils
from neupan_torch.config import load_planner_config
from neupan_torch.ipath import InitialPath
from neupan_torch.models.obs_point_net import ObsPointNet, load_checkpoint
from neupan_torch.ops.nrmp import AdjustParams, NRMPSpec
from neupan_torch.ops.pan import PANSpec, PANState, pan_forward
from neupan_torch.ops.qp import ADMMConfig
from neupan_torch.parallel import batched_init_state
from neupan_torch.robot import Robot
from neupan_torch.utils import downsample_decimation, file_check, get_transform, time_it

_INF = float("inf")


class NeuPan:
    """Real-time, map-free MPC planner mapping obstacle points to actions."""

    def __init__(
        self,
        receding: int = 10,
        step_time: float = 0.1,
        ref_speed: float = 4.0,
        device: Optional[str] = None,
        robot_kwargs: Optional[dict] = None,
        ipath_kwargs: Optional[dict] = None,
        pan_kwargs: Optional[dict] = None,
        adjust_kwargs: Optional[dict] = None,
        train_kwargs: Optional[dict] = None,
        **kwargs,
    ) -> None:
        robot_kwargs = robot_kwargs or {}
        ipath_kwargs = ipath_kwargs or {}
        pan_kwargs = pan_kwargs or {}
        adjust_kwargs = adjust_kwargs or {}
        train_kwargs = train_kwargs or {}

        self.T = receding
        self.dt = step_time
        self.ref_speed = ref_speed

        utils.set_time_print(kwargs.get("time_print", False))
        self.collision_threshold = kwargs.get("collision_threshold", 0.1)
        self._device = resolve_device(device)

        self.cur_vel_array = np.zeros((2, self.T))
        self.robot = Robot.create(receding, step_time, **robot_kwargs)
        self.ipath = InitialPath(receding, step_time, ref_speed, self.robot,
                                 **ipath_kwargs)
        self.dune_train_kwargs = train_kwargs

        # --- PAN / NRMP static specification ------------------------------
        iter_num = pan_kwargs.get("iter_num", 2)
        dune_max_num = pan_kwargs.get("dune_max_num", 100)
        nrmp_max_num = pan_kwargs.get("nrmp_max_num", 10)
        iter_threshold = pan_kwargs.get("iter_threshold", 0.1)
        admm_kwargs = pan_kwargs.get("admm", {}) or {}
        if os.environ.get("NEUPAN_ADMM_JSON"):
            # qualification hook: the contract/sweep gates (scripts/
            # exp_control_accuracy.py, scripts/sweep_scenarios.py) use this
            # to run the SAME closed-loop oracles on a candidate solver
            # config before the bench may publish it (BASELINE.md).
            # Announce loudly: a leftover exported var from a qualification
            # run would otherwise silently alter every planner constructed
            # in the process.
            import json
            print(f"NeuPan: NEUPAN_ADMM_JSON override active: "
                  f"{os.environ['NEUPAN_ADMM_JSON']}")
            admm_kwargs = dict(admm_kwargs,
                               **json.loads(os.environ["NEUPAN_ADMM_JSON"]))
        if "warm_iters" in admm_kwargs:
            # PAN-level knob riding the same override hook
            pan_kwargs = dict(pan_kwargs,
                              admm_warm_iters=admm_kwargs.pop("warm_iters"))

        if os.environ.get("NEUPAN_NRMP_JSON"):
            # same qualification hook for NRMPSpec fields (reg_u/reg_d
            # ladder, scripts/exp_formulation_gap.py) — announced loudly for
            # the same leftover-export reason as NEUPAN_ADMM_JSON above.
            import json
            print(f"NeuPan: NEUPAN_NRMP_JSON override active: "
                  f"{os.environ['NEUPAN_NRMP_JSON']}")
            adjust_kwargs = dict(adjust_kwargs,
                                 **json.loads(os.environ["NEUPAN_NRMP_JSON"]))
        nrmp_spec = NRMPSpec(
            T=receding,
            K=int(nrmp_max_num),
            kinematics=self.robot.kinematics,
            speed_bound=tuple(float(v) for v in self.robot.speed_bound[:, 0]),
            acce_bound=tuple(float(v) for v in self.robot.acce_bound[:, 0]),
            ro_obs=float(adjust_kwargs.get("ro_obs", 400.0)),
            bk=float(adjust_kwargs.get("bk", 0.1)),
            reg_u=float(adjust_kwargs.get("reg_u", 0.001)),
            reg_d=float(adjust_kwargs.get("reg_d", 0.01)),
        )
        if (nrmp_spec.reg_u == 0.0 or nrmp_spec.reg_d == 0.0) and \
                ADMMConfig(**admm_kwargs).polish:
            # The polish's value-based active-set identification requires a
            # strictly convex P (neupan_tpu/ops/qp.py:_polish docstring).
            # Warn rather than silently degrade.
            print("NeuPan WARNING: adjust.reg_u/reg_d = 0 with polish "
                  "enabled — the QP objective is only PSD and the active-"
                  "set polish may not converge (see NRMPSpec.reg_u). "
                  "Restore the defaults (reg_u 1e-3 / reg_d 1e-2) or disable "
                  "polish.")
        self.spec = PANSpec(
            robot=self.robot,
            nrmp=nrmp_spec,
            iter_num=int(iter_num),
            iter_threshold=float(iter_threshold),
            dune_max_num=int(dune_max_num),
            admm=ADMMConfig(**admm_kwargs),
            dune_select=str(pan_kwargs.get("dune_select", "exact")),
            admm_warm_iters=pan_kwargs.get("admm_warm_iters",
                                           PANSpec.admm_warm_iters),
        )
        self.no_obs = nrmp_spec.no_obs or dune_max_num == 0

        # --- adjustable (differentiable) weights --------------------------
        q_s = adjust_kwargs.get("q_s", 1.0)
        if isinstance(q_s, (list, tuple, np.ndarray)):
            q_s_arr = np.asarray(q_s, dtype=np.float32).flatten()
            if q_s_arr.shape[0] != 3:
                raise ValueError(
                    f"q_s must be a scalar or 3-element list, got {q_s_arr.shape[0]}")
            q_s_val = self._t(q_s_arr)
        else:
            q_s_val = self._t(float(q_s))
        self.adjust = AdjustParams(
            q_s=q_s_val,
            p_u=self._t(float(adjust_kwargs.get("p_u", 1.0))),
            eta=self._t(float(adjust_kwargs.get("eta", 10.0))),
            d_max=self._t(float(adjust_kwargs.get("d_max", 1.0))),
            d_min=self._t(float(adjust_kwargs.get("d_min", 0.1))),
        )

        # --- geometry + DUNE encoder, on the planner's device --------------
        self.vertices, self.G, self.h = self.robot.tensors(self._device)
        self.encoder = self._load_dune(pan_kwargs.get("dune_checkpoint"),
                                       train_kwargs)
        self.pan_state: PANState = batched_init_state(self.spec, 1, self._device)
        self.info = {"stop": False, "arrive": False, "collision": False}
        self._min_distance = _INF
        self._dune_points: Optional[np.ndarray] = None
        self._nrmp_points: Optional[np.ndarray] = None
        self._printed_downsample = False

        # --- deadlock escape (extension over the reference) ---------------
        # An MPC whose per-tick QP is solved EXACTLY reaches the
        # formulation's deadlock fixed points deterministically: with the
        # reference pull balanced against the obstacle hinge penalty the
        # optimal action is ~zero and stays zero (the reference shares
        # these fixed points and escapes them only through ECOS solver
        # jitter; see BASELINE.md).  When the commanded
        # action stays below `action_eps` for `patience` ticks while not
        # arrived/colliding, the planner temporarily scales eta/d_max
        # (rewarding clearance, which breaks the balance and routes the
        # robot around the blocking obstacle), restoring the user weights
        # after `hold` ticks.  Measured: un-sticks the polygon_robot and
        # corridor stall states within ~5 ticks.
        stuck_kwargs = kwargs.get("stuck_escape", {}) or {}
        self.stuck_action_eps = float(stuck_kwargs.get("action_eps", 0.02))
        self.stuck_patience = int(stuck_kwargs.get("patience", 5))
        self.stuck_eta_scale = float(stuck_kwargs.get("eta_scale", 3.0))
        self.stuck_dmax_scale = float(stuck_kwargs.get("d_max_scale", 2.0))
        self.stuck_hold = int(stuck_kwargs.get("hold", 50))
        self.stuck_enabled = bool(stuck_kwargs.get("enabled", True))
        self._stuck_count = 0
        self._escape_hold = 0
        self._saved_adjust: Optional[AdjustParams] = None

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    @classmethod
    def init_from_yaml(cls, yaml_file: str, **kwargs) -> "NeuPan":
        return cls(**load_planner_config(yaml_file, **kwargs))

    def _t(self, value) -> torch.Tensor:
        """A contiguous float32 tensor of ``value`` on the planner's device."""
        return torch.as_tensor(np.asarray(value, dtype=np.float32),
                               device=self._device).contiguous()

    def _load_dune(self, checkpoint, train_kwargs) -> ObsPointNet:
        """Load the DUNE encoder; with direct_train (and without obstacle
        handling) a seeded random init passes through."""
        if self.no_obs:
            return ObsPointNet.seeded(2, self.robot.edge_dim, seed=0, device=self._device)
        if checkpoint is not None and str(checkpoint) != "None":
            try:
                path = file_check(str(checkpoint))
            except FileNotFoundError:
                path = None
            if path is not None:
                return load_checkpoint(path, self._device)
        if train_kwargs.get("direct_train", False):
            print("train or test the model directly.")
            return ObsPointNet.seeded(2, self.robot.edge_dim, seed=0, device=self._device)
        raise FileNotFoundError(
            f"DUNE checkpoint not found: {checkpoint}. Set pan.dune_checkpoint "
            "to a valid .pth/.npz, or set train.direct_train: true and call "
            "train_dune().")

    # ------------------------------------------------------------------
    # the control step
    # ------------------------------------------------------------------

    def __call__(self, state, points=None, velocities=None):
        return self.forward(state, points, velocities)

    @time_it("neupan forward")
    def forward(self, state: np.ndarray, points: Optional[np.ndarray] = None,
                velocities: Optional[np.ndarray] = None):
        """One control tick.

        Args:
            state: (3,1)+ current robot state [x, y, theta].
            points: (2, N) obstacle points, world frame (or None).
            velocities: (2, N) per-point velocities (or None).
        Returns:
            (action (2,1), info dict)
        """
        state = np.asarray(state, dtype=np.float64)
        assert state.shape[0] >= 3

        if self.ipath.check_arrive(state):
            self.info["arrive"] = True
            return np.zeros((2, 1)), self.info

        nom_s, nom_u, ref_s, ref_us = self.ipath.generate_nom_ref_state(
            state, self.cur_vel_array, self.ref_speed
        )

        pts, vels, mask = self._pad_points(points, velocities)

        # a batch of one: the batch axis is added here and removed below
        up = lambda a: self._t(a)[None]
        ref_s_t, ref_us_t = up(ref_s), up(ref_us)
        out = pan_forward(
            self.spec, self.encoder, self.vertices, self.G, self.h, self.adjust,
            up(nom_s), up(nom_u), ref_s_t, ref_us_t, up(pts), up(vels),
            torch.as_tensor(mask, device=self._device)[None], self.pan_state)
        self.pan_state = out.state

        # the tick's one synchronization: everything the host needs, after the step
        opt_state_np = out.opt_s[0].cpu().numpy().astype(np.float64)
        opt_vel_np = out.opt_u[0].cpu().numpy().astype(np.float64)
        self.cur_vel_array = opt_vel_np
        self._min_distance = float(out.min_distance[0])
        self._dune_points = pts[:, mask]
        nrmp_valid = out.nrmp_valid[0].cpu().numpy()
        self._nrmp_points = out.nrmp_points[0].cpu().numpy()[:, nrmp_valid]

        # the step's tensors, on the planner's device
        self.info["state_tensor"] = out.opt_s[0]
        self.info["vel_tensor"] = out.opt_u[0]
        self.info["distance_tensor"] = None if out.opt_d is None else out.opt_d[0]
        self.info["ref_state_tensor"] = ref_s_t[0]
        self.info["ref_speed_tensor"] = ref_us_t[0]

        self.info["ref_state_list"] = [s[:, np.newaxis] for s in ref_s.T]
        self.info["opt_state_list"] = [s[:, np.newaxis] for s in opt_state_np.T]

        if self.check_stop():
            # The stop latch fires exactly when the minimum obstacle distance
            # crosses the collision threshold, so the collision flag rides
            # with it (the reference initializes info["collision"] but never
            # sets it — reference neupan.py:86; here it is live telemetry).
            self.info["stop"] = True
            self.info["collision"] = True
            return np.zeros((2, 1)), self.info
        self.info["stop"] = False
        self.info["collision"] = False

        action = opt_vel_np[:, 0:1].copy()
        self._stuck_escape_tick(action)
        if self.robot.kinematics == "omni":
            v, theta = action[0, 0], action[1, 0]
            action = np.array([[v * cos(theta)], [v * sin(theta)]])
            self.info["omni_linear_speed"] = v
            self.info["omni_orientation"] = theta

        return action, self.info

    def _stuck_escape_tick(self, action: np.ndarray) -> None:
        """Deadlock detection + temporary eta/d_max boost (see __init__)."""
        if not self.stuck_enabled:
            return
        if self._escape_hold > 0:
            self._escape_hold -= 1
            if self._escape_hold == 0 and self._saved_adjust is not None:
                self.adjust = self._saved_adjust
                self._saved_adjust = None
            return
        # Stall metric: for omni kinematics action[1] is an ORIENTATION,
        # not a rate — a stalled robot commanding zero speed with nonzero
        # heading would never trip a max(|action|) test.  Speed (action[0])
        # is the stall signal for omni; for diff/acker both components are
        # rates and either moves the robot.
        if self.robot.kinematics == "omni":
            stalled = abs(float(action[0, 0])) < self.stuck_action_eps
        else:
            stalled = float(np.abs(action).max()) < self.stuck_action_eps
        if stalled:
            self._stuck_count += 1
        else:
            self._stuck_count = 0
        if self._stuck_count >= self.stuck_patience:
            self._saved_adjust = self.adjust
            self.adjust = self.adjust._replace(
                eta=self.adjust.eta * self.stuck_eta_scale,
                d_max=self.adjust.d_max * self.stuck_dmax_scale,
            )
            self._escape_hold = self.stuck_hold
            self._stuck_count = 0
            self.info["stuck_escape"] = self.info.get("stuck_escape", 0) + 1

    def _pad_points(self, points, velocities):
        """Decimate to the static capacity P and pad with mask (numpy, host)."""
        P = self.spec.dune_max_num
        if points is None or self.no_obs or P == 0:
            zeros = np.zeros((2, max(P, 1)), np.float32)
            return zeros, zeros, np.zeros((max(P, 1),), bool)

        pts = np.asarray(points, dtype=np.float32)
        vels = (np.zeros_like(pts) if velocities is None
                else np.asarray(velocities, dtype=np.float32))
        n = pts.shape[1]
        if n > P:
            if not self._printed_downsample:
                print(f"down sample the obs points from {n} to {P}")
                self._printed_downsample = True
            pts = downsample_decimation(pts, P)
            vels = downsample_decimation(vels, P)
            n = P
        pad = P - n
        pts = np.pad(pts, ((0, 0), (0, pad)))
        vels = np.pad(vels, ((0, 0), (0, pad)))
        mask = np.arange(P) < n
        return pts, vels, mask

    def check_stop(self) -> bool:
        return self.min_distance < self.collision_threshold

    # ------------------------------------------------------------------
    # lidar scan conversion (reference neupan.py:173-281, vectorized)
    # ------------------------------------------------------------------

    def scan_to_point(self, state, scan, scan_offset=(0.0, 0.0, 0.0),
                      angle_range=(-np.pi, np.pi), down_sample: int = 1):
        """Convert a lidar scan dict to a world-frame point cloud (2, n)."""
        pts, _ = self._scan_points(state, scan, scan_offset, angle_range,
                                   down_sample, offset_inverse=False,
                                   min_inclusive=False)
        return pts

    def scan_to_point_velocity(self, state, scan, scan_offset=(0.0, 0.0, 0.0),
                               angle_range=(-np.pi, np.pi), down_sample: int = 1):
        """Scan -> (points (2,n), velocities (2,n)); parity with
        reference neupan.py:224-281 (sensor offset applied inversely there)."""
        return self._scan_points(state, scan, scan_offset, angle_range,
                                 down_sample, offset_inverse=True,
                                 min_inclusive=True)

    def _scan_points(self, state, scan, scan_offset, angle_range, down_sample,
                     offset_inverse, min_inclusive):
        from neupan_torch import native

        if native.available():
            pts, vels = native.scan_to_points(
                scan["ranges"], scan["angle_min"], scan["angle_max"],
                scan["range_min"], scan["range_max"], angle_range,
                down_sample, list(scan_offset),
                np.asarray(state, dtype=np.float64)[:3],
                velocity=scan.get("velocity"),
                offset_inverse=offset_inverse, min_inclusive=min_inclusive)
            return pts, vels

        ranges = np.asarray(scan["ranges"], dtype=np.float64)
        n = len(ranges)
        angles = np.linspace(scan["angle_min"], scan["angle_max"], n)
        velocity = np.asarray(scan.get("velocity", np.zeros((2, n))), dtype=np.float64)

        below_max = ranges < (scan["range_max"] - 0.02)
        above_min = (ranges >= scan["range_min"]) if min_inclusive else \
                    (ranges > scan["range_min"])
        in_angle = (angles > angle_range[0]) & (angles < angle_range[1])
        keep = below_max & above_min & in_angle
        if not np.any(keep):
            return (None, None) if min_inclusive else (None, None)

        r, a = ranges[keep], angles[keep]
        point_array = np.vstack([r * np.cos(a), r * np.sin(a)])

        s_trans, s_R = get_transform(np.c_[list(scan_offset)])
        if offset_inverse:
            temp = s_R.T @ (point_array - s_trans)
        else:
            temp = s_R @ point_array + s_trans

        trans, R = get_transform(np.asarray(state, dtype=np.float64)[:3].reshape(3, 1))
        pts = (R @ temp + trans)[:, ::down_sample]
        vels = velocity[:, keep][:, ::down_sample]
        return pts, vels

    # ------------------------------------------------------------------
    # training / tuning hooks
    # ------------------------------------------------------------------

    def train_dune(self, **overrides):
        """Offline DUNE training for this robot geometry on the planner's
        device (``neupan_torch/training``): ``train_kwargs`` with
        ``overrides`` on top; ``model_name`` and ``checkpoint_dir`` (default
        ``<cwd>/model/<model_name>``) name where the checkpoints go. Trains
        ``self.encoder`` in place, so the next tick plans with the trained
        weights; returns the last checkpoint's path."""
        from neupan_torch.training import DuneTrainer

        kwargs = dict(self.dune_train_kwargs)
        kwargs.update(overrides)
        model_name = kwargs.pop("model_name", self.robot.name)
        checkpoint_dir = kwargs.pop(
            "checkpoint_dir", os.path.join(os.getcwd(), "model", model_name))
        trainer = DuneTrainer(self.G.cpu().numpy(), self.h.cpu().numpy(), checkpoint_dir,
                              device=self._device)
        self.encoder, path = trainer.start(encoder=self.encoder, **kwargs)
        print(f"Complete Training. The model is saved in {path}")
        return path

    def update_adjust_parameters(self, **kwargs):
        """Update q_s / p_u / eta / d_max / d_min at runtime.

        The q_s arity (scalar vs 3-vector) is locked at construction, matching
        the reference behavior (nrmp.py:171-217)."""
        q_s_value = kwargs.get("q_s", None)
        q_s = self.adjust.q_s
        if q_s_value is not None:
            if q_s.dim() == 0:
                if isinstance(q_s_value, (list, tuple, np.ndarray)):
                    val = float(np.asarray(q_s_value).flatten()[0])
                    print(f"q_s should be a scalar when initialized as scalar; "
                          f"using the first element: {val}")
                else:
                    val = float(q_s_value)
                q_s = self._t(val)
            else:
                arr = np.asarray(q_s_value, dtype=np.float32).flatten()
                if arr.shape[0] != 3:
                    raise ValueError(
                        f"q_s must be a 3-element list/array, got {arr.shape[0]}")
                q_s = self._t(arr)
        self.adjust = AdjustParams(
            q_s=q_s,
            p_u=self._t(float(kwargs.get("p_u", self.adjust.p_u))),
            eta=self._t(float(kwargs.get("eta", self.adjust.eta))),
            d_max=self._t(float(kwargs.get("d_max", self.adjust.d_max))),
            d_min=self._t(float(kwargs.get("d_min", self.adjust.d_min))),
        )

    def set_adjust_parameters(self, adjust: AdjustParams):
        """Install an AdjustParams of tensors on the planner's device (LON).

        Cancels any in-flight deadlock-escape hold: the caller is taking
        explicit ownership of the weights, and letting the escape's
        save/restore interleave with tuner updates was measured to leak
        the x3 eta boost into the tuned parameters permanently."""
        self._saved_adjust = None
        self._escape_hold = 0
        self._stuck_count = 0
        self.adjust = adjust

    # ------------------------------------------------------------------
    # state management + path setters (reference neupan.py:288-341)
    # ------------------------------------------------------------------

    def reset(self):
        self.ipath.point_index = 0
        self.ipath.curve_index = 0
        self.ipath.arrive_flag = False
        self.info["stop"] = False
        self.info["arrive"] = False
        self.info["collision"] = False
        self.cur_vel_array = np.zeros_like(self.cur_vel_array)
        self.pan_state = batched_init_state(self.spec, 1, self._device)
        if self._saved_adjust is not None:
            self.adjust = self._saved_adjust
            self._saved_adjust = None
        self._stuck_count = 0
        self._escape_hold = 0

    def set_initial_path(self, path):
        self.ipath.set_initial_path(path)

    def set_initial_path_from_state(self, state):
        self.ipath.init_check(np.asarray(state, dtype=np.float64))

    def set_reference_speed(self, speed: float):
        self.ipath.ref_speed = speed
        self.ref_speed = speed

    def update_initial_path_from_goal(self, start, goal):
        self.ipath.update_initial_path_from_goal(start, goal)

    def update_initial_path_from_waypoints(self, waypoints):
        self.ipath.set_ipath_with_waypoints(waypoints)

    # ------------------------------------------------------------------
    # read-only properties (reference neupan.py:361-408)
    # ------------------------------------------------------------------

    @property
    def min_distance(self) -> float:
        return self._min_distance

    @property
    def dune_points(self):
        return self._dune_points

    @property
    def nrmp_points(self):
        return self._nrmp_points

    @property
    def initial_path(self):
        return self.ipath.initial_path

    @property
    def adjust_parameters(self) -> AdjustParams:
        return self.adjust

    @property
    def waypoints(self):
        return self.ipath.waypoints

    @property
    def opt_trajectory(self):
        return self.info["opt_state_list"]

    @property
    def ref_trajectory(self):
        return self.info["ref_state_list"]


# reference-compatible lowercase alias
neupan = NeuPan
