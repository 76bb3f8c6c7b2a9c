"""Matplotlib renderer for the built-in 2-D simulator (port of
``neupan_tpu/sim/render.py``).

Covers the visualization surface the reference gets from IR-SIM
(reference: example/run_exp.py:47-53 — draw dune/nrmp points, optimal and
reference trajectories, initial path, then env.render / animation save).
Headless-safe: uses the Agg backend unless a display is requested.
matplotlib is imported inside ``Renderer``, so the simulator and the
runners import without it.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from neupan_torch.sim import Sim2D
from neupan_torch.utils import get_transform


class Renderer:
    """Per-step frame drawing + optional animated-GIF export."""

    def __init__(self, sim: Sim2D, world_size=None, display: bool = False,
                 figsize=(8, 6)):
        import matplotlib

        if not display:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt = plt
        self.sim = sim
        self.display = display
        self.fig, self.ax = plt.subplots(figsize=figsize)
        self.world_size = world_size
        self.frames: List[np.ndarray] = []
        self.trail: List[np.ndarray] = []

    # -- drawing helpers ----------------------------------------------------

    def _draw_polygon(self, verts: np.ndarray, **kw):
        closed = np.hstack([verts, verts[:, :1]])
        self.ax.plot(closed[0], closed[1], **kw)

    def draw_frame(self, planner=None, initial_path=None):
        """Draw one frame: world, robot, obstacles, planner overlays."""
        ax, sim = self.ax, self.sim
        ax.clear()
        if self.world_size is not None:
            ax.set_xlim(self.world_size[0], self.world_size[1])
            ax.set_ylim(self.world_size[2], self.world_size[3])
        ax.set_aspect("equal")

        for obs in sim.obstacles:
            self._draw_polygon(obs.vertices, color="k", lw=1.2)

        trans, R = get_transform(sim.state)
        rverts = R @ sim.robot.vertices + trans
        self._draw_polygon(rverts, color="tab:blue", lw=1.5)
        self.trail.append(sim.state[:2, 0].copy())
        trail = np.asarray(self.trail)
        ax.plot(trail[:, 0], trail[:, 1], color="tab:blue", lw=0.8, alpha=0.5)
        ax.plot(sim.goal[0, 0], sim.goal[1, 0], "g*", markersize=12)

        if initial_path is not None and len(initial_path):
            path = np.hstack([p[:2] for p in initial_path])
            ax.plot(path[0], path[1], "k--", lw=0.8, alpha=0.6)

        if planner is not None:
            if planner.dune_points is not None and planner.dune_points.size:
                ax.scatter(planner.dune_points[0], planner.dune_points[1],
                           s=4, c="tab:orange", label="dune points")
            if planner.nrmp_points is not None and planner.nrmp_points.size:
                ax.scatter(planner.nrmp_points[0], planner.nrmp_points[1],
                           s=14, c="tab:red", label="nrmp points")
            for traj, color in ((planner.opt_trajectory, "r"),
                                (planner.ref_trajectory, "b")):
                if traj:
                    t = np.hstack([s[:2] for s in traj])
                    ax.plot(t[0], t[1], color=color, lw=1.0)

        self.fig.canvas.draw()
        buf = np.asarray(self.fig.canvas.buffer_rgba())[..., :3].copy()
        self.frames.append(buf)
        if self.display:
            self.plt.pause(0.001)

    # -- export -------------------------------------------------------------

    def save_animation(self, path: str, fps: int = 10):
        """Write collected frames as an animated GIF (pillow writer)."""
        from matplotlib.animation import FuncAnimation, PillowWriter

        if not self.frames:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig, ax = self.plt.subplots(
            figsize=(self.frames[0].shape[1] / 100,
                     self.frames[0].shape[0] / 100), dpi=100)
        ax.axis("off")
        im = ax.imshow(self.frames[0])

        def update(i):
            im.set_data(self.frames[i])
            return (im,)

        anim = FuncAnimation(fig, update, frames=len(self.frames))
        anim.save(path, writer=PillowWriter(fps=fps))
        self.plt.close(fig)
        return path

    def close(self):
        self.plt.close(self.fig)
