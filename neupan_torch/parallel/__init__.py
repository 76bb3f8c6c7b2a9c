"""Scenario-parallel entry points: one planner step for a batch of scenarios.

The scenarios are independent, so the batch is a leading axis of every
tensor; the encoder weights and the robot geometry are shared.
"""

from __future__ import annotations

import torch

from neupan_torch.ops.nrmp import AdjustParams
from neupan_torch.ops.pan import PANOutput, PANSpec, PANState, init_state, pan_forward


def batched_init_state(spec: PANSpec, batch: int, device=None) -> PANState:
    """The empty state of ``batch`` scenarios on ``device`` (None = the card)."""
    one = init_state(spec, device)
    return PANState(*(v.expand((batch,) + v.shape).clone() for v in one))


def batched_planner_step(spec: PANSpec, encoder, vertices: torch.Tensor,
                         G: torch.Tensor, h: torch.Tensor, adjust: AdjustParams,
                         nom_s, nom_u, ref_s, ref_us, points, velocities, mask,
                         state: PANState) -> PANOutput:
    """The full PAN control step for a batch of scenarios.

    Every tensor argument but the shared encoder, robot geometry (vertices,
    G, h) and ``adjust`` carries a leading batch dimension; all must sit on
    one device.
    """
    return pan_forward(spec, encoder, vertices, G, h, adjust, nom_s, nom_u,
                       ref_s, ref_us, points, velocities, mask, state)
