"""How far float32 rounding moves the full-space solver's planner actions.

    PYTHONPATH=. python scripts/exp_fullspace_spread.py      # ~3 min on a CPU

Feeds the corridor/diff facade ticks of ``tests/golden/torch/
facade_solvers.npz`` (states, points and the state the JAX facade carried
into each tick) to three planners per ``pan.admm`` setting of the golden:

* the JAX package on the CPU as it runs (its dense inverses above n=36 by
  Cholesky, ``neupan_tpu/ops/qp.py:_GJ_MAX_N``) -- the golden's own run;
* the JAX package with ``_GJ_MAX_N = 96``: the same function, its n=63
  inverses by Gauss-Jordan elimination, as its TPU path eliminates them
  (the sweep kernel), so only float32 rounding differs;
* the PyTorch port on the CPU (its inverses by the sweep's plain version).

Prints, per tick, the largest action difference of JAX-GJ and of the port
from the golden, and each run's maximum. Where the two JAX runs part as far
as the port does, the port's distance is float32 rounding of the same
function (the port's full-space ADMM equals JAX's to 1e-9 in float64:
tests/test_torch_solvers.py, golden ``qp_fullspace_f64``).
"""

from __future__ import annotations

import dataclasses
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main() -> None:
    import jax
    import torch
    import yaml

    jax.config.update("jax_default_matmul_precision", "highest")
    import neupan_tpu.ops.qp as jqp
    from neupan_tpu.ops.pan import PANState as JaxState
    from neupan_tpu.planner import NeuPan as JaxNeuPan
    from neupan_torch import NeuPan
    from neupan_torch.ops.pan import PANState
    from scripts.make_torch_goldens import (CARRY, FACADE_SOLVER_TICKS, FACADE_SOLVERS,
                                            FACADE_YAML, facade_points)

    yaml_path = os.path.join(ROOT, FACADE_YAML)
    with open(yaml_path) as f:
        pan = yaml.safe_load(f)["pan"]
    with np.load(os.path.join(ROOT, "tests", "golden", "torch", "facade_solvers.npz")) as g:
        g = {k: g[k] for k in g.files}
    pts, counts = facade_points()
    gj_max = jqp._GJ_MAX_N
    for name, admm in FACADE_SOLVERS.items():
        jqp._GJ_MAX_N = 96
        try:
            jax_gj = JaxNeuPan.init_from_yaml(yaml_path, pan=dict(pan, admm=admm))
        finally:
            jqp._GJ_MAX_N = gj_max
        port = NeuPan.init_from_yaml(yaml_path, device="cpu", pan=dict(pan, admm=admm))
        port.spec = dataclasses.replace(port.spec, dune_kernel=False)
        rows = []
        for i in range(FACADE_SOLVER_TICKS):
            carry = [g[f"{name}_{f}"][i] for f in CARRY]
            pts_i = pts[i, :, :counts[i]].astype(np.float64)
            jqp._GJ_MAX_N = 96
            try:
                jax_gj.pan_state = JaxState(*(jax.numpy.asarray(c) for c in carry))
                jax_gj.cur_vel_array = g[f"{name}_cur_vel"][i].copy()
                a_gj, _ = jax_gj(g[f"{name}_state"][i], pts_i)
            finally:
                jqp._GJ_MAX_N = gj_max
            port.pan_state = PANState(*(torch.as_tensor(c)[None] for c in carry))
            port.cur_vel_array = g[f"{name}_cur_vel"][i].copy()
            a_port, _ = port(g[f"{name}_state"][i], pts_i)
            ref = g[f"{name}_action"][i]
            rows.append((float(np.abs(np.asarray(a_gj) - ref).max()),
                         float(np.abs(a_port - ref).max())))
        print(f"{name} ({admm}): per tick, |JAX-GJ - JAX| and |port - JAX|:")
        for i, (d_gj, d_port) in enumerate(rows):
            print(f"  tick {i}: {d_gj:.3e}  {d_port:.3e}")
        print(f"  max: JAX-GJ {max(r[0] for r in rows):.3e}, port {max(r[1] for r in rows):.3e}")


if __name__ == "__main__":
    main()
