"""The float64 verdict on a scenario-step whose actions part from the
reference's by more than the limits' ``u_flip``: which answer is the better
optimum of that step's last QP, and which mechanism parted them.

The reference runs the step again in float64 from the same inputs and the
same carried state, keeping its last PAN iteration's QP; that QP is then
solved to convergence in float64 (``ORACLE_ITERS`` ADMM iterations, then
the polish and the snap). Each answer, the program's QP solution (its
``x_warm``), the float32 reference's and the float64 reference's, is judged
by that QP's objective, against the converged one's, and by its largest
violation of a hard row. Diagnostics only: the benchmark's runs do not
call it.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import check as K
from benchmark.reference import step as R

ORACLE_ITERS = 4000


def judge(pb: R.Problem, lanes, chunk, device, checked, threshold: float):
    """One verdict (a dict) per (record, row) pair of ``chunk``; ``checked``
    holds each one's opt_u gap as the check read it. The reference runs
    again here on this chunk alone, and a batch of another size rounds its
    products otherwise, so its gap (``u_gap_rerun``) may differ."""
    enc32 = R.Encoder(pb.checkpoint, torch.float32, device)
    enc64 = R.Encoder(pb.checkpoint, torch.float64, device)
    got, ref32 = K.reference_block(pb, enc32, lanes, chunk, device)
    _, ref64 = K.reference_block(pb, enc64, lanes, chunk, device, dtype=torch.float64,
                                 keep_qps=True)
    qp, Z, xp = ref64.trail["qp"][-1]
    oracle = dataclasses.replace(pb, solver=dict(pb.solver, iters=ORACLE_ITERS))
    x_star, _ = R.solve(oracle, oracle.solver, ORACLE_ITERS, qp, torch.zeros_like(xp),
                        torch.zeros_like(qp[3]), Z, xp)
    f_star, v_star = R.objective(qp, x_star)
    answers = {"program": got["state"][6].double(), "reference_f32": ref32.state.x_warm.double(),
               "reference_f64": ref64.state.x_warm}
    judged = {k: R.objective(qp, x) for k, x in answers.items()}
    A, l, u, soft = qp[2], qp[3], qp[4], qp[5]
    hard = ~(soft > 0.0)

    def active(x):
        Ax = R.mv(A, x)
        return hard & ((torch.abs(Ax - l) < 1e-4) | (torch.abs(Ax - u) < 1e-4))

    act_p, act_r = active(answers["program"]), active(answers["reference_f64"])
    out = []
    for i, (rec, j) in enumerate(chunk):
        u_gap = float(torch.max(torch.abs(got["opt_u"][i] - ref32.opt_u[i])))
        stop = float(ref32.trail["diff"][0][i])
        near0 = float(torch.max(torch.abs(got["state"][6][i] - ref32.trail["x"][0][i])))
        mech = []
        if not torch.equal(got["nrmp_points"][i], ref32.nrmp_points[i]):
            mech.append("selection")
        if float(torch.max(torch.abs(got["state"][0][i] - ref32.state.prev_mu[i]))) > 1e-2:
            mech.append("slot order or selection of a later frame")
        if near0 < u_gap or abs(stop - threshold) < 0.05 * threshold:
            mech.append("PAN early stop")
        flips = int(torch.sum(act_p[i] != act_r[i]))
        if flips:
            mech.append(f"polish active set ({flips} rows)")
        scale = 1.0 + abs(float(f_star[i]))
        out.append({
            "step": rec.step, "scenario": int(rec.ids[j]), "u_gap": float(checked[i]),
            "u_gap_rerun": u_gap, "ref_stop_measure_it0": stop,
            "oracle": {"objective": float(f_star[i]), "violation": float(v_star[i])},
            **{name: {"objective_gap": (float(f[i]) - float(f_star[i])) / scale,
                      "violation": float(v[i])} for name, (f, v) in judged.items()},
            "mechanism": mech or ["none found"]})
    return out
