"""The output check: the plain reference recomputes every sampled
scenario-step, and the gaps between the two are reduced to the numbers that
decide ``correct``.

The reference follows the program one step at a time: step 0 from the
empty state, which it makes itself, every later sampled step from the
carried state that the program took into that step. All eight fields of
the carried state that the step returned are compared with the
reference's as more outputs, the two flags exactly. Besides, over the
first ``chain`` steps the reference carries its own state for step 0's
sampled scenarios (``run_chain``), so that what the program hands from one
step to the next is checked against a chain that takes nothing from it.
Points, nominal and reference trajectories come from the traffic
generator, which the benchmark runs again for the sampled scenarios; the
encoder and the geometry come from the configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import traffic as TR
from benchmark.reference import step as R

# per scenario-step gaps: (output field, how far apart)
FIELDS = ("u", "s", "d", "dist", "pts", "mu", "lam", "ps", "pu", "xw", "yw", "flag")


def _abs(a, b):
    return torch.abs(a - b).reshape(a.shape[0], -1).amax(dim=1)


def _rel(a, b):
    return (torch.abs(a - b) / (1.0 + torch.abs(b))).reshape(a.shape[0], -1).amax(dim=1)


def gaps_of(got: dict, ref: R.Output) -> dict:
    """Per scenario-step gaps of each compared output."""
    st, rs = got["state"], ref.state
    return {
        "u": _abs(got["opt_u"], ref.opt_u), "s": _abs(got["opt_s"], ref.opt_s),
        "d": _abs(got["opt_d"], ref.opt_d),
        "dist": _rel(got["min_distance"][:, None], ref.min_distance[:, None]),
        "pts": _abs(got["nrmp_points"], ref.nrmp_points),
        "mu": _abs(st[0], rs.prev_mu), "lam": _abs(st[1], rs.prev_lam),
        "ps": _abs(st[2], rs.prev_s), "pu": _abs(st[3], rs.prev_u),
        "xw": _rel(st[6], rs.x_warm), "yw": _rel(st[7], rs.y_warm),
        "flag": ((st[4] != rs.prev_valid) | (st[5] != rs.prev_has_points)).to(torch.float64),
    }


def run_reference(pb: R.Problem, lanes: TR.Lanes, records, device, block: int):
    """(gaps per field as float64 arrays over every sampled scenario-step,
    the records' (step, scenario) pairs, the reference's trails)."""
    enc = R.Encoder(pb.checkpoint, torch.float32, device)
    flat = [(rec, i) for rec in records for i in range(len(rec.ids))]
    out = {f: [] for f in FIELDS}
    where = []
    trails = []
    for lo in range(0, len(flat), block):
        chunk = flat[lo:lo + block]
        got, ref = reference_block(pb, enc, lanes, chunk, device)
        for f, v in gaps_of(got, ref).items():
            out[f].append(v.double().cpu())
        where += [(rec.step, int(rec.ids[i])) for rec, i in chunk]
        trails.append({"diff": [d.cpu() for d in ref.trail["diff"]],
                       "x": [x.cpu() for x in ref.trail["x"]], "got_x": got["state"][6].cpu()})
    return {f: torch.cat(v).numpy() for f, v in out.items()}, where, trails


def run_chain(pb: R.Problem, lanes: TR.Lanes, records, device, chain: int) -> dict:
    """Gaps per field over steps 1 to ``chain`` - 1 of step 0's sampled
    scenarios, the reference carrying its own state from the empty one."""
    enc = R.Encoder(pb.checkpoint, torch.float32, device)
    recs = sorted((r for r in records if r.step < chain), key=lambda r: r.step)
    if [r.step for r in recs] != list(range(len(recs))):
        raise ValueError("the chain's steps were not all recorded")
    out = {f: [] for f in FIELDS}
    state = R.empty_state(pb, len(recs[0].ids), torch.float32, device)
    fixed = lanes.fixed(len(recs[0].ids), device)
    for rec in recs:
        pts = lanes.points_of(rec.ids, rec.step, device)
        with torch.no_grad():
            ref = R.step(pb, enc, *fixed[:4], pts, *fixed[4:], state)
        if rec.step > 0:
            for f, v in gaps_of(rec.out, ref).items():
                out[f].append(v.double().cpu())
        state = ref.state
    return {f: torch.cat(v).numpy() if v else np.zeros(0) for f, v in out.items()}


def reference_block(pb: R.Problem, enc, lanes: TR.Lanes, chunk, device, dtype=torch.float32,
                    keep_qps: bool = False):
    """The program's outputs of ``chunk`` ((record, row) pairs) stacked, and
    the reference's step over the same inputs."""
    B = len(chunk)
    pts = torch.cat([lanes.points_of(rec.ids[i:i + 1], rec.step, device) for rec, i in chunk])
    nom_s, nom_u, ref_s, ref_us, vel, mask = lanes.fixed(B, device)
    empty = R.empty_state(pb, 1, torch.float32, device)
    rows = [empty if rec.state_in is None else R.State(*(v[i:i + 1] for v in rec.state_in))
            for rec, i in chunk]
    state = R.State(*(torch.cat([r[j] for r in rows]) for j in range(len(empty))))
    got = {k: torch.cat([rec.out[k][i:i + 1] for rec, i in chunk])
           for k in chunk[0][0].out if k != "state"}
    got["state"] = tuple(torch.cat([rec.out["state"][j][i:i + 1] for rec, i in chunk])
                         for j in range(len(empty)))
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    state = R.State(*(cast(v) for v in state))
    with torch.no_grad():
        ref = R.step(pb, enc, *(cast(t) for t in (nom_s, nom_u, ref_s, ref_us, pts, vel)), mask,
                     state, keep_qps=keep_qps)
    return got, ref


def numbers(gaps: dict, u_flip: float, chain: dict) -> dict:
    """The run's candidate numbers: the median, 90th percentile and largest
    gap of each output over the sampled scenario-steps, and the share of
    scenario-steps whose actions part by more than ``u_flip``; the same,
    prefixed ``chain_``, over the reference's own chain. A number with no
    scenario-step to read is NaN, and fails."""
    stat = lambda fn, g: float(fn(g)) if len(g) else float("nan")
    out = {}
    for prefix, gs in (("", gaps), ("chain_", chain)):
        for f in FIELDS:
            out[f"{prefix}{f}_p50"] = stat(np.median, gs[f])
            out[f"{prefix}{f}_p90"] = stat(lambda g: np.percentile(g, 90), gs[f])
            out[f"{prefix}{f}_max"] = stat(np.max, gs[f])
        out[f"{prefix}u_share"] = stat(lambda g: np.mean(g > u_flip), gs["u"])
        out[f"{prefix}n"] = int(len(gs["u"]))
    return out


def judge(nums: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits file compares; a number above its limit, or not finite, fails."""
    checks = {}
    ok = bool(limits["compared"])
    for name, lim in limits["compared"].items():
        v = nums[name]
        checks[name] = {"value": v, "limit": lim["limit"]}
        if not (np.isfinite(v) and v <= lim["limit"]):
            ok = False
    return ok, checks
