"""The traced steps: ``torch.profiler`` over a few steps of the chain, reduced
in memory to what the per-layer readers need. Nothing is written to disk.

Device activity (kernels, copies, fills) comes from the CUDA activity of
the trace; the harness's own spans (``bench.traffic``,
``bench.issue``, ``bench.readback``, ``bench.check``) are host ranges on the
same clock, which bound the traced window and label the device's idle gaps.
"""

from __future__ import annotations

import collections

import torch

SPANS = ("traffic", "issue", "readback", "check")


def _union(intervals):
    """Merged (start, end) pairs of ``intervals``, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(runner, steps: int) -> dict:
    """Run ``steps`` more steps of ``runner`` under the profiler; return the
    reduction (times in seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness.runner import Window, sync

    runner.spans.profiling = True
    runner.sampling = False
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            win = Window()
            for _ in range(steps):
                runner.one(win)
            sync(runner.p.device)
    finally:
        runner.spans.profiling = False
        runner.sampling = True
    host, dev = [], []
    for e in _raw(prof):
        name, start, end, kind, index = e
        if kind == DeviceType.CPU and name.startswith("bench."):
            host.append((name[len("bench."):], start, end))
        elif kind == DeviceType.CUDA and not name.startswith("bench."):
            dev.append((name, start, end, index))
    if not host:
        raise RuntimeError("the profiler recorded none of the harness's spans")
    t0 = min(s for _, s, _ in host)
    t1 = max(max(e for _, _, e in host), max((e for _, _, e, _ in dev), default=t0))
    busy_iv = []
    names = collections.Counter()
    kernels = 0
    for name, s, t, _ in dev:
        s, t = max(s, t0), min(t, t1)
        if t <= s:
            continue
        busy_iv.append((s, t))
        names[name] += (t - s) * 1e-9
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    merged = _union(busy_iv)
    busy = sum(t - s for s, t in merged) * 1e-9
    gaps = collections.Counter()
    spans = sorted(host, key=lambda h: h[1])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for s, t in zip(edges[0::2], edges[1::2]):
        for label, ns in _overlaps(spans, s, t):
            gaps[label] += ns * 1e-9
    return {"window_s": (t1 - t0) * 1e-9, "busy_s": busy, "steps": steps, "kernels": kernels,
            "by_name": dict(names), "gaps": dict(gaps)}


def _raw(prof):
    """(name, start ns, end ns, device type, device index) of every event of
    the trace, read from the profiler's raw results (``prof.events()`` builds
    a tree of them, a hundred times slower)."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.device_type(),
                 e.device_index()) for e in results.events()]
    return [(e.name, e.time_range.start * 1000, e.time_range.end * 1000, e.device_type,
             e.device_index) for e in prof.events()]


def _overlaps(spans, s, t):
    """(span name, ns) of the host spans that overlap the gap [s, t], and
    ("other", ns) for the part of it that none covers."""
    out, covered = [], 0
    for name, a, b in spans:
        if a >= t:
            break
        ns = min(b, t) - max(a, s)
        if ns > 0:
            out.append((name, ns))
            covered += ns
    if t - s > covered:
        out.append(("other", t - s - covered))
    return out
