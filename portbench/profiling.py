"""The device's share of a profiled window, from ``torch.profiler``'s trace.

``profiled(fn)`` runs fn() under the profiler inside a span named
``WINDOW`` that ends after a device sync. The device is busy where any
device event (kernel, copy, set) runs: the union of their intervals inside
the span, so overlapping kernels count once. The profiler's own work
stretches the span (a chunk of the plain cell's graph replays ran 3.3
times as long under it on an H100: each kernel's record costs device time
between kernels), so a cell takes the window's length from the same work
timed without it. The breakdown lists the device operations that took
most time, and the idle time of the LONGEST longest gaps, each named by
the innermost host event that covers its middle, summed by name.
"""
from __future__ import annotations

WINDOW = "portbench_window"
# the idle gaps named by their host event; the rest are summed
LONGEST = 200


def _union(intervals):
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def _gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def profiled(fn):
    """Runs fn() under the profiler. Returns (fn's result, {"busy_s",
    "traced_s", "breakdown"}): the device's busy seconds and the length of
    the profiled span, which the profiler's own work stretches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    span = [e for e in events if e.name() == WINDOW and
            e.device_type() == DeviceType.CPU][0]
    lo, hi = span.start_ns(), span.end_ns()
    dev, host = [], []
    for e in events:
        a, b = max(e.start_ns(), lo), min(e.end_ns(), hi)
        if b <= a:
            continue
        if e.device_type() == DeviceType.CUDA:
            # a host span (record_function) shows on the device's timeline
            # too: no operation ran there
            if not e.is_user_annotation():
                dev.append((a, b, e.name()))
        elif e.name() != WINDOW:
            host.append((a, b, e.name()))
    intervals = [(a, b) for a, b, _ in dev]
    by_op = {}
    for a, b, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-9
    by_host = {}
    gaps = sorted(_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])
    for a, b in gaps[:LONGEST]:
        mid = (a + b) / 2
        cover = [(hb - ha, name) for ha, hb, name in host if ha <= mid <= hb]
        name = min(cover)[1] if cover else "host outside any span"
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-9
    if len(gaps) > LONGEST:
        by_host["shorter gaps"] = sum(b - a for a, b in gaps[LONGEST:]) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return out, {"busy_s": _union(intervals) * 1e-9,
                 "traced_s": (hi - lo) * 1e-9,
                 "breakdown": {"device_ops": top(by_op),
                               "idle_gaps": top(by_host)}}
