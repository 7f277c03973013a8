"""Observability: structured metrics logging, the program's spans and the
training step's stage stamps (port of ``mvsdf_tpu/train/metrics.py``).

JSONL metrics (one line per epoch), throughput counters, a
``torch.profiler`` trace (host and CUDA activities, written as a Chrome
trace) around chosen epochs, and ``Tracer``, the program's one span API.

``Tracer.span(name, **args)`` always enters a profiler ``record_function``
of that name, so profiles keep their names. With tracing on it also keeps
(name, start, end, parent, chunk, args) in memory on
``time.perf_counter_ns()``; the chunk is the first epoch of the fused
dispatch's chunk the span ran in. Spans are opened on the main thread
only; a span timed on another thread (the trainer's worker, which draws
the host RNG's next chunk ahead) is handed over finished
(``add_span``). The trainer (``train/loop.py``) hands the tracer each
chunk's stage stamps and row counters as well, one row a step
(``tracing/kernels/stamp``: the graph-replayed step stamps s0-s5 on the
device's ``%globaltimer``, and with several ranks one more after the
gradient all-reduce), the chunk's all-reduces and their bytes, its
replays' launches of the SDF network's activation kernel, and each plan's
count of epochs drawn ahead (``add_plan``). ``calibrate`` maps
the device's clock onto the host's with one bracketed stamp; ``summary``
gives the stage times (the all-reduce's with them), the gaps between
replays and across chunk boundaries, the host spans a step, the share of
epochs drawn ahead, the trace's rows, the all-reduces and the
activation kernel's launches a step; ``write`` puts all of
it, converted once to the profiler's clock (Unix nanoseconds, shown from
the same base time as ``profile_trace``'s ``trace.json``), into one
Chrome trace-event file with host spans, the worker's spans, device
stages and row counters on their own tracks.
With tracing off nothing is kept and the step captures no stamp or
counter: its graph is the untraced one.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from ..tracing.kernels import stamp as _stamp

# libkineto's ChromeTraceBaseTime: the profiler's Chrome traces give times
# from the start of the 7889238-second interval they fall in
_KINETO_BASE_S = 7889238
_HOST_TID, _DEVICE_TID, _WORKER_TID = 1, 2, 3
# a step's stages between its stamps, in the order of ``_bounds``' columns
_STAGES = (("forward", 0, 1), ("trace", 1, 2), ("forward", 2, 3),
           ("backward", 3, 4), ("allreduce", 4, 5), ("update", 5, 6))


class MetricsLogger:
    """Append-only JSONL metrics log."""

    def __init__(self, path: str, echo=print):
        self.path = path
        self.echo = echo
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


@contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (CPU activity, and CUDA's when a
    GPU is present), written to ``log_dir/trace.json``; no-op when log_dir
    is empty."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def unix_offset_ns() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``, read between two
    reads of the latter."""
    a = time.perf_counter_ns()
    u = time.time_ns()
    b = time.perf_counter_ns()
    return u - (a + b) // 2


def kineto_base_ns(unix_ns: int) -> int:
    """The base time the profiler's Chrome traces count from."""
    s = unix_ns // 10 ** 9
    return s // _KINETO_BASE_S * _KINETO_BASE_S * 10 ** 9


class Tracer:
    """The program's spans and the training step's stage stamps (module
    docstring). ``spans`` holds [name, start, end, parent, chunk, args]
    (host ``perf_counter`` ns; parent an index into ``spans`` or None);
    ``chunks`` one record a chunk of the fused dispatch: its first epoch,
    its (K, ``stamp.SLOTS``) int64 stamp and counter rows, which rows are
    replays (the rest: a capture's eager warm-up), its ``_StepClock``
    milliseconds over its replays, its (all-reduces, bytes) over its K
    steps or None, and its (K,) stamps after the gradient all-reduce or
    None (one process); ``plans`` one record a plan: its
    chunk, its epochs and how many of them were drawn ahead;
    ``worker_spans`` the indices of spans timed on another thread.
    ``device_clock``: ``offset_ns`` (device
    ns + offset = host ns), the bracket's ``width_ns``, and ``tick_ns``,
    the step the device's clock moves in (the greatest common divisor of
    back-to-back stamps' differences)."""

    def __init__(self, on: bool = False):
        self.on = on
        self.spans = []
        self.chunks = []
        self.plans = []
        self.worker_spans = set()
        self.chunk = None
        self.device_clock = {"offset_ns": 0, "width_ns": 0, "tick_ns": None}
        self._open = []

    @contextmanager
    def span(self, name: str, **args):
        """A named region: a profiler ``record_function``, and with tracing
        on a kept span that brackets it."""
        if not self.on:
            with torch.profiler.record_function(name):
                yield
            return
        rec = [name, time.perf_counter_ns(), None,
               self._open[-1] if self._open else None, self.chunk, args]
        self._open.append(len(self.spans))
        self.spans.append(rec)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._open.pop()
            rec[2] = time.perf_counter_ns()

    def add_span(self, name: str, start_ns: int, end_ns: int, chunk,
                 **args) -> None:
        """A span timed on another thread (``perf_counter_ns``), kept with
        no parent on the worker's track; ``_open`` is the main thread's."""
        if self.on:
            self.worker_spans.add(len(self.spans))
            self.spans.append([name, start_ns, end_ns, None, chunk, args])

    def add_plan(self, ahead: int, epochs: int) -> None:
        """A plan of ``epochs`` epochs in the current chunk, ``ahead`` of
        whose draws were ready when it asked."""
        if self.on:
            self.plans.append({"chunk": self.chunk, "epochs": epochs,
                               "ahead": ahead})

    @contextmanager
    def in_chunk(self, e0: int):
        """Spans opened inside belong to the chunk starting at epoch e0."""
        self.chunk = e0
        try:
            yield
        finally:
            self.chunk = None

    def self_ns(self):
        """Each kept span's length less its children's (None while open)."""
        child = [0] * len(self.spans)
        for _, a, b, parent, _, _ in self.spans:
            if parent is not None and b is not None:
                child[parent] += b - a
        return [None if b is None else b - a - c
                for (_, a, b, _, _, _), c in zip(self.spans, child)]

    def calibrate(self, device: torch.device) -> None:
        """Map the device's stamps onto the host clock: host clock, stamp,
        sync, host clock, the narrowest of eight brackets kept. On the CPU
        the stamps are the host clock."""
        if device.type != "cuda":
            self.device_clock = {"offset_ns": 0, "width_ns": 0,
                                 "tick_ns": None}
            return
        buf = torch.zeros(64, dtype=torch.int64, device=device)
        _stamp.stamp(buf, 0)   # builds and loads the library
        torch.cuda.synchronize(device)
        best = None
        for _ in range(8):
            t0 = time.perf_counter_ns()
            _stamp.stamp(buf, 0)
            torch.cuda.synchronize(device)
            t1 = time.perf_counter_ns()
            d = int(buf[0])
            if best is None or t1 - t0 < best[1]:
                best = ((t0 + t1) // 2 - d, t1 - t0)
        for i in range(64):
            _stamp.stamp(buf, i)
        steps = np.diff(buf.cpu().numpy())
        self.device_clock = {"offset_ns": best[0], "width_ns": best[1],
                             "tick_ns": int(np.gcd.reduce(steps))}

    def add_chunk(self, e0: int, rows: np.ndarray, replay, clock_ms: float,
                  replays: int, collectives=None, allreduce=None,
                  act=None, projected=None, act_bf16=None,
                  bf16_rows=None) -> None:
        """A chunk's stamp and counter rows (module docstring), its
        (all-reduces, bytes all-reduced) where counted, its stamps after
        the gradient all-reduce where a step of several ranks made them,
        and its replays' activation kernel launches (f32 and bf16
        entries), projected rows and bf16 product rows where counted."""
        self.chunks.append({"chunk": e0, "rows": np.array(rows, np.int64),
                            "replay": np.asarray(replay, bool),
                            "clock_ms": clock_ms, "replays": replays,
                            "collectives": collectives, "act": act,
                            "projected": projected, "act_bf16": act_bf16,
                            "bf16_rows": bf16_rows,
                            "allreduce": None if allreduce is None else
                            np.array(allreduce, np.int64)})

    def _host_ns(self, rows: np.ndarray) -> np.ndarray:
        """Stamps (..., STAMPS) on the host's perf_counter clock."""
        return rows[..., :_stamp.STAMPS] + self.device_clock["offset_ns"]

    def _bounds(self, c: dict, replays: bool = True) -> np.ndarray:
        """(K, 7) host ns of chunk ``c``'s replays (or every step): s0-s4,
        the stamp after the gradient all-reduce (s4 where the step has
        none: one process), s5."""
        pick = c["replay"] if replays else slice(None)
        s = self._host_ns(c["rows"][pick])
        ar = s[:, 4:5]
        if c.get("allreduce") is not None:
            ar = c["allreduce"][pick][:, None] + \
                self.device_clock["offset_ns"]
        return np.concatenate([s[:, :5], ar, s[:, 5:]], axis=1)

    def summary(self, chunks=None) -> dict:
        """Over the replays of the chunks whose first epochs ``chunks``
        lists (every chunk by default), milliseconds a step: the gaps
        between replays within a chunk (s0 of replay k+1 less s5 of k),
        across chunk boundaries (the same from a chunk's last replay to the
        next one's first), the host's ``replay`` and ``flush_wait`` spans,
        and the mean stages (trace s2 - s1, forward (s1 - s0) + (s3 - s2),
        backward s4 - s3, allreduce from s4 to the stamp after the
        gradient all-reduce, update from there to s5; with one process
        allreduce is 0 and update s5 - s4); the trace's SDF rows computed
        a step and the share of them asked for (ACTIVE over COMPUTED, %);
        the all-reduces and their bytes a step (over every step of the
        chunks that counted them, None where none did); the activation
        kernel's launches and the camera projections' rows a replay
        (``act_kernel_launches_per_step``, ``projected_rows_per_step``;
        None where no chunk counted them); with bf16 activations the
        launches of the activation's bf16 entries and the rows the bf16
        products contracted a replay (``act_bf16_launches_per_step``,
        ``bf16_gemm_rows_per_step``; None where no chunk counted them).
        Besides: the stages' sum and the ``_StepClock`` ms a replay, the
        ``plan_wait`` span a step, the share of the chunks' planned epochs
        whose draws were ready when asked, and each boundary with the
        spans of its chunk's plan, plan wait and first replay, host ns."""
        picked = [i for i, c in enumerate(self.chunks)
                  if (chunks is None or c["chunk"] in chunks) and
                  c["replay"].any()]
        ids = {self.chunks[i]["chunk"] for i in picked}
        stage = dict.fromkeys(("trace", "forward", "backward", "allreduce",
                               "update"), 0)
        n_coll = coll_steps = coll_bytes = 0
        act = act_steps = projected = projected_steps = 0
        bf16 = {"act_bf16": [0, 0], "bf16_rows": [0, 0]}
        gap = 0
        boundaries = []
        active = computed = steps = replays = 0
        clock_ms = 0.0
        for i in picked:
            c = self.chunks[i]
            rows = c["rows"][c["replay"]]
            s = self._bounds(c)
            for name, lo, hi in _STAGES:
                stage[name] += int((s[:, hi] - s[:, lo]).sum())
            if c["collectives"] is not None:
                n_coll += c["collectives"][0]
                coll_bytes += c["collectives"][1]
                coll_steps += len(c["rows"])
            if c["act"] is not None:
                act += c["act"]
                act_steps += c["replays"]
            if c["projected"] is not None:
                projected += c["projected"]
                projected_steps += c["replays"]
            for k, tally in bf16.items():
                if c.get(k) is not None:
                    tally[0] += c[k]
                    tally[1] += c["replays"]
            gap += int((s[1:, 0] - s[:-1, 6]).sum())
            prev = [p for p in self.chunks[:i] if p["replay"].any()]
            if prev:
                last = self._host_ns(prev[-1]["rows"][prev[-1]["replay"]])
                boundaries.append({"chunk": c["chunk"],
                                   "gap": [int(last[-1, 5]), int(s[0, 0])]})
            active += int(rows[:, _stamp.ACTIVE].sum())
            computed += int(rows[:, _stamp.COMPUTED].sum())
            steps += len(rows)
            clock_ms += c["clock_ms"]
            replays += c["replays"]
        if not steps:
            return {}
        host = dict.fromkeys(("replay", "flush_wait", "plan_wait"), 0)
        for name, a, b, _, chunk, _ in self.spans:
            if name in host and chunk in ids and b is not None:
                host[name] += b - a
        for bd in boundaries:
            mine = lambda want: [[a, b] for name, a, b, _, chunk, _
                                 in self.spans if name == want and
                                 chunk == bd["chunk"] and b is not None]
            bd["plan"] = min(mine("plan_chunk"), default=None)
            bd["plan_wait"] = min(mine("plan_wait"), default=None)
            bd["first_replay"] = min(mine("replay"), default=None)
        ms = lambda ns: ns / 1e6 / steps
        out = {"steps": steps,
               "chunk_boundary_ms_per_step": ms(sum(
                   b["gap"][1] - b["gap"][0] for b in boundaries)),
               "replay_gap_ms_per_step": ms(gap),
               "replay_host_ms_per_step": ms(host["replay"]),
               "flush_wait_ms_per_step": ms(host["flush_wait"]),
               "plan_wait_ms_per_step": ms(host["plan_wait"])}
        out.update({f"step_stage_ms.{k}": ms(v) for k, v in stage.items()})
        planned = [p for p in self.plans if p["chunk"] in ids]
        n_planned = sum(p["epochs"] for p in planned)
        out.update(plan_drawn_ahead_share=sum(p["ahead"] for p in planned) /
                   n_planned if n_planned else None,
                   trace_rows_per_step=computed / steps,
                   trace_row_fill=100.0 * active / computed if computed
                   else None,
                   stage_sum_ms=ms(sum(stage.values())),
                   allreduces_per_step=n_coll / coll_steps if coll_steps
                   else None,
                   allreduce_bytes_per_step=coll_bytes / coll_steps
                   if coll_steps else None,
                   act_kernel_launches_per_step=act / act_steps
                   if act_steps else None,
                   projected_rows_per_step=projected / projected_steps
                   if projected_steps else None,
                   act_bf16_launches_per_step=bf16["act_bf16"][0] /
                   bf16["act_bf16"][1] if bf16["act_bf16"][1] else None,
                   bf16_gemm_rows_per_step=bf16["bf16_rows"][0] /
                   bf16["bf16_rows"][1] if bf16["bf16_rows"][1] else None,
                   clock_ms_per_replay=clock_ms / replays if replays
                   else None,
                   boundaries=boundaries)
        return out

    def write(self, path: str) -> None:
        """Everything kept, as a Chrome trace-event file (module
        docstring): host spans, then each replay's stages and the gaps
        before it, then the rows a step counted; ``otherData`` holds the
        device clock and ``summary()``."""
        to_unix = unix_offset_ns()
        base = kineto_base_ns(time.time_ns())
        us = lambda host_ns: (int(host_ns) + to_unix - base) / 1e3
        pid = os.getpid()
        events = [{"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": "mvsdf_tpu_torch program trace"}}]
        for tid, name in ((_HOST_TID, "host spans"),
                          (_DEVICE_TID, "device stages"),
                          (_WORKER_TID, "host worker")):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        for i, ((name, a, b, parent, chunk, args), own) in enumerate(
                zip(self.spans, self.self_ns())):
            if b is None:
                continue
            tid = _WORKER_TID if i in self.worker_spans else _HOST_TID
            events.append({"ph": "X", "name": name, "pid": pid,
                           "tid": tid, "ts": us(a), "dur": (b - a) / 1e3,
                           "args": dict(args, chunk=chunk, parent=parent,
                                        self_us=own / 1e3)})
        last = None
        for c in self.chunks:
            s = self._bounds(c, replays=False)
            for k in np.flatnonzero(c["replay"]):
                args = {"chunk": c["chunk"], "k": int(k)}
                if last is not None:
                    events.append({
                        "ph": "X", "name": "replay_gap" if last[0] is c
                        else "chunk_boundary", "pid": pid, "tid": _DEVICE_TID,
                        "ts": us(last[1]), "dur": (s[k, 0] - last[1]) / 1e3,
                        "args": args})
                for name, a, b in _STAGES:
                    if name == "allreduce" and s[k, b] == s[k, a]:
                        continue   # one process: no all-reduce
                    events.append({"ph": "X", "name": name, "pid": pid,
                                   "tid": _DEVICE_TID, "ts": us(s[k, a]),
                                   "dur": (s[k, b] - s[k, a]) / 1e3,
                                   "args": args})
                events.append({"ph": "C", "name": "trace_rows", "pid": pid,
                               "ts": us(s[k, 0]), "args": {
                                   "active": int(c["rows"][k, _stamp.ACTIVE]),
                                   "computed": int(c["rows"][
                                       k, _stamp.COMPUTED])}})
                last = (c, s[k, 6])
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base,
                       "otherData": {"device_clock": self.device_clock,
                                     "unix_offset_ns": to_unix,
                                     "summary": self.summary()}}, f)


class Throughput:
    """Rays/s (and steps/s) moving counters."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.rays = 0
        self.steps = 0

    def add(self, n_rays: int):
        self.rays += n_rays
        self.steps += 1

    def rates(self):
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {"rays_per_s": self.rays / dt, "steps_per_s": self.steps / dt}
