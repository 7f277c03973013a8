"""Observability: structured metrics logging + profiler hooks (port of
``mvsdf_tpu/train/metrics.py``).

JSONL metrics (one line per epoch), throughput counters, and a
``torch.profiler`` trace (host and CUDA activities, written as a Chrome
trace) around chosen epochs.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Optional

import torch


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


@contextmanager
def annotate(name: str):
    """Named region visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield


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
