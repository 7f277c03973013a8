"""What every cell shares: ``BENCHMARK.json`` and the files it names, the
metric readers, timing on the card, the profiler's reading, and the
result line.

A cell's files are found by name: its traffic in
``workloads/<cell>.json`` (the ``kind`` there picks ``drivers/<kind>.py``),
its configuration in the file ``BENCHMARK.json`` gives, each metric's
reader in ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in a run: JAX and the package
# the program was ported from, compared whole (the program's own name
# begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mvsdf_tpu")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and traffic
    files read."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config_name = self.config_entry["name"]
        self.config = read_json(os.path.join(root, self.config_entry["file"]))
        self.traffic = read_json(traffic_path(self.entry["traffic"], root))
        self.kind = self.traffic["kind"]
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


def traffic_path(traffic: str, root: str = ROOT) -> str:
    return os.path.join(root, "portbench", "workloads", traffic + ".json")


def reader_path(metric: str, root: str = ROOT) -> str:
    return os.path.join(root, "portbench", "metrics", metric + ".py")


def load_reader(metric: str, root: str = ROOT):
    """The module of ``metrics/<metric>.py``: ``read(ctx)`` gives the
    metric's value, or None where the run has nothing to read."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"),
        reader_path(metric, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def read_metrics(entries, ctx: dict) -> dict:
    """{name: {"value", "unit"}} of the entries whose reader finds
    something."""
    out = {}
    for m in entries:
        v = load_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = {k.split(".")[0] for k in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over ``iters`` calls, by CUDA
    events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class Clock:
    """Named host-clock spans, in seconds."""

    def __init__(self):
        self.spans = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def timed(self, name: str, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.add(name, time.perf_counter() - t0)
        return run

    def total(self, name: str) -> float:
        return sum(self.spans.get(name, ()))
