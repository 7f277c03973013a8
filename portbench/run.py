"""Runs one cell of the port's benchmark on this machine's GPU and prints
its result as one JSON line, the last of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (``BENCHMARK.json``). Every
run checks what the timed path produced against the plain reference
(``reference/``) and prints each compared number beside its limit, as the
last lines of standard error and under the result's last key, ``checks``.
Exits non-zero, with no result, where there is no CUDA device or fewer
than the cell needs, and where JAX or the package the program was ported
from has been loaded.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def log(msg: str) -> None:
    """A line on standard error with the seconds since the start."""
    print(f"portbench [{time.perf_counter() - START:.2f} s]: {msg}",
          file=sys.stderr, flush=True)


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def _finite(v: float) -> float:
    """A reading as JSON holds it: a non-finite one as the largest
    float."""
    return v if math.isfinite(v) else sys.float_info.max


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            start: float = START, cache: str = None):
    """Set-up, the window, the traced readings and the check of one run;
    ``cache`` is the scene's cache directory (``scene.CACHE`` by default).
    Returns (result without ``device``'s card fields, checks)."""
    import torch
    from portbench import scene
    from portbench.common import driver_module, read_metrics
    cuda = device.type == "cuda"
    drv = driver_module(cell.kind).Driver(cell, seed, device, trace,
                                          cache or scene.CACHE)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_reserved()
        # the window's peak: what it holds, the CUDA graphs' pools with it,
        # and what it allocates; not the set-up's freed blocks
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start
    drv.window(seconds)
    ctx = drv.ctx
    ctx["setup_s"] = setup_s
    if cuda:
        ctx["peak_mem_bytes"] = torch.cuda.max_memory_reserved()
    parts = ", ".join(f"{k} {v:.2f}" for k, v in drv.parts.items()
                      if isinstance(v, float))
    log(f"set-up {setup_s:.2f} s ({parts}), window done")
    prof = None
    if trace and cuda:
        prof = ctx["profile"] = drv.profile()
        log(f"profiled: busy {prof['busy_s']:.3f} s, traced "
            f"{prof['traced_s']:.3f} s, the same work unprofiled "
            f"{prof['window_s']:.3f} s; busy share "
            f"{prof['busy_s'] / prof['window_s']:.4f} against the replays' "
            f"share of the window by CUDA events {prof['replay_share']:.4f}")
        drv.kernel_timings()
        log("kernel timings")
    peak = max(setup_peak, ctx["peak_mem_bytes"]) if cuda else 0
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = read_metrics(entries, ctx)
    drv.release()
    checks = drv.check()
    log("checked")
    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics,
              "device": {"memory_peak_bytes": int(peak)}}
    if prof is not None:
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        result["breakdown"] = prof["breakdown"]
    return result, checks


def main(argv=None):
    args = parse_args(argv)
    import torch
    from portbench.common import (Cell, forbidden_modules, load_benchmark,
                                  power_limit)
    cell = Cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} CUDA devices, this machine "
             f"has {torch.cuda.device_count()}")
    card = power_limit()
    print(f"portbench: {cell.name} seed {args.seed} on {card}",
          file=sys.stderr)
    result, checks = measure(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda"))
    found = forbidden_modules()
    if found:
        fail(f"modules loaded that the benchmark may not load: {found}")
    line = finish(result, checks, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cell.chips, "card": card})
    if not line["correct"]:
        print("portbench: not correct", file=sys.stderr)
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))


def finish(result: dict, checks, device: dict) -> dict:
    """The result line: ``device`` the card's fields, the compared
    numbers last, each beside its limit."""
    line = dict(result, device=dict(device, **result["device"]))
    line["checks"] = {k: {"value": _finite(v), "limit": lim}
                      for k, v, lim in checks}
    return line


if __name__ == "__main__":
    main()
