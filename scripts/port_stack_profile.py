"""Which code launches the device time of a benchmark cell's training step.

    python3 scripts/port_stack_profile.py --workload dtu_kernels.train_a \\
        --seed 7 [--out stack.json] [--tiny]

Sets the cell up as ``portbench/run.py`` does (``portbench/drivers/
train.py``: the CLI's trainer, the seed's weights, the phase's first epoch,
the capture and a warm chunk), then:
  - profiles one chunk of graph replays, as the traced benchmark run does:
    device seconds by kernel name, and the share of the matrix-vector
    (``gemv``) and copy kernels. A replay launches its kernels without
    Python, so nothing here says who asked for them;
  - profiles one eager step of the same captured code, each function of
    ``CALLERS`` run inside a profiler range of its caller's name: each
    kernel is charged to the innermost range around its launching op
    (`` projection`` added where ``geometry/projections._apply`` ran it),
    or, for the backward, whose ops run outside those ranges, to the
    autograd node that launched it.
Prints one JSON line (and writes it to ``--out``): the card, the chunk's
steps and kernels, the eager step's milliseconds by caller and kernel, the
matrix-vector and copy kernels' milliseconds by the innermost frame of the
program and the outermost aten op that launched them, and the rows the
projection counter (``projections.PROJECTED_ROWS``) adds in a step, where
the program has one.

``--tiny`` runs the cell at the harness tests' CPU size
(``portbench/tests/tiny.py``) on the CPU, where the ops' own CPU time
stands in for kernels.
"""
import argparse
import contextlib
import functools
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (module, function, caller): each call runs inside a profiler range named
# after its caller, which a kernel's launching op lies in
CALLERS = (("mvsdf_tpu_torch.rendering.renderer", "_unproject_depth_maps",
            "unproject"),
           ("mvsdf_tpu_torch.supervision.losses", "carving", "carving"),
           ("mvsdf_tpu_torch.supervision.losses", "feat_consistency_loss",
            "feature_warp"),
           ("mvsdf_tpu_torch.geometry.projections", "_apply", "projection"))
LABEL = "caller:"
KINDS = (("gemv", "gemv"), ("gemm", "gemm"), ("copy", "copy"),
         ("bmm", "gemv"), ("clone", "copy"))


def kind(name: str) -> str:
    low = name.lower()
    return next((k for pat, k in KINDS if pat in low), "other")


@contextlib.contextmanager
def labelled():
    """Every function of ``CALLERS`` runs inside its caller's range."""
    import importlib
    from torch.profiler import record_function

    def wrap(fn, label):
        @functools.wraps(fn)
        def run(*a, **kw):
            with record_function(LABEL + label):
                return fn(*a, **kw)
        return run
    saved = []
    try:
        for mod, name, label in CALLERS:
            m = importlib.import_module(mod)
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, wrap(getattr(m, name), label))
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _ancestors(evt):
    e = evt
    while e is not None:
        yield e
        e = e.cpu_parent


def caller(evt) -> str:
    """The innermost caller range around evt, `` projection`` added where
    ``_apply`` ran it; for the backward, whose ops run outside those
    ranges, the autograd node that launched it."""
    names = [e.name for e in _ancestors(evt)]
    node = next((n.split(": ", 1)[1] for n in names
                 if n.startswith("autograd::engine::evaluate_function: ")),
                None)
    if node is not None:
        return f"backward {node}"
    labels = [n[len(LABEL):] for n in names if n.startswith(LABEL)]
    where = next((n for n in labels if n != "projection"), "other")
    return f"{where} projection" if "projection" in labels else where


def site(evt) -> str:
    """The innermost frame of the program's own code in evt's stack (where
    the profiler recorded one) and the outermost aten op that launched
    evt's kernel."""
    frames = [f for e in _ancestors(evt) for f in list(e.stack) + [e.name]]
    own = next((f for f in frames if "mvsdf_tpu_torch/" in f), "")
    aten = [f for f in frames if f.startswith("aten::")]
    return f"{own} {aten[-1] if aten else ''}".strip()


def kernels(prof, cuda: bool):
    """(op event, kernel name, seconds) of every device kernel, or on the
    CPU of every op's self time."""
    out = []
    for e in prof.events():
        if cuda:
            out += [(e, k.name, k.duration * 1e-6) for k in e.kernels]
        elif e.name.startswith("aten::"):
            out.append((e, e.name, e.self_cpu_time_total * 1e-6))
    return out


def _table(rows, top: int = 15):
    return [[k, round(v, 9)] for k, v in
            sorted(rows.items(), key=lambda kv: -kv[1])[:top]]


def _profile(cuda: bool, **kw):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts, **kw)


def chunk_profile(drv, cuda: bool) -> dict:
    """A chunk of replays: the device's operations by name, from the
    profiler's device events (a replay's kernels have no launching op)."""
    import torch
    from torch.autograd import DeviceType
    with _profile(cuda) as prof:
        steps = drv._chunk() * drv.steps_per_epoch
        drv.trainer._flush_metrics()
        if cuda:
            torch.cuda.synchronize()
    by_name, by_kind = {}, {}
    if cuda:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and \
                    not e.is_user_annotation():
                s = (e.end_ns() - e.start_ns()) * 1e-9
                by_name[e.name()] = by_name.get(e.name(), 0.0) + s
                by_kind[kind(e.name())] = by_kind.get(kind(e.name()),
                                                      0.0) + s
    else:
        for _, name, s in kernels(prof, cuda):
            by_name[name] = by_name.get(name, 0.0) + s
            by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + s
    return {"steps": steps, "device_s": sum(by_name.values()),
            "kernels": _table(by_name), "by_kind_s": _table(by_kind)}


def eager_profile(drv, cuda: bool) -> dict:
    """One eager step of the captured code, its kernels by caller."""
    import torch
    kw = {"with_stack": True}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(verbose=True)
    except ImportError:
        pass
    with labelled(), _profile(cuda, **kw) as prof:
        drv.step.eager()
        if cuda:
            torch.cuda.synchronize()
    by_caller, sites = {}, {}
    for evt, name, s in kernels(prof, cuda):
        ms, k = s * 1e3, kind(name)
        if k in ("gemv", "copy"):
            sites[f"{k} {site(evt)}"] = sites.get(f"{k} {site(evt)}",
                                                  0.0) + ms
        c = by_caller.setdefault(caller(evt), {"ms": 0.0, "by_kind": {},
                                               "kernels": {}})
        c["ms"] += ms
        c["by_kind"][k] = c["by_kind"].get(k, 0.0) + ms
        c["kernels"][name] = c["kernels"].get(name, 0.0) + ms
    for c in by_caller.values():
        c["by_kind"] = _table(c["by_kind"])
        c["kernels"] = _table(c["kernels"], 6)
    gemv = {k: dict(c["by_kind"]).get("gemv", 0.0)
            for k, c in by_caller.items()}
    return {"ms": sum(c["ms"] for c in by_caller.values()),
            "gemv_ms_by_caller": {k: v for k, v in gemv.items() if v},
            "gemv_copy_ms_by_site": _table(sites, 25),
            "by_caller": dict(sorted(by_caller.items(),
                                     key=lambda kv: -kv[1]["ms"]))}


def projected_rows_per_step(drv):
    """The projection counter over one eager step, where the program has
    one (None on a tree without it)."""
    from mvsdf_tpu_torch.geometry import projections as proj
    rows = getattr(proj, "PROJECTED_ROWS", None)
    if rows is None:
        return None
    before = rows.launches
    drv.step.eager()
    return rows.launches - before


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from portbench.common import Cell, driver_module, load_benchmark, \
        power_limit
    if args.tiny:
        from portbench.tests import tiny
        names = {w["name"]: w["config"] for w in load_benchmark()["workloads"]}
        cell = tiny.cell(args.workload, names[args.workload])
        device, card = torch.device("cpu"), "cpu"
        cache = os.path.join(os.path.dirname(args.out) or ".", "cache")
    else:
        from portbench import scene
        cell = Cell(load_benchmark(), args.workload)
        device, cache, card = torch.device("cuda"), scene.CACHE, \
            power_limit()
    cuda = device.type == "cuda"
    drv = driver_module(cell.kind).Driver(cell, args.seed, device, False,
                                          cache)
    drv.setup()
    res = {"workload": args.workload, "seed": args.seed, "card": card,
           "chunk": chunk_profile(drv, cuda),
           "eager_step": eager_profile(drv, cuda),
           "projected_rows_per_step": projected_rows_per_step(drv)}
    drv.release()
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main()
