"""The program's own trace of a benchmark cell's training: the trainer's
spans, the captured step's stage stamps and its trace row counters
(``train/metrics.Tracer``), read on the card.

    python3 scripts/port_trace_pass.py --workload dtu_kernels.train_c \\
        --seed 7 [--seconds 20] [--chunks 3] [--out trace_out]

Sets the cell up as ``portbench/run.py`` does (``portbench/drivers/
train.py``: the CLI's trainer, the seed's weights, the phase's first epoch,
the capture and a warm chunk) and runs its window of whole chunks for
``--seconds``. Then, from where it stands: ``--chunks`` chunks untraced;
tracing on (which releases the phase's graph), one chunk (the step
captured again with its stamps and counters, and warmed up) and
``--chunks`` traced chunks ending with a device sync, which the summary
reads; one traced step on the batch the plain reference trace counts;
tracing off, one chunk (the untraced step captured anew) and ``--chunks``
untraced chunks. Prints one JSON line: the trace's summary
(``Tracer.summary``: the chunk boundaries', the gaps between replays',
the host's replay, flush-wait and plan-wait milliseconds a step, the
share of planned epochs whose draws the trainer's worker had made ahead,
the four stage times, the trace's SDF rows a step and their fill), the
stages' sum against the trainer's CUDA-event milliseconds a replay, the
device clock's offset, bracket and step, each chunk boundary beside its
chunk's plan, plan wait and first replay on the host's clock, the
same-batch step's rows
beside the reference's, and the traced chunks' rays/s against the
window's and against the untraced chunks' around them, and their device
ms a replay (CUDA events) against the untraced chunks': what tracing
costs while on. Writes the trace as ``OUT/<cell>.spans.json``
(``--trace_dir``'s format).

A data-parallel cell (``portbench/drivers/train_ddp.py``) switches tracing
on every rank, adds each rank's summary of the traced chunks under
``ranks`` (the stages, with the gradient all-reduce's, and the all-reduces
and their bytes a step) and writes each rank's trace (rank r's as
``OUT/<cell>.spans.rank<r>.json``); it runs no same-batch step (each
rank's batch is its share of the reference's).

``--tiny`` runs the cell at the harness tests' CPU size
(``portbench/tests/tiny.py``) on the CPU.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def boundary_checks(summary: dict) -> list:
    """Each chunk boundary's device gap beside the host spans of its
    chunk's plan, plan wait (0 where the plan did not wait for the
    worker's draws) and first replay (host ns): whether the gap lies
    between the plan's start and the replay's end, and the margins in
    ms."""
    out = []
    for b in summary.get("boundaries", []):
        (g0, g1), plan, rep = b["gap"], b["plan"], b["first_replay"]
        if plan is None or rep is None:
            continue
        wait = b["plan_wait"]
        out.append({"chunk": b["chunk"], "gap_ms": (g1 - g0) / 1e6,
                    "plan_wait_ms": 0.0 if wait is None else
                    (wait[1] - wait[0]) / 1e6,
                    "after_plan_start_ms": (g0 - plan[0]) / 1e6,
                    "before_replay_end_ms": (rep[1] - g1) / 1e6,
                    "inside": plan[0] <= g0 and g1 <= rep[1]})
    return out


def _block(drv, chunks: int) -> dict:
    """``chunks`` whole chunks from where the trainer stands: rays/s on the
    host clock from there to the sync after them, and the device ms a
    replay of the chunks read meanwhile (the trainer's ``_StepClock``)."""
    import torch
    tr = drv.trainer
    first, steps = drv.epoch, 0
    replayed = []
    log_epoch = tr._log_epoch

    def logged(epoch, rays_per_s, m, **kw):
        replayed.append((kw["steps"], kw["steps"] * kw["ms_per_step"]))
        return log_epoch(epoch, rays_per_s, m, **kw)
    tr._log_epoch = logged
    try:
        t0 = time.perf_counter()
        for _ in range(chunks):
            steps += drv._chunk() * drv.steps_per_epoch
        tr._flush_metrics()
        if drv.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tr._log_epoch = log_epoch
    return {"first_epoch": first, "steps": steps, "seconds": wall,
            "rays_per_s": steps * drv.rays_per_step / wall,
            "device_ms_per_replay": sum(ms for _, ms in replayed) /
            sum(n for n, _ in replayed)}


def _same_batch_rows(drv) -> dict:
    """One traced step on the batch the plain reference counts
    (``_reference_counts``: the first epoch's first batch), at the
    weights it counts at: the step's ACTIVE and COMPUTED rows beside the
    reference's."""
    import torch
    from mvsdf_tpu_torch.tracing.kernels.stamp import ACTIVE, COMPUTED
    tr = drv.trainer
    with torch.no_grad():
        want = drv._reference_counts()["trace_rows"]
    (step,) = tr.fused_steps.values()
    plan, epochs, _ = tr._plan_chunk(drv.epoch, drv.epoch, step)
    indices, sel = drv._plan(1)[0]
    B = len(indices)
    plan[0, :B], plan[0, B:B + len(sel)] = indices, sel
    row = tr._dispatch(step, plan[:1], epochs[:1])["stamps"]
    if drv.device.type == "cuda":
        torch.cuda.synchronize()
    drv.epoch += 1
    return {"active": int(row[0, ACTIVE]), "computed": int(row[0, COMPUTED]),
            "reference": want}


def _ranks(drv) -> int:
    return getattr(drv, "world", 1)


def _set_tracing(drv, on: bool) -> None:
    """Tracing on or off, on every rank of a data-parallel cell."""
    getattr(drv, "set_tracing", drv.trainer.set_tracing)(on)


def trace_pass(drv, chunks: int) -> dict:
    """The pass on a cell whose window has run (module docstring): an
    untraced block, tracing on (a warm chunk, the traced block, the
    same-batch step with one process), tracing off (a warm chunk, an
    untraced block)."""
    tr = drv.trainer
    before = _block(drv, chunks)
    _set_tracing(drv, True)
    drv._chunk()
    traced = _block(drv, chunks)
    ids = [c["chunk"] for c in tr.tracer.chunks
           if c["chunk"] >= traced["first_epoch"]]
    summary = tr.tracer.summary(chunks=ids)
    ranks = drv.rank_summaries(ids) if _ranks(drv) > 1 else None
    same = _same_batch_rows(drv) if _ranks(drv) == 1 else None
    _set_tracing(drv, False)
    drv._chunk()
    after = _block(drv, chunks)
    w = drv.ctx["train_window"]
    window = {"steps": w["steps"], "seconds": w["seconds"],
              "rays_per_s": w["rays"] / w["seconds"]}
    untraced = (before["rays_per_s"] + after["rays_per_s"]) / 2
    return {"summary": {k: v for k, v in summary.items()
                        if k != "boundaries"},
            "stage_sum_over_clock": summary["stage_sum_ms"] /
            summary["clock_ms_per_replay"],
            "boundaries": boundary_checks(summary),
            "device_clock": tr.tracer.device_clock,
            "same_batch_rows": same,
            "ranks": ranks,
            "blocks": {"window": window, "untraced_before": before,
                       "traced": traced, "untraced_after": after},
            "tracing_cost": {
                "against_window": 1 - traced["rays_per_s"] /
                window["rays_per_s"],
                "against_untraced_blocks": 1 - traced["rays_per_s"] /
                untraced,
                "device_ms_per_replay": traced["device_ms_per_replay"] /
                (before["device_ms_per_replay"] +
                 after["device_ms_per_replay"]) * 2 - 1}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from portbench.common import Cell, driver_module, load_benchmark, \
        power_limit
    if args.tiny:
        from portbench.tests import tiny
        names = {w["name"]: w["config"] for w in load_benchmark()["workloads"]}
        cell = tiny.cell(args.workload, names.get(
            args.workload, tiny.config_of(args.workload)))
        if "ranks" in cell.config:   # two gloo ranks on the CPU
            cell.config["ranks"] = 2
        device, cache = torch.device("cpu"), os.path.join(
            args.out or ".", "cache")
        card = "cpu"
    else:
        from portbench import scene
        cell = Cell(load_benchmark(), args.workload)
        device, cache, card = torch.device("cuda"), scene.CACHE, \
            power_limit()
    drv = driver_module(cell.kind).Driver(cell, args.seed, device, False,
                                          cache)
    t = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t
    drv.window(args.seconds)
    res = {"workload": args.workload, "seed": args.seed, "card": card,
           "setup_s": setup_s, **trace_pass(drv, args.chunks)}
    if args.out:
        path = os.path.join(args.out, f"{args.workload}.spans.json")
        getattr(drv, "write_spans", drv.trainer.tracer.write)(path)
    drv.release()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
