"""Where the port's training step spends its time on the GPU.

Runs one of the two trace configurations of the bench step (full-width
model, B=8 x P=4096 rays, phase B): bench_phaseB (chip_smoke.bench_config,
the trace through the sdf_mlp kernel) or, with --fused, bench_phaseB_fused
(chip_smoke.fused_config: the fused march, secant and in-kernel-PE
SDF-MLP kernels). Reports:
  - wall time per step, and the part spent in the no-grad trace
    (renderer._frozen_trace, synchronized before and after);
  - for each trace kernel, launches and MLP rows per step (for the march,
    the rows its blocks evaluated and the rows the march used, from the
    kernel's own counter);
  - a torch.profiler window over the following steps: device time by
    kernel, each trace kernel's device time with the launches and rows of
    that same window (the trace's work follows the training state, so the
    two windows differ), and the device's busy share of the window;
  - with --chunk, the same state then trained on as the trainer's fused
    dispatch runs a chunk: the step captured into a CUDA graph
    (train/step.CapturableStep, the bench batch served whatever the plan
    says), a plan of --steps rows uploaded in one copy and replayed row by
    row: the capture's seconds and graph pool, the window's ms/step, device
    time by kernel and busy share, beside the per-epoch window's.

    python3 scripts/port_step_profile.py [--fused] [--chunk] [--steps 5]
        [--out f]

Prints the result as JSON (and writes it to --out if given). Needs a GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# kernel -> the name its device kernel carries in a profile
DEVICE_NAMES = {"sdf_mlp": "sdf_mlp_kernel",
                "sdf_mlp_xyz": "sdf_mlp_xyz_kernel",
                "secant": "secant_kernel", "sphere_march": "march_kernel"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fused", action="store_true",
                    help="profile bench_phaseB_fused instead of "
                         "bench_phaseB")
    ap.add_argument("--chunk", action="store_true",
                    help="also profile a chunk of graph replays of the "
                         "captured step")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("port_step_profile: needs a CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import B, P, bench_config, fused_config
    from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
    from mvsdf_tpu_torch.rendering import renderer
    from mvsdf_tpu_torch.tracing.kernels import march_kernel as M
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.tracing.kernels import secant_kernel as S
    from mvsdf_tpu_torch.train.step import init_train_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = fused_config() if args.fused else bench_config()
    batch = scene_to_torch(make_scene(n_images=B, n_pix=P, feat_ch=32,
                                      img_hw=96, depth_hw=48), dev)
    state = init_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, phase_idx=1)
    weights = cfg.schedule.weights(0.3)
    gen = torch.Generator(device=dev).manual_seed(0)

    trace_s = []
    launches = {k: [] for k in DEVICE_NAMES}   # rows of each launch
    march_rows = torch.zeros(2, dtype=torch.int64, device=dev)
    inner = {"trace": renderer._frozen_trace, "sdf_mlp": K._launch,
             "sdf_mlp_xyz": K._launch_xyz, "secant": S._launch,
             "sphere_march": M._launch}

    def timed_trace(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner["trace"](*a, **kw)
        torch.cuda.synchronize()
        trace_s.append(time.perf_counter() - t0)
        return out

    def sdf_launch(packed, pe):
        launches["sdf_mlp"].append(pe.shape[0])
        return inner["sdf_mlp"](packed, pe)

    def xyz_launch(packed, multires, x):
        launches["sdf_mlp_xyz"].append(x.shape[0])
        return inner["sdf_mlp_xyz"](packed, multires, x)

    def secant_launch(packed, multires, n_steps, org, *a):
        launches["secant"].append(org.shape[0] * n_steps)
        return inner["secant"](packed, multires, n_steps, org, *a)

    def march_launch(*a):
        launches["sphere_march"].append(0)   # rows: the kernel's counter
        return inner["sphere_march"](*a[:-1], march_rows)

    def patch(on, time_trace=True):
        renderer._frozen_trace = timed_trace if on and time_trace \
            else inner["trace"]
        K._launch = sdf_launch if on else inner["sdf_mlp"]
        K._launch_xyz = xyz_launch if on else inner["sdf_mlp_xyz"]
        S._launch = secant_launch if on else inner["secant"]
        M._launch = march_launch if on else inner["sphere_march"]

    patch(True)
    for _ in range(3):
        step(state, batch, weights, gen)
    torch.cuda.synchronize()
    trace_s.clear()
    for v in launches.values():
        v.clear()
    march_rows.zero_()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = step(state, batch, weights, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    trace_ms = sum(trace_s) / args.steps * 1e3
    m_eval, m_used = march_rows.tolist()
    timed = {k: list(v) for k, v in launches.items()}
    # the profiled window counts its own launches (no trace timing: its
    # synchronizes would change the window's busy share)
    patch(True, time_trace=False)
    for v in launches.values():
        v.clear()
    march_rows.zero_()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch, weights, gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    patch(False)
    p_eval, p_used = march_rows.tolist()
    kern = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host ops; their kernels are listed on their own
        dt = ev.self_device_time_total
        if dt > 0:
            kern[ev.key] = (dt / 1e3, ev.count)   # us -> ms
    busy_ms = sum(v[0] for v in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:15]
    per_kernel = {}
    for k, dname in DEVICE_NAMES.items():
        rows, p_rows = timed[k], launches[k]
        # demangled "...::name(...)" or "...::name<...>(...)", or mangled
        # "...<len>name..."
        ms = sum(v[0] for key, v in kern.items()
                 if f"{dname}(" in key or f"{dname}<" in key
                 or f"{len(dname)}{dname}" in key)
        per_kernel[k] = {
            "launches_per_step": len(rows) / args.steps,
            "rows_per_step": sum(rows) / args.steps,
            "profiled_launches_per_step": len(p_rows) / args.steps,
            "profiled_rows_per_step": sum(p_rows) / args.steps,
            "device_ms_per_step": ms / args.steps}
        if rows and k != "sphere_march":
            per_kernel[k].update(rows_max=max(rows), rows_min=min(rows))
    per_kernel["sphere_march"].update(
        rows_per_step=m_used / args.steps,
        rows_evaluated_per_step=m_eval / args.steps,
        profiled_rows_per_step=p_used / args.steps,
        profiled_rows_evaluated_per_step=p_eval / args.steps)
    res = {
        "device": smi, "config": ("bench_phaseB_fused" if args.fused
                                  else "bench_phaseB"),
        "steps": args.steps,
        "step_ms": step_ms, "trace_ms_per_step": trace_ms,
        "kernels": per_kernel,
        "profiled_window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / window_ms,
        "top_kernels_ms_per_step": {k: [v[0] / args.steps, v[1] / args.steps]
                                    for k, v in top},
        "hit_frac": float(metrics["hit_frac"]),
    }
    if args.chunk:
        res["chunk"] = chunk_window(cfg, state, batch, weights, gen,
                                    args.steps)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


def device_ms(prof):
    """{kernel name: (device ms, launches)} of a profile."""
    from torch.autograd import DeviceType
    kern = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kern[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    return kern


def chunk_window(cfg, state, batch, weights, gen, steps):
    """The state trained on by a CapturableStep: captured (its warm-up a
    real step), 3 replays, then a profiled window of ``steps`` replays of
    a plan uploaded in one pinned copy, as train/loop.Trainer._dispatch
    runs a chunk."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import B, P, BatchCache
    from mvsdf_tpu_torch.train.step import (METRIC_KEYS, CapturableStep,
                                            adam_scalars)
    step = CapturableStep(cfg, 1, weights, state, BatchCache(batch), gen)
    opt = state.optimizer

    def rows(n):
        out = []
        for _ in range(n):
            t = int(step.adam[0][2]) + 1
            for _, _, st in step.adam:
                st += 1
            out.append(step.plan_row(np.arange(B), np.arange(P),
                                     adam_scalars(opt, t)))
        return torch.from_numpy(np.stack(out)).pin_memory()

    def run(plan):
        plan_d = plan.to(step.device, non_blocking=True)
        out = torch.empty((len(plan), step.metrics.numel()),
                          device=step.device)
        for k in range(len(plan)):
            step.row.copy_(plan_d[k])
            step()
            out[k].copy_(step.metrics)
        return out

    step.row.copy_(rows(1)[0].to(step.device))
    step.capture()
    run(rows(3))
    torch.cuda.synchronize()
    plan = rows(steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run(plan)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kern = device_ms(prof)
    busy_ms = sum(v[0] for v in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:15]
    return {"capture_s": step.capture_s, "graph_pool_bytes":
            step.graph_bytes, "launches_per_replay": step.launches,
            "window_ms": window_ms, "step_ms": window_ms / steps,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / window_ms,
            "top_kernels_ms_per_step": {k: [v[0] / steps, v[1] / steps]
                                        for k, v in top},
            "hit_frac": float(out[-1, METRIC_KEYS.index("hit_frac")])}


if __name__ == "__main__":
    main()
