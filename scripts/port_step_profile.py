"""Where the port's training step spends its time on the GPU.

Runs the bench configuration (chip_smoke.bench_config: full-width model,
B=8 x P=4096 rays, phase B) and reports:
  - wall time per step, and the part spent in the no-grad trace
    (renderer._frozen_trace, synchronized before and after);
  - sdf_mlp launches and rows per step (the trace's SDF evaluations);
  - a torch.profiler window: device time by kernel, the sdf_mlp kernel's
    share, and the device's busy share of the window.

    python3 scripts/port_step_profile.py [--steps 5] [--out result.json]

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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("port_step_profile: needs a CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import B, P, bench_config
    from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
    from mvsdf_tpu_torch.rendering import renderer
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.train.step import init_train_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = bench_config()
    batch = scene_to_torch(make_scene(n_images=B, n_pix=P, feat_ch=32,
                                      img_hw=96, depth_hw=48), dev)
    state = init_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, phase_idx=1)
    weights = cfg.schedule.weights(0.3)
    gen = torch.Generator(device=dev).manual_seed(0)

    trace_s = []
    rows = []
    inner_trace = renderer._frozen_trace
    inner_launch = K._launch

    def timed_trace(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_trace(*a, **kw)
        torch.cuda.synchronize()
        trace_s.append(time.perf_counter() - t0)
        return out

    def counted_launch(packed, pe):
        rows.append(pe.shape[0])
        return inner_launch(packed, pe)

    renderer._frozen_trace = timed_trace
    K._launch = counted_launch
    for _ in range(3):
        step(state, batch, weights, gen)
    torch.cuda.synchronize()
    trace_s.clear()
    rows.clear()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = step(state, batch, weights, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    trace_ms = sum(trace_s) / args.steps * 1e3
    renderer._frozen_trace = inner_trace
    K._launch = inner_launch

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch, weights, gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kern = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host ops; their kernels are listed on their own
        dt = ev.self_device_time_total
        if dt > 0:
            kern[ev.key] = (dt / 1e3, ev.count)   # us -> ms
    busy_ms = sum(v[0] for v in kern.values())
    sdf_ms = sum(v[0] for k, v in kern.items() if "sdf_mlp_kernel" in k)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:15]
    res = {
        "device": smi, "steps": args.steps,
        "step_ms": step_ms, "trace_ms_per_step": trace_ms,
        "sdf_mlp_launches_per_step": len(rows) / args.steps,
        "sdf_mlp_rows_per_step": sum(rows) / args.steps,
        "sdf_mlp_rows_max": max(rows), "sdf_mlp_rows_min": min(rows),
        "profiled_window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / window_ms,
        "sdf_mlp_device_ms_per_step": sdf_ms / args.steps,
        "top_kernels_ms_per_step": {k: [v[0] / args.steps, v[1] / args.steps]
                                    for k, v in top},
        "hit_frac": float(metrics["hit_frac"]),
    }
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
