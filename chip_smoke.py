"""Smoke run of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the main path (phase-B
training steps of the full-size model at the bench shapes, then an eval
render) through them, and prints what it measured.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. build   compile every kernel from the sources in the checkout
  2. kernel  each kernel against its plain version at the main path's
             widths (tolerance stated below), with timings and bounds
  3. train   3 warm-up + 5 timed phase-B steps, B=8 images x P=4096 rays,
             full-width model from seed 0, on the synthetic bench scene
  4. eval    eval-mode render of one view's 4096 rays; a small render
             through the kernel against one through the plain field
The line before the last is a JSON object listing each kernel; the last is
{"ok": true, "device": {...}}. Without a GPU it exits non-zero and prints
no result.
"""
import copy
import dataclasses
import json
import subprocess
import sys
import time

B, P = 8, 4096                 # the bench shapes: 8 images x 4096 rays
N_KERNEL = 65537               # ragged row count for the kernel check
TOL = 1e-4                     # max |kernel - plain| on |sdf| <~ 1, f32
WARMUP, TIMED = 3, 5
PEAK_F32 = 67e12               # H100 SXM, f32 outside the tensor cores
PEAK_BF16 = 989e12             # H100 SXM, dense bf16 tensor cores
HBM_BYTES_S = 3.35e12


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=10):
    """Mean device time of fn() over iters launches after one warm-up."""
    import torch
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


def bench_config():
    """The configuration the JAX package's bench.py builds, in the port."""
    from mvsdf_tpu_torch.config import MVSDFConfig, TrainConfig
    cfg = MVSDFConfig(train=TrainConfig(batch_size=B, num_pixels=P))
    m = cfg.model
    tracer = dataclasses.replace(
        m.tracer, fill_misses=False, sampler_capacity_frac=0.25,
        fill_capacity_frac=0.5, fallback_capacity_frac=(0.0625, 0.09375,
                                                        0.375),
        march_compact_schedule=((0, (0.375, 0.5)), (1, (0.1875, 0.25)),
                                (5, (0.0625, 0.125, 0.25))))
    model = dataclasses.replace(
        m, use_pallas_trace=True, tracer=tracer,
        supervised_compact_frac=(0.375,),
        implicit=dataclasses.replace(m.implicit, bf16_activations=True))
    return dataclasses.replace(cfg, model=model)


def library_chain(net, x):
    """The SDF column as plain torch library calls at the true widths:
    F.linear + F.softplus(beta=100). A yardstick only."""
    import torch
    import torch.nn.functional as F
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    cfg = net.cfg
    pe = positional_encoding(x, cfg.multires)
    h = pe
    n = len(net.layers)
    for l, layer in enumerate(net.layers):
        if l in cfg.skip_in:
            h = torch.cat([h, pe], -1) * (2 ** -0.5)
        W = layer.effective_weight()
        if l == n - 1:
            return F.linear(h, W[:, :1].T, layer.b[:1])[:, 0]
        h = F.softplus(F.linear(h, W.T, layer.b), beta=100)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.rendering.renderer import render_forward
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.train.step import (init_params, init_train_state,
                                            make_train_step)

    # 1. build
    t0 = time.perf_counter()
    K.build()
    log(f"[build] sdf_mlp.cu built in {time.perf_counter() - t0:.2f} s")

    # 2. kernel against its plain version
    cfg = bench_config()
    icfg = cfg.model.implicit
    net = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        packed = K.pack_sdf_weights(net.implicit)
        x = torch.rand((N_KERNEL, 3), generator=gen, device=dev) * 2 - 1
        pe = positional_encoding(x, icfg.multires).contiguous()
        # through the wrapper; the counts are zeroed before the main path
        got = K.sdf_mlp(packed, pe)
        ref = K.sdf_mlp_reference(packed, pe)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"[kernel] sdf_mlp N={N_KERNEL}: max|kernel - plain| = {err:.3e}"
            f" (tolerance {TOL:g}), max|sdf| = {ref.abs().max().item():.3f}")
        if not (err <= TOL and torch.isfinite(got).all()):
            raise AssertionError(f"sdf_mlp disagrees with its plain version:"
                                 f" {err}")
        ms = cuda_ms(lambda: K.sdf_mlp(packed, pe))
        plain_ms = cuda_ms(lambda: K.sdf_mlp_reference(packed, pe))
        library_ms = cuda_ms(lambda: library_chain(net.implicit, x))
    flops = K.flops_per_point(icfg) * N_KERNEL
    nbytes = 4 * (pe.numel() + N_KERNEL + sum(
        t.numel() for t in packed if isinstance(t, torch.Tensor)))
    bound_ms = max(flops / PEAK_F32, nbytes / HBM_BYTES_S) * 1e3
    log(f"[kernel] sdf_mlp {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"chain {library_ms:.3f} ms; {flops / 1e9:.1f} GFLOP -> bound "
        f"{bound_ms:.3f} ms at f32 peak ({flops / PEAK_BF16 * 1e3:.3f} ms "
        f"at bf16 peak); {flops / ms / 1e9:.1f} TFLOP/s achieved")

    # 3. training: the main path
    scene = make_scene(n_images=B, n_pix=P, feat_ch=32, img_hw=96,
                       depth_hw=48)
    batch = scene_to_torch(scene, dev)
    state = init_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, phase_idx=1)
    weights = cfg.schedule.weights(0.3)
    K.sdf_mlp.launches = 0
    per_step = []

    def run(n):
        for _ in range(n):
            before = K.sdf_mlp.launches
            out = step(state, batch, weights, gen)
            per_step.append(K.sdf_mlp.launches - before)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run(WARMUP)
    log(f"[train] warm-up {WARMUP} steps: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    metrics = run(TIMED)
    dt = (time.perf_counter() - t0) / TIMED
    launches = K.sdf_mlp.launches
    m = {k: float(v) for k, v in metrics.items()}
    log(f"[train] {dt * 1e3:.1f} ms/step, {B * P / dt:.1f} rays/s, hit "
        f"{m['hit_frac']:.4f}, sdf_mlp launches/step "
        f"{launches / (WARMUP + TIMED):.1f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log("[train] last step: " + json.dumps(
        {k: round(v, 6) for k, v in m.items()}))
    if not all(torch.isfinite(torch.tensor(list(m.values())))):
        raise AssertionError(f"non-finite training metrics: {m}")
    log(f"[train] sdf_mlp launches per step: {per_step}")
    if min(per_step) == 0:
        raise AssertionError("a training step never launched sdf_mlp")

    # 4. eval render of one view, through the kernel
    view = {k: v[:1] for k, v in batch.items()}
    K.sdf_mlp.launches = 0
    with torch.no_grad():
        out = render_forward(cfg.model, state.net, view, training=False)
    torch.cuda.synchronize()
    eval_launches = K.sdf_mlp.launches
    rgb = out.rgb_values
    log(f"[eval] rgb {tuple(rgb.shape)}, hit "
        f"{out.network_object_mask.float().mean().item():.4f}, sdf_mlp "
        f"launches {eval_launches}")
    if rgb.shape != (1, P, 3) or not torch.isfinite(rgb).all():
        raise AssertionError("eval render is not finite RGB of (1, P, 3)")
    if eval_launches == 0:
        raise AssertionError("the eval render never launched sdf_mlp")
    # a small render through the kernel against one through the plain f32
    # field (same weights)
    small = {"uv": batch["uv"][:1, :256], "pose": batch["pose"][:1],
             "intrinsics": batch["intrinsics"][:1],
             "object_mask": batch["object_mask"][:1, :256]}
    plain_net = copy.deepcopy(state.net)
    plain_net.implicit.cfg = dataclasses.replace(icfg, bf16_activations=False)
    plain_cfg = dataclasses.replace(cfg.model, use_pallas_trace=False)
    with torch.no_grad():
        a = render_forward(cfg.model, state.net, small, training=False)
        b = render_forward(plain_cfg, plain_net, small, training=False)
    agree = (a.network_object_mask == b.network_object_mask)
    both = agree & a.network_object_mask
    derr = (a.dists - b.dists)[both].abs().max().item() if both.any() else 0
    log(f"[eval] kernel vs plain field on 256 rays: hit masks agree on "
        f"{agree.float().mean().item():.4f}, max |d dists| on common hits "
        f"{derr:.2e}")
    if agree.float().mean().item() < 0.99 or derr > 1e-3:
        raise AssertionError("traced render through the kernel disagrees "
                             "with the plain field")

    print(json.dumps({"kernels": [{
        "name": "sdf_mlp", "route": "cuda",
        "source": "mvsdf_tpu_torch/tracing/kernels/csrc/sdf_mlp.cu",
        "replaces": "mvsdf_tpu/tracing/pallas/sdf_kernel.py:205",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / PEAK_F32 >= nbytes / HBM_BYTES_S
        else "bytes",
        "library_ms": library_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
