"""Benchmark: training-step throughput (rays/s per GPU, forward + backward)
of the full-size model on one GPU (counterpart of the JAX package's
``bench.py``, same contract, switches and protocol; bench.py's
MVSDF_BENCH_FUSEDGRAD selects a JAX-only path and is not read here).

    python -m mvsdf_tpu_torch.bench

Prints ONE JSON line on stdout: {"metric": "train_rays_per_s_per_chip",
"value", "unit": "rays/s", "vs_baseline"}, where ``value`` is B x P rays
over the median of WINDOWS windows of WINDOW_ITERS phase-B steps (each
window ending in a device sync) after WARMUP steps, and ``vs_baseline`` is
value / V100_RAYS_S, the JAX package's estimate of the PyTorch reference
on a V100. The shape is B=8 images x P=4096 rays, the full-width model from
seed-0 weights, the synthetic ring scene of ``data/synthetic.make_scene``
(96x96 images, 48x48 depth maps, 32 feature channels), phase B at
``weights(0.3)``; every step makes the same random draws, as bench.py's
fixed key does. On stderr: each switch's state, the card's name and power
limit, the precision, the window times, the peak memory and each kernel's
launches a step.

Switches (environment, bench.py's defaults and meaning; ``bench_config``):
  MVSDF_BENCH_PALLAS=1         the no-grad trace through the sdf_mlp kernel
                               (0: the plain field)
  MVSDF_BENCH_MARCH=0          the fused march kernel (sphere_march)
  MVSDF_BENCH_INKPE=0          the positional encoding in the kernel
                               (sdf_mlp_xyz)
  MVSDF_BENCH_SECANT=0         the fused secant kernel (secant)
  MVSDF_BENCH_FILLSKIP=1       skip the training-mode miss fill
  MVSDF_BENCH_COMPACT=1        the fallback stage's compaction tiers
  MVSDF_BENCH_MARCH_COMPACT=1  the mid-march compaction schedule
  MVSDF_BENCH_SUPCOMPACT=1     the supervised path on surface hits only
  MVSDF_BENCH_BF16ACT=1        bf16 activation storage in the supervised MLP
  MVSDF_BENCH_PRECISION=default  f32 matmuls of the step: default and
                               tensorfloat32 = TF32, highest = full f32
The march and secant flags are read only with the trace kernels on, as in
JAX. Runs on the GPU and raises without one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Mapping, Optional

V100_RAYS_S = 1.0e4

# full-size model, reference training shape: batch 8 images x 4096 rays
N_IMAGES = 8
N_PIX = 4096
FEAT_CH = 32
IMG_HW, DEPTH_HW = 96, 48
# bench.py's protocol: warm-up past the first steps' larger active sets,
# then the median of several windows
WARMUP = 20
WINDOWS = 3
WINDOW_ITERS = 10
PHASE_B_TP = 0.3
# MVSDF_BENCH_PRECISION -> TF32 on for the step's f32 matmuls
PRECISIONS = {"default": True, "tensorfloat32": True, "highest": False}
# bench_phaseB_fused: the fused march, secant and in-kernel PE
FUSED_SWITCHES = {"MVSDF_BENCH_MARCH": "1", "MVSDF_BENCH_INKPE": "1",
                  "MVSDF_BENCH_SECANT": "1"}


def _quiet(msg: str) -> None:
    pass


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def precision(env: Optional[Mapping[str, str]] = None):
    """(MVSDF_BENCH_PRECISION, whether it means TF32); raises on a value
    that is none of PRECISIONS."""
    name = (env or {}).get("MVSDF_BENCH_PRECISION", "default")
    if name not in PRECISIONS:
        raise ValueError(f"MVSDF_BENCH_PRECISION={name!r} is none of "
                         f"{sorted(PRECISIONS)}")
    return name, PRECISIONS[name]


def bench_config(env: Optional[Mapping[str, str]] = None,
                 log: Callable[[str], None] = _quiet):
    """The configuration the MVSDF_BENCH_* switches in ``env`` build (none
    given: every default), as bench.py builds it; ``log`` gets each
    switch's state."""
    from .config import MVSDFConfig, TrainConfig
    env = env or {}
    on = lambda name, default: env.get(f"MVSDF_BENCH_{name}",
                                       default) == "1"
    rep = dataclasses.replace
    cfg = MVSDFConfig(train=TrainConfig(batch_size=N_IMAGES,
                                        num_pixels=N_PIX))
    model = cfg.model
    if on("PALLAS", "1"):
        march, inkpe, secant = (on("MARCH", "0"), on("INKPE", "0"),
                                on("SECANT", "0"))
        model = rep(model, use_pallas_trace=True, use_pallas_march=march,
                    pallas_in_kernel_pe=inkpe, use_pallas_secant=secant)
        log(f"trace kernels: on (fused march: {march}, in-kernel PE: "
            f"{inkpe}, fused secant: {secant})")
    else:
        log("trace kernels: off (the plain field)")
    if on("FILLSKIP", "1"):
        model = rep(model, tracer=rep(model.tracer, fill_misses=False))
        log("miss fill: skipped (dead compute in the train step)")
    if on("COMPACT", "1"):
        model = rep(model, tracer=rep(
            model.tracer, sampler_capacity_frac=0.25, fill_capacity_frac=0.5,
            fallback_capacity_frac=(0.0625, 0.09375, 0.375)))
        log("fallback compaction: on")
    if on("MARCH_COMPACT", "1"):
        model = rep(model, tracer=rep(
            model.tracer, march_compact_schedule=(
                (0, (0.375, 0.5)), (1, (0.1875, 0.25)),
                (5, (0.0625, 0.125, 0.25)))))
        log("march compaction: on")
    if on("SUPCOMPACT", "1"):
        model = rep(model, supervised_compact_frac=(0.375,))
        log("supervised compaction: on")
    if on("BF16ACT", "1"):
        model = rep(model, implicit=rep(model.implicit,
                                        bf16_activations=True))
        log("bf16 activations: on")
    return rep(cfg, model=model)


def fused_config():
    """bench_phaseB_fused: the defaults with MVSDF_BENCH_MARCH=1,
    MVSDF_BENCH_INKPE=1 and MVSDF_BENCH_SECANT=1."""
    return bench_config(FUSED_SWITCHES)


def bench_batch(cfg, device, img_hw: int = IMG_HW, depth_hw: int = DEPTH_HW,
                feat_ch: int = FEAT_CH) -> dict:
    """The bench scene's batch of ``cfg.train`` images x rays on
    ``device``."""
    from .data.synthetic import make_scene, scene_to_torch
    scene = make_scene(n_images=cfg.train.batch_size,
                       n_pix=cfg.train.num_pixels, feat_ch=feat_ch,
                       img_hw=img_hw, depth_hw=depth_hw)
    return scene_to_torch(scene, device)


def kernel_counts() -> Dict[str, int]:
    """Each trace kernel's launch count so far."""
    from .tracing.kernels.march_kernel import sphere_march
    from .tracing.kernels.sdf_mlp import sdf_mlp, sdf_mlp_xyz
    from .tracing.kernels.secant_kernel import secant
    return {f.__name__: f.launches
            for f in (sdf_mlp, sdf_mlp_xyz, secant, sphere_march)}


def run_bench(cfg, batch, device, warmup: int = WARMUP,
              windows: int = WINDOWS, window_iters: int = WINDOW_ITERS,
              log: Callable[[str], None] = _stderr, out=None) -> dict:
    """Times phase-B steps of ``cfg`` on ``batch`` from the seed-0 weights:
    ``warmup`` steps, then ``windows`` windows of ``window_iters`` steps,
    each ending in a device sync. Prints the JSON line to ``out``
    (stdout) and returns it with ``window_s`` (seconds a step, each
    window), ``launches_per_step`` and ``peak_gib`` (None off the GPU)
    beside it."""
    import numpy as np
    import torch
    from .train.step import init_train_state, make_train_step
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    state = init_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, phase_idx=1)
    weights = cfg.schedule.weights(PHASE_B_TP)
    gen = torch.Generator(device=device)

    def one():
        gen.manual_seed(0)
        return step(state, batch, weights, gen)

    t0 = time.perf_counter()
    for _ in range(warmup):
        one()
    sync()
    log(f"step warm-up ({warmup} steps): {time.perf_counter() - t0:.1f}s")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = kernel_counts()
    window_s = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(window_iters):
            metrics = one()
        sync()
        window_s.append((time.perf_counter() - t0) / window_iters)
    n = windows * window_iters
    launches = {k: (v - before[k]) / n for k, v in kernel_counts().items()}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda \
        else None
    dt = float(np.median(window_s))
    log(f"window ms: {[round(d * 1e3, 1) for d in window_s]}")
    log(f"last step: loss {float(metrics['loss']):.6f}, hit "
        f"{float(metrics['hit_frac']):.4f}; peak memory "
        + (f"{peak:.2f} GiB" if cuda else "not measured (CPU)"))
    log(f"kernel launches a step: {launches}")
    B, P = batch["uv"].shape[:2]
    rays_s = B * P / dt
    line = {"metric": "train_rays_per_s_per_chip",
            "value": round(rays_s, 1), "unit": "rays/s",
            "vs_baseline": round(rays_s / V100_RAYS_S, 3)}
    print(json.dumps(line), file=out or sys.stdout, flush=True)
    return dict(line, window_s=window_s, launches_per_step=launches,
                peak_gib=peak)


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return res.stdout.strip() or f"nvidia-smi failed: {res.stderr.strip()}"


def main() -> int:
    import torch
    from .device import resolve_device
    env = os.environ
    name, tf32 = precision(env)
    device = resolve_device()
    _stderr(f"card: {card()}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    _stderr(f"precision: {name} (TF32 {'on' if tf32 else 'off'} in the "
            f"step's f32 matmuls)")
    cfg = bench_config(env, _stderr)
    batch = bench_batch(cfg, device)
    run_bench(cfg, batch, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
