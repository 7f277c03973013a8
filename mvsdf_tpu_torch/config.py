"""Typed configuration tree + phase schedule as data (port of
``mvsdf_tpu/config.py``).

Training progress tp = epoch / nepochs; phases A/B/C split at (1/6, 1/2);
depth-surface sample sources only in phase A; feature weight 0 -> 0.1 ->
0.01; near attenuation 1 -> 0.1 -> 0.01; grad cap 2 -> 2 -> 0.5 (enabled
from the end of phase A).

Fields that only steer XLA in the JAX package (``shard_map_trace``,
``supervised_remat``, ``pallas_block``, ``pallas_march_block``,
``pallas_interpret``, the capacity fractions) are accepted so configs
carry over, and change no result here. ``ImplicitConfig.fused_value_grad``
(JAX's hand-derived value + gradient backward) keeps JAX's schema and is
refused when set: the port's one path is autograd's. ``supervised_compact_frac`` sets
the tiers of the graph-replayed step's supervised cascade
(``compaction.bounded_cascade_call_into``), whose later tiers are always
recomputed in the backward: JAX's ``supervised_remat=True``, whose
gradients equal the stored forward's, so ``supervised_remat`` has no
effect here. ``TrainConfig.fused_dispatch`` and
``epochs_per_dispatch`` choose the trainer's path as in the JAX package
(``train/loop.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .fields.radiance import RenderConfig
from .fields.sdf import ImplicitConfig
from .tracing.sphere_trace import TracerConfig


@dataclasses.dataclass(frozen=True)
class Gates:
    """Per-phase gates: which sample groups feed the depth (d_use_*) and
    eikonal (eik_use_*) losses; detach_geometry_for_rgb freezes geometry
    into the radiance net during phase A."""
    d_use_rt_surf: bool = True
    d_use_eik: bool = True
    d_use_dsurf_on: bool = False
    d_use_dsurf_jitter: bool = False
    eik_use_rt_surf: bool = True
    eik_use_eik: bool = True
    eik_use_dsurf_on: bool = False
    eik_use_dsurf_jitter: bool = False
    detach_geometry_for_rgb: bool = False
    enable_feat: bool = True
    enable_surf: bool = True

    @property
    def use_dsurf(self) -> bool:
        return (self.d_use_dsurf_on or self.d_use_dsurf_jitter or
                self.eik_use_dsurf_on or self.eik_use_dsurf_jitter)


@dataclasses.dataclass(frozen=True)
class Weights:
    """Per-step loss weights."""
    rgb: float = 0.5
    eikonal: float = 0.1
    surf: float = 0.01
    feat: float = 0.0
    depth: float = 1.0
    far_att: float = 1.0
    near_att: float = 1.0
    grad_cap: float = 0.0  # <= 0 disables clipping


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Phase tables indexed A=0, B=1, C=2."""
    phase: Tuple[float, float] = (1.0 / 6.0, 1.0 / 2.0)
    rgb_weight: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    feat_weight: Tuple[float, float, float] = (0.0, 0.1, 0.01)
    depth_weight: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    eikonal_weight: float = 0.1
    surf_weight: float = 0.01
    far_thresh: float = 0.25
    far_att: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    near_thresh: float = 0.1
    near_att: Tuple[float, float, float] = (1.0, 0.1, 0.01)
    smooth: Tuple[Optional[float], Optional[float], Optional[float]] = (
        None, None, None)
    grad_cap: Tuple[float, float, float] = (2.0, 2.0, 0.5)
    enable_grad_cap: bool = True
    enable_feat: bool = True
    enable_rgb: bool = True
    use_dsurf_phase: Tuple[bool, bool, bool] = (True, False, False)
    use_invalid: bool = False  # carving_t vs carving_t2
    out_thresh_perc: float = 1.0 / 8.0
    feat_img_scale: int = 2

    def phase_index(self, tp: float) -> int:
        if tp < self.phase[0]:
            return 0
        if tp < self.phase[1]:
            return 1
        return 2

    def gates(self, tp: float) -> Gates:
        return self.gates_for_phase(self.phase_index(tp))

    def gates_for_phase(self, i: int) -> Gates:
        ds = self.use_dsurf_phase[i]
        return Gates(
            d_use_dsurf_on=ds, d_use_dsurf_jitter=ds,
            eik_use_dsurf_on=ds, eik_use_dsurf_jitter=ds,
            detach_geometry_for_rgb=(i == 0),
            enable_feat=(i > 0 and self.enable_feat),
            enable_surf=(i > 0),
        )

    def weights(self, tp: float) -> Weights:
        i = self.phase_index(tp)
        cap = self.grad_cap[i] if (
            self.enable_grad_cap and tp >= self.phase[0]) else 0.0
        return Weights(
            rgb=self.rgb_weight[i] if self.enable_rgb else 0.0,
            eikonal=self.eikonal_weight,
            surf=self.surf_weight,
            feat=self.feat_weight[i],
            depth=self.depth_weight[i],
            far_att=self.far_att[i],
            near_att=self.near_att[i],
            grad_cap=cap,
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    implicit: ImplicitConfig = ImplicitConfig()
    render: RenderConfig = RenderConfig()
    tracer: TracerConfig = TracerConfig()
    use_mask: bool = False
    disable_rgb_grad: bool = False
    # Clamp |grad . dir| in the implicit-diff division away from zero
    # (0 = reference-exact; parity tests pin 0.0).
    implicit_diff_min_dot: float = 1e-2
    shard_map_trace: bool = False      # no effect here
    # Trace through the fused SDF-MLP kernel (tracing/kernels/sdf_mlp.py);
    # on a CPU tensor the kernel's plain version runs instead.
    use_pallas_trace: bool = False
    # Read only with use_pallas_trace, as in the JAX package: the fused
    # march (march_kernel.py) and secant (secant_kernel.py) kernels, and
    # the SDF-MLP kernel computing the positional encoding itself.
    use_pallas_march: bool = False
    use_pallas_secant: bool = False
    pallas_block: int = 1024           # no effect here
    pallas_march_block: int = 512      # no effect here
    pallas_interpret: bool = False     # no effect here
    pallas_in_kernel_pe: bool = False
    # Supervised-path compaction: non-empty runs the rt_surf group and the
    # shading only on surface-hit lanes (exact; every consumer masks the
    # other lanes to zero): the per-epoch step gathers exactly those, the
    # graph-replayed step takes the tier of these fractions that fits them,
    # as JAX does. The fractions do not change results.
    supervised_compact_frac: Tuple[float, ...] = ()
    # the graph-replayed step always recomputes the later tiers in the
    # backward (JAX's remat, equal gradients): no effect here
    supervised_remat: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4     # scaled by batch size
    batch_size: int = 8
    num_pixels: int = 4096
    nepochs: int = 1800
    sched_milestones: Tuple[float, float] = (4.0 / 6.0, 5.0 / 6.0)
    sched_factor: float = 0.1
    plot_freq: float = 1.0 / 12.0
    seed: int = 0
    # Per-image camera poses trained with the field (train/cameras_opt.py),
    # stepped by SparseAdam at the constant learning_rate_cam.
    train_cameras: bool = False
    learning_rate_cam: float = 1e-4
    # Fused multi-epoch dispatch (one process): chunks of up to
    # epochs_per_dispatch epochs, each step a CUDA-graph replay of the
    # phase's captured step, metrics read one chunk behind; data-parallel
    # runs always take the per-epoch path (train/loop.py).
    fused_dispatch: bool = True
    epochs_per_dispatch: int = 16
    # Skip the update (zero gradients into Adam) on a non-finite gradient.
    skip_nonfinite_updates: bool = True


@dataclasses.dataclass(frozen=True)
class MVSDFConfig:
    model: ModelConfig = ModelConfig()
    schedule: Schedule = Schedule()
    train: TrainConfig = TrainConfig()
