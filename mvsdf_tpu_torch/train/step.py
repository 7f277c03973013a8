"""Training step: forward + loss + grad + clip + Adam (port of
``mvsdf_tpu/train/step.py``).

- Adam (betas 0.9/0.999, eps 1e-8) at lr = learning_rate * batch_size;
- MultiStepLR x0.1 at 4/6 and 5/6 of the epochs (``advance_epoch`` steps
  it once per epoch);
- global grad-norm clip with the scheduled cap (<= 0: no clipping);
- on a non-finite gradient the update runs with zero gradients
  (``skip_nonfinite_updates``), as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import MVSDFConfig, Weights
from ..device import resolve_device
from ..fields.network import MVSDFNetwork
from ..fields.radiance import init_render
from ..fields.sdf import init_implicit
from ..rendering.renderer import render_forward
from ..supervision.losses import total_loss

GT_KEYS = ("rgb", "depths", "depth_cams", "size", "center", "feat",
           "feat_src", "cam", "src_cams")


@dataclasses.dataclass
class TrainState:
    net: MVSDFNetwork
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.MultiStepLR

    @property
    def epoch(self) -> int:
        return self.scheduler.last_epoch


def init_params(cfg: MVSDFConfig, seed: int = 0,
                device=None) -> MVSDFNetwork:
    """The model's MLPs, drawn from ``np.random.default_rng(seed)`` in the
    JAX package's order: the same seed gives the same weights. Runs on
    ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    net = MVSDFNetwork(cfg.model.implicit, cfg.model.render)
    net.implicit = init_implicit(cfg.model.implicit, rng)
    net.render = init_render(cfg.model.render, rng)
    return net.to(dev)


def milestones(cfg: MVSDFConfig) -> List[int]:
    return [int(m * cfg.train.nepochs) for m in cfg.train.sched_milestones]


def init_train_state(cfg: MVSDFConfig, seed: int = 0,
                     device=None) -> TrainState:
    if cfg.train.train_cameras:
        raise NotImplementedError("camera optimisation is not ported yet")
    net = init_params(cfg, seed, device)
    opt = torch.optim.Adam(net.parameters(),
                           lr=cfg.train.learning_rate * cfg.train.batch_size,
                           betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones=milestones(cfg), gamma=cfg.train.sched_factor)
    return TrainState(net, opt, sched)


def advance_epoch(state: TrainState) -> None:
    """End of an epoch: the learning-rate schedule moves on."""
    state.scheduler.step()


def _clip_by_global_norm(grads, cap: float):
    """clip_grad_norm_ semantics with +1e-6 in the denominator; cap <= 0
    disables clipping. Returns (grads, global norm)."""
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    if cap <= 0:
        return grads, gnorm
    coef = torch.clamp_max(cap / (gnorm + 1e-6), 1.0)
    return [g * coef for g in grads], gnorm


def make_train_step(cfg: MVSDFConfig, phase_idx: int):
    """Returns step(state, batch, weights, generator=None, noise=None) ->
    metrics (dict of 0-d tensors). ``batch`` holds the render inputs and
    the ground truth (GT_KEYS) as tensors on the model's device; ``weights``
    is ``cfg.schedule.weights(tp)``."""
    gates = cfg.schedule.gates_for_phase(phase_idx)
    sched = cfg.schedule

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             weights: Weights, generator: Optional[torch.Generator] = None,
             noise: Optional[dict] = None):
        net = state.net
        out = render_forward(cfg.model, net, batch, training=True,
                             gates=gates, generator=generator, noise=noise)
        lt = total_loss(out, {k: batch[k] for k in GT_KEYS}, gates, sched,
                        weights)
        params = list(net.parameters())
        grads = torch.autograd.grad(lt.loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        grads, gnorm = _clip_by_global_norm(grads, weights.grad_cap)
        if cfg.train.skip_nonfinite_updates:
            finite = torch.isfinite(gnorm)
            grads = [torch.where(finite, g, torch.zeros_like(g))
                     for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        lr = state.optimizer.param_groups[0]["lr"]
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        metrics = {name: getattr(lt, name).detach() for name in lt._fields}
        metrics.update(grad_norm=gnorm.detach(),
                       lr=torch.tensor(lr),
                       hit_frac=out.network_object_mask.float().mean())
        return metrics

    return step
