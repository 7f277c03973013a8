"""Training step: forward + loss + grad + clip + Adam (port of
``mvsdf_tpu/train/step.py``).

- Adam (betas 0.9/0.999, eps 1e-8) at lr = learning_rate * batch_size;
- MultiStepLR x0.1 at 4/6 and 5/6 of the epochs (``advance_epoch`` steps
  it once per epoch);
- global grad-norm clip with the scheduled cap (<= 0: no clipping);
- on a non-finite gradient the update runs with zero gradients
  (``skip_nonfinite_updates``), as the JAX package does;
- with ``train_cameras``, the batch's poses are the (B, 7) rows
  ``pose_vecs[indices]``; the loss is differentiated with respect to them
  too, and the touched rows take a SparseAdam step at the constant
  ``learning_rate_cam``. As in the JAX package, the clip and the
  non-finite skip apply to the field's gradients only, so a non-finite
  batch still moves the poses.

Data parallel (``parallel/``): each rank's batch holds its share of the
ray axis and its losses are its share of the global terms
(``supervision/losses``). The step sums the ranks' gradients (the pose
gradients too) and their metric terms in one all-reduce, before the clip,
so the clip, the non-finite skip and Adam see the global gradient and its
norm on every rank, take the same branch and keep the replicas equal.
After a step each parameter's ``.grad`` holds the gradient Adam applied.
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
from ..parallel import sum_, world_size
from ..rendering.renderer import render_forward
from ..supervision.losses import total_loss
from .cameras_opt import (SparseAdamState, init_sparse_adam,
                          pose_vecs_from_matrices, sparse_adam_step)

GT_KEYS = ("rgb", "depths", "depth_cams", "size", "center", "feat",
           "feat_src", "cam", "src_cams")


@dataclasses.dataclass
class TrainState:
    net: MVSDFNetwork
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    pose_vecs: Optional[torch.Tensor] = None    # (n_images, 7) with cameras
    cam_opt: Optional[SparseAdamState] = None

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


def init_train_state(cfg: MVSDFConfig, seed: int = 0, device=None,
                     pose_init: Optional[np.ndarray] = None) -> TrainState:
    """pose_init, (n_images, 4, 4) camera-to-world or (n_images, 7) rows,
    seeds the camera poses when cfg.train.train_cameras (required
    then)."""
    net = init_params(cfg, seed, device)
    opt = torch.optim.Adam(net.parameters(),
                           lr=cfg.train.learning_rate * cfg.train.batch_size,
                           betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones=milestones(cfg), gamma=cfg.train.sched_factor)
    state = TrainState(net, opt, sched)
    if cfg.train.train_cameras:
        if pose_init is None:
            raise ValueError("train_cameras requires pose_init")
        pv = np.asarray(pose_init, np.float32)
        if pv.ndim == 3:
            pv = pose_vecs_from_matrices(pv)
        state.pose_vecs = torch.from_numpy(pv).to(
            next(net.parameters()).device)
        state.cam_opt = init_sparse_adam(state.pose_vecs)
    return state


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
    the ground truth (GT_KEYS) as tensors on the model's device, and the
    images' ``indices`` with cameras; ``weights`` is
    ``cfg.schedule.weights(tp)``."""
    gates = cfg.schedule.gates_for_phase(phase_idx)
    sched = cfg.schedule
    cameras = cfg.train.train_cameras

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             weights: Weights, generator: Optional[torch.Generator] = None,
             noise: Optional[dict] = None):
        net = state.net
        params = list(net.parameters())
        inputs = batch
        if cameras:
            # the batch images' 7-d poses (ref idr_train.py:263)
            pose_vecs = state.pose_vecs.detach().requires_grad_(True)
            inputs = dict(batch, pose=pose_vecs[batch["indices"]])
            params.append(pose_vecs)
        out = render_forward(cfg.model, net, inputs, training=True,
                             gates=gates, generator=generator, noise=noise)
        lt = total_loss(out, {k: batch[k] for k in GT_KEYS}, gates, sched,
                        weights)
        grads = torch.autograd.grad(lt.loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        # this rank's share of each metric: the terms, and its hits over
        # the global ray count
        hits = out.network_object_mask.float()
        shares = torch.stack([t.detach() for t in lt] + [
            hits.sum() / (hits.numel() * world_size())])
        sum_(grads + [shares])
        if cameras:
            params.pop()
            pose_grads = grads.pop()
        grads, gnorm = _clip_by_global_norm(grads, weights.grad_cap)
        if cfg.train.skip_nonfinite_updates:
            finite = torch.isfinite(gnorm)
            grads = [torch.where(finite, g, torch.zeros_like(g))
                     for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        lr = state.optimizer.param_groups[0]["lr"]
        state.optimizer.step()
        if cameras:
            touched = torch.zeros(state.pose_vecs.shape[0], dtype=torch.bool,
                                  device=state.pose_vecs.device)
            touched[batch["indices"]] = True
            state.cam_opt, state.pose_vecs = sparse_adam_step(
                state.cam_opt, state.pose_vecs, pose_grads, touched,
                cfg.train.learning_rate_cam)
        metrics = dict(zip(lt._fields + ("hit_frac",), shares))
        metrics.update(grad_norm=gnorm.detach(), lr=torch.tensor(lr))
        return metrics

    return step
