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
``CapturableStep`` captures those all-reduces, and the losses' count
all-reduces, into each rank's graph: every rank captures its own step and
replays it, and the collectives of a replay meet those of the other
ranks' replays. None of them sits inside a conditional node, so every
rank's replay makes the same collectives in the same order whichever of
its tiers run.

Tracing (``CapturableStep(trace=True)``, which the trainer makes while its
``metrics.Tracer`` is on): the step enters its ``stamp.StepProbe``, which
stamps six points of every run into ``probe.buf`` (s0 the step's start, s1
and s2 around the frozen trace, s3 after the loss, s4 after the gradients,
s5 after the metrics write; with several ranks also ``probe.allreduce``,
after the gradient all-reduce) and counts the rows the trace's SDF
evaluations asked for and ran (``tracing/kernels/stamp``). A captured
graph holds those launches, so every replay stamps and counts. With
tracing off nothing of it is launched, and the captured graph is the one
an untraced step captures.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
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
from ..supervision.losses import LossTerms, total_loss
from ..tracing.kernels import counts, stamp
from ..tracing.sphere_trace import BOUNDED, GATHERED
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


def _gradients(cfg: MVSDFConfig, gates, state: TrainState,
               batch: Dict[str, torch.Tensor], weights: Weights, generator,
               noise, mode: str = GATHERED):
    """The step up to the optimizers: forward, loss, gradients, the
    all-reduce, the clip and the non-finite skip. Returns (loss term names,
    field parameters, their gradients, the pose gradients or None, the
    metric shares (terms + hit_frac), the global grad norm)."""
    net = state.net
    params = list(net.parameters())
    inputs = batch
    cameras = cfg.train.train_cameras
    if cameras:
        # the batch images' 7-d poses (ref idr_train.py:263)
        pose_vecs = state.pose_vecs.detach().requires_grad_(True)
        inputs = dict(batch, pose=pose_vecs[batch["indices"]])
        params.append(pose_vecs)
    out = render_forward(cfg.model, net, inputs, training=True, gates=gates,
                         generator=generator, noise=noise, mode=mode)
    lt = total_loss(out, {k: batch[k] for k in GT_KEYS}, gates,
                    cfg.schedule, weights)
    stamp.mark(3)
    grads = torch.autograd.grad(lt.loss, params, allow_unused=True)
    stamp.mark(4)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    # this rank's share of each metric: the terms, and its hits over the
    # global ray count
    hits = out.network_object_mask.float()
    shares = torch.stack([t.detach() for t in lt] + [
        hits.sum() / (hits.numel() * world_size())])
    sum_(grads + [shares])
    if world_size() > 1:
        stamp.mark_allreduce()
    pose_grads = None
    if cameras:
        params.pop()
        pose_grads = grads.pop()
    grads, gnorm = _clip_by_global_norm(grads, weights.grad_cap)
    if cfg.train.skip_nonfinite_updates:
        finite = torch.isfinite(gnorm)
        grads = [torch.where(finite, g, torch.zeros_like(g)) for g in grads]
    return lt._fields, params, grads, pose_grads, shares, gnorm


def make_train_step(cfg: MVSDFConfig, phase_idx: int):
    """Returns step(state, batch, weights, generator=None, noise=None) ->
    metrics (dict of 0-d tensors). ``batch`` holds the render inputs and
    the ground truth (GT_KEYS) as tensors on the model's device, and the
    images' ``indices`` with cameras; ``weights`` is
    ``cfg.schedule.weights(tp)``."""
    gates = cfg.schedule.gates_for_phase(phase_idx)
    cameras = cfg.train.train_cameras

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             weights: Weights, generator: Optional[torch.Generator] = None,
             noise: Optional[dict] = None):
        names, params, grads, pose_grads, shares, gnorm = _gradients(
            cfg, gates, state, batch, weights, generator, noise)
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
        metrics = dict(zip(names + ("hit_frac",), shares))
        metrics.update(grad_norm=gnorm.detach(), lr=torch.tensor(lr))
        return metrics

    return step


# --- the capturable step ---------------------------------------------------

# the capturable step's metrics, in its output's order
METRIC_KEYS = LossTerms._fields + ("hit_frac", "grad_norm", "lr")
ADAM_SCALARS = 3   # a plan row's -step size, sqrt(1 - beta2^t), lr


def adam_state(optimizer: torch.optim.Adam):
    """The (exp_avg, exp_avg_sq, step) of every parameter, made as
    ``torch.optim.Adam`` makes them at its first step where it has not
    taken one, so checkpoints and the per-epoch path read the same state."""
    out = []
    for p in optimizer.param_groups[0]["params"]:
        st = optimizer.state[p]
        if not st:
            st["step"] = torch.tensor(0.0, dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        out.append((st["exp_avg"], st["exp_avg_sq"], st["step"]))
    return out


def adam_scalars(optimizer: torch.optim.Adam, t: int) -> tuple:
    """The host scalars of Adam's t-th step at the group's current lr, in
    ``torch.optim.Adam``'s own double arithmetic: (-lr / (1 - beta1^t),
    sqrt(1 - beta2^t), lr). The capturable step reads them, as f32, from
    its plan row."""
    group = optimizer.param_groups[0]
    beta1, beta2 = group["betas"]
    lr = group["lr"]
    step = float(t)
    return (-(lr / (1 - beta1 ** step)), (1 - beta2 ** step) ** 0.5, lr)


def adam_update(params, grads, state, step_neg, bc2_sqrt, betas, eps):
    """One Adam step in place, ``torch.optim.Adam``'s update as its default
    implementation computes it on the params' device, with the step's
    scalars as 0-d f32 tensors on that device: ``step_neg`` = -lr / (1 -
    beta1^t) and ``bc2_sqrt`` = sqrt(1 - beta2^t). ``state`` holds each
    param's (exp_avg, exp_avg_sq, step). On the CPU that is the
    single-tensor loop, element for element (``param + (step_neg *
    exp_avg) / denom`` as ``addcdiv_`` orders it there); on the GPU the
    multi-tensor one (``_foreach_*``), whose final ``addcdiv_`` with a host
    scalar is ``param.addcmul_(exp_avg / denom, step_neg)``: the same
    single rounding. Both equal the optimizer's bits (a card check and
    ``tests/test_torch_fused_dispatch.py``)."""
    beta1, beta2 = betas
    ms = [m for m, _, _ in state]
    vs = [v for _, v, _ in state]
    if params[0].device.type == "cpu":
        for p, g, m, v in zip(params, grads, ms, vs):
            m.lerp_(g, 1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            denom = (v.sqrt() / bc2_sqrt).add_(eps)
            p.add_((step_neg * m) / denom)
        return
    torch._foreach_lerp_(ms, grads, 1 - beta1)
    torch._foreach_mul_(vs, beta2)
    torch._foreach_addcmul_(vs, grads, grads, 1 - beta2)
    denom = torch._foreach_sqrt(vs)
    torch._foreach_div_(denom, bc2_sqrt)
    torch._foreach_add_(denom, eps)
    for p, q in zip(params, torch._foreach_div(ms, denom)):
        p.addcmul_(q, step_neg)


class CapturableStep:
    """One training step of a phase in a form a CUDA graph captures: no
    host sync, no host value baked in, no allocation that outlives it.

    The step reads its inputs from one static int32 row, ``self.row``: the
    batch's B image indices, the P pixel ids, and the ADAM_SCALARS f32 bit
    patterns of ``adam_scalars``. It gathers the batch from the device
    scene cache itself, renders in the bounded formulation
    (``render_forward(mode=BOUNDED)``: the trace through the kernels'
    count entries, the supervised path and the shading through the
    supervised cascade's tiers, the later ones conditional nodes that
    autograd passes through), and updates the parameters,
    Adam's moments and, with cameras, the poses and their SparseAdam state
    in place. It writes the metrics (METRIC_KEYS) into ``self.metrics``.

    Adam is ``adam_update``: ``torch.optim.Adam``'s own update, to the bit
    on either device, with the two step-dependent scalars computed on the
    host in its double arithmetic and read from the plan row. So the
    step-count tensor stays on the host as the optimizer keeps it, and the
    fused and per-epoch paths stay interchangeable. (``capturable=True``
    would move those scalars onto the device in another arithmetic, and
    refuses CPU tensors.) The metric ``lr`` is the row's.

    On the CPU ``__call__`` runs the step eagerly: that is the graph's
    plain version. On the GPU ``capture()`` runs the step of the current
    row on a side stream (a real step, the warm-up), then captures the
    step without running it; ``__call__`` then replays it. The
    conditional nodes' bodies, forward and backward, allocate from the
    pool of the graph's ``ConditionalBodies``, which ``release()`` gives
    back with the graph. With several ranks the warm-up runs the step's
    all-reduces (every rank captures in step with the others), and the
    capture is thread-local (``capture_error_mode``), its bodies' too:
    torch's collective watchdog thread may query its events meanwhile.
    Kernel launch counts (``tracing/kernels/counts``) are taken at the
    capture and added once per replay. Capture after any restore: the
    graph holds the addresses of the state's tensors."""

    def __init__(self, cfg: MVSDFConfig, phase_idx: int, weights: Weights,
                 state: TrainState, cache, generator: torch.Generator,
                 trace: bool = False):
        """``weights`` are the phase's (``cfg.schedule.weights`` is constant
        within a phase): the graph holds them as constants. ``trace``: the
        step stamps its stages and counts its trace rows into
        ``self.probe.buf`` (module docstring)."""
        self.cfg = cfg
        self.gates = cfg.schedule.gates_for_phase(phase_idx)
        self.weights = weights
        self.state = state
        self.cache = cache
        self.generator = generator
        self.B, self.P = cfg.train.batch_size, cfg.train.num_pixels
        dev = cache.device
        self.device = dev
        self.row = torch.zeros(self.B + self.P + ADAM_SCALARS,
                               dtype=torch.int32, device=dev)
        self.metrics = torch.zeros(len(METRIC_KEYS), dtype=torch.float32,
                                   device=dev)
        self.adam = adam_state(state.optimizer)
        self.params = list(state.optimizer.param_groups[0]["params"])
        group = state.optimizer.param_groups[0]
        self.betas, self.eps = group["betas"], group["eps"]
        if group["weight_decay"] or group["amsgrad"] or group["maximize"]:
            raise ValueError("the capturable step is Adam without weight "
                             "decay, amsgrad or maximize")
        self.probe = stamp.StepProbe(dev) if trace else None
        self.graph = None
        self.bodies = None
        self.launches = {}
        self.capture_s = None
        self.graph_bytes = None

    def plan_row(self, indices: np.ndarray, sel: np.ndarray,
                 scalars) -> np.ndarray:
        """The int32 row ``self.row`` takes for one step."""
        adam = np.asarray(scalars, np.float32).view(np.int32)
        return np.concatenate([np.asarray(indices, np.int32),
                               np.asarray(sel, np.int32), adam])

    def eager(self):
        """The step from ``self.row``, run eagerly (no graph); inside the
        step's probe when it traces."""
        with self.probe or contextlib.nullcontext():
            self._eager()

    def _eager(self):
        B, P = self.B, self.P
        row = self.row
        indices = row[:B].long()
        sel = row[B:B + P].long()
        adam = row[B + P:].view(torch.float32)
        batch = self.cache.gather(indices, sel)
        _, params, grads, pose_grads, shares, gnorm = _gradients(
            self.cfg, self.gates, self.state, batch, self.weights,
            self.generator, None, mode=BOUNDED)
        with torch.no_grad():
            adam_update(params, grads, self.adam, adam[0], adam[1],
                        self.betas, self.eps)
            st = self.state
            if pose_grads is not None:
                touched = torch.zeros(st.pose_vecs.shape[0],
                                      dtype=torch.bool,
                                      device=st.pose_vecs.device
                                      ).index_fill_(0, indices, True)
                opt, pv = sparse_adam_step(st.cam_opt, st.pose_vecs,
                                           pose_grads, touched,
                                           self.cfg.train.learning_rate_cam)
                st.cam_opt.m.copy_(opt.m)
                st.cam_opt.v.copy_(opt.v)
                st.cam_opt.step.copy_(opt.step)
                st.pose_vecs.copy_(pv)
            self.metrics.copy_(torch.cat([shares, gnorm.reshape(1),
                                          adam[2:3]]))

    def written(self):
        """Every tensor the step writes: the parameters, Adam's moments,
        with cameras the poses and their SparseAdam state, the metrics."""
        out = self.params + [t for m, v, _ in self.adam for t in (m, v)]
        st = self.state
        if st.pose_vecs is not None:
            out += [st.pose_vecs, st.cam_opt.m, st.cam_opt.v,
                    st.cam_opt.step]
        return out + [self.metrics]

    def capture(self):
        """Run the step of the current row on a side stream (the warm-up: a
        real step), then capture the step into a CUDA graph with the
        generator registered, its bounded blocks' tiles and the
        supervised cascade's later tiers as conditional nodes
        (``graph_cond.ConditionalBodies``)."""
        from ..tracing.kernels.graph_cond import ConditionalBodies
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.eager()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = counts.snapshot()
        # torch.cuda.graph empties the allocator's cache as it starts; the
        # graph's pool is what the reserve grows by from there
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        mode = "thread_local" if world_size() > 1 else "global"
        self.bodies = ConditionalBodies(dev, mode)
        with torch.cuda.graph(graph, capture_error_mode=mode), self.bodies:
            self.eager()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved
        # the wrappers ran once at capture; those launches did not happen
        self.launches = counts.since(before)
        counts.add({k: -v for k, v in self.launches.items()})
        self.graph = graph

    def release(self):
        """Drop the graph and give its memory back."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
            self.bodies.release()

    def __call__(self):
        """One step from ``self.row``: a replay when captured, else eager."""
        if self.graph is None:
            self.eager()
            return
        self.graph.replay()
        counts.add(self.launches)
