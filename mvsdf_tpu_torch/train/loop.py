"""Per-scene training loop (port of ``mvsdf_tpu/train/loop.py``).

Behavioral parity target: ``code/training/idr_train.py`` (IDRTrainRunner):
shuffled drop-last batches of B images x P shared random pixels, epochs
``start_epoch..nepochs`` over three phases, checkpoints and mesh snapshots
every ``plot_freq`` epochs.

Execution model: the scene's tensors live on the device from the start
(``train/device_data.py``); each epoch the host draws the pixel subset and
then the image order from ``np.random.default_rng(seed)``, in the JAX
package's order, and each step gathers its batch on the device from the
batch's image indices and that subset. Per-step noise comes from one
``torch.Generator`` on the model's device, seeded from ``cfg.train.seed``;
its state is checkpointed with the host RNG's. The JAX package's fused
multi-epoch dispatch (``lax.scan``) has no counterpart: every epoch runs
the per-epoch path, so ``fused_dispatch`` and ``epochs_per_dispatch`` have
no effect. Metrics are read once per epoch (the last step's), so the loop
adds no host sync a step beyond the training step's own. With
``train_cameras`` the camera poses start from ``scene.pose_init`` and the
step trains them; mesh snapshots and the full render keep the
ground-truth poses (``scene.poses``), as the JAX package's do.

Data parallel (``parallel/``, one process a GPU): every rank loads the
scene, draws the same host plan and the same per-step noise, and trains
on its share of the rays; the step's all-reduce keeps the replicas equal.
Rank 0 alone logs and writes ``metrics.jsonl``, checkpoints (the others
wait at a barrier) and plots; the full render's view is drawn from the
host RNG on every rank, so the ranks' streams stay in step. Every rank
restores the same checkpoint.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import MVSDFConfig
from ..data.scene import SceneData
from ..device import resolve_device
from ..parallel import barrier, rank, validate_ray_divisibility
from . import checkpoints as ckpt
from .device_data import DeviceSceneCache
from .metrics import MetricsLogger, Throughput, annotate, profile_trace
from .step import advance_epoch, init_train_state, make_train_step, \
    milestones


class Trainer:
    def __init__(self, cfg: MVSDFConfig, scene: SceneData, exp_dir: str,
                 device=None, log_fn=print,
                 profile_dir: Optional[str] = None, profile_epochs: int = 0):
        if cfg.train.batch_size > scene.n_images:
            raise ValueError(
                f"batch_size {cfg.train.batch_size} > {scene.n_images} "
                "images: drop-last batching would run zero steps per epoch")
        validate_ray_divisibility(cfg.train.num_pixels)
        self.cfg = cfg
        self.scene = scene
        self.exp_dir = exp_dir
        self.main = rank() == 0
        self.ckpt_dir = os.path.join(exp_dir, "checkpoints")
        self.plots_dir = os.path.join(exp_dir, "plots")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.plots_dir, exist_ok=True)
        self.log = log_fn if self.main else (lambda *_: None)
        self.device = resolve_device(device)
        self.steps = {}        # phase_idx -> train step
        # the linear-method camera initialisation where the scene has one,
        # the ground-truth poses otherwise (ref idr_train.py:121-127)
        self.state = init_train_state(
            cfg, seed=cfg.train.seed, device=self.device,
            pose_init=scene.pose_init if cfg.train.train_cameras else None)
        self.rng = np.random.default_rng(cfg.train.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed)
        self.start_epoch = 0
        nepochs = cfg.train.nepochs
        self.plot_freq = max(1, int(cfg.train.plot_freq * nepochs))
        self.metrics_log = MetricsLogger(
            os.path.join(exp_dir, "metrics.jsonl"), echo=lambda *_: None)
        self.throughput = Throughput()
        self.profile_dir = profile_dir
        self.profile_epochs = profile_epochs
        # wall times of the loop's other work, for whoever drives it
        self.timings = {"save_ms": [], "restore_ms": [], "mesh_ms": [],
                        "render_s": []}
        self.last_render = None   # (epoch, image index, rgb (1, HW, 3))
        self.cache = DeviceSceneCache(scene, self.device)
        self.log(f"device scene cache: {self.cache.nbytes() / 1e6:.1f} MB "
                 f"resident on {self.device}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def maybe_resume(self, step=None):
        """step=None resumes the latest checkpoint; an int resumes that
        specific epoch (ref exp_runner.py --checkpoint)."""
        if step is None:
            step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return False
        t0 = time.perf_counter()
        epoch, rng_state = ckpt.restore_checkpoint(self.ckpt_dir, step,
                                                   self.state)
        if self.cfg.train.train_cameras and self.state.pose_vecs is None:
            raise ValueError(f"the checkpoint of epoch {epoch} holds no "
                             f"camera state: it was trained without "
                             f"--train_cameras")
        if rng_state is not None:
            if rng_state.get("np_rng") is not None:
                self.rng.bit_generator.state = rng_state["np_rng"]
            gen = rng_state.get("torch_generator")
            if gen is not None:
                if rng_state["torch_generator_device"] == self.device.type:
                    self.generator.set_state(torch.from_numpy(gen))
                else:
                    self.log(f"checkpoint's generator is a "
                             f"{rng_state['torch_generator_device']} one: "
                             f"the {self.device.type} generator keeps its "
                             f"seed")
        self._follow_schedule()
        self._sync()
        self.timings["restore_ms"].append((time.perf_counter() - t0) * 1e3)
        self.start_epoch = epoch + 1
        self.log(f"resumed from epoch {epoch}")
        return True

    def _follow_schedule(self):
        """A run resumed with another --nepoch moves the lr milestones as
        the JAX package's lr_for_epoch does."""
        sched = self.state.scheduler
        want = milestones(self.cfg)
        if sorted(sched.milestones.elements()) == sorted(want):
            return
        sched.milestones = collections.Counter(want)
        n = sum(sched.last_epoch >= m for m in want)
        for group, base in zip(self.state.optimizer.param_groups,
                               sched.base_lrs):
            group["lr"] = base * self.cfg.train.sched_factor ** n

    def _get_step(self, phase_idx: int):
        if phase_idx not in self.steps:
            self.steps[phase_idx] = make_train_step(self.cfg, phase_idx)
        return self.steps[phase_idx]

    def train_epoch(self, epoch: int):
        cfg = self.cfg
        tp = epoch / cfg.train.nepochs
        phase_idx = cfg.schedule.phase_index(tp)
        step = self._get_step(phase_idx)
        w = cfg.schedule.weights(tp)
        dev = self.device
        B = cfg.train.batch_size
        self.scene.change_sampling_idx(cfg.train.num_pixels, self.rng)
        sel = self.scene.sampling_idx
        if sel is None:
            sel = np.arange(self.scene.total_pixels)
        sel_d = torch.from_numpy(sel.astype(np.int64)).to(dev)
        order = self.rng.permutation(self.scene.n_images)

        t0 = time.perf_counter()
        t_first = None
        n_steps = 0
        metrics = None
        with annotate(f"epoch[{epoch}]"):
            for i in range(0, self.scene.n_images - B + 1, B):
                idx = torch.from_numpy(order[i:i + B].astype(np.int64))
                batch = self.cache.gather(idx.to(dev), sel_d)
                metrics = step(self.state, batch, w, self.generator)
                n_steps += 1
                if n_steps == 1:
                    t_first = time.perf_counter()
        advance_epoch(self.state)
        m = {k: float(v) for k, v in metrics.items()}   # the epoch's sync
        t1 = time.perf_counter()
        n_rays = n_steps * B * len(sel)
        self.throughput.add(n_rays)
        # the steps after the first (which pays for first calls)
        ms_step = ((t1 - t_first) / (n_steps - 1) if n_steps > 1
                   else t1 - t0) * 1e3
        self._log_epoch(epoch, n_rays / (t1 - t0), m, phase=phase_idx,
                        steps=n_steps, ms_per_step=ms_step)
        return m

    def _log_epoch(self, epoch, rays_per_s, m, **extra):
        cfg = self.cfg
        if self.main:
            self.metrics_log.log(epoch, rays_per_s=rays_per_s, **extra, **m)
        self.log(
            f"[{epoch}/{cfg.train.nepochs}] loss={m['loss']:.4f} "
            f"rgb={m['rgb_loss']:.4f} eik={m['eikonal_loss']:.4f} "
            f"depth={m['depth_loss']:.4f} feat={m['feat_loss']:.4f} "
            f"surf={m['surf_loss']:.4f} |g|={m['grad_norm']:.2f} "
            f"lr={m['lr']:.2e} hit={m['hit_frac']:.2f} "
            f"rays/s={rays_per_s:.0f}")

    def save(self, epoch: int):
        t0 = time.perf_counter()
        if self.main:
            ckpt.save_checkpoint(self.ckpt_dir, epoch, self.state, epoch,
                                 rng_state=self.rng.bit_generator.state,
                                 generator=self.generator)
        barrier()
        self.timings["save_ms"].append((time.perf_counter() - t0) * 1e3)

    def plot(self, epoch: int, resolution: int = 100, full: bool = False,
             chunk_pixels: int = 10000):
        """Periodic mesh snapshot (analog of plots.get_surface_trace,
        ref idr_train.py:246-247): the plain SDF field on a grid, its
        surface (the C++ triangulator) as an OBJ, a static scene snapshot
        PNG and an HTML scene; with full=True also renders one full view
        through the eval-mode renderer in fixed chunks of rays and writes
        it beside the ground truth (ref plot_epoch full). Rank 0 plots; the
        view is drawn on every rank."""
        from ..eval.html_viewer import write_scene_html
        from ..eval.marching import extract_mesh
        from ..eval.mesh import save_obj
        from ..eval.plots import plot_image_grid, plot_scene_snapshot
        from ..fields.sdf import sdf_apply
        from ..rendering.renderer import render_view

        idx = int(self.rng.integers(self.scene.n_images)) if full else None
        if not self.main:
            return
        net = self.state.net
        t0 = time.perf_counter()
        verts, faces = extract_mesh(lambda x: sdf_apply(net.implicit, x),
                                    resolution=resolution,
                                    device=self.device)
        if len(faces):
            save_obj(os.path.join(self.plots_dir, f"surface_{epoch}.obj"),
                     verts, faces)
            plot_scene_snapshot(
                os.path.join(self.plots_dir, f"scene_{epoch}.png"),
                verts, faces, poses=self.scene.poses)
            write_scene_html(
                os.path.join(self.plots_dir, f"scene_{epoch}.html"),
                verts, faces, poses=self.scene.poses,
                title=f"epoch {epoch}")
        self.timings["mesh_ms"].append((time.perf_counter() - t0) * 1e3)

        if full:
            t0 = time.perf_counter()
            c = self.cache
            rgb = render_view(self.cfg.model, net, c.uv,
                              c.intrinsics[idx:idx + 1],
                              c.poses[idx:idx + 1], c.masks[idx],
                              min(chunk_pixels, self.scene.total_pixels)
                              )[None]
            self.last_render = (epoch, idx, rgb)
            plot_image_grid(
                os.path.join(self.plots_dir, f"rendering_{epoch}.png"),
                rgb, self.scene.rgb[idx][None], self.scene.img_res)
            self.timings["render_s"].append(time.perf_counter() - t0)

    def run(self, resume: bool = True, resume_step=None):
        if resume:
            self.maybe_resume(resume_step)
        cfg = self.cfg
        self.throughput.reset()
        prof = profile_trace(self.profile_dir) if (
            self.profile_dir and self.profile_epochs > 0 and self.main) \
            else None
        prof_remaining = self.profile_epochs
        if prof is not None:
            prof.__enter__()
        try:
            for epoch in range(self.start_epoch, cfg.train.nepochs + 1):
                self.train_epoch(epoch)
                if prof is not None:
                    prof_remaining -= 1
                    if prof_remaining <= 0:
                        self._sync()
                        prof.__exit__(None, None, None)
                        prof = None
                if epoch % self.plot_freq == 0 and epoch != 0:
                    self.save(epoch)
                    try:
                        # full render every 4th plot (ref :324-328)
                        full = (epoch // self.plot_freq) % 4 == 0
                        self.plot(epoch, full=full)
                    except Exception as exc:  # never kill training
                        self.log(f"plot failed at epoch {epoch}: {exc}")
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        self.save(cfg.train.nepochs)
        rates = self.throughput.rates()
        self.log(f"training done: {rates['rays_per_s']:.0f} rays/s "
                 f"({rates['steps_per_s']:.2f} epochs/s overall)")
        return self.state
