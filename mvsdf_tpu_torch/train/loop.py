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
its state is checkpointed with the host RNG's. With ``train_cameras`` the
camera poses start from ``scene.pose_init`` and the step trains them; mesh
snapshots and the full render keep the ground-truth poses
(``scene.poses``), as the JAX package's do.

Two paths, as in the JAX package:
- the fused multi-epoch dispatch (``cfg.train.fused_dispatch``, the
  default, with one process or several, as the JAX package fuses on a
  one-host mesh; ``fuses``): the counterpart of the JAX package's
  ``lax.scan`` over a chunk of up to ``epochs_per_dispatch`` epochs. Each
  phase gets one ``step.CapturableStep``, captured into a CUDA graph at
  its first chunk (after any resume) and replayed step after step. The
  host RNG's draws of a chunk (each epoch's pixel subset, then its image
  order, in the per-epoch path's stream order) are made one chunk ahead
  on the trainer's one worker thread (``_draw_ahead``): once a chunk is
  planned, and before its replays are queued, the worker draws the
  epochs the next chunk can take, up to the first save epoch (its
  checkpoint holds the RNG's state after it, and its plot draws from the
  RNG next), while the main thread dispatches. A chunk's host plan (those
  draws, taken in epoch order and made in place where none were drawn
  ahead, and Adam's scalars) is uploaded in one copy; before each replay
  the step's row is copied into the graph's static input on the device.
  No replay waits on the host. Every other user of the RNG (``save``,
  ``plot``, ``train_epoch``, ``maybe_resume``) first waits for the
  worker, and a resume drops what it drew. Each replay's metrics go into
  the chunk's buffer, read one
  chunk behind (after the next chunk is queued); each epoch logs its last
  step, and ``rays_per_s`` and ``ms_per_step`` are the chunk's. A phase's
  graph is dropped when the next phase's is made. A chunk
  closes at save epochs, phase changes, the ``profile_epochs`` cut and
  ``epochs_per_dispatch``; checkpoints, snapshots and full renders run
  between chunks. A torch graph holds one step, so a short chunk replays
  fewer times (JAX pads its scan to a fixed length instead). On the CPU
  the same chunk path runs the same step eagerly.
- the per-epoch path (``train_epoch``), for ``--no_fused``: the host
  drives every step, and metrics are read once an epoch (the last
  step's).
The two paths take the same batches and draws, and their checkpoints are
interchangeable. Both time their steps on one clock (``_StepClock``: CUDA
events on a GPU, the host clock on the CPU): ``ms_per_step`` leaves out
an epoch's first step (per-epoch) or the phase's capture (fused), and
``rays_per_s`` is a step's rays over it.

Tracing (``Trainer(trace=True)``, ``trace_dir=``, the CLI's
``--trace_dir``; ``set_tracing`` switches it): ``self.tracer``
(``metrics.Tracer``) keeps the host spans ``plan_chunk``, ``plan_wait``
(the plan's wait for the worker's draws), ``dispatch``, ``epoch[e]``,
``capture``, ``replay`` (the graph's launch, which blocks on a full
launch queue), ``flush_wait`` (the wait for a chunk's metrics), ``save``
and ``plot``, each tagged with its chunk's first epoch, the worker's
``draw_ahead`` (tagged with the chunk it ran beside) and each plan's
epochs drawn ahead (``Tracer.add_plan``); the
phase's step is captured again with its stage stamps and row counters
(``step.CapturableStep(trace=True)``), and each step's row of them is
copied beside its metrics and read one chunk behind with them, with no
sync of its own, with the chunk's all-reduces and their bytes
(``parallel/sharding``'s counters). ``run`` writes them to
``trace_dir/spans.json``, and with several ranks each other rank r to
``trace_dir/spans.rank<r>.json``. With tracing off the spans are profiler
annotations only and the captured graph is the untraced one.

Data parallel (``parallel/``, one process a GPU): every rank loads the
scene, draws the same host plan and the same per-step noise, and trains
on its share of the rays; the step's all-reduce keeps the replicas equal.
On the fused path each rank captures and replays its own step, with the
all-reduces inside its graph (``step.CapturableStep``).
Rank 0 alone logs and writes ``metrics.jsonl``, checkpoints (the others
wait at a barrier) and plots; the full render's view is drawn from the
host RNG on every rank, so the ranks' streams stay in step. Every rank
restores the same checkpoint.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import MVSDFConfig
from ..data.scene import SceneData
from ..device import resolve_device
from ..parallel import barrier, rank, validate_ray_divisibility, world_size
from ..tracing.kernels import counts
from ..tracing.kernels.stamp import SLOTS
from . import checkpoints as ckpt
from .device_data import DeviceSceneCache
from .metrics import MetricsLogger, Throughput, Tracer, profile_trace
from .step import (METRIC_KEYS, CapturableStep, adam_scalars, advance_epoch,
                   init_train_state, make_train_step, milestones)


class _StepClock:
    """Two marks and the milliseconds between them: CUDA events (the
    device's timeline, read after a later sync) on a GPU, the host clock on
    the CPU. Both training paths time their steps with it."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> float:
        """From the first mark to the last (0 with fewer than two)."""
        if len(self.marks) < 2:
            return 0.0
        a, b = self.marks[0], self.marks[-1]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t``, queued behind what is queued."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def fuses(cfg: MVSDFConfig, device=None) -> bool:
    """Whether ``Trainer.run`` takes the fused chunk path: where
    ``cfg.train.fused_dispatch`` asks for it, with one process or a
    process group alike (the JAX package fuses on a one-host mesh); not on
    a GPU ``device`` whose group is not NCCL's (gloo's collectives run on
    the host, and a CUDA graph cannot capture them)."""
    on_gpu = device is not None and torch.device(device).type == "cuda"
    return cfg.train.fused_dispatch and not (
        on_gpu and world_size() > 1 and dist.get_backend() != "nccl")


def spans_file() -> str:
    """This rank's file of ``Tracer.write`` under the trace directory:
    ``spans.json`` on rank 0, ``spans.rank<r>.json`` on rank r."""
    r = rank()
    return "spans.json" if r == 0 else f"spans.rank{r}.json"


def _draw_epochs(scene: SceneData, rng: np.random.Generator,
                 num_pixels: int, epochs):
    """Each of ``epochs``' host draws, in the per-epoch path's stream
    order: the pixel subset (None: every pixel), then the image order. Runs
    on the trainer's worker thread or in place; returns the (epoch,
    subset, order) triples and the ``perf_counter_ns`` pair it ran
    between."""
    t0 = time.perf_counter_ns()
    draws = [(e, scene.draw_sampling_idx(num_pixels, rng),
              rng.permutation(scene.n_images)) for e in epochs]
    return draws, (t0, time.perf_counter_ns())


class Trainer:
    def __init__(self, cfg: MVSDFConfig, scene: SceneData, exp_dir: str,
                 device=None, log_fn=print,
                 profile_dir: Optional[str] = None, profile_epochs: int = 0,
                 trace: bool = False, trace_dir: Optional[str] = None):
        """``trace`` (or a ``trace_dir``) turns tracing on (module
        docstring); ``run`` writes ``trace_dir/spans.json`` at its end."""
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
        self.fused_steps = {}  # phase_idx -> CapturableStep (this phase's)
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
        self.tracer = Tracer()
        self.trace_dir = trace_dir
        # wall times of the loop's other work, for whoever drives it
        self.timings = {"save_ms": [], "restore_ms": [], "mesh_ms": [],
                        "render_s": [], "capture_s": {}, "graph_bytes": {}}
        # the fused path's chunk whose metrics are not read yet
        self._pending = None
        # the host RNG's draws made ahead of their plan (module docstring):
        # the worker's job (its future and the chunk it was started in),
        # and the (epoch, subset, order) triples it drew, in stream order
        self._draw_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="draw_ahead")
        self._ahead = None
        self._drawn = collections.deque()
        self.last_render = None   # (epoch, image index, rgb (1, HW, 3))
        self.cache = DeviceSceneCache(scene, self.device)
        self.log(f"device scene cache: {self.cache.nbytes() / 1e6:.1f} MB "
                 f"resident on {self.device}")
        self.set_tracing(trace or bool(trace_dir))

    def set_tracing(self, on: bool) -> None:
        """Tracing on or off. The phase's graph is released, so the next
        chunk captures the step with its stamps and counters, or without;
        turning it on on a GPU maps the device's clock onto the host's
        (``Tracer.calibrate``)."""
        if on == self.tracer.on:
            return
        self.tracer.on = on
        self._release_fused_steps()
        if on:
            self.tracer.calibrate(self.device)

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
        # the checkpoint's RNG state replaces what was drawn ahead from it
        self._join_draws()
        self._drawn.clear()
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
        # graphs hold the replaced state tensors' addresses
        self._release_fused_steps()
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
        ((_, sel, order),), _ = self._take_draws(epoch, epoch)
        if sel is None:
            sel = np.arange(self.scene.total_pixels)
        sel_d = torch.from_numpy(sel.astype(np.int64)).to(dev)

        # ms_per_step: the steps after the first (which pays for first
        # calls), on the device's clock (CUDA events) as the fused path's,
        # on the host's on the CPU
        clock = _StepClock(dev)
        n_steps = 0
        metrics = None
        with self.tracer.span(f"epoch[{epoch}]"):
            for i in range(0, self.scene.n_images - B + 1, B):
                idx = torch.from_numpy(order[i:i + B].astype(np.int64))
                batch = self.cache.gather(idx.to(dev), sel_d)
                metrics = step(self.state, batch, w, self.generator)
                n_steps += 1
                if n_steps == 1:
                    clock.mark()
        clock.mark()
        advance_epoch(self.state)
        m = {k: float(v) for k, v in metrics.items()}   # the epoch's sync
        n_rays = n_steps * B * len(sel)
        self.throughput.add(n_rays)
        ms_step = max(clock.ms() / max(n_steps - 1, 1), 1e-6)
        self._log_epoch(epoch, B * len(sel) / ms_step * 1e3, m,
                        phase=phase_idx, steps=n_steps, ms_per_step=ms_step)
        return m

    # ------------------------------------------------------------------
    # The fused multi-epoch dispatch (module docstring).
    def _chunk_end(self, e0: int) -> int:
        """Last epoch of the chunk starting at e0: it stops at a save
        epoch (a checkpoint holds the state just after it), before a phase
        change, at nepochs and at the dispatch cap."""
        cfg = self.cfg
        nepochs = cfg.train.nepochs
        phase0 = cfg.schedule.phase_index(e0 / nepochs)
        e = e0
        cap = e0 + self._dispatch_epochs() - 1
        while e < min(cap, nepochs):
            if self._is_save_epoch(e):
                break
            nxt = e + 1
            if cfg.schedule.phase_index(nxt / nepochs) != phase0:
                break
            e = nxt
        return e

    def _dispatch_epochs(self) -> int:
        """The most epochs a chunk runs: epochs_per_dispatch, and never
        more than plot_freq + 1 (the longest chunk a save epoch allows)."""
        return max(1, min(self.cfg.train.epochs_per_dispatch,
                          self.plot_freq + 1))

    def _is_save_epoch(self, e: int) -> bool:
        """A checkpoint and a plot follow epoch e."""
        return e % self.plot_freq == 0 and e != 0

    def _draw_ahead(self, e1: int) -> None:
        """Start the worker on the draws the chunk after e1 can take (module
        docstring): the epochs after those drawn, to e1 +
        ``_dispatch_epochs()`` and nepochs, ending at the first save epoch
        from e1 on; none where e1 is one."""
        self._join_draws()
        last = min(e1 + self._dispatch_epochs(), self.cfg.train.nepochs)
        last = next((e for e in range(e1, last) if self._is_save_epoch(e)),
                    last)
        first = self._drawn[-1][0] + 1 if self._drawn else e1 + 1
        if first <= last:
            self._ahead = (self._draw_pool.submit(
                _draw_epochs, self.scene, self.rng, self.cfg.train.num_pixels,
                range(first, last + 1)), self.tracer.chunk)

    def _join_draws(self) -> int:
        """Wait for the worker's job, if one was started, and queue its
        draws (its ``draw_ahead`` span kept); returns how many of them were
        not drawn yet when asked (the wait inside ``plan_wait``)."""
        if self._ahead is None:
            return 0
        future, chunk = self._ahead
        self._ahead = None
        late = not future.done()
        with self.tracer.span("plan_wait") if late else \
                contextlib.nullcontext():
            draws, (a, b) = future.result()
        self.tracer.add_span("draw_ahead", a, b, chunk, e0=draws[0][0],
                             e1=draws[-1][0])
        self._drawn.extend(draws)
        return len(draws) if late else 0

    def _take_draws(self, e0: int, e1: int):
        """Epochs [e0, e1]'s (epoch, subset, order) triples: those drawn
        ahead, which must start at e0, then the rest drawn in place; the
        scene's ``sampling_idx`` is left at the last subset. Returns them
        and how many were drawn before they were asked for."""
        late = self._join_draws()
        queued = len(self._drawn)
        if queued and self._drawn[0][0] != e0:
            raise ValueError(
                f"epochs {e0}-{e1} asked for, but the host RNG's next draws "
                f"are epoch {self._drawn[0][0]}'s")
        draws = [self._drawn.popleft()
                 for _ in range(min(queued, e1 + 1 - e0))]
        ready = min(len(draws), queued - late)
        draws += _draw_epochs(self.scene, self.rng, self.cfg.train.num_pixels,
                              range(e0 + len(draws), e1 + 1))[0]
        self.scene.sampling_idx = draws[-1][1]
        return draws, ready

    def _settle_draws(self, what: str) -> None:
        """Before ``what`` reads or draws from the host RNG: the worker's
        job joined, and nothing drawn ahead of it."""
        self._join_draws()
        if self._drawn:
            raise ValueError(
                f"{what}: epochs {self._drawn[0][0]}-{self._drawn[-1][0]} "
                f"were drawn ahead from the host RNG")

    def _release_fused_steps(self):
        for step in self.fused_steps.values():
            step.release()
        self.fused_steps.clear()

    def _get_fused_step(self, phase_idx: int, weights) -> CapturableStep:
        step = self.fused_steps.get(phase_idx)
        if step is None:
            # phases never come back: the earlier phases' graphs, and the
            # pools they hold, go before this one is captured
            self._release_fused_steps()
            step = CapturableStep(self.cfg, phase_idx, weights, self.state,
                                  self.cache, self.generator,
                                  trace=self.tracer.on)
            self.fused_steps[phase_idx] = step
        elif step.weights != weights:
            raise ValueError(f"phase {phase_idx}'s weights changed within "
                             f"the phase: {step.weights} != {weights}")
        return step

    def _plan_chunk(self, e0: int, e1: int, step: CapturableStep):
        """The host plan of epochs [e0, e1] as (K, row) int32: their draws
        in the per-epoch path's stream order (``_take_draws``: those the
        worker drew ahead, which must start at e0, then the rest in place);
        the schedule and Adam's step count move on as the steps will."""
        cfg = self.cfg
        B = cfg.train.batch_size
        opt = self.state.optimizer
        draws, ready = self._take_draws(e0, e1)
        self.tracer.add_plan(ready, len(draws))
        rows, epochs = [], []
        for epoch, sel, order in draws:
            if sel is None:
                sel = np.arange(self.scene.total_pixels)
            for i in range(0, self.scene.n_images - B + 1, B):
                t = int(step.adam[0][2]) + 1
                for _, _, st in step.adam:
                    st += 1
                rows.append(step.plan_row(order[i:i + B], sel,
                                          adam_scalars(opt, t)))
                epochs.append(epoch)
            with warnings.catch_warnings():
                # this path steps Adam itself, never optimizer.step()
                warnings.filterwarnings("ignore", "Detected call of")
                advance_epoch(self.state)
        return np.stack(rows), epochs, len(sel)

    def _train_chunk(self, e0: int, e1: int):
        """Epochs [e0, e1] as replays of the phase's captured step (eager
        steps on the CPU), with no host sync; the previous chunk's metrics
        are read once this one is queued."""
        cfg = self.cfg
        nepochs = cfg.train.nepochs
        phase_idx = cfg.schedule.phase_index(e0 / nepochs)
        weights = cfg.schedule.weights(e0 / nepochs)
        for e in range(e0 + 1, e1 + 1):
            if cfg.schedule.weights(e / nepochs) != weights:
                raise ValueError(f"the weights of epochs {e0} and {e} differ "
                                 f"within one chunk")
        step = self._get_fused_step(phase_idx, weights)
        span = self.tracer.span
        with self.tracer.in_chunk(e0):
            with span("plan_chunk", e0=e0, e1=e1):
                plan, epochs, n_sel = self._plan_chunk(e0, e1, step)
            self._draw_ahead(e1)
            with span("dispatch", e0=e0, e1=e1):
                chunk = self._dispatch(step, plan, epochs)
            if chunk["capture_s"] is not None:
                self.timings["capture_s"][phase_idx] = chunk["capture_s"]
                self.timings["graph_bytes"][phase_idx] = step.graph_bytes
                self.log(f"phase {phase_idx}: step captured in "
                         f"{chunk['capture_s']:.2f} s, graph pool "
                         f"{step.graph_bytes / 2 ** 20:.1f} MiB")
            chunk.update(phase=phase_idx,
                         rays=cfg.train.batch_size * n_sel)
            self._flush_metrics()
        self._pending = chunk

    def _dispatch(self, step: CapturableStep, plan_np: np.ndarray, epochs):
        """Upload the plan (K, row) in one copy and run its K steps: each
        step's row copied into ``step.row`` on the device, then a replay
        (the phase's first step: the warm-up and the capture), its metrics
        copied into row k of the chunk's buffer, and that buffer copied to
        pinned host memory behind them. Nothing here waits on the device
        once the step is captured. Returns the chunk's record for
        ``_flush_metrics``: its epochs, metrics buffer, the event after its
        copy, a ``_StepClock`` marked around its replays (its eager steps on
        the CPU), the host seconds of this call, the capture's seconds (or
        None) and the pinned plan, which must live until its copy has
        run. A tracing step's stamp and counter row is copied into row k
        of a second buffer (``stamps``) behind its metrics, and read with
        them (with several ranks its stamp after the gradient all-reduce
        too, into ``allreduce``); ``replay`` says which steps were replays
        (or eager steps on the CPU) and which the capture's warm-up;
        ``collectives`` the chunk's all-reduces and their bytes; ``act``
        its replays' launches of the activation kernel
        (``counts.ACT_KERNEL``), ``act_bf16`` of its bf16 entries
        (``counts.ACT_KERNEL_BF16``); ``projected`` the rows their camera
        projections contracted (``projected_rows``), ``bf16_rows`` those
        the SDF network's bf16 products contracted (``bf16_gemm_rows``)."""
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        span = self.tracer.span
        plan = torch.from_numpy(plan_np)
        if cuda:
            plan = plan.pin_memory()
        plan_d = plan.to(self.device, non_blocking=True)
        out = torch.empty((len(epochs), len(METRIC_KEYS)),
                          dtype=torch.float32, device=self.device)
        stamps = None if step.probe is None else torch.empty(
            (len(epochs), SLOTS), dtype=torch.int64, device=self.device)
        allreduce = None if stamps is None or world_size() == 1 else \
            torch.empty(len(epochs), dtype=torch.int64, device=self.device)
        chunk = {"epochs": epochs, "plan": plan, "capture_s": None,
                 "replays": 0, "done": None, "clock": _StepClock(self.device),
                 "replay": [True] * len(epochs), "collectives": None,
                 "act": None, "projected": None, "act_bf16": None,
                 "bf16_rows": None}
        launched = None if stamps is None else counts.snapshot()
        replays_from = launched   # the activation's and projections' counts
        with contextlib.ExitStack() as spans:
            for k in range(len(epochs)):
                if k == 0 or epochs[k] != epochs[k - 1]:
                    spans.close()
                    spans.enter_context(span(f"epoch[{epochs[k]}]"))
                step.row.copy_(plan_d[k])
                if step.graph is None and cuda:
                    with span("capture"):
                        step.capture()   # step k is the warm-up
                    chunk["capture_s"] = step.capture_s
                    chunk["replay"][k] = False
                    if launched is not None:
                        replays_from = counts.snapshot()
                else:
                    if chunk["replays"] == 0:
                        chunk["clock"].mark()
                    with span("replay", k=k):
                        step()
                    chunk["replays"] += 1
                out[k].copy_(step.metrics)
                if stamps is not None:
                    stamps[k].copy_(step.probe.buf)
                if allreduce is not None:
                    allreduce[k:k + 1].copy_(step.probe.allreduce)
        if chunk["replays"]:
            chunk["clock"].mark()
        if launched is not None:
            n = counts.since(launched)
            chunk["collectives"] = (n["allreduce"], n["allreduce_bytes"])
            n = counts.since(replays_from)
            chunk["act"] = sum(n[k] for k in counts.ACT_KERNEL)
            chunk["projected"] = n["projected_rows"]
            chunk["act_bf16"] = sum(n[k] for k in counts.ACT_KERNEL_BF16)
            chunk["bf16_rows"] = n["bf16_gemm_rows"]
        if cuda:
            out = _to_pinned(out)
            stamps = None if stamps is None else _to_pinned(stamps)
            allreduce = None if allreduce is None else _to_pinned(allreduce)
            chunk["done"] = torch.cuda.Event()
            chunk["done"].record()
        chunk["out"], chunk["stamps"] = out, stamps
        chunk["allreduce"] = allreduce
        chunk["host_s"] = time.perf_counter() - t0
        return chunk

    def _flush_metrics(self):
        """Read and log the pending chunk's metrics. The read waits on the
        chunk's own event, not on the work queued after it, so the device
        stays busy with the next chunk. ``ms_per_step`` is the time of the
        chunk's replays over their count, on the clock ``train_epoch``
        reads (``_StepClock``); for a chunk with none (a phase's first
        chunk of one step: the warm-up), the host time of its dispatch less
        the capture's. ``rays_per_s`` is a step's rays over it, as in
        ``train_epoch``."""
        chunk, self._pending = self._pending, None
        if chunk is None:
            return
        if chunk["done"] is not None:
            with self.tracer.span("flush_wait", of=chunk["epochs"][0]):
                chunk["done"].synchronize()
        m_np = chunk["out"].numpy()
        epochs = chunk["epochs"]
        if chunk["replays"]:
            ms_step = chunk["clock"].ms() / chunk["replays"]
        else:
            ms_step = (chunk["host_s"] - (chunk["capture_s"] or 0.0)) / \
                len(epochs) * 1e3
        if chunk["stamps"] is not None:
            self.tracer.add_chunk(epochs[0], chunk["stamps"].numpy(),
                                  chunk["replay"], ms_step *
                                  chunk["replays"], chunk["replays"],
                                  collectives=chunk["collectives"],
                                  act=chunk["act"],
                                  projected=chunk["projected"],
                                  act_bf16=chunk["act_bf16"],
                                  bf16_rows=chunk["bf16_rows"],
                                  allreduce=None if chunk["allreduce"] is None
                                  else chunk["allreduce"].numpy())
        ms_step = max(ms_step, 1e-6)
        self.throughput.add(chunk["rays"] * len(epochs))
        steps = epochs.count(epochs[0])
        for epoch in sorted(set(epochs)):
            last = max(k for k, e in enumerate(epochs) if e == epoch)
            m = {k: float(v) for k, v in zip(METRIC_KEYS, m_np[last])}
            self._log_epoch(epoch, chunk["rays"] / ms_step * 1e3, m,
                            phase=chunk["phase"], steps=steps,
                            ms_per_step=ms_step)

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
        self._settle_draws(f"the checkpoint of epoch {epoch}")
        t0 = time.perf_counter()
        with self.tracer.span("save", epoch=epoch):
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

        if full:
            self._settle_draws(f"the full render of epoch {epoch}")
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
        fused = fuses(cfg, self.device)
        if prof is not None:
            prof.__enter__()
        try:
            epoch = self.start_epoch
            while epoch <= cfg.train.nepochs:
                if fused:
                    e1 = self._chunk_end(epoch)
                    if prof is not None:
                        e1 = min(e1, epoch + prof_remaining - 1)
                    self._train_chunk(epoch, e1)
                else:
                    e1 = epoch
                    self.train_epoch(epoch)
                if prof is not None:
                    prof_remaining -= e1 + 1 - epoch
                    if prof_remaining <= 0:
                        self._flush_metrics()
                        self._sync()
                        prof.__exit__(None, None, None)
                        prof = None
                for e in range(epoch, e1 + 1):
                    if self._is_save_epoch(e):
                        self._flush_metrics()
                        self.save(e)
                        try:
                            # full render every 4th plot (ref :324-328)
                            full = (e // self.plot_freq) % 4 == 0
                            with self.tracer.span("plot", epoch=e):
                                self.plot(e, full=full)
                        except Exception as exc:  # never kill training
                            self.log(f"plot failed at epoch {e}: {exc}")
                epoch = e1 + 1
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        self._flush_metrics()
        self.save(cfg.train.nepochs)
        if self.trace_dir:
            self.tracer.write(os.path.join(self.trace_dir, spans_file()))
        rates = self.throughput.rates()
        peak = ""
        if self.device.type == "cuda":
            gib = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
            peak = f", peak memory {gib:.2f} GiB"
        self.log(f"training done: {rates['rays_per_s']:.0f} rays/s "
                 f"({rates['steps_per_s']:.2f} epochs/s overall){peak}")
        return self.state
