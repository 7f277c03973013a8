"""Training cells: the training CLI's trainer on the configuration's scene,
driven chunk by chunk through ``Trainer._train_chunk`` from the phase's
first epoch, as ``python -m mvsdf_tpu_torch.train.cli`` runs a scene.

Set-up builds the trainer as the CLI does (``train.cli.setup``), gives it
the seed's weights, moves its schedule to the traffic's ``start_epoch``,
then runs the first epoch through the fused dispatch in four pieces
(``Trainer._plan_chunk`` once, then ``Trainer._dispatch`` on step 1, which
is the phase's capture and its eager warm-up, on step 2, the first graph
replay, on step 3, and on the rest), keeping what the check reads after
steps 1, 2 and 3, and the rest of the first chunk through
``_train_chunk``. The window runs whole chunks of ``chunk_epochs`` epochs
until ``--seconds`` have passed, then waits for the device.

The check reads the first replay, step 2, as the window's replays run it.
The plain reference (``reference/step.py``) takes the first steps from the
same weights, scene, pixels and draws. Compared, each against its limit
(the traffic file's ``limits``):
- ``loss_gap``: step 2's |loss - reference| / |reference|, the reference
  taking step 2 from the program's weights after step 1 (from its own,
  the loss swings with the precision of step 1 alone: the reference's own
  step-2 loss in f32 and in TF32 parts by up to 8.6e-3);
- ``grad_gap``: step 2's gradient as Adam took it ((m2 - beta1 m1) /
  (1 - beta1) of its first moments after steps 1 and 2) against the
  reference's clipped gradient from the same weights, by the worst leaf:
  | |g| - |g_ref| | over the larger of |g_ref| and the median leaf's (the
  median of those, where the traffic's ``grad_gap_leaf`` says so: one leaf
  whose gradient nearly cancels can read far above the others);
- ``update_gap``: the same of each leaf's change over three steps, against
  the reference's own three steps from the seed's weights.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the last two.
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys
import time

import numpy as np

from .. import scene as scene_files
from ..common import Clock, cuda_ms
from ..weights import make_weights

BETA1 = 0.9
# leaves whose reference gradient norm is under this share of the median
# leaf's move under Adam by round-off alone
QUIET_LEAF = 1e-3


def _check_config(cfg, config: dict, train: bool = True) -> None:
    """The program's configuration must be the file's (its training
    entries only where ``train``)."""
    icfg, rcfg = config["model"]["implicit"], config["model"]["render"]
    tcfg, tr = config["model"]["tracer"], config["train"]
    pairs = [(tuple(cfg.model.implicit.dims), tuple(icfg["dims"])),
             (cfg.model.implicit.multires, icfg["multires"]),
             (tuple(cfg.model.implicit.skip_in), tuple(icfg["skip_in"])),
             (cfg.model.implicit.bias, icfg["bias"]),
             (cfg.model.implicit.feature_vector_size,
              icfg["feature_vector_size"]),
             (tuple(cfg.model.render.dims), tuple(rcfg["dims"])),
             (cfg.model.render.multires_view, rcfg["multires_view"]),
             (cfg.model.tracer.n_steps, tcfg["n_steps"]),
             (cfg.model.tracer.n_secant_steps, tcfg["n_secant_steps"]),
             (cfg.model.tracer.sphere_tracing_iters,
              tcfg["sphere_tracing_iters"]),
             (cfg.model.use_mask, config["model"]["use_mask"])]
    if train:
        pairs += [
             (cfg.train.batch_size, tr["batch_size"]),
             (cfg.train.num_pixels, tr["num_pixels"]),
             (cfg.train.nepochs, tr["nepochs"]),
             (cfg.train.learning_rate, tr["learning_rate"]),
             (cfg.train.epochs_per_dispatch, tr["epochs_per_dispatch"])]
    bad = [(a, b) for a, b in pairs if a != b]
    if bad:
        raise ValueError(f"the program's configuration is not the file's: "
                         f"{bad}")


def write_conf(config: dict, name: str, cache: str) -> str:
    """The configuration's HOCON text as a file in the cache (a
    configuration at other widths than the CLI's built-in ones)."""
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"{name}.conf")
    with open(path, "w") as f:
        f.write(config["hocon"])
    return path


class Driver:
    def __init__(self, cell, seed: int, device, trace: bool,
                 cache: str = scene_files.CACHE):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, \
            trace
        self.config, self.traffic = cell.config, cell.traffic
        self.cache = cache
        self.clock = Clock()
        self.ctx = {}

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from mvsdf_tpu_torch.train import cli
        cfg, tr = self.config, self.traffic
        train = cfg["train"]
        t = time.perf_counter()
        self.root = scene_files.ensure_scene(self.cell.config_name,
                                             cfg["scene"], self.cache)
        os.environ["MVSDF_VISMVSNET_PT"] = os.path.join(self.root,
                                                        "featext.pt")
        self.exps = os.path.join(self.cache, "exps", self.cell.name)
        argv = ["--data_dir", os.path.join(self.root, "scene"),
                "--exps_folder", self.exps, "--expname", "run", "--no_mesh",
                "--allow_random_features", "--seed", str(self.seed),
                "--nepoch", str(train["nepochs"]),
                "--batch_size", str(train["batch_size"]),
                "--num_pixels", str(train["num_pixels"]),
                "--epochs_per_dispatch", str(train["epochs_per_dispatch"]),
                "--matmul_precision", train["matmul_precision"],
                *cfg["cli_args"]]
        if "hocon" in cfg:
            argv += ["--conf", write_conf(cfg, self.cell.config_name,
                                          self.cache)]
        if self.device.type == "cpu":
            argv += ["--platform", "cpu"]
        self.parts = {"scene_files": time.perf_counter() - t}
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            trainer, _ = cli.setup(argv)
        self.parts["cli_setup"] = time.perf_counter() - t
        self.parts.update(trainer.scene.timings)
        trainer.log = lambda *a: None
        _check_config(trainer.cfg, cfg)
        self.trainer = trainer
        st = trainer.state
        self.weights0 = make_weights(cfg["model"], self.seed, self.device)
        st.net.load_state_dict(self.weights0)
        self.weights0 = {k: v.cpu() for k, v in self.weights0.items()}
        # the schedule at the phase's first epoch
        e0 = tr["start_epoch"]
        n = sum(e0 >= m for m in st.scheduler.milestones)
        st.scheduler.last_epoch = e0
        for group, base in zip(st.optimizer.param_groups,
                               st.scheduler.base_lrs):
            group["lr"] = base * st.scheduler.gamma ** n
        nepochs = trainer.cfg.train.nepochs
        phase = trainer.cfg.schedule.phase_index(e0 / nepochs)
        step = trainer._get_fused_step(phase,
                                       trainer.cfg.schedule.weights(
                                           e0 / nepochs))
        self.steps_per_epoch = trainer.scene.n_images // \
            trainer.cfg.train.batch_size
        self.rays_per_step = trainer.cfg.train.batch_size * \
            trainer.cfg.train.num_pixels
        plan, epochs, _ = trainer._plan_chunk(e0, e0, step)
        named = dict(st.net.named_parameters())
        losses = []
        moment = lambda: {k: st.optimizer.state[p]["exp_avg"].cpu().clone()
                          for k, p in named.items()}
        weights = lambda: {k: p.detach().cpu().clone()
                           for k, p in named.items()}

        def run(a, b):
            chunk = trainer._dispatch(step, plan[a:b], epochs[a:b])
            self._sync()
            out = chunk["out"]
            losses.extend(float(out[k][0]) for k in range(b - a))
            return chunk

        t = time.perf_counter()
        self.parts["capture"] = run(0, 1)["capture_s"]
        self.parts["first_step"] = time.perf_counter() - t
        self.moment1, self.weights1 = moment(), weights()
        run(1, 2)
        self.moment2 = moment()
        run(2, 3)
        self.weights3 = weights()
        run(3, len(epochs))
        self.losses = losses[:3]
        self.epoch = e0 + 1
        chunk = tr["chunk_epochs"]
        t = time.perf_counter()
        if chunk > 1:
            trainer._train_chunk(self.epoch, e0 + chunk - 1)
            self.epoch = e0 + chunk
        trainer._flush_metrics()
        self._sync()
        self.parts["warm_chunk"] = time.perf_counter() - t
        self.step = step
        if step.graph_bytes is not None:
            self.parts["graph_pool_gib"] = step.graph_bytes / 2 ** 30

    def _sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    # -- the window -----------------------------------------------------
    def _chunk(self):
        e, n = self.epoch, self.traffic["chunk_epochs"]
        self.trainer._train_chunk(e, e + n - 1)
        self.epoch = e + n
        return n

    def window(self, seconds: float) -> None:
        """Whole chunks until ``seconds`` have passed, then the device
        drains. With tracing the host spans of each chunk's plan, its
        dispatch and the replay calls in it (where the launch blocks on a
        full queue) are kept, and the replays' device seconds (the
        trainer's CUDA events around each chunk's replays)."""
        tr = self.trainer
        nonfinite, replay_ms = [], []
        log_epoch = tr._log_epoch

        def logged(epoch, rays_per_s, m, **kw):
            if not all(math.isfinite(v) for v in m.values()):
                nonfinite.append(epoch)
            replay_ms.append(kw["steps"] * kw["ms_per_step"])
            return log_epoch(epoch, rays_per_s, m, **kw)

        tr._log_epoch = logged
        step_type = type(self.step)
        replay = step_type.__call__
        if self.trace:
            tr._plan_chunk = self.clock.timed("plan", _spanned(
                "plan_chunk", tr._plan_chunk))
            tr._dispatch = self.clock.timed("dispatch", _spanned(
                "dispatch", tr._dispatch))
            step_type.__call__ = self.clock.timed("replay", replay)
        epochs = 0
        t0 = time.perf_counter()
        try:
            while time.perf_counter() - t0 < seconds:
                epochs += self._chunk()
            tr._flush_metrics()
            self._sync()
        finally:
            step_type.__call__ = replay
        wall = time.perf_counter() - t0
        steps = epochs * self.steps_per_epoch
        self.ctx.update(train_window={
            "seconds": wall, "steps": steps,
            "rays": steps * self.rays_per_step,
            "plan_s": self.clock.total("plan") if self.trace else None,
            "dispatch_s": self.clock.total("dispatch") -
            self.clock.total("replay") if self.trace else None,
            "replay_device_s": sum(replay_ms) / 1e3})
        self.attempted, self.failed = epochs, len(nonfinite)
        tr._log_epoch = log_epoch

    # -- what only the traced run reads ----------------------------------
    def profile(self) -> dict:
        """One more chunk under the profiler; its window is a chunk's
        length in the window, where no profiler ran. ``replay_share`` is
        the window's share in which the device ran replays, by the
        trainer's CUDA events and with no profiler: a bound from above on
        the busy share that the profiler's chunk gives."""
        from ..profiling import profiled

        def chunk():
            self._chunk()
            self.trainer._flush_metrics()
        prof = profiled(chunk)[1]
        w = self.ctx["train_window"]
        prof["window_s"] = w["seconds"] * self.traffic["chunk_epochs"] / \
            (w["steps"] / self.steps_per_epoch)
        prof["replay_share"] = w["replay_device_s"] / w["seconds"]
        return prof

    def kernel_timings(self) -> None:
        """``sdf_mlp`` alone at the trace's block shape, where the
        configuration traces through it; the reference trace's counts on
        the state at the window's end, for the step's operations."""
        import torch
        from ..reference import field
        tr = self.trainer
        icfg = self.config["model"]["implicit"]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        if tr.cfg.model.use_pallas_trace:
            from mvsdf_tpu_torch.tracing.kernels.sdf_mlp import (
                pack_sdf_weights, sdf_mlp)
            rows = self.traffic["sdf_mlp_rows"]
            with torch.no_grad():
                packed = pack_sdf_weights(tr.state.net.implicit)
                x = torch.rand((rows, 3), generator=gen,
                               device=self.device) * 2 - 1
                pe = field.encode(x, icfg["multires"]).contiguous()
                ms = cuda_ms(lambda: sdf_mlp(packed, pe), iters=50)
            self.ctx["sdf_mlp"] = {"rows": rows, "ms": ms, "icfg": icfg}
        self.ctx["step_counts"] = self._reference_counts()

    def _reference_counts(self) -> dict:
        """The plain trace's counts on one batch of the first epoch's plan
        at the current weights."""
        import torch
        from ..reference import scene as ref_scene
        from ..reference import step as ref_step
        from ..reference.trace import Counter, trace
        from ..reference import field
        cfg = self.config
        params = {k: v.detach() for k, v in
                  self.trainer.state.net.state_dict().items()}
        sc = ref_scene.Scene(self.root, self.device)
        indices, sel = self._plan(1)[0]
        b = sc.batch(indices, sel)
        dirs, loc = ref_step.camera_rays(b["uv"], b["pose"],
                                         b["intrinsics"])
        B, P, _ = dirs.shape
        count = Counter(lambda x: field.sdf_value(params, cfg["model"][
            "implicit"], x))
        obj = torch.ones((B * P,), dtype=torch.bool, device=self.device)
        if cfg["model"]["use_mask"]:
            obj = b["object_mask"].reshape(-1).bool()
        with torch.no_grad(), _no_tf32():
            _, hit, _, smp = trace(cfg["model"]["tracer"], count,
                                   loc[:, None].expand(B, P, 3).reshape(-1, 3),
                                   dirs.reshape(-1, 3), obj)
        gates, _ = ref_step.gates_weights(cfg["schedule"], self.epoch,
                                          cfg["train"]["nepochs"])
        return {"trace_rows": count.rows, "hits": int((hit & obj).sum()),
                "sampler_rays": int(smp.sum()), "B": B, "P": P,
                "dsurf": gates["dsurf"],
                "detach_geometry": gates["detach_geometry"],
                "icfg": cfg["model"]["implicit"],
                "rcfg": cfg["model"]["render"]}

    # -- the check ------------------------------------------------------
    def release(self) -> None:
        """Frees the program's state; what the check reads stays."""
        import gc
        import torch
        self.trainer._release_fused_steps()
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.exps, ignore_errors=True)

    def _plan(self, n: int):
        """The first epoch's first ``n`` steps as the trainer draws them
        from the seed: a pixel subset, then an order of the images."""
        rng = np.random.default_rng(self.seed)
        sc = self.config["scene"]
        H, W = sc["img_hw"]
        B, P = self.config["train"]["batch_size"], \
            self.config["train"]["num_pixels"]
        sel = rng.permutation(H * W)[:P]
        order = rng.permutation(sc["views"])
        return [(order[i * B:(i + 1) * B], sel) for i in range(n)]

    def reference(self, control: bool = False, start: dict = None,
                  plan=None):
        """The plain reference's first steps from the seed's weights, as
        train_steps gives them: (losses, clipped gradients, weights after
        each step). In f32 with TF32 off, or with ``control`` in bfloat16
        (autocast).
        ``start``: two steps, step 2 from these weights; ``plan``: the
        steps' batches (the first epoch's first three by default)."""
        import torch
        from ..reference import scene as ref_scene
        from ..reference.step import train_steps
        sc = ref_scene.Scene(self.root, self.device)
        params = {k: v.to(self.device).clone()
                  for k, v in self.weights0.items()}
        if plan is None:
            plan = self._plan(3 if start is None else 2)
        with _no_tf32(), torch.autocast(self.device.type,
                                        dtype=torch.bfloat16,
                                        enabled=control):
            return train_steps(self.config, params, sc, plan,
                               self.traffic["start_epoch"], self.seed,
                               self.device, start and {1: start})

    def program(self):
        """What the check reads of the program: step 2's loss and gradient
        as Adam took it, the weights after steps 1 and 3."""
        g2 = {k: (self.moment2[k] - BETA1 * self.moment1[k]) / (1 - BETA1)
              for k in self.moment2}
        return self.losses[1], g2, self.weights1, self.weights3

    @staticmethod
    def in_place_of_program(run):
        """A reference run (``reference``'s result) put in the program's
        place: what ``program`` gives of the program."""
        losses, grads, weights = run
        return losses[1], grads[1], weights[0], weights[2]

    def readings(self, subject, ref=None) -> dict:
        """The compared numbers of ``subject`` (as ``program`` gives them)
        against the reference: step 2 from the subject's weights after
        step 1, and ``ref``, the reference's own three steps (run here
        where not given). Besides the limits' keys: the gradient's gap by
        the worst and by the median leaf, and the worst leaf."""
        loss2, grad2, weights1, weights3 = subject
        at_losses, at_grads, _ = self.reference(start=weights1)
        r_loss, r_grad = at_losses[1], at_grads[1]
        r_weights = (ref or self.reference())[2][2]
        loss_gap = abs(loss2 - r_loss) / abs(r_loss)
        norm = lambda t: float(t.double().norm())
        g_ref = {k: norm(v) for k, v in r_grad.items()}
        med = float(np.median(list(g_ref.values())))
        keep = [k for k, v in g_ref.items() if v >= QUIET_LEAF * med]

        def gaps(prog, ref):
            m = float(np.median([ref[k] for k in keep]))
            return {k: abs(prog[k] - ref[k]) / max(ref[k], m) for k in keep}

        d_ref = {k: norm(r_weights[k] - self.weights0[k]) for k in keep}
        d_prog = {k: norm(weights3[k] - self.weights0[k]) for k in keep}
        grad = gaps({k: norm(grad2[k]) for k in keep}, g_ref)
        worst = max(grad, key=grad.get)
        by_leaf = {"worst": grad[worst],
                   "median": float(np.median(list(grad.values())))}
        return {"loss_gap": loss_gap,
                "grad_gap": by_leaf[self.traffic.get("grad_gap_leaf",
                                                     "worst")],
                "update_gap": max(gaps(d_prog, d_ref).values()),
                "grad_gap_worst": by_leaf["worst"],
                "grad_gap_median": by_leaf["median"], "worst_leaf": worst}

    def check(self):
        """[(name, reading, limit)] of this run."""
        got = self.readings(self.program())
        limits = self.traffic["limits"]
        return [(k, got[k], limits[k]) for k in ("loss_gap", "grad_gap",
                                                 "update_gap")]


def _spanned(name: str, fn):
    """fn inside a profiler span of ``name``, so the profile names the
    host's work outside torch's own operations."""
    from torch.profiler import record_function

    def run(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return run


@contextlib.contextmanager
def _no_tf32():
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
