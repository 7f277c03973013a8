"""Driver entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``).

``entry(device=None) -> (fn, example_args)``: the eval-mode renderer
forward of the full-size model from seed-0 weights on 1,024 rays of the
synthetic scene; ``fn(params, uv, intrinsics, pose, object_mask)`` returns
``(rgb_values, network_object_mask, dists)`` with ``params`` a state dict
of the port's network.

``dryrun_multichip(n_devices, fullsize=None, device=None)``: the
data-parallel training step (phase B) in ``n_devices`` processes, each on
its slice of the rays, held to the same step in one process. The tiny leg
is the JAX dry run's small model with the SDF-MLP and secant kernels in
the trace; the full-size leg is the default model with the plain trace.
Each rank and the single process run in processes of their own; on the
GPU, the ranks join NCCL when there is a card for each, else gloo on one
card. The GPU runs with TF32 off. ``fullsize=None`` runs both legs.

    python -m mvsdf_tpu_torch.graft_entry

calls ``entry()`` on the GPU and prints the output shapes, then runs
``dryrun_multichip(max(2, cards))``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch import nn

ENTRY_RAYS = 1024
# the one-step comparison's bounds (the JAX dry run's): the loss, the
# relative gradient norm, the parameters against Adam's one-step scale
# (2.5 x lr x batch), the tiny leg's raw gradients against their largest
# entry
LOSS_TOL, GRAD_NORM_RTOL, PARAM_ADAM_STEPS, GRAD_RTOL = 1e-5, 5e-4, 2.5, 5e-4
TIMEOUT_S = 900


def _scene(n_images, n_pix, feat_ch, depth_hw=24, img_hw=48) -> dict:
    from .data.synthetic import make_scene
    return make_scene(n_images=n_images, n_pix=n_pix, feat_ch=feat_ch,
                      depth_hw=depth_hw, img_hw=img_hw)


class _EntryModule(nn.Module):
    """The eval-mode render's three outputs, as a module, so that
    ``functional_call`` can swap its parameters."""

    def __init__(self, model, net):
        super().__init__()
        self.model, self.net = model, net

    def forward(self, uv, intrinsics, pose, object_mask):
        from .rendering.renderer import render_forward
        out = render_forward(
            self.model, self.net,
            {"uv": uv, "intrinsics": intrinsics, "pose": pose,
             "object_mask": object_mask}, training=False)
        return out.rgb_values, out.network_object_mask, out.dists


def entry(device=None):
    """(fn, example_args): the eval-mode renderer forward of the full-size
    ``MVSDFConfig()`` (the plain trace, as its default) at seed 0 on
    ENTRY_RAYS rays of one view, on ``device`` (the GPU unless named)."""
    from .config import MVSDFConfig
    from .data.synthetic import scene_to_torch
    from .device import resolve_device
    from .fields.network import MVSDFNetwork
    from .train.step import init_params
    dev = resolve_device(device)
    cfg = MVSDFConfig()
    params = {k: v.detach() for k, v in
              init_params(cfg, seed=0, device=dev).state_dict().items()}
    with torch.device("meta"):
        module = _EntryModule(cfg.model, MVSDFNetwork(cfg.model.implicit,
                                                      cfg.model.render))
    inputs = scene_to_torch(_scene(n_images=1, n_pix=ENTRY_RAYS,
                                   feat_ch=32), dev)

    def fn(params, uv, intrinsics, pose, object_mask):
        with torch.no_grad():
            return torch.func.functional_call(
                module, {f"net.{k}": v for k, v in params.items()},
                (uv, intrinsics, pose, object_mask), strict=True)

    return fn, (params, inputs["uv"], inputs["intrinsics"], inputs["pose"],
                inputs["object_mask"])


def leg(n_devices: int, fullsize: bool):
    """(config, sizes) of a dry-run leg, as the JAX dry run builds them:
    sizes holds feat, n_pix, batch_size, n_images, depth_hw, img_hw and
    steps."""
    from .config import MVSDFConfig, ModelConfig, Schedule, TrainConfig
    from .fields.radiance import RenderConfig
    from .fields.sdf import ImplicitConfig
    from .tracing.sphere_trace import TracerConfig
    if fullsize:
        sizes = dict(feat=32, n_pix=4096, batch_size=8, n_images=12,
                     depth_hw=48, img_hw=96, steps=1)
        model = ModelConfig(implicit=ImplicitConfig(),
                            render=RenderConfig(),
                            tracer=TracerConfig(fill_misses=False),
                            shard_map_trace=True)
    else:
        feat = 16
        sizes = dict(feat=feat, n_pix=max(8 * n_devices, 32), batch_size=2,
                     n_images=3, depth_hw=24, img_hw=48, steps=2)
        model = ModelConfig(
            implicit=ImplicitConfig(feature_vector_size=feat,
                                    dims=(64,) * 3, skip_in=(2,),
                                    multires=6),
            render=RenderConfig(feature_vector_size=feat, dims=(64,),
                                multires_view=4),
            tracer=TracerConfig(sphere_tracing_iters=5, n_steps=20,
                                n_secant_steps=4, sample_chunk=0,
                                sampler_capacity_frac=0.9,
                                fill_capacity_frac=0.9,
                                fallback_capacity_frac=0.9,
                                fill_misses=False),
            shard_map_trace=True, use_pallas_trace=True,
            use_pallas_secant=True, pallas_block=128)
    cfg = MVSDFConfig(model=model, schedule=Schedule(),
                      train=TrainConfig(batch_size=sizes["batch_size"],
                                        num_pixels=sizes["n_pix"],
                                        nepochs=12))
    return cfg, sizes


def host_plan(sizes, n_pixels: int):
    """(image ids (steps, B), pixel ids (steps, P)) from
    ``np.random.default_rng(0)``, as the JAX dry run draws them."""
    rng = np.random.default_rng(0)
    K = sizes["steps"]
    idx = np.stack([rng.permutation(sizes["n_images"])[:sizes["batch_size"]]
                    for _ in range(K)]).astype(np.int64)
    sel = np.stack([rng.permutation(n_pixels)[:sizes["n_pix"]]
                    for _ in range(K)]).astype(np.int64)
    return idx, sel


class _SceneView:
    """A SceneData-shaped view of a synthetic scene dict, for
    DeviceSceneCache."""

    def __init__(self, sc):
        self.n_images = sc["rgb"].shape[0]
        self.uv = sc["uv"][0]
        self.rgb = sc["rgb"]
        self.masks = sc["object_mask"]
        self.intrinsics = sc["intrinsics"]
        self.poses = sc["pose"]
        self.depths = sc["depths"][:, 0]
        self.depth_cams = sc["depth_cams"][:, 0]
        self.size = float(np.asarray(sc["size"]).reshape(-1)[0])
        self.center = np.asarray(sc["center"]).reshape(-1, 3)[0]
        self.feats = torch.from_numpy(np.asarray(sc["feat"]))
        self.cams_hd = sc["cam"]

    def src_indices(self, i):
        return [(i + 1) % self.n_images, (i + 2) % self.n_images]


def loss_and_grads(cfg, net, batch, phase_idx: int, tp: float,
                   generator=None, noise=None):
    """The training step's loss terms and raw parameter gradients (summed
    over the ranks, before the clip and Adam) at ``net``'s weights."""
    from .parallel import sum_
    from .rendering.renderer import render_forward
    from .supervision.losses import total_loss
    from .train.step import GT_KEYS
    gates = cfg.schedule.gates_for_phase(phase_idx)
    out = render_forward(cfg.model, net, batch, training=True, gates=gates,
                         generator=generator, noise=noise)
    lt = total_loss(out, {k: batch[k] for k in GT_KEYS}, gates, cfg.schedule,
                    cfg.schedule.weights(tp))
    params = list(net.parameters())
    grads = torch.autograd.grad(lt.loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    sum_(grads)
    return lt, grads


def _skip_sum(tensors):
    """A rank that skips its sum: it joins the all-reduce with zeros and
    keeps its own values (a sabotage for testing the bounds)."""
    import torch.distributed as dist
    n = sum(t.numel() for t in tensors)
    if n:
        dist.all_reduce(torch.zeros(n, dtype=tensors[0].dtype,
                                    device=tensors[0].device))


def _worker(spec_path: str, out_path: str) -> int:
    """One process of a dry-run leg (a rank when WORLD_SIZE is set): the
    tiny leg's raw gradients, then the leg's steps; its record saved to
    ``out_path``."""
    from . import parallel
    from .train import step as step_mod
    from .train.device_data import DeviceSceneCache
    from .train.step import advance_epoch, init_train_state, make_train_step
    from .bench import kernel_counts
    with open(spec_path) as f:
        spec = json.load(f)
    dev = parallel.init_distributed(
        spec["backend"], device="cpu" if spec["device"] == "cpu" else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    if spec.get("skip_sum_rank") == parallel.rank() and \
            parallel.world_size() > 1:
        parallel.sum_ = step_mod.sum_ = _skip_sum
    cfg, sizes = leg(spec["n_devices"], spec["fullsize"])
    sc = _scene(sizes["n_images"], sizes["n_pix"], sizes["feat"],
                sizes["depth_hw"], sizes["img_hw"])
    cache = DeviceSceneCache(_SceneView(sc), dev)
    idx, sel = host_plan(sizes, sc["uv"].shape[1])
    batches = [cache.gather(torch.from_numpy(i).to(dev),
                            torch.from_numpy(s).to(dev))
               for i, s in zip(idx, sel)]
    state = init_train_state(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    rec = {"rank": parallel.rank(), "world": parallel.world_size(),
           "device": str(dev)}
    before = kernel_counts()
    if not spec["fullsize"]:
        gen.manual_seed(0)
        _, grads = loss_and_grads(cfg, state.net, batches[0], 1, 0.3, gen)
        rec["grads"] = [g.detach().cpu().numpy() for g in grads]
    step = make_train_step(cfg, phase_idx=1)
    weights = cfg.schedule.weights(0.3)
    rec["metrics"] = []
    for k, batch in enumerate(batches):
        gen.manual_seed(k)
        m = step(state, batch, weights, gen)
        advance_epoch(state)
        rec["metrics"].append({n: float(v) for n, v in m.items()})
        if k == 0:
            rec["params"] = [p.detach().cpu().numpy()
                             for p in state.net.parameters()]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec["launches"] = {k: v - before[k] for k, v in kernel_counts().items()}
    torch.save(rec, out_path)
    if parallel.world_size() > 1:
        torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_leg(n_devices: int, fullsize: bool, dev: torch.device,
             skip_sum_rank=None):
    """The leg's n_devices ranks and its single process, started together;
    their records (ranks first), the backend and the seconds. Every
    process is stopped before this returns."""
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    nccl = dev.type == "cuda" and n_devices <= cards
    backend = "nccl" if nccl else "gloo"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs, outs = [], []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mvsdf_dryrun_") as tmp:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"n_devices": n_devices, "fullsize": fullsize,
                       "device": dev.type, "backend": backend,
                       "skip_sum_rank": skip_sum_rank}, f)
        try:
            for r in list(range(n_devices)) + [None]:
                env = {k: v for k, v in os.environ.items() if k not in (
                    "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT")}
                env["PYTHONPATH"] = os.pathsep.join(
                    [repo] + [p for p in [env.get("PYTHONPATH")] if p])
                if r is not None:
                    env.update(RANK=str(r), WORLD_SIZE=str(n_devices),
                               LOCAL_RANK=str(r if nccl else 0),
                               MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(port))
                out = os.path.join(tmp, f"{'single' if r is None else r}.pt")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mvsdf_tpu_torch.graft_entry",
                     "worker", spec, out], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
                outs.append(out)
            texts = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [f"process {'single' if r == n_devices else r} exited "
                  f"{p.returncode}:\n{text[-3000:]}"
                  for r, (p, text) in enumerate(zip(procs, texts))
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        recs = [torch.load(o, weights_only=False) for o in outs]
    return recs, backend, time.perf_counter() - t0


def _dryrun_one(n_devices: int, fullsize: bool, device=None,
                skip_sum_rank=None) -> dict:
    """One leg: runs it, holds the ranks' first step to the single
    process's within the JAX dry run's bounds (AssertionError on a miss)
    and prints its line. ``skip_sum_rank`` makes that rank skip its
    gradient sum (a sabotage the bounds must catch). Returns the line's
    numbers."""
    from .device import resolve_device
    dev = resolve_device(device)
    cfg, sizes = leg(n_devices, fullsize)
    recs, backend, wall = _run_leg(n_devices, fullsize, dev, skip_sum_rank)
    sh, one = recs[0], recs[-1]
    loss = sh["metrics"][-1]["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    d_grad_rel = None
    if not fullsize:
        g_scale = max(float(np.abs(g).max()) for g in one["grads"])
        d_grad = max(float(np.abs(a.astype(np.float64) - b).max())
                     for a, b in zip(sh["grads"], one["grads"]))
        d_grad_rel = d_grad / (g_scale + 1e-30)
        if d_grad_rel > GRAD_RTOL:
            raise AssertionError(
                f"the ranks' pre-Adam gradients diverge beyond roundoff: rel "
                f"{d_grad_rel:.2e} (abs {d_grad:.2e}, scale {g_scale:.2e})")
    m_sh, m_1 = sh["metrics"][0], one["metrics"][0]
    d_loss = abs(m_sh["loss"] - m_1["loss"])
    d_gn = abs(m_sh["grad_norm"] - m_1["grad_norm"]) / (
        abs(m_1["grad_norm"]) + 1e-12)
    d_par = max(float(np.abs(a.astype(np.float64) - b).max())
                for a, b in zip(sh["params"], one["params"]))
    lr_eff = cfg.train.learning_rate * sizes["batch_size"]
    if d_loss > LOSS_TOL:
        raise AssertionError(f"the ranks' loss != one process's: {d_loss}")
    if d_gn > GRAD_NORM_RTOL:
        raise AssertionError(f"the ranks' grad_norm != one process's: {d_gn}")
    if d_par > PARAM_ADAM_STEPS * lr_eff:
        raise AssertionError(f"the ranks' params diverge beyond the Adam "
                             f"step scale: {d_par}")
    if dev.type == "cuda" and not fullsize:
        for r in recs:
            if not (r["launches"]["sdf_mlp"] and r["launches"]["secant"]):
                raise AssertionError(f"a tiny-leg process launched no "
                                     f"sdf_mlp or secant: {r['launches']}")
    icfg = cfg.model.implicit
    kernels = "plain" if fullsize else "sdf_mlp + secant kernel"
    tf32 = "TF32 off" if dev.type == "cuda" else "CPU"
    print(f"dryrun_multichip({n_devices}, fullsize={fullsize}): "
          f"loss={loss:.4f} hit_frac={sh['metrics'][-1]['hit_frac']:.3f} "
          f"[{sizes['batch_size']}x{sizes['n_pix']} rays, "
          f"{len(icfg.dims)}x{icfg.dims[0]} net; {sizes['steps']} step(s) "
          f"in a loop, {n_devices} {backend} ranks on {sh['device']}, "
          f"{kernels} trace, {tf32}; launches a rank "
          f"{sh['launches']}; ranks==one process (1 step): "
          f"|dloss|={d_loss:.2e} |dgrad_norm|rel={d_gn:.2e} "
          f"max|dparam|={d_par:.2e} (adam-step ceiling "
          f"{PARAM_ADAM_STEPS * lr_eff:.1e})"
          + (f" max|dgrad|rel={d_grad_rel:.2e} (roundoff ceiling "
             f"{GRAD_RTOL:g})" if d_grad_rel is not None else "")
          + f"; {wall:.1f} s]", flush=True)
    return {"loss": loss, "d_loss": d_loss, "d_grad_norm_rel": d_gn,
            "d_param": d_par, "d_grad_rel": d_grad_rel, "wall_s": wall,
            "backend": backend, "launches": [r["launches"] for r in recs]}


def dryrun_multichip(n_devices: int, fullsize=None, device=None) -> list:
    """The data-parallel step on ``n_devices`` ranks against one process:
    the tiny leg, the full-size leg, or (``fullsize=None``) both. Returns
    each leg's numbers."""
    legs = (False, True) if fullsize is None else (fullsize,)
    return [_dryrun_one(n_devices, fs, device) for fs in legs]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["worker"]:
        return _worker(*argv[1:3])
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(max(2, torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
