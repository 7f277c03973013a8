"""Three-phase training validation at full scale without DTU data
(counterpart of the JAX repo's ``scripts/full_training_validation.py``,
same flags and summary): a fully coherent synthetic scene (the textured
lambertian sphere of ``data/synthetic.make_scene_shaded``, 12 frontal-cap
cameras, analytic depth maps, frozen FeatExt features computed from the
rendered images) trained through the full phase schedule (A: depth +
eikonal carving; B/C: + RGB with live geometry, feature consistency,
surface indicator), then evaluated: DTU-style chamfer against the analytic
sphere, PSNR of a held-out view, and the surface indicator's separation of
surface from random points.

    python -m mvsdf_tpu_torch.validation.full_training [--epochs 600] \\
        [--seed 0] [--out DIR] [--platform cpu]

Runs on the GPU unless ``--platform cpu`` is given, and raises without
one. With kernels (the default) the no-grad trace and the 160^3 mesh grid
go through the ``sdf_mlp`` kernel; ``--no_pallas`` runs the plain field.
Training runs at ``--precision`` (TF32 unless ``highest``); the evaluation
in full f32, as the eval CLI's. Writes ``surface.obj``,
``heldout_pred.png``, ``heldout_gt.png`` and ``params.pt`` (the network's
state dict) into ``--out`` and prints one JSON summary as its last line.

The host plan is the JAX script's, draw for draw: one
``np.random.default_rng(seed)`` gives each epoch's pixel permutation and
then its view permutation over the 11 training views, and after training
the ground-truth sphere points and the random cube points. The in-step
draws come from a ``torch.Generator`` seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

RADIUS = 0.45
N_VIEWS = 12
IMG_HW = 96          # the render resolution; the focal scales with it
HELD_OUT = N_VIEWS - 1   # the last view is kept out of every batch
WIN = 50             # epochs a rate window, each ending in a device sync
BOUNDS = (-0.7, 0.7)
# the region scored: the object, without the ground plane and the bottom
# cap no frontal camera sees
BBOX = np.array([[-0.55, -0.40, -0.55], [0.55, 0.55, 0.55]])
CHAMFER_SAMPLES, CHAMFER_MAX_DIST = 200_000, 0.2
N_GT, N_INDICATOR = 100_000, 5000
PSNR_CHUNK = 4608
# the summary's decimals, as the JAX script rounds
ROUNDING = {"chamfer_accuracy": 5, "chamfer_completeness": 5,
            "chamfer_overall": 5, "heldout_psnr": 2, "indicator_acc": 3,
            "indicator_sigmoid_on_med": 3, "indicator_sigmoid_off_med": 3}
LOGGED = ("loss", "rgb_loss", "depth_loss", "feat_loss", "surf_loss",
          "hit_frac")
# the JAX script's summary keys, in its order
SUMMARY_KEYS = (
    "epochs", "seed", "plane_r", "focal_mult", "supervised_cascade",
    "rays_per_s_incl_host", "median_window_rays_per_s", "final_loss",
    "chamfer_accuracy", "chamfer_completeness", "chamfer_overall",
    "heldout_psnr", "mesh_verts", "nonfinite_epochs", "indicator_acc",
    "indicator_sigmoid_on_med", "indicator_sigmoid_off_med")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="three-phase training validation on the shaded "
                    "synthetic scene (PyTorch/CUDA port)")
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--resolution", type=int, default=160)
    ap.add_argument("--platform", default="", choices=["", "cpu", "cuda"],
                    help="'cpu' runs on the CPU; the default is the GPU")
    ap.add_argument("--no_pallas", action="store_true",
                    help="the plain field for the trace and the mesh grid "
                         "instead of the sdf_mlp kernel")
    ap.add_argument("--n_pix", type=int, default=4096)
    ap.add_argument("--precision", default="default",
                    choices=["default", "tensorfloat32", "highest"],
                    help="f32 matmuls of the training step on the GPU: "
                         "'highest' = full f32, 'tensorfloat32' and "
                         "'default' = TF32, as the training CLI's "
                         "--matmul_precision (the trace's SDF kernel is "
                         "split bf16 regardless)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bf16_acts", action="store_true",
                    help="bf16 activation storage in the supervised "
                         "implicit MLP (quality study arm)")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (init, pixel permutations, in-step "
                         "draws); the scene stays fixed")
    ap.add_argument("--plane_r", type=float, default=0.92,
                    help="scene ground-plane radius; 0 = object-only "
                         "mask-tight scene")
    ap.add_argument("--focal_mult", type=float, default=1.3,
                    help="focal = focal_mult * 96; lower widens the FoV "
                         "and drops the sphere-intersect fraction")
    ap.add_argument("--supervised_compact", default="auto",
                    choices=["auto", "off", "top", "twotier", "bound"],
                    help="the supervised-path compaction tiers, chosen as "
                         "the JAX script chooses them (auto/top: "
                         "auto_supervised_cascade; off: dense; twotier: "
                         "(0.25, bound); bound: the bound tier even at 0.5 "
                         "or more). Whenever a tier is set the port's "
                         "per-epoch step gathers exactly the hit lanes and "
                         "its graph-replayed step takes the tiers, as JAX "
                         "does; their values change no result")
    ap.add_argument("--no_supervised_remat", action="store_true",
                    help="accepted for the JAX script's sake; no effect: "
                         "the port's graph-replayed step always recomputes "
                         "the later tiers in the backward, with equal "
                         "gradients (ModelConfig.supervised_remat)")
    ap.add_argument("--out", default="mvsdf_validation")
    return ap.parse_args(argv)


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def supervised_tiers(mode: str, isect: float):
    """The supervised compaction tiers the JAX script picks for ``mode``
    from the sphere-intersect fraction."""
    from ..tracing.sphere_trace import auto_supervised_cascade
    if mode in ("auto", "top"):
        return auto_supervised_cascade(intersect_frac=isect)
    if mode == "twotier":
        top = auto_supervised_cascade(intersect_frac=isect)
        return tuple(sorted({min(0.25, top[0]), top[0]})) if top else ()
    if mode == "bound":
        b = float(np.ceil(isect * 16) / 16)
        return (b,) if b < 0.95 else ()
    return ()


def make_config(args, sc, log=print):
    """(config, supervised tiers) of the run: the JAX script's
    configuration (lr 5e-5, implicit_diff_min_dot 1e-2, the non-finite
    skip) and, with kernels, its tracer capacities from the scene's mask
    and sphere-intersect statistics (carried; they change no result
    here)."""
    from ..config import MVSDFConfig, TrainConfig
    cfg = MVSDFConfig(train=TrainConfig(
        batch_size=args.batch, num_pixels=args.n_pix, nepochs=args.epochs,
        learning_rate=5e-5, skip_nonfinite_updates=True, seed=args.seed))
    model = _replace(cfg.model, implicit_diff_min_dot=1e-2,
                     supervised_remat=not args.no_supervised_remat)
    if args.bf16_acts:
        model = _replace(model, implicit=_replace(model.implicit,
                                                  bf16_activations=True))
    sup = ()
    if not args.no_pallas:
        from ..tracing.sphere_trace import (auto_fallback_cascade,
                                            auto_march_schedule,
                                            ray_intersect_fraction)
        obj_frac = float(np.mean(sc["mask_full"]))
        uv_all = np.broadcast_to(sc["uv_full"][None],
                                 (N_VIEWS,) + sc["uv_full"].shape)
        isect = ray_intersect_fraction(uv_all, sc["intrinsics"], sc["pose"])
        cap = auto_fallback_cascade(obj_frac, intersect_frac=isect,
                                    fill_misses=False)
        march_sched = auto_march_schedule(obj_frac, intersect_frac=isect)
        sup = supervised_tiers(args.supervised_compact, isect)
        log(f"fallback cascade: {cap}, march schedule {march_sched} "
            f"supervised cascade {sup} (object frac {obj_frac:.3f}, "
            f"intersect {isect:.3f})")
        tr = _replace(model.tracer, sampler_capacity_frac=0.25,
                      fill_capacity_frac=0.5, fallback_capacity_frac=cap,
                      march_compact_schedule=march_sched, fill_misses=False)
        model = _replace(model, use_pallas_trace=True, tracer=tr,
                         supervised_compact_frac=sup)
    return _replace(cfg, model=model), sup


def epoch_plan(rng, n_pixels: int, n_pix: int, n_train: int, batch: int):
    """One epoch's host draws, in the JAX script's order: the pixel subset
    (n_pix of n_pixels), then the batch's views (batch of n_train)."""
    sel = rng.permutation(n_pixels)[:n_pix]
    views = rng.permutation(np.arange(n_train))[:batch]
    return sel, views


BATCH_KEYS = ("intrinsics", "pose", "depths", "depth_cams", "feat",
              "feat_src", "cam", "src_cams")


class SceneTensors:
    """The scene's arrays on the device, and each epoch's batch gathered
    there from the host plan's pixel subset and views."""

    def __init__(self, sc, device):
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.device = device
        self.t = {k: put(sc[k]) for k in BATCH_KEYS + (
            "size", "center", "uv_full", "rgb_full", "mask_full")}

    def batch(self, sel: np.ndarray, views: np.ndarray) -> dict:
        t, dev = self.t, self.device
        s = torch.from_numpy(sel.astype(np.int64)).to(dev)
        v = torch.from_numpy(views.astype(np.int64)).to(dev)
        B, P = len(views), len(sel)
        b = {"uv": t["uv_full"][s][None].expand(B, P, 2).contiguous(),
             "rgb": t["rgb_full"][v][:, s],
             "object_mask": t["mask_full"][v][:, s],
             "indices": v}
        for k in BATCH_KEYS:
            b[k] = t[k][v]
        b["size"] = t["size"][:B]
        b["center"] = t["center"][:B]
        return b


def sdf_mlp_launches() -> int:
    from ..tracing.kernels.sdf_mlp import sdf_mlp
    return sdf_mlp.launches


def train(cfg, sc, rng, device, log=print):
    """Trains ``cfg.train.nepochs`` epochs of one step each on the scene's
    training views from ``init_params(cfg, seed)``, drawing each epoch's
    plan from ``rng``. Returns (network, stats): ``metrics`` (the last
    step's, floats), ``nonfinite`` (epochs whose gradient norm was not
    finite), ``train_s``, ``rays_per_s`` (all of it), ``windows`` (one
    (last epoch, ms/step, rays/s, clean) a WIN-epoch window; a window
    holding a phase's first step is not clean), ``median_window_rays_per_s``
    (over the clean ones) and ``sdf_mlp_launches``."""
    from ..train.step import advance_epoch, init_train_state, make_train_step
    tc = cfg.train
    n, B, P = tc.nepochs, tc.batch_size, tc.num_pixels
    sched = cfg.schedule
    data = SceneTensors(sc, device)
    n_pixels = sc["uv_full"].shape[0]
    state = init_train_state(cfg, seed=tc.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(tc.seed)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    steps = {}
    launches0 = sdf_mlp_launches()
    nonfinite = torch.zeros((), dtype=torch.int64, device=device)
    metrics = None
    windows = []
    t0 = win_t0 = time.perf_counter()
    win_dirty = False
    for epoch in range(n):
        tp = epoch / n
        ph = sched.phase_index(tp)
        if ph not in steps:
            log(f"phase {ph} step (epoch {epoch})...")
            steps[ph] = make_train_step(cfg, ph)
            win_dirty = True
        sel, views = epoch_plan(rng, n_pixels, P, N_VIEWS - 1, B)
        metrics = steps[ph](state, data.batch(sel, views),
                            sched.weights(tp), gen)
        advance_epoch(state)
        nonfinite += (~torch.isfinite(metrics["grad_norm"])).long()
        if (epoch + 1) % WIN == 0:
            sync()
            dt = time.perf_counter() - win_t0
            windows.append((epoch, dt / WIN * 1e3, WIN * B * P / dt,
                            not win_dirty))
            log(f"window to epoch {epoch}: {dt / WIN * 1e3:.1f} ms/step, "
                f"{WIN * B * P / dt:.0f} rays/s"
                + ("" if not win_dirty else " (holds a phase's first step)"))
            win_t0 = time.perf_counter()
            win_dirty = False
        if epoch % 100 == 0 or epoch == n - 1:
            m = {k: float(metrics[k]) for k in LOGGED}
            log(f"[{epoch}] phase {ph} " +
                " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    sync()
    train_s = time.perf_counter() - t0
    rays_s = n * B * P / train_s
    clean = [w[2] for w in windows if w[3]]
    med = float(np.median(clean)) if clean else rays_s
    log(f"trained {n} epochs in {train_s:.0f}s ({rays_s:.0f} rays/s incl "
        f"host batching and first calls; median window rate {med:.0f} "
        f"rays/s over {len(clean)} clean windows)")
    return state.net, {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "nonfinite": int(nonfinite), "train_s": train_s,
        "rays_per_s": rays_s, "windows": windows,
        "median_window_rays_per_s": med,
        "sdf_mlp_launches": sdf_mlp_launches() - launches0}


def surface_points(rng, n=N_GT):
    """n points of the ground-truth sphere, drawn from ``rng``."""
    p = rng.normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True) * RADIUS


def cube_points(rng, n=N_INDICATOR):
    """n float32 points uniform in [-1, 1]^3, drawn from ``rng``."""
    return rng.uniform(-1, 1, (n, 3)).astype(np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


@torch.no_grad()
def evaluate(cfg, net, sc, rng, device, resolution=160, pallas=True,
             out=None, log=print):
    """The trained field's quality, as the JAX script measures it: the
    mesh of the ``resolution``^3 grid over BOUNDS (through the sdf_mlp
    kernel with ``pallas``) scored by ``dtu_style_eval`` against N_GT
    points of the sphere drawn from ``rng``; the masked PSNR of the
    held-out view rendered in PSNR_CHUNK-ray chunks; the surface
    indicator's accuracy at the median logit of N_INDICATOR sphere points
    and as many cube points drawn from ``rng`` after them. Full f32 (TF32
    off). Writes ``surface.obj`` and the held-out PNGs into ``out`` when
    given. Returns the summary's quality keys, unrounded, with
    ``verts``/``faces`` (the mesh), ``grid_s`` and ``launches`` (sdf_mlp
    launches of the grid and of the held-out render) beside them."""
    from ..data.featext import tf32_off
    from ..data.png import write_png
    from ..eval.chamfer import dtu_style_eval
    from ..eval.cli import grid_sdf_fn
    from ..eval.marching import extract_mesh
    from ..eval.mesh import save_obj
    from ..eval.psnr import masked_psnr
    from ..fields.sdf import implicit_apply
    from ..rendering.renderer import render_forward
    with tf32_off():
        l0 = sdf_mlp_launches()
        t0 = time.perf_counter()
        verts, faces = extract_mesh(grid_sdf_fn(net, pallas),
                                    resolution=resolution, bounds=BOUNDS,
                                    device=device)
        grid_s = time.perf_counter() - t0
        grid_launches = sdf_mlp_launches() - l0
        if out:
            save_obj(os.path.join(out, "surface.obj"), verts, faces)
        gt_pts = surface_points(rng)
        ch = dtu_style_eval(verts, faces, gt_pts, n_samples=CHAMFER_SAMPLES,
                            max_dist=CHAMFER_MAX_DIST, bbox=BBOX)

        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        HW = sc["uv_full"].shape[0]
        H = W = int(round(HW ** 0.5))
        rows = []
        l0 = sdf_mlp_launches()
        for s in range(0, HW, PSNR_CHUNK):
            sel = slice(s, min(s + PSNR_CHUNK, HW))
            inputs = {"uv": put(sc["uv_full"][sel][None]),
                      "intrinsics": put(sc["intrinsics"][HELD_OUT][None]),
                      "pose": put(sc["pose"][HELD_OUT][None]),
                      "object_mask": put(sc["mask_full"][HELD_OUT][sel][None])}
            o = render_forward(cfg.model, net, inputs, training=False)
            rows.append(o.rgb_values[0].cpu().numpy())
        render_launches = sdf_mlp_launches() - l0
        pred = (np.concatenate(rows, 0).reshape(H, W, 3) + 1) / 2
        gt_img = (sc["rgb_full"][HELD_OUT].reshape(H, W, 3) + 1) / 2
        mask = sc["mask_full"][HELD_OUT].reshape(H, W, 1)
        psnr = masked_psnr(pred * mask, gt_img * mask, mask)
        if out:
            u8 = lambda a: (np.clip(a, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(out, "heldout_pred.png"), u8(pred))
            write_png(os.path.join(out, "heldout_gt.png"), u8(gt_img))

        # the indicator logit should be higher on the true surface than at
        # random cube points (it drives the mesh cut's confidences)
        logit = lambda x: implicit_apply(
            net.implicit, put(np.asarray(x, np.float32)))[..., 1].cpu() \
            .numpy()
        on_l = logit(gt_pts[:N_INDICATOR])
        off_l = logit(cube_points(rng))
    thresh = np.median(np.concatenate([on_l, off_l]))
    ind_acc = 0.5 * ((on_l > thresh).mean() + (off_l <= thresh).mean())
    log(f"mesh {len(verts)} verts {len(faces)} faces ({resolution}^3 grid "
        f"{grid_s:.2f} s, {grid_launches} sdf_mlp launches; the held-out "
        f"render {render_launches}); chamfer "
        f"{ch['overall']:.5f}; held-out PSNR {psnr:.2f}; indicator "
        f"accuracy {ind_acc:.3f}")
    return {
        "chamfer_accuracy": ch["accuracy"],
        "chamfer_completeness": ch["completeness"],
        "chamfer_overall": ch["overall"],
        "heldout_psnr": psnr,
        "mesh_verts": int(len(verts)),
        "indicator_acc": float(ind_acc),
        # the surface mode's absolute calibration, not only its separation
        "indicator_sigmoid_on_med": float(np.median(_sigmoid(on_l))),
        "indicator_sigmoid_off_med": float(np.median(_sigmoid(off_l))),
        "verts": verts, "faces": faces, "grid_s": grid_s,
        "launches": {"grid": grid_launches, "render": render_launches}}


def summarize(args, sup, stats, quality, device) -> dict:
    """The JAX script's summary keys, in its order, from the run's
    arguments, supervised tiers, ``train``'s stats and ``evaluate``'s
    quality; then ``device``, ``matmul_precision`` and
    ``sdf_mlp_launches`` (training, grid, held-out render)."""
    summary = {
        "epochs": args.epochs,
        "seed": args.seed,
        "plane_r": args.plane_r,
        "focal_mult": args.focal_mult,
        "supervised_cascade": list(sup),
        "rays_per_s_incl_host": round(stats["rays_per_s"], 1),
        "median_window_rays_per_s": round(
            stats["median_window_rays_per_s"], 1),
        "final_loss": round(stats["metrics"]["loss"], 4),
        "nonfinite_epochs": stats["nonfinite"],
        **{k: round(quality[k], ROUNDING[k]) if k in ROUNDING
           else quality[k] for k in SUMMARY_KEYS if k in quality},
    }
    summary = {k: summary[k] for k in SUMMARY_KEYS}
    cuda = device.type == "cuda"
    summary.update(
        device=torch.cuda.get_device_name(device) if cuda else "cpu",
        matmul_precision=("tf32" if cuda and args.precision != "highest"
                          else "f32"),
        sdf_mlp_launches={"train": stats["sdf_mlp_launches"],
                          **quality["launches"]})
    return summary


def run(args, log=print):
    """The whole validation for parsed ``args``: (summary, training
    stats). The summary holds the JAX script's keys in its order, then
    ``device``, ``matmul_precision`` and ``sdf_mlp_launches`` (training,
    grid, held-out render)."""
    from ..data.synthetic import make_scene_shaded
    from ..device import resolve_device
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    os.makedirs(args.out, exist_ok=True)
    log(f"building the shaded scene and its features on {device}...")
    sc = make_scene_shaded(n=N_VIEWS, img_hw=IMG_HW, n_pix=args.n_pix,
                           sphere_radius=RADIUS,
                           focal=args.focal_mult * IMG_HW,
                           plane_r=args.plane_r, device=device)
    cfg, sup = make_config(args, sc, log)
    rng = np.random.default_rng(args.seed)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = args.precision != "highest"
    try:
        net, stats = train(cfg, sc, rng, device, log)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    q = evaluate(cfg, net, sc, rng, device, args.resolution,
                 pallas=not args.no_pallas, out=args.out, log=log)
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
               os.path.join(args.out, "params.pt"))
    summary = summarize(args, sup, stats, q, device)
    stats["grid_s"] = q["grid_s"]
    return summary, stats


def main(argv=None):
    summary, _ = run(parse_args(argv),
                     log=lambda m: print(m, flush=True))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
