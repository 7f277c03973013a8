"""Evaluation CLI (port of ``mvsdf_tpu/eval/cli.py``; same flags, output
files and printed lines): mesh extraction, optional rendering PSNR and DTU
chamfer from a checkpoint of the training CLI.

    python -m mvsdf_tpu_torch.eval.cli --data_dir DATA --expname NAME \\
        [--resolution 512] [--eval_rendering] [--pallas] [--eval_cameras]

Runs on the GPU unless ``--platform cpu`` is given; without a GPU and
without that flag it raises. Its matmuls run in full f32 (TF32 off): the
grid and the PSNR are measurements. Under ``--pallas`` the SDF grid goes
through the hand-written SDF-MLP kernel (``sdf_mlp``, the positional
encoding computed outside it) and the rendering paths trace through it
too; without it the plain field serves both, as in the JAX package. The
surface is triangulated by the native C++ triangulator, which raises if it
cannot be built or run. ``--eval_cameras`` scores a ``--train_cameras``
checkpoint's poses against the ground truth, extracts the mesh into the
ground-truth frame through the cameras' similarity, and renders with the
optimised poses. ``main`` returns what it measured (see ``EvalResult``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

CHUNK_VERTS = 1 << 20   # vertices a colour evaluation of the field takes


@dataclasses.dataclass
class EvalResult:
    """What ``main`` produced: the checkpoint's epoch, the SDF grid the
    mesh was extracted from, the mesh (world coordinates, after the
    component cleanup) and its colours, the per-view PSNRs, wall times in
    seconds (``grid_s``, ``triangulate_s``, ``render_s`` a view), and under
    --eval_cameras ``eval.cameras.camera_accuracy``'s dict."""
    epoch: int
    grid: Optional[np.ndarray] = None
    verts: Optional[np.ndarray] = None
    faces: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    psnrs: List[float] = dataclasses.field(default_factory=list)
    timings: dict = dataclasses.field(default_factory=dict)
    cameras: Optional[dict] = None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="mvsdf evaluation "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--expname", default="mvsdf")
    ap.add_argument("--exps_folder", default="exps")
    ap.add_argument("--evals_folder", default="evals")
    ap.add_argument("--timestamp", default="latest")
    ap.add_argument("--checkpoint", default="latest")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--eval_rendering", action="store_true")
    ap.add_argument("--chunk_pixels", type=int, default=10000)
    ap.add_argument("--render_mode", action="store_true",
                    help="high-quality tracing (dist clip 0.05, 40 iters; "
                         "the reference's IDR_RENDER=1) and skip the mesh")
    ap.add_argument("--only_cam", default="",
                    help="free-viewpoint rendering: path to a cameras npz "
                         "(world_mat_i/scale_mat_i); renders those views "
                         "without images (the reference's IDR_ONLY_CAM=1)")
    ap.add_argument("--only_cam_size", default="",
                    help="HxW output resolution for --only_cam")
    ap.add_argument("--pallas", action="store_true",
                    help="the hand-written SDF-MLP kernel for the grid SDF "
                         "evaluation and for the ray trace in the rendering "
                         "paths")
    ap.add_argument("--eval_cameras", action="store_true",
                    help="evaluate optimized camera poses against GT "
                         "(requires a --train_cameras checkpoint; the "
                         "reference's --eval_cameras, eval.py:26-104): "
                         "prints R/t errors, aligns the mesh by the "
                         "camera similarity, renders with optimized poses")
    ap.add_argument("--keep_all_components", action="store_true",
                    help="skip the biggest-connected-component cleanup "
                         "(the reference always keeps only the biggest, "
                         "eval.py:120 — correct when the object touches "
                         "the table; use this for floating objects)")
    ap.add_argument("--platform", default="", choices=["", "cpu", "cuda",
                                                       "gpu"],
                    help="'cpu' runs on the CPU; the default is the GPU")
    ap.add_argument("--conf", default="",
                    help="HOCON config matching the trained checkpoint")
    ap.add_argument("--dtu_stl", default="",
                    help="official-protocol DTU chamfer: path to the scan's "
                         "ground-truth STL point cloud (.ply); evaluates "
                         "the extracted world-coordinates mesh")
    ap.add_argument("--dtu_obsmask", default="",
                    help="ObsMask<scan>_10.mat for the observability-grid "
                         "crop (optional but required for protocol parity)")
    ap.add_argument("--dtu_plane", default="",
                    help="Plane<scan>.mat ground-plane filter for "
                         "completeness (optional)")
    ap.add_argument("--dtu_max_dist", type=float, default=20.0)
    ap.add_argument("--dtu_downsample", type=float, default=0.2,
                    help="densify/downsample density in mm")
    return ap.parse_args(argv)


def grid_sdf_fn(net, pallas: bool):
    """The SDF the mesh grid is evaluated with: points (..., 3) -> (...,).
    With ``pallas`` the ``sdf_mlp`` kernel on the packed weights (the
    positional encoding computed outside it), else the plain field."""
    from ..fields.embedder import positional_encoding
    from ..fields.sdf import sdf_apply
    from ..tracing.kernels.sdf_mlp import pack_sdf_weights, sdf_mlp
    if not pallas:
        return lambda x: sdf_apply(net.implicit, x)
    packed = pack_sdf_weights(net.implicit)
    multires = net.implicit.cfg.multires

    def sdf(x):
        pe = positional_encoding(x.reshape(-1, 3), multires)
        return sdf_mlp(packed, pe).reshape(x.shape[:-1])
    return sdf


@torch.no_grad()
def surface_colors(net, verts: np.ndarray, world: np.ndarray,
                   device) -> np.ndarray:
    """Surface-indicator vertex colours (ref plots.py:179-203): red = 1 - s,
    green = s, with s the sigmoid of the indicator logit at the vertex
    mapped back into the unit frame."""
    from ..fields.sdf import implicit_apply
    vu = (verts - world[:3, 3]) @ np.linalg.inv(world[:3, :3]).T
    x = torch.from_numpy(np.ascontiguousarray(vu, np.float32)).to(device)
    surf = torch.cat([torch.sigmoid(implicit_apply(net.implicit, c)[..., 1])
                      for c in x.split(CHUNK_VERTS)]).cpu().numpy()
    return np.stack([1 - surf, surf, np.zeros_like(surf)], -1)


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def _to_u8(rgb: np.ndarray) -> np.ndarray:
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def main(argv=None) -> EvalResult:
    args = parse_args(argv)
    if args.platform != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --platform "
                           "cpu to run on the CPU")
    device = torch.device("cpu" if args.platform == "cpu" else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("matmul precision: full f32 (TF32 off)")

    from ..config import MVSDFConfig
    from ..data.png import write_png
    from ..rendering.renderer import render_view
    from ..data.scene import SceneData
    from ..fields.network import MVSDFNetwork
    from ..train import checkpoints as ckpt
    from .marching import eval_sdf_grid, mesh_from_grid
    from .mesh import biggest_component, save_obj
    from .psnr import masked_psnr

    if args.conf:
        from ..hocon import config_from_hocon
        cfg = config_from_hocon(args.conf)
    else:
        cfg = MVSDFConfig()
    model = cfg.model
    if args.pallas:
        # the trace of the rendering paths through the SDF-MLP kernel too;
        # it only locates surface points, rgb is evaluated in f32
        model = _replace(model, use_pallas_trace=True)
    if args.render_mode:
        # ref ray_tracing.py:127-131 + eval.py:106-107
        model = _replace(model, tracer=_replace(
            model.tracer, dist_clip=0.05, sphere_tracing_iters=40))
    exp_base = os.path.join(args.exps_folder, args.expname)
    stamp = args.timestamp
    if stamp == "latest":
        stamp = sorted(os.listdir(exp_base))[-1]
    ckpt_dir = os.path.join(exp_base, stamp, "checkpoints")
    evaldir = os.path.join(args.evals_folder, args.expname)
    os.makedirs(evaldir, exist_ok=True)

    net = MVSDFNetwork(model.implicit, model.render).to(device)
    step = None if args.checkpoint == "latest" else int(args.checkpoint)
    tree, _ = ckpt.load_checkpoint(ckpt_dir, step, map_location=device)
    net.load_state_dict(tree["net"])
    result = EvalResult(epoch=int(tree["epoch"]))
    epoch = result.epoch

    if args.only_cam:
        _render_only_cam(args, model, net, evaldir, device)
        return result

    scene = SceneData(args.data_dir, load_features=False, device=device)

    # --- camera accuracy + mesh alignment (ref eval.py:89-106) -----------
    cams_transformation = None
    opt_poses = None
    if args.eval_cameras:
        if tree.get("pose_vecs") is None:
            raise ValueError("--eval_cameras needs a checkpoint trained "
                             "with --train_cameras (no pose_vecs found)")
        from ..geometry.cameras import quat_to_rot
        from .cameras import camera_accuracy
        opt_poses = tree["pose_vecs"]          # (n, 7) rows, on the device
        pv = opt_poses.detach().cpu()
        pred_Rs = quat_to_rot(pv[:, :4]).numpy()
        pred_ts = pv[:, 4:].numpy().astype(np.float64)
        gt_pose = scene.get_gt_pose()
        acc = camera_accuracy(pred_Rs, pred_ts,
                              gt_pose[:, :3, :3], gt_pose[:, :3, 3])
        result.cameras = acc
        msg = ("CAMERAS EVALUATION: R error mean = %.2f ; t error mean = "
               "%.2f ; R error median = %.2f ; t error median = %.2f" % (
                   acc["R_errors_deg"].mean(), acc["t_errors"].mean(),
                   np.median(acc["R_errors_deg"]),
                   np.median(acc["t_errors"])))
        print(msg)
        with open(os.path.join(evaldir, "cameras.txt"), "w") as f:
            f.write(msg + "\n")
        cams_transformation = np.eye(4)
        cams_transformation[:3, :3] = acc["scale"] * acc["R_opt"]
        cams_transformation[:3, 3] = acc["t_opt"]

    # --- mesh extraction (ref eval.py:109-125) ---------------------------
    if not args.render_mode:
        # with optimised cameras the mesh lives in the training frame: the
        # cameras' similarity maps it to the ground truth's (ref
        # eval.py:116-123)
        world = (cams_transformation if cams_transformation is not None
                 else scene.get_scale_mat())
        t0 = time.perf_counter()
        vol = eval_sdf_grid(grid_sdf_fn(net, args.pallas),
                            resolution=args.resolution, device=device)
        t1 = time.perf_counter()
        verts, faces = mesh_from_grid(vol, scale_mat=world)
        result.timings.update(grid_s=t1 - t0,
                              triangulate_s=time.perf_counter() - t1)
        if not args.keep_all_components:
            verts, faces = biggest_component(verts, faces)
        colors = surface_colors(net, verts, world, device)
        result.grid = vol
        result.verts, result.faces, result.colors = verts, faces, colors
        out_obj = os.path.join(evaldir,
                               f"surface_world_coordinates_{epoch}.obj")
        save_obj(out_obj, verts, faces, colors)
        print(f"mesh: {len(verts)} verts {len(faces)} faces -> {out_obj}")
        # interactive scene artifact: mesh w/ indicator colors + cameras
        from .html_viewer import write_scene_html
        world_poses = np.asarray(scene.poses).copy()
        world_poses[:, :3, 3] = (world_poses[:, :3, 3]
                                 @ world[:3, :3].T) + world[:3, 3]
        world_poses[:, :3, :3] = np.einsum(
            "ij,njk->nik", world[:3, :3], world_poses[:, :3, :3])
        out_html = os.path.join(evaldir, f"scene_{epoch}.html")
        write_scene_html(out_html, verts, faces, poses=world_poses,
                         vert_colors=colors, title=args.expname)
        print(f"interactive scene -> {out_html}")

        # --- official DTU protocol chamfer (ref README.md:78-79) ---------
        if args.dtu_stl:
            from ..data.convert import load_ply_points
            from .dtu_eval import (dtu_official_eval_mesh, load_obs_mask,
                                   load_ground_plane)
            stl = load_ply_points(args.dtu_stl)
            mask_kw = {}
            if args.dtu_obsmask:
                m, bb, res = load_obs_mask(args.dtu_obsmask)
                mask_kw.update(obs_mask=m, bb=bb, res=res)
            if args.dtu_plane:
                mask_kw.update(
                    ground_plane=load_ground_plane(args.dtu_plane))
            dtu = dtu_official_eval_mesh(
                verts, faces, stl, thresh=args.dtu_downsample,
                max_dist=args.dtu_max_dist, **mask_kw)
            msg = (f"DTU EVALUATION {args.expname}: accuracy = "
                   f"{dtu['accuracy']:.4f} ; completeness = "
                   f"{dtu['completeness']:.4f} ; overall = "
                   f"{dtu['overall']:.4f}")
            print(msg)
            with open(os.path.join(evaldir, "chamfer.txt"), "w") as f:
                f.write(msg + "\n")

    # --- rendering eval (ref eval.py:127-185) ----------------------------
    if args.eval_rendering:
        images_dir = os.path.join(evaldir, "rendering")
        os.makedirs(images_dir, exist_ok=True)
        H, W = scene.img_res
        chunk = min(args.chunk_pixels, scene.total_pixels)
        if args.pallas:
            # the JAX package's eval-mode capacities, carried over (they
            # change no result here)
            from ..tracing.sphere_trace import (auto_march_schedule,
                                                ray_intersect_fraction)
            uv_all = np.broadcast_to(
                scene.uv[None], (scene.n_images,) + scene.uv.shape)
            isect = ray_intersect_fraction(uv_all, scene.intrinsics,
                                           scene.poses)
            sched = auto_march_schedule(1.0, intersect_frac=isect)
            model = _replace(model, tracer=_replace(
                model.tracer, sampler_capacity_frac=(0.0625, 0.25),
                march_compact_schedule=sched))
            print(f"render compaction: sampler (0.0625, 0.25), march "
                  f"{sched} (intersect {isect:.3f})")
        uv = torch.from_numpy(scene.uv).to(device)
        mask_src = (scene.perfect_masks if scene.perfect_masks
                    is not None else scene.masks)
        result.timings["render_s"] = []
        for idx in range(scene.n_images):
            t0 = time.perf_counter()
            pose = (opt_poses[idx:idx + 1] if opt_poses is not None
                    else torch.from_numpy(scene.poses[idx:idx + 1]).to(
                        device))
            rgb = render_view(
                model, net, uv,
                torch.from_numpy(scene.intrinsics[idx:idx + 1]).to(device),
                pose, torch.from_numpy(scene.masks[idx]).to(device), chunk)
            result.timings["render_s"].append(time.perf_counter() - t0)
            rgb = (rgb.reshape(H, W, 3) + 1) / 2
            write_png(os.path.join(images_dir, f"eval_{idx:03d}.png"),
                      _to_u8(rgb))
            mask = mask_src[idx].reshape(H, W, 1)
            gt = (scene.rgb[idx].reshape(H, W, 3) + 1) / 2
            result.psnrs.append(masked_psnr(rgb * mask, gt * mask, mask))
        psnrs = result.psnrs
        msg = (f"RENDERING EVALUATION {args.expname}: psnr mean = "
               f"{np.mean(psnrs):.2f} ; psnr std = {np.std(psnrs):.2f}")
        print(msg)
        with open(os.path.join(evaldir, "psnr.txt"), "w") as f:
            f.write(msg + "\n")
    return result


def _render_only_cam(args, model, net, evaldir, device):
    """Free-viewpoint rendering from a cameras-only npz (the reference's
    IDR_ONLY_CAM dataset mode, scene_dataset.py:26-56)."""
    from ..data.png import write_png
    from ..geometry.cameras import decompose_projection
    from ..rendering.renderer import render_view

    H, W = (int(v) for v in args.only_cam_size.split(","))
    cams = np.load(args.only_cam)
    n = len([k for k in cams.files if k.startswith("world_mat_")])
    out_dir = os.path.join(evaldir, "rendering2")
    os.makedirs(out_dir, exist_ok=True)
    uv = torch.from_numpy(np.stack(np.meshgrid(np.arange(W), np.arange(H)),
                                   -1).reshape(-1, 2).astype(np.float32)
                          ).to(device)
    mask = torch.ones(H * W, dtype=torch.bool, device=device)
    chunk = min(args.chunk_pixels, H * W)
    for i in range(n):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        intr, pose = decompose_projection(P)
        rgb = render_view(model, net, uv,
                          torch.from_numpy(intr[None]).to(device),
                          torch.from_numpy(pose[None]).to(device), mask,
                          chunk)
        rgb = (rgb.reshape(H, W, 3) + 1) / 2
        write_png(os.path.join(out_dir, f"eval_{i:03d}.png"), _to_u8(rgb))
    print(f"rendered {n} free viewpoints -> {out_dir}")


if __name__ == "__main__":
    main()
