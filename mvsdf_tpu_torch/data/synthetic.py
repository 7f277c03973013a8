"""Synthetic multi-view scenes (numpy): pinhole cameras on a ring looking at
the origin, a unit-scale scene (size=2, center=0), depth maps of a sphere.

- ``make_scene``: one batch in memory, with smooth random frozen feature
  maps. The same generator as the JAX package's test fixture
  ``tests/golden/scene_fixtures.make_scene``, so one seed gives both
  packages the same data; it is also the scene of the JAX package's
  ``bench.py``.
- ``write_scene_dir``: a scene directory on disk in the reference layout,
  with rendered images, for ``data/scene.SceneData`` and the training CLI;
  ``write_pose_init`` adds perturbed initial cameras to one, for camera
  optimisation.
- ``write_vismvsnet_dir``: a Vis-MVSNet output directory, the input of
  ``data/convert.py``.
- ``make_scene_fibonacci`` and ``make_scene_shaded``: the coherent scenes
  of the JAX package's ``tests/golden/scene_fixtures.py`` (cameras on a
  fibonacci sphere, then a frontal cap looking at a textured lambertian
  sphere on a ground plane, rendered by ``render_shaded_sphere``), with
  frozen FeatExt features computed from the rendered images on a device;
  the scene ``validation/full_training.py`` trains on.
- ``write_shaded_scene_dir`` and ``python -m mvsdf_tpu_torch.data.synthetic``:
  that scene as a scene directory, the counterpart of the JAX repo's
  ``scripts/make_synthetic_scene.py`` (same flags, same files).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def look_at_extrinsic(cam_pos, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """World-to-camera 4x4 extrinsic of a camera at cam_pos facing
    target."""
    c = np.asarray(cam_pos, np.float64)
    z = np.asarray(target, np.float64) - c
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])  # world -> cam rows
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ c
    return E


def _conv2(img, k):
    """Same-size 2D convolution with symmetric boundary."""
    from scipy.signal import convolve2d
    return convolve2d(img, k, mode="same", boundary="symm").astype(np.float32)


def make_scene(n_images=2, n_src=2, img_hw=64, depth_hw=32, n_pix=64,
               seed=0, feat_ch=32, sphere_radius=0.6, focal=60.0,
               two_rings=False):
    """Returns a dict of float32 numpy arrays: the render inputs (uv,
    intrinsics, pose, object_mask) and the ground truth (rgb, depths,
    depth_cams, cam, src_cams, feat, feat_src, size, center)."""
    rng = np.random.default_rng(seed)
    B = n_images
    H = W = img_hw
    h = w = depth_hw

    angles = np.linspace(0, 2 * np.pi, B + n_src, endpoint=False)
    ys = (np.where(np.arange(B + n_src) % 2 == 0, 0.9, -0.5)
          if two_rings else 0.35 * np.ones(B + n_src))
    rad = np.sqrt(np.maximum(2.2 ** 2 - ys ** 2, 0.5))
    cam_pos = np.stack([rad * np.sin(angles), ys, rad * np.cos(angles)], -1)
    extr = np.stack([look_at_extrinsic(p) for p in cam_pos])

    K_hd = np.array([[float(focal), 0, W / 2], [0, float(focal), H / 2],
                     [0, 0, 1.0]])
    K_d = K_hd.copy()
    K_d[0] *= h / H
    K_d[1] *= h / H

    def mvs_cam(E, K):
        cam = np.zeros((2, 4, 4))
        cam[0] = E
        cam[1][:3, :3] = K
        return cam

    depth_cams = np.stack([mvs_cam(extr[i], K_d) for i in range(B)])
    cams_hd = np.stack([mvs_cam(extr[i], K_hd) for i in range(B + n_src)])
    for c in cams_hd:  # feature cams = 2x depth cams (feat_img_scale=2)
        c[1][:3, :3] = K_d * 2
        c[1][2, 2] = 1.0

    intrinsics = np.tile(np.eye(4), (B, 1, 1))
    intrinsics[:, :3, :3] = K_hd
    pose = np.stack([np.linalg.inv(extr[i]) for i in range(B)])

    depths = np.zeros((B, 1, 1, h, w), np.float32)
    for i in range(B):
        ys_, xs = np.mgrid[0:h, 0:w]
        pix = np.stack([xs + 0.5, ys_ + 0.5, np.ones_like(xs)],
                       -1).reshape(-1, 3).astype(np.float64)
        dirs_cam = (np.linalg.inv(K_d) @ pix.T).T
        dirs_w = dirs_cam @ extr[i][:3, :3]
        dirs_w /= np.linalg.norm(dirs_w, axis=-1, keepdims=True)
        o = cam_pos[i]
        b = dirs_w @ o
        disc = b ** 2 - (o @ o - sphere_radius ** 2)
        tq = -b - np.sqrt(np.maximum(disc, 0))
        z = tq * (dirs_cam @ np.array([0, 0, 1.0])) / np.linalg.norm(
            dirs_cam, axis=-1)
        depths[i, 0, 0] = np.where(disc > 0, z, 0.0).reshape(h, w)

    uv_full = np.stack(np.meshgrid(np.arange(W), np.arange(H)),
                       -1).reshape(-1, 2).astype(np.float32)
    sel = rng.permutation(H * W)[:n_pix]
    uv = np.tile(uv_full[sel][None], (B, 1, 1))

    base = rng.normal(size=(feat_ch, h, w)).astype(np.float32)
    k = np.ones((5, 5), np.float32) / 25.0
    base = np.stack([_conv2(c, k) for c in base])
    feat = np.stack([base + 0.4 * rng.normal(
        size=base.shape).astype(np.float32) for _ in range(B)])
    feat_src = np.stack([np.stack([base + 0.4 * rng.normal(
        size=base.shape).astype(np.float32) for _ in range(n_src)])
        for _ in range(B)])
    src_cams = np.stack([cams_hd[B:][:n_src] for _ in range(B)])

    return dict(
        uv=uv.astype(np.float32),
        intrinsics=intrinsics.astype(np.float32),
        pose=pose.astype(np.float32),
        object_mask=np.ones((B, n_pix), bool),
        rgb=rng.uniform(-1, 1, (B, n_pix, 3)).astype(np.float32),
        depths=depths,
        depth_cams=depth_cams.astype(np.float32).reshape(B, 1, 2, 4, 4),
        cam=cams_hd[:B].astype(np.float32),
        src_cams=src_cams.astype(np.float32),
        feat=feat,
        feat_src=feat_src,
        size=np.full((B,), 2.0, np.float32),
        center=np.zeros((B, 3), np.float32),
    )


def scene_to_torch(scene, device) -> dict:
    """The scene's arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in scene.items()}


def _hw(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def render_ring_view(extr, K, hw, cam_pos, sphere_radius):
    """One view of the ring scene's sphere: (rgb (H, W, 3) uint8, silhouette
    (H, W) bool, z-depth (H, W) float32, 0 off the sphere). The sphere's
    albedo varies with its normal, lit from a fixed direction; the
    background is a smooth gradient."""
    H, W = hw
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1).reshape(-1, 3)
    dirs_cam = pix @ np.linalg.inv(K).T.astype(np.float32)
    dirs_w = dirs_cam @ extr[:3, :3].astype(np.float32)
    dirs_w /= np.linalg.norm(dirs_w, axis=-1, keepdims=True)
    o = np.asarray(cam_pos, np.float32)
    b = dirs_w @ o
    disc = b ** 2 - (o @ o - sphere_radius ** 2)
    hit = disc > 0
    tq = -b - np.sqrt(np.maximum(disc, 0))
    z = np.where(hit, tq * dirs_cam[:, 2] / np.linalg.norm(dirs_cam, axis=-1),
                 0)
    n = (o + tq[:, None] * dirs_w) / sphere_radius
    albedo = np.stack([0.55 + 0.4 * np.sin(6 * n[:, 0]),
                       0.5 + 0.4 * np.sin(6 * n[:, 1] + 1),
                       0.5 + 0.4 * np.cos(5 * n[:, 2])], -1)
    light = np.array([0.3, 0.8, 0.5], np.float32)
    shade = 0.3 + 0.7 * np.clip(n @ (light / np.linalg.norm(light)), 0, None)
    u, v = pix[:, 0] / W, pix[:, 1] / H
    bg = np.stack([0.2 + 0.3 * u, 0.25 + 0.2 * v, 0.35 + 0.1 * u * v], -1)
    rgb = np.where(hit[:, None], albedo * shade[:, None], bg)
    rgb = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return (rgb.reshape(H, W, 3), hit.reshape(H, W),
            z.astype(np.float32).reshape(H, W))


def _rotation(axis, angle):
    """Rodrigues: the rotation by ``angle`` radians about unit ``axis``."""
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def write_pose_init(data_dir, deg, frac, seed=0):
    """Writes ``cameras_linear_init.npz`` beside a scene directory's
    ``cameras_hd.npz``, with the keys and layout the scene loaders read
    (``world_mat_i``, ``scale_mat_i``): each ground-truth camera turned by
    ``deg`` degrees about a random axis, and its centre moved by ``frac``
    times its distance from the world origin in a random direction, drawn
    from ``np.random.default_rng(seed)``. Returns the file's path."""
    from ..geometry.cameras import decompose_projection
    cams = np.load(os.path.join(data_dir, "cameras_hd.npz"))
    n = sum(k.startswith("world_mat_") for k in cams.files)
    rng = np.random.default_rng(seed)
    unit = lambda v: v / np.linalg.norm(v)
    out = {}
    for i in range(n):
        K, pose = decompose_projection(cams[f"world_mat_{i}"][:3, :4])
        R = _rotation(unit(rng.normal(size=3)), np.radians(deg)) @ \
            pose[:3, :3]
        c = pose[:3, 3] + frac * np.linalg.norm(pose[:3, 3]) * unit(
            rng.normal(size=3))
        P = np.eye(4)
        P[:3, :3] = K[:3, :3] @ R.T
        P[:3, 3] = -K[:3, :3] @ R.T @ c
        out[f"world_mat_{i}"] = P.astype(np.float32)
        out[f"scale_mat_{i}"] = cams[f"scale_mat_{i}"]
    path = os.path.join(data_dir, "cameras_linear_init.npz")
    np.savez(path, **out)
    return path


def write_scene_dir(root, n_images=3, img_hw=32, depth_hw=16,
                    sphere_radius=0.5, pose_noise=None):
    """Writes a scene directory in the reference layout under ``root``
    (``scene/image_hd/``, ``scene/mask_hd/``, ``scene/depth/*.pfm``,
    ``scene/cameras_hd.npz``, ``pair.txt``, ``cam_*_flow3.txt``) and returns
    its ``scene`` path. Cameras on a ring at distance 2.2 look at a sphere
    of ``sphere_radius``; the images are renders of it, the masks its
    silhouette, the depth maps its depth at ``depth_hw``. Sizes are ints
    (square) or (H, W). Each view's source views are its ring neighbours.
    ``pose_noise=(deg, frac)`` also writes perturbed initial cameras
    (``write_pose_init``).
    """
    from . import formats
    from .png import write_png
    data_dir = os.path.join(root, "scene")
    for sub in ("image_hd", "mask_hd", "depth"):
        os.makedirs(os.path.join(data_dir, sub))
    H, W = _hw(img_hw)
    h, w = _hw(depth_hw)
    angles = np.linspace(0, 2 * np.pi, n_images, endpoint=False)
    cam_pos = np.stack([2.2 * np.sin(angles), 0.3 * np.ones_like(angles),
                        2.2 * np.cos(angles)], -1)
    extr = np.stack([look_at_extrinsic(p) for p in cam_pos])
    f = 30.0 * W / 32
    K_hd = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    K_d = K_hd.copy()
    K_d[0] *= w / W
    K_d[1] *= h / H

    cam_npz = {}
    pair = {"id_list": [str(i) for i in range(n_images)]}
    ring = lambda i, j: min((j - i) % n_images, (i - j) % n_images)
    for i in range(n_images):
        rgb, mask, _ = render_ring_view(extr[i], K_hd, (H, W), cam_pos[i],
                                        sphere_radius)
        write_png(os.path.join(data_dir, "image_hd", f"{i:03}.png"), rgb)
        write_png(os.path.join(data_dir, "mask_hd", f"{i:03}.png"),
                  mask.astype(np.uint8) * 255)
        _, _, z = render_ring_view(extr[i], K_d, (h, w), cam_pos[i],
                                   sphere_radius)
        formats.write_pfm(os.path.join(data_dir, "depth", f"{i:03}.pfm"), z)

        P = np.zeros((4, 4), np.float32)
        P[:3] = K_hd @ extr[i][:3]
        P[3, 3] = 1
        cam_npz[f"world_mat_{i}"] = P
        cam_npz[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)  # size 2

        cam = np.zeros((2, 4, 4))
        cam[0] = extr[i]
        cam[1][:3, :3] = K_d
        cam[1][3] = [0.5, 0.01, 256, 0.5 + 0.01 * 255]
        formats.write_cam(os.path.join(root, f"cam_{i:08}_flow3.txt"), cam)
        others = sorted((j for j in range(n_images) if j != i),
                        key=lambda j: ring(i, j))[:2]
        pair[str(i)] = {"id": str(i), "index": i,
                        "pair": [str(j) for j in others],
                        "score": [10.0 - k for k in range(len(others))]}
    np.savez(os.path.join(data_dir, "cameras_hd.npz"), **cam_npz)
    formats.write_pair(os.path.join(root, "pair.txt"), pair)
    if pose_noise is not None:
        write_pose_init(data_dir, *pose_noise)
    return data_dir


def write_vismvsnet_dir(root, n_views=3, hw=16, image_ext=".png",
                        write_image=None):
    """Writes a Vis-MVSNet output directory under ``root``, the input of
    ``data/convert.py``: ``pair.txt`` (each view paired with all the
    others, scores 100, 90, ...), ``cam_%08d_flow3.txt`` (cameras on a ring 2.5 from the origin, K
    at the depth maps' size), ``%08d<image_ext>`` random images at 4x the
    depth size, ``%08d_flow3.pfm`` depths uniform in [2, 3] at ``hw`` x
    ``hw``, ``%08d_flow{1,2,3}_prob.pfm`` probabilities at 1/4, 1/2 and 1x
    that size, as Vis-MVSNet writes them (0.95, and 0.05 on the left half
    of view 0's flow3 map and on the top-left quarter of view 1's flow1
    map), and an ascii ``cut.ply``, 500 points uniform in
    [-0.5, 0.5]^3. The draws follow the JAX package's test fixture
    (``tests/unit/test_convert.py``), from ``np.random.default_rng(0)``.
    The probabilities are 0.95 and 0.05 so that no bilinear sample of them
    lies near a threshold of 0.8 or 0.7. PNG images are written with
    ``png.write_png``; another format needs ``write_image(path, rgb)``.
    Returns (cams (n, 2, 4, 4), cut points)."""
    from . import formats
    from .convert import write_ply_points
    from .png import write_png
    if write_image is None:
        if image_ext != ".png":
            raise ValueError(f"no writer for {image_ext} images: pass "
                             f"write_image")
        write_image = write_png
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    ids = [str(i) for i in range(n_views)]
    pair = {"id_list": ids}
    for i in ids:
        srcs = [j for j in ids if j != i]
        pair[i] = {"id": i, "index": int(i), "pair": srcs,
                   "score": [100.0 - 10 * k for k in range(len(srcs))]}
    formats.write_pair(os.path.join(root, "pair.txt"), pair)
    cams = []
    for k in range(n_views):
        ang = 2 * np.pi * k / n_views
        R = np.array([[np.cos(ang), 0, np.sin(ang)],
                      [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = -R.T @ np.array([0, 0, 2.5])
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = -R @ c
        K = np.array([[hw * 1.2, 0, hw / 2, 0],
                      [0, hw * 1.2, hw / 2, 0],
                      [0, 0, 1, 0],
                      [1.0, 0.01, 256, 3.0]])  # depth min/interval/num/max
        cam = np.stack([E, K])
        cams.append(cam)
        stem = f"{k:08}"
        formats.write_cam(os.path.join(root, f"cam_{stem}_flow3.txt"), cam)
        img = rng.uniform(0, 255, (hw * 4, hw * 4, 3)).astype(np.uint8)
        write_image(os.path.join(root, stem + image_ext), img)
        depth = rng.uniform(2.0, 3.0, (hw, hw)).astype(np.float32)
        formats.write_pfm(os.path.join(root, f"{stem}_flow3.pfm"), depth)
        for s, div in zip((1, 2, 3), (4, 2, 1)):
            n = hw // div
            prob = np.full((n, n), 0.95, np.float32)
            if k == 0 and s == 3:
                prob[:, :n // 2] = 0.05
            if k == 1 and s == 1:
                prob[:n // 2, :n // 2] = 0.05
            formats.write_pfm(os.path.join(root, f"{stem}_flow{s}_prob.pfm"),
                              prob)
    pts = rng.uniform(-0.5, 0.5, (500, 3))
    write_ply_points(os.path.join(root, "cut.ply"), pts, binary=False)
    return np.stack(cams), pts


# ---------------------------------------------------------------------------
# The coherent shaded scene (counterpart of the JAX package's
# tests/golden/scene_fixtures.py, function for function)
# ---------------------------------------------------------------------------

def make_scene_fibonacci(n=10, img_hw=48, depth_hw=24, n_pix=192,
                         feat_ch=16, sphere_radius=0.45, focal=84.0,
                         seed=21):
    """``make_scene`` with n cameras on a fibonacci sphere (full angular
    coverage) at distance 2.2 and depth maps of the analytic sphere."""
    golden = (1 + 5 ** 0.5) / 2
    idx = np.arange(n)
    z = 1 - 2 * (idx + 0.5) / n
    th = 2 * np.pi * idx / golden
    r = np.sqrt(1 - z * z)
    cam_pos = 2.2 * np.stack([r * np.cos(th), z * 0.8, r * np.sin(th)], -1)

    sc = make_scene(n_images=n, n_src=2, img_hw=img_hw, depth_hw=depth_hw,
                    n_pix=n_pix, seed=seed, feat_ch=feat_ch,
                    sphere_radius=sphere_radius, focal=focal)
    f = focal
    extr = np.stack([look_at_extrinsic(p) for p in cam_pos])
    K = np.array([[f, 0, img_hw / 2], [0, f, img_hw / 2], [0, 0, 1.0]])
    Kd = K.copy()
    Kd[:2] *= depth_hw / img_hw
    sc["pose"] = np.stack([np.linalg.inv(e) for e in extr]).astype(
        np.float32)
    intr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    intr[:, :3, :3] = K
    sc["intrinsics"] = intr.astype(np.float32)
    dc = np.zeros((n, 1, 2, 4, 4), np.float32)
    for i in range(n):
        dc[i, 0, 0] = extr[i]
        dc[i, 0, 1, :3, :3] = Kd
    sc["depth_cams"] = dc
    h = w = depth_hw
    depths = np.zeros((n, 1, 1, h, w), np.float32)
    for i in range(n):
        ys, xs = np.mgrid[0:h, 0:w]
        pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)],
                       -1).reshape(-1, 3).astype(np.float64)
        dcam = (np.linalg.inv(Kd) @ pix.T).T
        dw = dcam @ extr[i][:3, :3]
        dw /= np.linalg.norm(dw, axis=-1, keepdims=True)
        o = cam_pos[i]
        b = dw @ o
        disc = b ** 2 - (o @ o - sphere_radius ** 2)
        tq = -b - np.sqrt(np.maximum(disc, 0))
        zz = tq * dcam[:, 2] / np.linalg.norm(dcam, axis=-1)
        depths[i, 0, 0] = np.where(disc > 0, zz, 0).reshape(h, w)
    sc["depths"] = depths
    return sc


def _sphere_texture(p, radius):
    """View-independent procedural albedo on the sphere surface, in
    [-1, 1]; p (..., 3) world points."""
    n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    r = 0.6 * np.sin(7 * n[..., 0]) * np.cos(5 * n[..., 1])
    g = 0.6 * np.sin(6 * n[..., 1] + 1.3) * np.cos(4 * n[..., 2])
    b = 0.6 * np.sin(5 * n[..., 2] + 2.1) * np.cos(6 * n[..., 0])
    return np.stack([r, g, b], -1)


def render_shaded_sphere(cam_pos, extr, K, hw, radius,
                         light=(0.3, 0.8, 0.5), plane_y=-0.43,
                         plane_r=0.92):
    """Analytic lambertian render of the textured sphere resting in a
    finite checkered ground plane of radius ``plane_r`` at ``plane_y``
    (the object and the plane form one connected surface). Returns rgb
    (hw, hw, 3) in [-1, 1] (white where neither is hit), z-depth (hw, hw)
    (0 = invalid) and the object mask (hw, hw)."""
    H = W = hw
    ys, xs = np.mgrid[0:H, 0:W]
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)],
                   -1).reshape(-1, 3).astype(np.float64)
    dirs_cam = (np.linalg.inv(K) @ pix.T).T
    dirs_w = dirs_cam @ extr[:3, :3]
    dirs_w = dirs_w / np.linalg.norm(dirs_w, axis=-1, keepdims=True)
    o = np.asarray(cam_pos, np.float64)
    b = dirs_w @ o

    disc = b ** 2 - (o @ o - radius ** 2)
    t_obj = -b - np.sqrt(np.maximum(disc, 0))
    hit_obj = (disc > 0) & (t_obj > 0)

    dy = dirs_w[:, 1]
    t_pl = np.where(np.abs(dy) > 1e-9, (plane_y - o[1]) / dy, -1.0)
    p_pl = o + t_pl[:, None] * dirs_w
    hit_pl = (t_pl > 0) & (p_pl[:, 0] ** 2 + p_pl[:, 2] ** 2 <
                           plane_r ** 2)
    # the object occludes the plane where both are hit
    hit_pl = hit_pl & (~hit_obj | (t_pl < t_obj))
    hit_obj = hit_obj & (~hit_pl)

    t = np.where(hit_obj, t_obj, np.where(hit_pl, t_pl, 0.0))
    pts = o + t[:, None] * dirs_w

    ldir = np.asarray(light, np.float64)
    ldir = ldir / np.linalg.norm(ldir)
    n_obj = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True),
                             1e-9)
    shade_obj = 0.35 + 0.65 * np.maximum(0.0, n_obj @ ldir)
    rgb_obj = np.clip(_sphere_texture(pts, radius) * shade_obj[:, None],
                      -1, 1)
    # the plane: a checker lit by the same light (normal +y)
    checker = (np.floor(pts[:, 0] * 6) + np.floor(pts[:, 2] * 6)) % 2
    base = np.where(checker > 0.5, 0.45, -0.1)
    shade_pl = 0.4 + 0.6 * max(0.0, float(ldir[1]))
    rgb_pl = np.stack([base * shade_pl + 0.1, base * shade_pl,
                       base * shade_pl - 0.1], -1)
    rgb = np.where(hit_obj[:, None], rgb_obj,
                   np.where(hit_pl[:, None], np.clip(rgb_pl, -1, 1), 1.0))
    z = t * dirs_cam[:, 2] / np.linalg.norm(dirs_cam, axis=-1)
    depth = np.where(hit_obj | hit_pl, z, 0.0)
    return (rgb.reshape(H, W, 3).astype(np.float32),
            depth.reshape(H, W).astype(np.float32),
            hit_obj.reshape(H, W))


def frontal_cap_positions(n, dist=2.2):
    """Camera centres of the frontal cap (a DTU-like rig looking down at a
    table): elevations 20-65 degrees, golden-angle azimuths."""
    golden = np.pi * (3 - np.sqrt(5))
    elev = np.deg2rad(np.linspace(20, 65, n))
    azim = golden * np.arange(n)
    return dist * np.stack([np.cos(elev) * np.cos(azim), np.sin(elev),
                            np.cos(elev) * np.sin(azim)], -1)


def shaded_features(rgbs, depth_hw, feat_params=None, device=None):
    """``scene.frozen_features`` of images ``rgbs`` (n, H, W, 3) in
    [-1, 1] at twice ``depth_hw``, on ``device`` (``cuda`` unless named),
    by a FeatExt holding ``feat_params`` (a state dict; random from
    ``np.random.default_rng(0)`` by default). Returns (n, 32, depth_hw,
    depth_hw) float32 numpy."""
    from ..device import resolve_device
    from .featext import init_feat_ext, make_feat_ext
    from .scene import frozen_features
    if feat_params is None:
        feat_params = init_feat_ext(np.random.default_rng(0))
    net = make_feat_ext(feat_params, resolve_device(device))
    imgs = [np.ascontiguousarray(r.transpose(2, 0, 1)) for r in rgbs]
    return frozen_features(net, imgs, (2 * depth_hw, 2 * depth_hw)) \
        .cpu().numpy()


def make_scene_shaded(n=12, img_hw=96, depth_hw=48, n_pix=4096,
                      sphere_radius=0.45, focal=None, seed=0,
                      feat_params=None, plane_r=0.92, device=None):
    """Fully coherent multi-view scene: frontal-cap cameras, analytic
    lambertian renders of the textured sphere, analytic depth maps, and
    frozen FeatExt features computed from the rendered images on
    ``device`` (``cuda`` unless named). The ground-truth surface is the
    sphere of ``sphere_radius`` at the origin. ``plane_r=0`` removes the
    ground plane (a mask-tight object-only scene). Besides
    ``make_scene``'s keys: ``rgb_full`` (n, HW, 3), ``mask_full`` (n, HW)
    and ``uv_full`` (HW, 2), for the caller's pixel subsets."""
    if focal is None:
        focal = 1.3 * img_hw
    sc = make_scene_fibonacci(n=n, img_hw=img_hw, depth_hw=depth_hw,
                              n_pix=n_pix, feat_ch=32,
                              sphere_radius=sphere_radius, focal=focal,
                              seed=seed)
    H = W = img_hw
    h = w = depth_hw
    Kd = sc["depth_cams"][0, 0, 1, :3, :3].astype(np.float64)
    K = sc["intrinsics"][0, :3, :3].astype(np.float64)

    extrs = np.stack([look_at_extrinsic(p)
                      for p in frontal_cap_positions(n)])
    sc["pose"] = np.stack([np.linalg.inv(e) for e in extrs]).astype(
        np.float32)
    dc = np.zeros((n, 1, 2, 4, 4), np.float32)
    for i in range(n):
        dc[i, 0, 0] = extrs[i]
        dc[i, 0, 1, :3, :3] = Kd
    sc["depth_cams"] = dc

    rgbs, masks = [], []
    depths = np.zeros((n, 1, 1, h, w), np.float32)
    for i in range(n):
        extr = np.linalg.inv(sc["pose"][i].astype(np.float64))
        cam_pos = sc["pose"][i][:3, 3].astype(np.float64)
        rgb, _, m = render_shaded_sphere(cam_pos, extr, K, H, sphere_radius,
                                         plane_r=plane_r)
        _, z, _ = render_shaded_sphere(cam_pos, extr, Kd, h, sphere_radius,
                                       plane_r=plane_r)
        rgbs.append(rgb)
        masks.append(m)
        depths[i, 0, 0] = z
    sc["depths"] = depths
    feats = shaded_features(rgbs, h, feat_params, device)

    # the two nearest cameras are each view's source views
    cams = sc["pose"][:, :3, 3]
    src_idx = []
    for i in range(n):
        d = np.linalg.norm(cams - cams[i], axis=1)
        d[i] = np.inf
        src_idx.append(np.argsort(d)[:2])
    # feature cameras: the depth cameras at twice their resolution
    cams_hd = np.zeros((n, 2, 4, 4), np.float32)
    for i in range(n):
        cams_hd[i, 0] = np.linalg.inv(sc["pose"][i])
        cams_hd[i, 1, :3, :3] = Kd * 2
        cams_hd[i, 1, 2, 2] = 1.0

    sc["feat"] = feats
    sc["feat_src"] = np.stack([feats[s] for s in src_idx])
    sc["cam"] = cams_hd
    sc["src_cams"] = np.stack([cams_hd[s] for s in src_idx])

    sc["rgb_full"] = np.stack(rgbs).reshape(n, H * W, 3)
    sc["mask_full"] = np.stack(masks).reshape(n, H * W)
    uv_full = np.stack(np.meshgrid(np.arange(W), np.arange(H)),
                       -1).reshape(-1, 2).astype(np.float32)
    sc["uv_full"] = uv_full
    rng = np.random.default_rng(seed)
    sel = rng.permutation(H * W)[:n_pix]
    sc["uv"] = np.tile(uv_full[sel][None], (n, 1, 1))
    sc["rgb"] = sc["rgb_full"][:, sel]
    sc["object_mask"] = sc["mask_full"][:, sel]
    return sc


def write_shaded_scene_dir(out, views=12, img_hw=128, depth_hw=64,
                           radius=0.45, focal_mult=1.3, plane_r=0.92,
                           dist=2.2):
    """Writes the shaded scene to ``out`` in the reference dataset layout:
    ``image_hd/``, ``mask_hd/`` (PNG), ``depth/*.pfm``, ``cameras_hd.npz``,
    and in ``out``'s parent ``pair.txt`` (each view's two nearest cameras)
    and ``cam_*_flow3.txt``. Returns ``out``'s absolute path."""
    from . import formats
    from .png import write_png
    out = os.path.abspath(out)
    parent = os.path.dirname(out)
    for sub in ("image_hd", "mask_hd", "depth"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)

    n = views
    H = W = img_hw
    h = depth_hw
    f_hd = focal_mult * H
    K = np.array([[f_hd, 0, W / 2], [0, f_hd, H / 2], [0, 0, 1.0]])
    Kd = K.copy()
    Kd[:2] *= h / H
    cam_pos = frontal_cap_positions(n, dist)

    cam_npz = {}
    pair = {"id_list": [str(i) for i in range(n)]}
    for i in range(n):
        extr = look_at_extrinsic(cam_pos[i])
        rgb, _, mask = render_shaded_sphere(cam_pos[i], extr, K, H, radius,
                                            plane_r=plane_r)
        _, depth, _ = render_shaded_sphere(cam_pos[i], extr, Kd, h, radius,
                                           plane_r=plane_r)
        img8 = ((rgb / 2 + 0.5) * 255).clip(0, 255).astype(np.uint8)
        write_png(os.path.join(out, "image_hd", f"{i:03}.png"), img8)
        write_png(os.path.join(out, "mask_hd", f"{i:03}.png"),
                  (mask * 255).astype(np.uint8))
        formats.write_pfm(os.path.join(out, "depth", f"{i:03}.pfm"),
                          depth.astype(np.float32))

        P = np.zeros((4, 4), np.float32)
        P[:3] = K @ extr[:3]
        P[3, 3] = 1
        cam_npz[f"world_mat_{i}"] = P
        cam_npz[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)

        cam = np.zeros((2, 4, 4))
        cam[0] = extr
        cam[1][:3, :3] = Kd
        cam[1][3] = [1.0, 0.01, 256, 1.0 + 0.01 * 255]
        formats.write_cam(
            os.path.join(parent, f"cam_{i:08}_flow3.txt"), cam)

        d = np.linalg.norm(cam_pos - cam_pos[i], axis=1)
        d[i] = np.inf
        srcs = np.argsort(d)[:2]
        pair[str(i)] = {"id": str(i), "index": i,
                        "pair": [str(j) for j in srcs],
                        "score": [float(10 - k) for k in range(len(srcs))]}

    np.savez(os.path.join(out, "cameras_hd.npz"), **cam_npz)
    formats.write_pair(os.path.join(parent, "pair.txt"), pair)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="write the shaded synthetic scene (a textured "
                    "lambertian sphere on a checkered ground plane, "
                    "frontal-cap cameras, analytic depth maps) as a scene "
                    "directory")
    ap.add_argument("--out", required=True,
                    help="scene directory (parent gets pair.txt + cams)")
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--img_hw", type=int, default=128)
    ap.add_argument("--depth_hw", type=int, default=64)
    ap.add_argument("--radius", type=float, default=0.45)
    ap.add_argument("--focal_mult", type=float, default=1.3,
                    help="focal = focal_mult * img_hw; lower = wider FoV "
                         "(drops the sphere-intersect fraction)")
    ap.add_argument("--plane_r", type=float, default=0.92,
                    help="ground-plane radius; 0 disables the plane "
                         "(mask-tight object-only scene)")
    ap.add_argument("--dist", type=float, default=2.2,
                    help="camera distance from the origin")
    args = ap.parse_args(argv)
    out = write_shaded_scene_dir(args.out, args.views, args.img_hw,
                                 args.depth_hw, args.radius, args.focal_mult,
                                 args.plane_r, args.dist)
    print(f"wrote {args.views} views to {out} (images {args.img_hw}x"
          f"{args.img_hw}, depths {args.depth_hw}x{args.depth_hw})")


if __name__ == "__main__":
    main()
