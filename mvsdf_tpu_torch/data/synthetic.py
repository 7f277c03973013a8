"""Synthetic multi-view scene (numpy): pinhole cameras on a ring looking at
the origin, a unit-scale scene (size=2, center=0), depth maps of a sphere,
and smooth random frozen feature maps. The same generator as the JAX
package's test fixture ``tests/golden/scene_fixtures.make_scene``, so one
seed gives both packages the same data; it is also the scene of the JAX
package's ``bench.py``."""
from __future__ import annotations

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
