"""Camera math (port of ``mvsdf_tpu/geometry/cameras.py``): ray generation,
ray/bounding-sphere intersection, quaternion -> rotation, and the numpy
decomposition of a projection matrix for data loading. Shape-polymorphic
over leading batch dims."""
from __future__ import annotations

import numpy as np
import torch


def decompose_projection(P: np.ndarray):
    """Decompose a 3x4 projection matrix P = K [R | t] into intrinsics and
    camera-to-world pose (same convention as cv2.decomposeProjectionMatrix as
    used by the reference at ``rend_util.py:25-46``).

    Returns (intrinsics 4x4, pose 4x4) float32 where pose maps camera ->
    world and pose[:3, 3] is the camera center.
    """
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    # RQ decomposition of M via QR of the flipped transpose.
    rev = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)
    Q_, R_ = np.linalg.qr((rev @ M).T)
    K = rev @ R_.T @ rev
    R = rev @ Q_.T
    # Force positive diagonal of K.
    D = np.diag(np.sign(np.diag(K)))
    K = K @ D
    R = D @ R
    if np.linalg.det(R) < 0:  # proper rotation
        R = -R
        K = -K  # keep K @ R = M; sign absorbed by normalization below
    # Camera center: null space of P.
    c = -np.linalg.inv(M) @ P[:, 3]
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float64)
    pose[:3, :3] = R.T  # world-from-camera rotation
    pose[:3, 3] = c
    return intrinsics.astype(np.float32), pose.astype(np.float32)


def lift(x, y, z, intrinsics):
    """Back-project pixel coords (x, y) at depth z to homogeneous camera
    coords, honoring skew. x, y, z: (..., N); intrinsics (..., 4, 4) ->
    (..., N, 4)."""
    fx = intrinsics[..., 0, 0][..., None]
    fy = intrinsics[..., 1, 1][..., None]
    cx = intrinsics[..., 0, 2][..., None]
    cy = intrinsics[..., 1, 2][..., None]
    sk = intrinsics[..., 0, 1][..., None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def quat_to_rot(q):
    """Quaternion (..., 4) [w, x, y, z], normalized here -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(
        1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def get_camera_params(uv, pose, intrinsics):
    """Pixel coords -> world-space unit ray directions + camera center.

    uv (B, P, 2); pose (B, 4, 4) cam-to-world or (B, 7) quaternion +
    translation; intrinsics (B, 4, 4). Returns (ray_dirs (B, P, 3),
    cam_loc (B, 3)); pixel centers are at +0.5."""
    if pose.shape[-1] == 7:
        cam_loc = pose[..., 4:]
        R = quat_to_rot(pose[..., :4])
        p = torch.zeros(pose.shape[:-1] + (4, 4), dtype=pose.dtype,
                        device=pose.device)
        p[..., :3, :3] = R
        p[..., :3, 3] = cam_loc
        p[..., 3, 3] = 1.0
    else:
        cam_loc = pose[..., :3, 3]
        p = pose
    x = uv[..., 0] + 0.5
    y = uv[..., 1] + 0.5
    z = torch.ones_like(x)
    pix_cam = lift(x, y, z, intrinsics)                       # (B, P, 4)
    world = torch.einsum("...ij,...pj->...pi", p, pix_cam)[..., :3]
    dirs = world - cam_loc[..., None, :]
    dirs = dirs / torch.linalg.vector_norm(
        dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    return dirs, cam_loc


def get_sphere_intersection(cam_loc, ray_dirs, r=1.0):
    """Intersect rays from cam_loc (B, 3) along ray_dirs (B, P, 3) with the
    sphere |x| = r. Returns (t_near_far (B, P, 2) clamped to >= 0,
    mask_intersect (B, P)); rays that miss get (0, 0)."""
    d_dot_o = torch.einsum("bpi,bi->bp", ray_dirs, cam_loc)
    under = d_dot_o ** 2 - (
        torch.sum(cam_loc ** 2, dim=-1)[..., None] - r ** 2)
    mask = under > 0
    sq = torch.sqrt(torch.where(mask, under, torch.zeros_like(under)))
    zero = torch.zeros_like(d_dot_o)
    near = torch.where(mask, -d_dot_o - sq, zero)
    far = torch.where(mask, -d_dot_o + sq, zero)
    return torch.stack([near, far], dim=-1).clamp_min(0.0), mask
