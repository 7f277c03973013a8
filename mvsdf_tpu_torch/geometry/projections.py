"""MVS camera projections and image sampling (port of
``mvsdf_tpu/geometry/projections.py``).

An MVS camera is a (2, 4, 4) tensor: cam[0] the world-to-camera extrinsic,
cam[1][:3, :3] the intrinsic K. Cameras may carry extra leading dims that
broadcast against the points' leading dims (e.g. cams (V, 1, 2, 4, 4) with
points (M, 4) give (V, M, 4)).

Sampling follows ``torch.nn.functional.grid_sample`` with
align_corners=False and zero padding, written as explicit gathers so the
JAX package's rounding and weights carry over exactly.
"""
from __future__ import annotations

import torch


def _apply(M, p):
    """M (..., i, j) @ p (..., j) with broadcasting -> (..., i)."""
    return torch.matmul(M, p.unsqueeze(-1)).squeeze(-1)


def to_hom(x):
    """(..., 3) -> (..., 4) homogeneous."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def world_to_cam(pts_hom, cam):
    """pts_hom (..., 4), cam (..., 2, 4, 4) -> camera-frame homogeneous
    coords (..., 4), w-normalized."""
    p = _apply(cam[..., 0, :, :], pts_hom)
    return p / (p[..., -1:] + 1e-9)


def cam_to_world(pts_hom, cam, extr_inv=None):
    """Inverse of world_to_cam."""
    E = torch.linalg.inv(cam[..., 0, :, :]) if extr_inv is None \
        else extr_inv
    p = _apply(E, pts_hom)
    return p / (p[..., -1:] + 1e-9)


def cam_to_img(pts_cam_hom, cam):
    """Camera-frame homogeneous coords (..., 4) -> pixel coords (..., 3)
    (x, y, 1)."""
    p3 = pts_cam_hom[..., :3] / (pts_cam_hom[..., 3:4] + 1e-9)
    p = _apply(cam[..., 1, :3, :3], p3)
    return p / (p[..., -1:] + 1e-9)


def img_to_cam(xy_hom, depth, cam, intr_inv=None):
    """Pixel coords (..., 3) (x, y, 1) + depth (...,) -> camera homogeneous
    coords (..., 4)."""
    Kinv = torch.linalg.inv(cam[..., 1, :3, :3]) if intr_inv is None \
        else intr_inv
    p = _apply(Kinv, xy_hom)
    p = p / (p[..., -1:] + 1e-9) * depth[..., None]
    return to_hom(p)


def pixel_grid(height: int, width: int, device=None):
    """(h, w, 3) homogeneous pixel-center coords (x+0.5, y+0.5, 1)."""
    x = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)


def normalize_pixel_coords(xy, height: int, width: int):
    """Pixel coords (..., 2) -> normalized [-1, 1] coords clamped to
    [-1.1, 1.1]."""
    size = torch.tensor([width, height], dtype=xy.dtype, device=xy.device)
    return (xy / size * 2 - 1).clamp(-1.1, 1.1)


def in_range_mask(grid_n):
    """Normalized coords (..., 2) -> bool mask of coords within [-1, 1]."""
    return torch.all((grid_n >= -1) & (grid_n <= 1), dim=-1)


def _unnormalize(coord, size):
    # align_corners=False: ix = ((x + 1) * W - 1) / 2
    return ((coord + 1) * size - 1) / 2


def _gather(img, iy, ix):
    """img (V, C, H, W); iy, ix (V, M) int64 in range -> (V, M, C)."""
    V, C, H, W = img.shape
    flat = (iy * W + ix)[:, None, :].expand(V, C, iy.shape[1])
    return torch.gather(img.reshape(V, C, H * W), 2, flat).transpose(1, 2)


def _batched(img, grid_n, sample):
    """Run a (V, C, H, W) x (V, M, 2) sampler on img (C, H, W) or
    (V, C, H, W) with grid (..., 2) or (V, ..., 2) -> (..., C)."""
    single = img.dim() == 3
    if single:
        img, grid_n = img[None], grid_n[None]
    lead = grid_n.shape[:-1]
    out = sample(img, grid_n.reshape(lead[0], -1, 2))
    out = out.reshape(lead + (img.shape[1],))
    return out[0] if single else out


def _nearest(img, grid_n):
    _, _, H, W = img.shape
    ix = torch.round(_unnormalize(grid_n[..., 0], W)).long()
    iy = torch.round(_unnormalize(grid_n[..., 1], H)).long()
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    out = _gather(img, iy.clamp(0, H - 1), ix.clamp(0, W - 1))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def _bilinear(img, grid_n):
    _, _, H, W = img.shape
    fx = _unnormalize(grid_n[..., 0], W)
    fy = _unnormalize(grid_n[..., 1], H)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1 = fx - x0
    wy1 = fy - y0
    out = 0.0
    for dx, wx in ((0, 1 - wx1), (1, wx1)):
        for dy, wy in ((0, 1 - wy1), (1, wy1)):
            ix = x0.long() + dx
            iy = y0.long() + dy
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            v = _gather(img, iy.clamp(0, H - 1), ix.clamp(0, W - 1))
            out = out + v * ((wx * wy) * valid)[..., None]
    return out


def grid_sample_nearest(img, grid_n):
    """img (C, H, W) with grid_n (..., 2), or img (V, C, H, W) with grid_n
    (V, ..., 2), in normalized coords -> (..., C). Nearest neighbour,
    round-half-to-even, zero padding."""
    return _batched(img, grid_n, _nearest)


def grid_sample_bilinear(img, grid_n):
    """As grid_sample_nearest, bilinear (grid_sample mode='bilinear',
    padding_mode='zeros', align_corners=False)."""
    return _batched(img, grid_n, _bilinear)
