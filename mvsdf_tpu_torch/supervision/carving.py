"""MVS-depth carving (port of ``mvsdf_tpu/supervision/carving.py``): signed
distance of sample points to the depth surfaces of V views, as a masked
min/max over the view axis."""
from __future__ import annotations

import torch

from ..geometry import projections as proj


def carving(points_world, depths, cams, out_thresh_perc: float,
            use_invalid: bool = False):
    """points_world (M, 3); depths (V, 1, h, w); cams (V, 2, 4, 4).

    Returns (dist (M,), inside (M,) bool, support (M,) bool); support is
    scene_in_range (use_invalid=True, carving_t) or scene_valid (the
    default, carving_t2). dist is the smallest positive distance over
    inside-voting views for points classified inside, else the largest
    negative over outside-voting views."""
    V, _, h, w = depths.shape
    BIG = 1e30 / V
    pts_hom = proj.to_hom(points_world)                     # (M, 4)
    pc = proj.world_to_cam(pts_hom, cams[:, None])          # (V, M, 4)
    point_depth = pc[..., 2]
    xy = proj.cam_to_img(pc, cams[:, None])[..., :2]
    grid_n = proj.normalize_pixel_coords(xy, h, w)
    in_range = proj.in_range_mask(grid_n)
    gathered = proj.grid_sample_nearest(depths, grid_n)[..., 0]   # (V, M)
    valid = (gathered > 0) & in_range
    inside = (point_depth > gathered * 0.99) & valid
    outside = valid & ~inside
    dist = (point_depth - gathered) * valid

    total_in_range = in_range.sum(0)
    total_valid = valid.sum(0)
    total_inside = inside.sum(0)

    big = torch.full_like(dist, BIG)
    pos = torch.where(inside, dist, big).amin(0)
    neg = torch.where(outside, dist, -big).amax(0)
    pos = torch.where(inside.any(0), pos, big[0])
    neg = torch.where(outside.any(0), neg, -big[0])

    if use_invalid:
        total_outside_valid = total_valid - total_inside
        total_invalid = total_in_range - total_valid
        perc = (total_outside_valid + total_invalid * 0.5) / (
            total_in_range + 1e-9)
        support = total_in_range > 0
    else:
        perc = (total_valid - total_inside) / (total_valid + 1e-9)
        support = total_valid > 0
    scene_outside = (perc > out_thresh_perc) & support
    scene_inside = support ^ scene_outside
    ave_dist = pos * scene_inside + neg * scene_outside
    return ave_dist, scene_inside, support
