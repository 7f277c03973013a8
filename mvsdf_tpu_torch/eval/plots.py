"""Visualization artifacts (port of the parts of ``mvsdf_tpu/eval/plots.py``
that training writes): the rendered-vs-GT image pair, written as one PNG by
the port's own writer, and the camera viewing cones of the HTML scene.

The JAX package draws its grid and its static 3-D scene snapshot with
matplotlib; the port has no counterpart of the snapshot
(``plot_scene_snapshot``) yet.
"""
from __future__ import annotations

import numpy as np

from ..data.png import write_png


def lin2img(flat, img_res):
    """(B, HW, C) -> (B, H, W, C) (ref plots.py:375-377)."""
    H, W = img_res
    return np.asarray(flat).reshape(-1, H, W, flat.shape[-1])


def to_uint8(img):
    """[-1, 1] floats -> uint8 (0 at -1, 255 at 1)."""
    return np.round(np.clip((np.asarray(img) + 1) / 2, 0, 1) *
                    255).astype(np.uint8)


def plot_image_grid(path, rgb_pred, rgb_gt, img_res):
    """Rendered | ground truth side by side, one row per image (ref
    plots.py:356-373), as a PNG of (B H, 2 W) RGB pixels. Inputs (B, HW, 3)
    in [-1, 1]."""
    pred = to_uint8(lin2img(rgb_pred, img_res))
    gt = to_uint8(lin2img(rgb_gt, img_res))
    grid = np.concatenate([pred, gt], axis=2)       # (B, H, 2W, 3)
    write_png(path, grid.reshape(-1, grid.shape[2], 3))


def _camera_cone_lines(pose, depth=0.3, half=0.18):
    """Wireframe viewing cone for one camera-to-world pose (4, 4): apex at
    the camera center, square base ``depth`` along the optical axis (the
    reference draws the same cones via plotly, ref plots.py:67-111)."""
    R = pose[:3, :3]
    c = pose[:3, 3]
    corners = np.array([[-half, -half, 1.0], [half, -half, 1.0],
                        [half, half, 1.0], [-half, half, 1.0]]) * depth
    base = (corners @ R.T) + c
    lines = [(c, b) for b in base]
    lines += [(base[i], base[(i + 1) % 4]) for i in range(4)]
    return lines
