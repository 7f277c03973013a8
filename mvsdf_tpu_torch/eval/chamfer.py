"""DTU-protocol-style mesh evaluation: accuracy / completeness / overall
(port of ``mvsdf_tpu/eval/chamfer.py``).

The reference computes Chamfer externally with the official DTU MATLAB
evaluation or the author's DTUeval-python (README.md:78-79). This module
implements the same protocol shape for in-repo evaluation once ground-truth
point clouds are available:

  accuracy     = mean distance from sampled reconstruction points to the
                 ground-truth cloud (outliers beyond max_dist dropped)
  completeness = mean distance from ground-truth points to the
                 reconstruction
  overall      = (accuracy + completeness) / 2   (the reported "Chamfer")
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Uniform-by-area surface sampling of a triangle mesh -> (n, 3)."""
    rng = np.random.default_rng(seed)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    p = areas / max(areas.sum(), 1e-30)
    idx = rng.choice(len(faces), size=n, p=p)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return v0[idx] + u * (v1[idx] - v0[idx]) + v * (v2[idx] - v0[idx])


def dtu_style_eval(verts: np.ndarray, faces: np.ndarray,
                   gt_points: np.ndarray, n_samples: int = 200_000,
                   max_dist: float = 20.0,
                   bbox: Optional[np.ndarray] = None, seed: int = 0):
    """Returns dict(accuracy, completeness, overall) in the units of the
    inputs (DTU uses mm). bbox (2, 3) optionally crops both clouds (the
    official protocol evaluates inside the observation mask/BB)."""
    from scipy.spatial import cKDTree

    rec = sample_surface(verts, faces, n_samples, seed)
    gt = np.asarray(gt_points)
    if bbox is not None:
        lo, hi = np.asarray(bbox)
        rec = rec[np.all((rec >= lo) & (rec <= hi), axis=1)]
        gt = gt[np.all((gt >= lo) & (gt <= hi), axis=1)]
    if len(rec) == 0 or len(gt) == 0:
        return {"accuracy": np.inf, "completeness": np.inf,
                "overall": np.inf}
    d_acc = cKDTree(gt).query(rec, k=1)[0]
    d_comp = cKDTree(rec).query(gt, k=1)[0]
    d_acc = d_acc[d_acc < max_dist]
    d_comp = d_comp[d_comp < max_dist]
    acc = float(d_acc.mean()) if len(d_acc) else np.inf
    comp = float(d_comp.mean()) if len(d_comp) else np.inf
    return {"accuracy": acc, "completeness": comp,
            "overall": 0.5 * (acc + comp)}
