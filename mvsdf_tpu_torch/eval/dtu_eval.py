"""Official DTU evaluation protocol (observability masks + plane filter;
port of ``mvsdf_tpu/eval/dtu_eval.py``).

The reference defers Chamfer to the official DTU MATLAB evaluation or the
author's DTUeval-python (ref README.md:78-79). This module implements those
protocol semantics natively so the 15-scan suite is turnkey when the DTU
ground-truth data (STL point clouds + ObsMask/Plane .mat files) is present:

  1. The reconstruction mesh is densified (triangles sampled at <= thresh
     spacing) and greedily radius-downsampled at thresh (default 0.2 mm).
  2. Accuracy  = mean distance reconstruction -> STL, evaluated only on
     reconstruction points inside the scan's observability-mask grid
     (BB crop with patch margin, then the boolean ObsMask voxel lookup),
     with distances >= max_dist (20 mm) discarded.
  3. Completeness = mean distance STL -> reconstruction, evaluated only on
     STL points above the scan's ground plane, same max_dist truncation.
  4. overall ("Chamfer") = (accuracy + completeness) / 2.

Everything is numpy/scipy on the host: offline post-processing, no device
work.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def sample_triangles(verts: np.ndarray, faces: np.ndarray,
                     thresh: float) -> np.ndarray:
    """Densify a mesh: barycentric-grid sample every triangle at <= thresh
    spacing along its edges; returns samples plus the original vertices."""
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    n1 = np.linalg.norm(e1, axis=-1)
    n2 = np.linalg.norm(e2, axis=-1)
    k1 = np.ceil(n1 / thresh).astype(int)
    k2 = np.ceil(n2 / thresh).astype(int)
    out = [verts]
    # group triangles by grid size so each group is one vectorized op
    order = np.lexsort((k2, k1))
    i = 0
    while i < len(order):
        j = i
        a, b = k1[order[i]], k2[order[i]]
        while j < len(order) and k1[order[j]] == a and k2[order[j]] == b:
            j += 1
        if a * b > 0 and (a > 1 or b > 1):
            idx = order[i:j]
            u = (np.arange(a + 1) + 0.5) / max(a, 1)
            v = (np.arange(b + 1) + 0.5) / max(b, 1)
            uu, vv = np.meshgrid(u, v, indexing="ij")
            keep = (uu + vv) < 1.0
            bu = uu[keep]
            bv = vv[keep]
            if len(bu):
                pts = (v0[idx][:, None, :] +
                       bu[None, :, None] * e1[idx][:, None, :] +
                       bv[None, :, None] * e2[idx][:, None, :])
                out.append(pts.reshape(-1, 3))
        i = j
    return np.concatenate(out, 0)


def downsample_points(points: np.ndarray, thresh: float,
                      seed: int = 0) -> np.ndarray:
    """Greedy radius downsampling: visit points in random order, keep a
    point iff no previously kept point lies within thresh (the DTUeval
    densify-then-thin step)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(points))
    pts = points[perm]
    tree = cKDTree(pts)
    alive = np.ones(len(pts), bool)
    for i in range(len(pts)):
        if alive[i]:
            nbrs = tree.query_ball_point(pts[i], thresh)
            alive[nbrs] = False
            alive[i] = True
    return pts[alive]


def load_obs_mask(path: str):
    """Load an official ObsMask .mat -> (mask bool (X,Y,Z), BB (2,3), res).
    """
    from scipy.io import loadmat

    m = loadmat(path)
    return (np.asarray(m["ObsMask"]).astype(bool),
            np.asarray(m["BB"]).astype(np.float64),
            float(np.asarray(m["Res"]).reshape(-1)[0]))


def load_ground_plane(path: str) -> np.ndarray:
    """Load an official Plane .mat -> (4,) plane coefficients."""
    from scipy.io import loadmat

    return np.asarray(loadmat(path)["P"]).reshape(4)


def dtu_official_eval(rec_points: np.ndarray, stl_points: np.ndarray,
                      obs_mask: Optional[np.ndarray] = None,
                      bb: Optional[np.ndarray] = None,
                      res: float = 1.0,
                      ground_plane: Optional[np.ndarray] = None,
                      max_dist: float = 20.0, patch: float = 60.0):
    """Protocol-faithful accuracy/completeness/overall (units = inputs, DTU
    uses mm). rec_points should already be densified+downsampled (see
    prepare_reconstruction_points). obs_mask/bb/res/ground_plane are the
    official per-scan artifacts; each is optional so the metric degrades
    gracefully on non-DTU data (no mask -> all points observable; no plane
    -> all STL points count)."""
    from scipy.spatial import cKDTree

    rec = np.asarray(rec_points, np.float64)
    stl = np.asarray(stl_points, np.float64)

    if bb is not None:
        bb = np.asarray(bb, np.float64)
        inbound = np.all((rec >= bb[0] - patch) &
                         (rec < bb[1] + patch * 2), axis=-1)
        data_in = rec[inbound]
    else:
        data_in = rec
    if obs_mask is not None and bb is not None:
        grid = np.around((data_in - bb[0]) / res).astype(np.int64)
        shape = np.asarray(obs_mask.shape)
        grid_ok = np.all((grid >= 0) & (grid < shape), axis=-1)
        gi = grid[grid_ok]
        in_obs = obs_mask[gi[:, 0], gi[:, 1], gi[:, 2]]
        data_in_obs = data_in[grid_ok][in_obs]
    else:
        data_in_obs = data_in

    if ground_plane is not None:
        hom = np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
        stl_above = stl[hom @ np.asarray(ground_plane, np.float64) > 0]
    else:
        stl_above = stl

    out = {"n_rec_obs": int(len(data_in_obs)),
           "n_stl_above": int(len(stl_above))}
    if len(data_in_obs) == 0 or len(stl_above) == 0 or len(data_in) == 0:
        out.update(accuracy=np.inf, completeness=np.inf, overall=np.inf)
        return out
    d_acc = cKDTree(stl).query(data_in_obs, k=1)[0]
    d_comp = cKDTree(data_in).query(stl_above, k=1)[0]
    d_acc = d_acc[d_acc < max_dist]
    d_comp = d_comp[d_comp < max_dist]
    acc = float(d_acc.mean()) if len(d_acc) else np.inf
    comp = float(d_comp.mean()) if len(d_comp) else np.inf
    out.update(accuracy=acc, completeness=comp,
               overall=0.5 * (acc + comp))
    return out


def prepare_reconstruction_points(verts: np.ndarray, faces: np.ndarray,
                                  thresh: float = 0.2,
                                  seed: int = 0) -> np.ndarray:
    """Mesh -> evaluation point set: triangle densification at thresh
    spacing followed by greedy radius downsampling at thresh."""
    dense = sample_triangles(np.asarray(verts, np.float64),
                             np.asarray(faces), thresh)
    return downsample_points(dense, thresh, seed=seed)


def dtu_official_eval_mesh(verts, faces, stl_points, *, thresh: float = 0.2,
                           obs_mask=None, bb=None, res: float = 1.0,
                           ground_plane=None, max_dist: float = 20.0,
                           patch: float = 60.0, seed: int = 0):
    """Convenience wrapper: mesh in, protocol metrics out."""
    rec = prepare_reconstruction_points(verts, faces, thresh, seed=seed)
    return dtu_official_eval(rec, stl_points, obs_mask=obs_mask, bb=bb,
                             res=res, ground_plane=ground_plane,
                             max_dist=max_dist, patch=patch)
