"""Mesh utilities (port of ``mvsdf_tpu/eval/mesh.py``): OBJ export and
import, face areas, connected components (the biggest-component cleanup
the reference does with trimesh.split, ``evaluation/eval.py:121-125``).
Pure numpy + scipy.sparse.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components


def face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0 = verts[faces[:, 0]]
    n = np.cross(verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0)
    return 0.5 * np.linalg.norm(n, axis=-1)


def biggest_component(verts: np.ndarray, faces: np.ndarray,
                      by: str = "area") -> Tuple[np.ndarray, np.ndarray]:
    """Keep the largest vertex-connected component (by total face area,
    matching trimesh areas.argmax; ref eval.py:121-125), then drop
    unreferenced vertices."""
    if len(faces) == 0:
        return verts, faces
    n = len(verts)
    i = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    j = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = sp.coo_matrix((np.ones_like(i), (i, j)), shape=(n, n))
    ncomp, labels = connected_components(adj, directed=False)
    if ncomp <= 1:
        return _compact(verts, faces)
    face_label = labels[faces[:, 0]]
    if by == "area":
        areas = face_areas(verts, faces)
        score = np.bincount(face_label, weights=areas, minlength=ncomp)
    else:
        score = np.bincount(face_label, minlength=ncomp)
    keep = face_label == int(score.argmax())
    return _compact(verts, faces[keep])


def _compact(verts, faces):
    used = np.unique(faces.ravel())
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             vertex_colors: Optional[np.ndarray] = None):
    """OBJ export; vertex colors appended to 'v' lines (the trimesh/meshlab
    convention the reference relies on for mesh_cut confidences)."""
    with open(path, "w") as f:
        if vertex_colors is None:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        else:
            for v, c in zip(verts, vertex_colors):
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                        f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for t in faces + 1:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")


def load_obj(path: str):
    """Minimal OBJ reader -> (verts, faces, vertex_colors|None)."""
    verts, faces, colors = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:4]]
                faces.append([int(x) - 1 for x in idx])
    v = np.asarray(verts, np.float32)
    fc = np.asarray(faces, np.int64)
    c = np.asarray(colors, np.float32) if colors else None
    return v, fc, c
