"""Mesh trimming by max-flow / min-cut over face confidences (port of
``mvsdf_tpu/meshcut/cut.py``, the same results to the bit).

A face's confidence is the mean red channel of its vertex colours (1 -
sigmoid of the surface indicator, as the eval CLI writes them). Faces
above ``thresh / 255`` are linked to the source with capacity 1, the rest
to the sink; faces that share an edge are joined both ways with capacity
``smooth``. The min cut's source side (the faces reachable from the source
in the residual graph, which every maximum flow leaves the same) is
removed. ``maxflow_cut`` runs the native Dinic max-flow
(``csrc/maxflow.cpp``); ``maxflow_cut_reference`` is its plain version on
the same s-t graph through ``scipy.sparse.csgraph.maximum_flow``, for the
tests and the card's smoke run; ``trim_mesh`` never uses it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .native import load as load_native


def face_adjacency_edges(faces: np.ndarray) -> np.ndarray:
    """(F, 3) faces -> (E, 2) pairs of faces that share an edge (each edge
    key's consecutive occurrences in sorted order)."""
    F = len(faces)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    fid = np.tile(np.arange(F), 3)
    key = e.min(1).astype(np.int64) << 32 | e.max(1).astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    fid_s = fid[order]
    i = np.nonzero(key_s[1:] == key_s[:-1])[0]
    return np.stack([fid_s[i], fid_s[i + 1]], 1)


def _graph(face_labels, edges_with_cap):
    labels = np.ascontiguousarray(np.asarray(face_labels).astype(np.uint8))
    edges = np.ascontiguousarray(
        np.asarray(edges_with_cap).astype(np.uint32)).reshape(-1, 3)
    if len(labels) >= 2 ** 31 - 2:
        raise ValueError(f"{len(labels)} faces: the max-flow takes fewer "
                         f"than 2^31 - 2")
    if len(edges) and int(edges[:, :2].max()) >= len(labels):
        raise ValueError("an adjacency edge names a face beyond the "
                         f"{len(labels)} labels")
    return labels, edges


def maxflow_cut(face_labels: np.ndarray, edges_with_cap: np.ndarray
                ) -> Tuple[int, np.ndarray]:
    """face_labels (F,) bool (True: source-linked); edges_with_cap (E, 3)
    (u, v, capacity). Returns (the max-flow value, (F,) bool source-side
    membership: the faces to remove), by the native Dinic max-flow."""
    labels, edges = _graph(face_labels, edges_with_cap)
    out = np.zeros(len(labels), np.uint8)
    flow = load_native().mesh_maxflow_cut(
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(labels),
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(edges),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return int(flow), out.astype(bool)


def mesh_cut(face_labels: np.ndarray, edges_with_cap: np.ndarray
             ) -> np.ndarray:
    """The source side of ``maxflow_cut``: (F,) bool, the faces to
    remove."""
    return maxflow_cut(face_labels, edges_with_cap)[1]


def maxflow_cut_reference(face_labels: np.ndarray,
                          edges_with_cap: np.ndarray
                          ) -> Tuple[int, np.ndarray]:
    """Plain version of ``maxflow_cut`` on the same s-t graph (source 0,
    sink 1, face i at i + 2): ``scipy.sparse.csgraph.maximum_flow``, then
    the nodes reachable from the source over arcs with residual capacity.
    Self-loops and arcs of capacity 0 carry no flow and are left out."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow
    labels, edges = _graph(face_labels, edges_with_cap)
    n = len(labels)
    e = edges.astype(np.int64)
    e = e[(e[:, 0] != e[:, 1]) & (e[:, 2] > 0)]
    node = np.arange(n) + 2
    src = labels.astype(bool)
    rows = np.concatenate([np.where(src, 0, node), e[:, 0] + 2,
                           e[:, 1] + 2])
    cols = np.concatenate([np.where(src, node, 1), e[:, 1] + 2,
                           e[:, 0] + 2])
    caps = np.concatenate([np.ones(n, np.int64), e[:, 2], e[:, 2]])
    graph = csr_matrix((caps.astype(np.int32), (rows, cols)),
                       shape=(n + 2, n + 2))
    res = maximum_flow(graph, 0, 1)
    residual = (graph - res.flow).tocsr()
    residual.data[residual.data < 0] = 0
    residual.eliminate_zeros()
    reach = breadth_first_order(residual, 0, directed=True,
                                return_predecessors=False)
    side = np.zeros(n + 2, bool)
    side[reach] = True
    return int(res.flow_value), side[2:]


def auto_threshold(face_conf: np.ndarray) -> float:
    """A trim threshold from the data (0-255 scale): Otsu's criterion over
    the face confidences, at the midpoint of its plateau (in an empty
    valley between the two modes the criterion is flat, and the midpoint
    keeps a margin on both sides). The reference's fixed ``--thresh 15``
    presumes a surface indicator calibrated above 0.94, which a shorter
    training run does not reach; its two modes still separate."""
    hist, edges = np.histogram(np.clip(face_conf, 0.0, 1.0), bins=256,
                               range=(0.0, 1.0))
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 15.0
    centers = 0.5 * (edges[:-1] + edges[1:])
    w0 = np.cumsum(hist)
    w1 = total - w0
    mu0 = np.cumsum(hist * centers) / np.maximum(w0, 1e-12)
    mu1 = (np.sum(hist * centers) - np.cumsum(hist * centers)) / \
        np.maximum(w1, 1e-12)
    between = w0 * w1 * (mu0 - mu1) ** 2
    between[(w0 == 0) | (w1 == 0)] = -1.0
    mx = between.max()
    if mx <= 0:  # all mass in one bin: no split exists
        return float(np.median(np.clip(face_conf, 0.0, 1.0)) * 255.0)
    plateau = np.flatnonzero(between >= mx * (1.0 - 1e-9))
    return float(centers[plateau[(len(plateau) - 1) // 2]] * 255.0)


def indicator_separation(face_conf: np.ndarray) -> float:
    """The gap between the mean confidences below and above the Otsu split
    (0..1): ~0.55 on a trained mesh, ~0.001 on an untrained one, whose cut
    then partitions noise (callers warn below 0.1)."""
    t = auto_threshold(face_conf) / 255.0
    conf = np.clip(face_conf, 0.0, 1.0)
    lo, hi = conf[conf <= t], conf[conf > t]
    if len(lo) == 0 or len(hi) == 0:
        return 0.0
    return float(hi.mean() - lo.mean())


def trim_mesh(verts: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray, thresh=15.0, smooth: int = 10):
    """The trimming pipeline (ref mesh_cut.py:15-43): vertex_colors in
    [0, 1]; ``thresh`` on the 0-255 scale, or "auto" for
    ``auto_threshold``. Returns the kept (verts, faces, vertex_colors),
    unreferenced vertices dropped."""
    conf = vertex_colors[faces, 0].mean(axis=1)
    if isinstance(thresh, str):
        if thresh != "auto":
            raise ValueError(f"thresh must be a number or 'auto': {thresh}")
        thresh = auto_threshold(conf)
    labels = conf > (thresh / 255.0)
    adj = face_adjacency_edges(faces)
    edges = np.concatenate(
        [adj, np.full((len(adj), 1), smooth, adj.dtype)], 1)
    remove = mesh_cut(labels, edges)
    keep_faces = faces[~remove]
    used = np.unique(keep_faces.ravel())
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[keep_faces], vertex_colors[used]
