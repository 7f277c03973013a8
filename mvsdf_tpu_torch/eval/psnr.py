"""Rendering-quality metrics (port of ``mvsdf_tpu/eval/psnr.py``).

masked PSNR parity target: ``code/evaluation/eval.py:239-246``
(MSE over the full image renormalized by the mask pixel count).
"""
from __future__ import annotations

import math

import numpy as np


def masked_psnr(img1: np.ndarray, img2: np.ndarray,
                mask: np.ndarray) -> float:
    """img1/img2 (h, w, 3) in [0, 1] already mask-multiplied; mask (h, w[,1])
    bool/float. Matches calculate_psnr (ref eval.py:239-246)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2) * (
        img2.shape[0] * img2.shape[1]) / mask.sum()
    if mse == 0:
        return float("inf")
    return 20 * math.log10(1.0 / math.sqrt(mse))


def chamfer_points(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric mean nearest-neighbor distance between point sets (the DTU
    Chamfer is computed externally in the reference, README.md:78-79; this
    utility supports in-repo regression checks)."""
    from scipy.spatial import cKDTree
    da = cKDTree(b).query(a, k=1)[0].mean()
    db = cKDTree(a).query(b, k=1)[0].mean()
    return 0.5 * (da + db)
