"""Camera accuracy (port of ``mvsdf_tpu/eval/cameras.py``, float64 numpy):
align the predicted poses to the ground truth by a similarity and report
each camera's rotation and translation error.

Behavioral parity target: ``code/evaluation/eval.py:188-246``
(get_cameras_accuracy, compare_rotations). The reference fits the scale
and shift with cvxpy; here the same sum-of-norms objective is solved by
iteratively reweighted least squares.
"""
from __future__ import annotations

import numpy as np


def align_rotations(pred_Rs: np.ndarray, gt_Rs: np.ndarray) -> np.ndarray:
    """The global rotation R_opt minimising sum ||R_opt pred_R - gt_R||_F,
    by SVD (ref eval.py:196-205)."""
    M = np.einsum("nij,nkj->ik", gt_Rs, pred_Rs)  # sum gt @ pred^T
    U, _, Vt = np.linalg.svd(M)
    D = np.eye(3)
    D[2, 2] = np.linalg.det(U @ Vt)
    return U @ D @ Vt


def umeyama(src: np.ndarray, dst: np.ndarray):
    """The similarity (c, R, t) minimising ||c R src + t - dst||^2."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    var_s = (sc ** 2).sum() / len(src)
    c = np.trace(np.diag(S) @ D) / var_s
    t = mu_d - c * R @ mu_s
    return c, R, t


def rotation_errors_deg(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """Geodesic rotation error of each pair, in degrees (ref
    eval.py:233-237)."""
    cos_err = (np.einsum("nij,nij->n", R1, R2) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos_err, -1, 1)))


def _fit_scale_shift_sum_of_norms(p, g, iters=200, tol=1e-12):
    """min over (c, t) of sum_i ||g_i - (c p_i + t)||_2 (ref eval.py:206-212
    with cvxpy) by iteratively reweighted least squares (Weiszfeld-style);
    the first iterate is the closed-form least squares."""
    w = np.ones(len(p))
    c, t = 1.0, np.zeros(p.shape[1])
    for _ in range(iters):
        W = w / w.sum()
        mp = W @ p
        mg = W @ g
        pc = p - mp
        gc = g - mg
        c_new = (W * np.einsum("ni,ni->n", gc, pc)).sum() / max(
            (W * np.einsum("ni,ni->n", pc, pc)).sum(), 1e-30)
        t_new = mg - c_new * mp
        if abs(c_new - c) < tol and np.abs(t_new - t).max() < tol:
            c, t = c_new, t_new
            break
        c, t = c_new, t_new
        r = np.linalg.norm(g - (c * p + t), axis=1)
        w = 1.0 / np.maximum(r, 1e-9)
    return c, t


def camera_accuracy(pred_Rs, pred_ts, gt_Rs, gt_ts):
    """Aligns the predicted cameras to the ground truth as the reference's
    get_cameras_accuracy does (eval.py:188-232): a global rotation R_opt,
    then the rotated predicted translations fitted by a robust scale and
    shift. Returns a dict: R_opt, scale, t_opt, and each camera's
    R_errors_deg and t_errors."""
    pred_Rs = np.asarray(pred_Rs)
    gt_Rs = np.asarray(gt_Rs)
    gt_ts = np.asarray(gt_ts)
    R_opt = align_rotations(pred_Rs, gt_Rs)
    R_fixed = np.einsum("ij,njk->nik", R_opt, pred_Rs)
    p = np.einsum("ij,nj->ni", R_opt, np.asarray(pred_ts))
    c, t = _fit_scale_shift_sum_of_norms(p, gt_ts)
    t_fixed = c * p + t
    return {
        "R_opt": R_opt, "scale": c, "t_opt": t,
        "R_errors_deg": rotation_errors_deg(R_fixed, gt_Rs),
        "t_errors": np.linalg.norm(t_fixed - gt_ts, axis=-1),
    }
