"""Camera-pose optimisation (port of ``mvsdf_tpu/train/cameras_opt.py``):
a quaternion and a translation per image, (n, 7) rows ``[w, x, y, z, tx,
ty, tz]``, trained with the field and stepped by SparseAdam.

SparseAdam is done as masked moments, with explicit tensor ops rather than
``torch.optim.SparseAdam``: only the rows the batch touched update their
moments and move, a touched row with a zero gradient still decays its
moments, and the state (``m``, ``v``, ``step``) has the JAX package's
layout, so checkpoints and tests carry it across as it is.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SparseAdamState:
    m: torch.Tensor      # (n, 7)
    v: torch.Tensor      # (n, 7)
    step: torch.Tensor   # 0-d int32


def _rot_to_quat_robust(R: np.ndarray) -> np.ndarray:
    """(3, 3) -> (4,) [w, x, y, z] by Shepperd's choice of branch (the
    plain sqrt(1 + trace) formula fails for a trace below -1)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def pose_vecs_from_matrices(poses: np.ndarray) -> np.ndarray:
    """(n, 4, 4) camera-to-world -> (n, 7) float32 [quaternion wxyz,
    translation] (ref get_pose_init, scene_dataset.py:270-287)."""
    poses = np.asarray(poses)
    q = np.stack([_rot_to_quat_robust(p[:3, :3]) for p in poses])
    return np.concatenate([q, poses[:, :3, 3]], axis=1).astype(np.float32)


def init_sparse_adam(pose_vecs: torch.Tensor) -> SparseAdamState:
    return SparseAdamState(
        m=torch.zeros_like(pose_vecs), v=torch.zeros_like(pose_vecs),
        step=torch.zeros((), dtype=torch.int32, device=pose_vecs.device))


@torch.no_grad()
def sparse_adam_step(state: SparseAdamState, pose_vecs: torch.Tensor,
                     grads: torch.Tensor, touched_rows: torch.Tensor,
                     lr: float, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8):
    """grads (n, 7), dense with zeros on untouched rows; touched_rows (n,)
    bool. Returns (new state, new pose_vecs); only touched rows update
    their moments and move (torch.optim.SparseAdam's semantics), in the
    JAX package's f32 arithmetic."""
    t = touched_rows[:, None]
    m = torch.where(t, b1 * state.m + (1 - b1) * grads, state.m)
    v = torch.where(t, b2 * state.v + (1 - b2) * grads ** 2, state.v)
    step = state.step + 1
    # filled on the device: a CUDA graph captures no host copy
    f32 = lambda x: torch.full((), x, dtype=torch.float32,
                               device=pose_vecs.device)
    bc1 = 1 - f32(b1) ** step.float()
    bc2 = 1 - f32(b2) ** step.float()
    upd = torch.where(t, -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps),
                      torch.zeros_like(m))
    return SparseAdamState(m, v, step), pose_vecs + upd
