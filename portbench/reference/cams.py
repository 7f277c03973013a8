"""The reference of the trained-cameras traffic (``--train_cameras``): the
plain reference's training step with each image's pose a row of an
(n, 7) leaf, [quaternion w, x, y, z, translation], trained with the field
and stepped by SparseAdam, in plain PyTorch and f32 (TF32 off by the
caller).

A batch's camera-to-world poses are built from its rows (the quaternion
normalized, then its rotation matrix), the losses are
``reference/step.losses`` on them, and the loss is differentiated with
respect to the rows too. The field's gradients are clipped and stepped by
``step.Adam``; the pose gradients are neither clipped nor zeroed, and only
the rows the batch touched update their moments and move, with the bias
corrections of the tensor's step count (``torch.optim.SparseAdam``'s
semantics) at a constant learning rate. The initial poses are the scene's
``cameras_linear_init.npz``, read as the scene's cameras are.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import step as ref_step
from .scene import decompose


def quaternion(R: np.ndarray) -> np.ndarray:
    """A unit quaternion [w, x, y, z] of the rotation R (3, 3), from the
    largest of the four squared components."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    sq = np.array([1 + t, 1 + 2 * R[0, 0] - t, 1 + 2 * R[1, 1] - t,
                   1 + 2 * R[2, 2] - t]) / 4
    i = int(np.argmax(sq))
    q = np.empty(4)
    q[i] = math.sqrt(sq[i])
    # the off-diagonal sums and differences, each 4 q_a q_b
    pairs = {(0, 1): R[2, 1] - R[1, 2], (0, 2): R[0, 2] - R[2, 0],
             (0, 3): R[1, 0] - R[0, 1], (1, 2): R[0, 1] + R[1, 0],
             (1, 3): R[0, 2] + R[2, 0], (2, 3): R[1, 2] + R[2, 1]}
    for j in range(4):
        if j != i:
            q[j] = pairs[(min(i, j), max(i, j))] / (4 * q[i])
    return q


def initial_poses(root: str, device) -> torch.Tensor:
    """(n, 7) rows of the scene's ``cameras_linear_init.npz``."""
    lin = np.load(os.path.join(root, "scene", "cameras_linear_init.npz"))
    n = sum(k.startswith("world_mat_") for k in lin.files)
    rows = []
    for i in range(n):
        _, pose = decompose((lin[f"world_mat_{i}"].astype(np.float32) @
                             lin[f"scale_mat_{i}"].astype(np.float32))[:3])
        rows.append(np.concatenate([quaternion(pose[:3, :3]),
                                    pose[:3, 3]]))
    return torch.tensor(np.stack(rows), dtype=torch.float32, device=device)


def pose_matrices(rows: torch.Tensor) -> torch.Tensor:
    """(B, 7) rows -> (B, 4, 4) camera-to-world."""
    q = rows[:, :4] / torch.linalg.vector_norm(rows[:, :4], dim=-1,
                                               keepdim=True)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    top = torch.cat([R, rows[:, 4:, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=rows.device
                          ).expand(rows.shape[0], 1, 4)
    return torch.cat([top, bottom], 1)


class SparseAdam:
    """Adam (0.9, 0.999, 1e-8) on the rows a step touched."""

    def __init__(self, rows: torch.Tensor, lr: float):
        self.lr, self.t = lr, 0
        self.m = torch.zeros_like(rows)
        self.v = torch.zeros_like(rows)

    def step(self, rows: torch.Tensor, grad: torch.Tensor, touched) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        with torch.no_grad():
            for i in touched:
                g = grad[i]
                self.m[i] = b1 * self.m[i] + (1 - b1) * g
                self.v[i] = b2 * self.v[i] + (1 - b2) * g * g
                m_hat = self.m[i] / (1 - b1 ** self.t)
                v_hat = self.v[i] / (1 - b2 ** self.t)
                rows[i] -= self.lr * m_hat / (v_hat.sqrt() + 1e-8)


def train_steps(cfg: dict, params: dict, poses: torch.Tensor, scene, plan,
                epoch: int, seed: int, device, lr_cam: float,
                start: dict = None):
    """``reference/step.train_steps`` with trained poses: ``poses`` (n, 7)
    is modified in place with ``params``; ``start`` maps a step's index to
    (weights, poses) it starts from instead. Returns (each step's loss,
    each step's clipped field gradients, the field's weights after each
    step, each step's pose gradient (n, 7), the poses after each step;
    on the host)."""
    train = cfg["train"]
    gates, weights = ref_step.gates_weights(cfg["schedule"], epoch,
                                            train["nepochs"])
    opt = ref_step.Adam(params, train["learning_rate"] * train["batch_size"])
    cam = SparseAdam(poses, lr_cam)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out, grads_of, weights_of, pose_grads_of, poses_of = [], [], [], [], []
    keys = list(params)
    for i, (indices, sel) in enumerate(plan):
        if start and i in start:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(start[i][0][k])
                poses.copy_(start[i][1])
        for p in params.values():
            p.requires_grad_(True)
        leaf = poses.detach().clone().requires_grad_(True)
        batch = scene.batch(indices, sel)
        idx = torch.as_tensor(np.asarray(indices), device=device).long()
        batch["pose"] = pose_matrices(leaf[idx])
        loss, _ = ref_step.losses(cfg, params, batch, gates, weights, gen)
        gs = torch.autograd.grad(loss, [params[k] for k in keys] + [leaf],
                                 allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g.detach()
                 for k, g in zip(keys, gs)}
        pose_grad = torch.zeros_like(poses) if gs[-1] is None else \
            gs[-1].detach()
        grads = opt.clip(grads, weights["grad_cap"])
        for p in params.values():
            p.requires_grad_(False)
        opt.step(params, grads)
        cam.step(poses, pose_grad, sorted(set(int(j) for j in indices)))
        out.append(float(loss.detach()))
        grads_of.append({k: g.cpu() for k, g in grads.items()})
        weights_of.append({k: p.detach().cpu().clone()
                           for k, p in params.items()})
        pose_grads_of.append(pose_grad.cpu())
        poses_of.append(poses.detach().cpu().clone())
    return out, grads_of, weights_of, pose_grads_of, poses_of
