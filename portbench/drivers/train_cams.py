"""Training cells with trained cameras (``--train_cameras``): a ``train``
cell whose scene carries initial cameras off the true ones and whose
program trains each image's pose with the field, stepped by SparseAdam at
the traffic's ``learning_rate_cam`` (the program's default).

The scene: the configuration's, seen through a directory of its own in
the cache (``<config>.cams_init``) that links every file of it and adds
``scene/cameras_linear_init.npz`` (``write_pose_init``: each true camera
turned by ``pose_init.degrees`` about a random axis and its centre moved
by ``pose_init.distance_share`` of its distance from the origin, drawn
from ``default_rng(pose_init.seed)``); the other cells' scene is left as
it is.

The check adds two numbers to the ``train`` cell's, each a worst row
(an image's pose) as the field's gaps take a worst leaf: ``pose_grad_gap``,
step 2's pose gradient as SparseAdam took it ((m2 - beta1 m1) / (1 -
beta1) of its first moments after steps 1 and 2) on the rows step 2
touched, against the reference's (``reference/cams.py``) from the
program's weights and poses after step 1: | |g| - |g_ref| | over the
larger of |g_ref| and the median row's; ``pose_update_gap``, the same of
each touched row's change over three steps against the reference's own
three steps.
"""
from __future__ import annotations

import copy
import json
import os
import shutil

import numpy as np

from .. import scene as scene_files
from ..reference.scene import decompose
from . import train

BETA1 = train.BETA1


def _rotation(axis, angle):
    """Rodrigues: the rotation by ``angle`` radians about unit ``axis``."""
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def write_pose_init(data_dir: str, degrees: float, distance_share: float,
                    seed: int) -> str:
    """Writes ``cameras_linear_init.npz`` beside ``data_dir``'s
    ``cameras_hd.npz``, in its keys and layout (``world_mat_i``,
    ``scale_mat_i``): each camera turned and moved as the module says.
    Returns the file's path."""
    cams = np.load(os.path.join(data_dir, "cameras_hd.npz"))
    n = sum(k.startswith("world_mat_") for k in cams.files)
    rng = np.random.default_rng(seed)
    unit = lambda v: v / np.linalg.norm(v)
    out = {}
    for i in range(n):
        K, pose = decompose(cams[f"world_mat_{i}"][:3, :4])
        R = _rotation(unit(rng.normal(size=3)), np.radians(degrees)) @ \
            pose[:3, :3]
        c = pose[:3, 3] + distance_share * np.linalg.norm(pose[:3, 3]) * \
            unit(rng.normal(size=3))
        P = np.eye(4)
        P[:3, :3] = K[:3, :3] @ R.T
        P[:3, 3] = -K[:3, :3] @ R.T @ c
        out[f"world_mat_{i}"] = P.astype(np.float32)
        out[f"scale_mat_{i}"] = cams[f"scale_mat_{i}"]
    path = os.path.join(data_dir, "cameras_linear_init.npz")
    np.savez(path, **out)
    return path


def cams_scene(base: str, name: str, spec: dict, pose_init: dict,
               cache: str) -> None:
    """``<cache>/scenes/<name>``: every file of the scene at ``base``
    linked, and the initial cameras written, marked complete with
    ``spec`` as ``scene.ensure_scene`` marks a scene (it then returns the
    directory as it is). Rewritten where its mark is another."""
    root = scene_files.scene_dir(name, cache)
    mark = dict(spec, pose_init=pose_init)
    done = os.path.join(root, scene_files.DONE)
    if os.path.exists(done):
        with open(done) as f:
            if json.load(f) == spec and os.path.exists(os.path.join(
                    root, "scene", "cameras_linear_init.npz")) and \
                    os.path.exists(os.path.join(root, "pose_init.json")):
                with open(os.path.join(root, "pose_init.json")) as g:
                    if json.load(g) == mark:
                        return
    part = root + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(part, "scene"))
    for sub in ("", "scene"):
        src = os.path.join(base, sub)
        for f in os.listdir(src):
            if (sub == "" and f in ("scene", scene_files.DONE)) or \
                    f == "cameras_linear_init.npz":
                continue
            os.symlink(os.path.join(src, f), os.path.join(part, sub, f))
    write_pose_init(os.path.join(part, "scene"), pose_init["degrees"],
                    pose_init["distance_share"], pose_init["seed"])
    with open(os.path.join(part, "pose_init.json"), "w") as f:
        json.dump(mark, f)
    with open(os.path.join(part, scene_files.DONE), "w") as f:
        json.dump(spec, f)
    os.replace(part, root)


class _Run(tuple):
    """A reference run as ``train.Driver.reference`` gives it (losses,
    clipped gradients, weights), with ``pose0`` the initial poses and
    ``pose_grads``, ``poses`` after each step."""


def _row_gap(prog, ref, rows) -> float:
    """The worst row's | |p| - |r| | over the larger of |r| and the
    median row's, on ``rows`` of two (n, 7) tensors."""
    import torch
    p = prog[rows].double().norm(dim=1)
    r = ref[rows].double().norm(dim=1)
    return float(((p - r).abs() / torch.clamp_min(r, float(r.median()))
                  ).max())


class Driver(train.Driver):
    def __init__(self, cell, *a, **kw):
        cell = copy.copy(cell)
        cell.config = copy.deepcopy(cell.config)
        cell.config["cli_args"] = list(cell.config["cli_args"]) + [
            "--train_cameras"]
        self.base_config = cell.config_name
        cell.config_name = cell.config_name + ".cams_init"
        super().__init__(cell, *a, **kw)
        self.pose_states = []

    def setup(self) -> None:
        from mvsdf_tpu_torch.train.cameras_opt import \
            pose_vecs_from_matrices
        spec = self.config["scene"]
        base = scene_files.ensure_scene(self.base_config, spec, self.cache)
        cams_scene(base, self.cell.config_name, spec,
                   self.traffic["pose_init"], self.cache)
        super().setup()
        tr = self.trainer
        if tr.cfg.train.learning_rate_cam != \
                self.traffic["learning_rate_cam"]:
            raise ValueError(f"the program's learning_rate_cam "
                             f"{tr.cfg.train.learning_rate_cam} is not the "
                             f"traffic's")
        import torch
        self.pose0 = torch.from_numpy(pose_vecs_from_matrices(
            tr.scene.pose_init))

    def _sync(self):
        """Also keeps the poses and their first moments after each of the
        set-up's first three steps (each is followed by this)."""
        super()._sync()
        tr = getattr(self, "trainer", None)
        if tr is not None and len(self.pose_states) < 3 and \
                tr.state.pose_vecs is not None:
            st = tr.state
            self.pose_states.append((st.pose_vecs.cpu().clone(),
                                     st.cam_opt.m.cpu().clone()))

    def reference(self, control: bool = False, start: dict = None,
                  plan=None):
        """The trained-cameras reference's first steps from the seed's
        weights and the initial poses, as ``train.Driver.reference``
        takes them (step 2 from ``start`` and the poses ``readings`` set);
        a ``_Run``."""
        import torch
        from ..reference import cams
        from ..reference import scene as ref_scene
        sc = ref_scene.Scene(self.root, self.device)
        params = {k: v.to(self.device).clone()
                  for k, v in self.weights0.items()}
        poses = cams.initial_poses(self.root, self.device)
        pose0 = poses.cpu().clone()
        if plan is None:
            plan = self._plan(3 if start is None else 2)
        with train._no_tf32(), torch.autocast(self.device.type,
                                              dtype=torch.bfloat16,
                                              enabled=control):
            run = cams.train_steps(
                self.config, params, poses, sc, plan,
                self.traffic["start_epoch"], self.seed, self.device,
                self.traffic["learning_rate_cam"],
                start and {1: (start, self._pose_start.to(self.device))})
        out = _Run(run[:3])
        out.pose0, out.pose_grads, out.poses = pose0, run[3], run[4]
        if start is not None:
            self._at = out
        return out

    def program(self):
        """``train.Driver.program``'s, then step 2's pose gradient as
        SparseAdam took it, the initial poses and the poses after steps 1
        and 3."""
        (pv1, m1), (_, m2), (pv3, _) = self.pose_states
        return super().program() + ((m2 - BETA1 * m1) / (1 - BETA1),
                                    self.pose0, pv1, pv3)

    @staticmethod
    def in_place_of_program(run):
        return train.Driver.in_place_of_program(run) + (
            run.pose_grads[1], run.pose0, run.poses[0], run.poses[2])

    def readings(self, subject, ref=None) -> dict:
        """``train.Driver.readings`` and the two pose gaps."""
        pose_grad, pose0, poses1, poses3 = subject[4:]
        self._pose_start = poses1
        ref = ref or self.reference()
        got = super().readings(subject[:4], ref)
        plan = self._plan(3)
        rows2 = sorted({int(i) for i in plan[1][0]})
        rows = sorted({int(i) for idx, _ in plan for i in idx})
        got["pose_grad_gap"] = _row_gap(pose_grad, self._at.pose_grads[1],
                                        rows2)
        got["pose_update_gap"] = _row_gap(poses3 - pose0,
                                          ref.poses[2] - ref.pose0, rows)
        return got

    def check(self):
        got = self.readings(self.program())
        return [(k, got[k], lim) for k, lim in self.traffic["limits"].items()]
