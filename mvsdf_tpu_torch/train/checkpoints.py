"""Checkpoint/resume (port of ``mvsdf_tpu/train/checkpoints.py``; torch
files in place of orbax).

A step directory ``step_{N}/`` holds
- ``state.pt``: the network's and Adam's state dicts, the learning-rate
  scheduler's state and the epoch, and with camera optimisation the
  (n, 7) ``pose_vecs`` and their SparseAdam state (``cam_opt``: ``m``,
  ``v``, ``step``, the JAX package's layout);
- ``rng.json``: the host sampling RNG's state (``np_rng``, the JSON layout
  of the JAX package) and the per-step torch generator's state with its
  device type, so a resumed run draws what an unbroken one would.

The directory is written under a temporary name and renamed into place, so
a killed run never leaves half a step. ``latest.txt`` names the last step
saved.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from .cameras_opt import SparseAdamState


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")


def save_checkpoint(ckpt_dir: str, step: int, state, epoch: int,
                    rng_state=None, generator: torch.Generator = None):
    """state: TrainState; rng_state: the numpy Generator's state dict;
    generator: the per-step torch generator."""
    path = step_path(ckpt_dir, step)
    tmp = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree = {"net": state.net.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "epoch": int(epoch)}
    if state.pose_vecs is not None:
        # the camera state in the same step (the reference saves it to
        # files of its own, idr_train.py:188-199)
        opt = state.cam_opt
        tree["pose_vecs"] = state.pose_vecs
        tree["cam_opt"] = {"m": opt.m, "v": opt.v, "step": opt.step}
    torch.save(tree, os.path.join(tmp, "state.pt"))
    blob = {"np_rng": rng_state}
    if generator is not None:
        blob["torch_generator"] = generator.get_state().numpy()
        blob["torch_generator_device"] = generator.device.type
    with open(os.path.join(tmp, "rng.json"), "w") as f:
        json.dump(_jsonable(blob), f)
    if os.path.exists(path):   # a step saved twice (the final save)
        old = f"{path}.old{os.getpid()}"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    latest = os.path.join(os.path.abspath(ckpt_dir), "latest.txt")
    with open(latest + ".tmp", "w") as f:
        f.write(str(step))
    os.replace(latest + ".tmp", latest)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "latest.txt")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def load_checkpoint(ckpt_dir: str, step: Optional[int], map_location="cpu"):
    """(state.pt's dict, rng.json's dict or None) of a step (None: the
    latest) with the tensors on ``map_location``. Raises
    FileNotFoundError naming the step's path if it is missing."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = step_path(ckpt_dir, step)
    state_file = os.path.join(path, "state.pt")
    if not os.path.exists(state_file):
        raise FileNotFoundError(f"no checkpoint at {path}")
    # the scheduler's state holds a collections.Counter
    tree = torch.load(state_file, map_location=map_location,
                      weights_only=False)
    rng_state = None
    rng_path = os.path.join(path, "rng.json")
    if os.path.exists(rng_path):
        with open(rng_path) as f:
            rng_state = _unjsonable(json.load(f))
    return tree, rng_state


def restore_checkpoint(ckpt_dir: str, step: Optional[int], state):
    """Loads a step into ``state`` (TrainState, in place, onto the device of
    its network). A state with cameras takes the checkpoint's camera state,
    or None where the checkpoint holds none (as the JAX package's restore
    returns it), so the caller can raise its own error. Returns (epoch,
    rng_state)."""
    dev = next(state.net.parameters()).device
    tree, rng_state = load_checkpoint(ckpt_dir, step, map_location=dev)
    state.net.load_state_dict(tree["net"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.scheduler.load_state_dict(tree["scheduler"])
    if state.pose_vecs is not None:
        state.pose_vecs = tree.get("pose_vecs")
        state.cam_opt = (SparseAdamState(**tree["cam_opt"])
                         if "cam_opt" in tree else None)
    return tree["epoch"], rng_state


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return {"__nd__": obj.tolist(), "dtype": str(obj.dtype)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _unjsonable(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return np.asarray(obj["__nd__"], dtype=obj["dtype"])
        return {k: _unjsonable(v) for k, v in obj.items()}
    return obj
