"""The trained-cameras traffic (``--train_cameras``) held to the
benchmark's reference of it (``portbench/reference/cams.py``: the poses an
(n, 7) leaf, the plain reference's losses, SparseAdam on the rows a batch
touched) on the CPU at the tiny size (``portbench/tests/tiny.py``): the
port's pose gradient and pose updates against the reference's, and the
reference's own pieces. No JAX needed.
"""
import tempfile

import numpy as np
import pytest
import torch

from mvsdf_tpu_torch.geometry.cameras import quat_to_rot
from mvsdf_tpu_torch.train.cameras_opt import pose_vecs_from_matrices


@pytest.fixture(scope="module")
def tiny_cams_driver():
    from portbench.common import driver_module
    from portbench.tests import tiny
    cell = tiny.cell("dtu_kernels.train_c_cams", "mvsdf_dtu_kernels")
    drv = driver_module(cell.kind).Driver(cell, 2 ** 31 + 29,
                                          torch.device("cpu"), False,
                                          cache=tempfile.mkdtemp())
    drv.setup()
    drv.release()
    return drv


def test_pose_gradient_and_updates_against_the_reference(tiny_cams_driver):
    """Step 2's pose gradient (from SparseAdam's moments) on the rows it
    touched, and three steps' pose changes, against the reference's: the
    worst row within 1e-5 and 1e-3 (measured 1.6e-7 and 1.1e-4: the
    program's bias corrections in f32, the reference's in double); the
    field's gaps within 1e-4 as the f32 cells'. Half of each batch left
    out moves other rows: the update gap reads 1."""
    from portbench.calibrate import half_batch
    drv = tiny_cams_driver
    ref = drv.reference()
    got = drv.readings(drv.program(), ref)
    assert got["pose_grad_gap"] <= 1e-5 and got["pose_update_gap"] <= 1e-3, \
        got
    assert max(got[k] for k in ("loss_gap", "grad_gap", "update_gap")) \
        <= 1e-4, got
    fault = drv.readings(half_batch(drv), ref)
    assert fault["pose_grad_gap"] > 0.5 and fault["pose_update_gap"] > 0.5


def test_the_scene_of_its_own_links_the_cells_scene(tiny_cams_driver):
    """The cell's scene directory links every file of the configuration's
    and adds the initial cameras; the configuration's scene has none."""
    import os
    drv = tiny_cams_driver
    base = os.path.join(os.path.dirname(drv.root), drv.base_config)
    assert not os.path.exists(os.path.join(base, "scene",
                                           "cameras_linear_init.npz"))
    assert os.path.isfile(os.path.join(drv.root, "scene",
                                       "cameras_linear_init.npz"))
    assert os.path.islink(os.path.join(drv.root, "scene", "cameras_hd.npz"))


def test_initial_poses_are_two_degrees_and_one_percent_off(
        tiny_cams_driver):
    """The reference's initial rows: the program's rotations and centres
    (its quaternion may be the other sign), each turned 2 degrees and
    moved 1% of its distance from the ground truth."""
    from portbench.reference import cams
    from portbench.reference.scene import Scene
    drv = tiny_cams_driver
    rows = cams.initial_poses(drv.root, torch.device("cpu"))
    R = cams.pose_matrices(rows)[:, :3, :3]
    assert torch.allclose(R, quat_to_rot(drv.pose0[:, :4]), atol=1e-6)
    assert torch.allclose(rows[:, 4:], drv.pose0[:, 4:], atol=1e-6)
    true = Scene(drv.root, torch.device("cpu")).poses
    cos = ((R.transpose(1, 2) @ true[:, :3, :3]).diagonal(
        dim1=1, dim2=2).sum(-1) - 1) / 2
    assert np.allclose(np.degrees(np.arccos(cos.clamp(-1, 1).numpy())), 2.0,
                       atol=1e-2)
    c = true[:, :3, 3]
    moved = (rows[:, 4:] - c).norm(dim=1) / c.norm(dim=1)
    assert torch.allclose(moved, torch.full_like(moved, 0.01), atol=1e-4)


def test_quaternion_round_trip():
    """``reference/cams.quaternion`` and ``pose_matrices`` invert each
    other, on rotations of every branch (trace below -1 too), and give
    the program's quaternion up to its sign."""
    from portbench.reference import cams
    rng = np.random.default_rng(0)
    for _ in range(50):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = quat_to_rot(torch.tensor(q)).numpy()
        got = cams.quaternion(R)
        assert np.allclose(got, q) or np.allclose(got, -q)
        pose = np.eye(4)
        pose[:3, :3] = R
        prog = pose_vecs_from_matrices(pose[None])[0, :4]
        assert np.allclose(np.abs(got @ prog), 1, atol=1e-6)
        back = cams.pose_matrices(torch.tensor(
            np.concatenate([got, [0.0, 0.0, 0.0]])[None],
            dtype=torch.float64))[0, :3, :3]
        assert np.allclose(back.numpy(), R, atol=1e-12)
