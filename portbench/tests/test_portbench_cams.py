"""The trained-cameras driver (``drivers/train_cams.py``) on the CPU at the
tiny size (``tiny.py``): a whole run through ``run.measure`` with the pose
gaps, and a program whose poses do not move refused."""
import torch

from portbench import run
from portbench.common import Cell, load_benchmark
from portbench.tests import tiny

NAME = "dtu_kernels.train_c_cams"


def _measure(tmp_path, seed):
    real = Cell(load_benchmark(), NAME)
    cell = tiny.cell(NAME, real.config_name)
    cell.end_to_end, cell.per_layer = real.end_to_end, real.per_layer
    res, checks = run.measure(cell, seed, 0.5, False, torch.device("cpu"),
                              cache=str(tmp_path))
    return res, {k: v for k, v, _ in checks}


def test_sound_run_is_correct(tmp_path):
    res, got = _measure(tmp_path, 2 ** 31 + 41)
    assert res["correct"] and res["attempted"] > 0, got
    assert {"pose_grad_gap", "pose_update_gap"} <= set(got)
    assert got["pose_grad_gap"] <= 1e-5, got


def test_poses_left_unchanged_are_not_correct(tmp_path, monkeypatch):
    from mvsdf_tpu_torch.train import step
    keep = step.sparse_adam_step
    monkeypatch.setattr(step, "sparse_adam_step",
                        lambda st, pv, *a, **k: (keep(st, pv, *a, **k)[0],
                                                 pv))
    res, got = _measure(tmp_path, 2 ** 31 + 43)
    assert not res["correct"]
    assert got["pose_update_gap"] > 0.5, got
