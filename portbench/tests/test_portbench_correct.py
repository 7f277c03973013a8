"""``correct`` at a size a test run holds, on the CPU: sound runs read
close to the reference, and a run with the timed path broken underneath
reads over its limits, for each cell. These skip the harness's look for a
card and drive the rest of a run (``run.measure``); the program takes its
plain versions on CPU tensors."""
import pytest
import torch

from portbench import run
from portbench.common import Cell, load_benchmark
from portbench.tests import tiny

BENCH = load_benchmark()
TRAIN = ("dtu_kernels.train_c", "dtu_plain.train_c", "dtu_kernels.train_a")


def measure(name, tmp_path, seed=2 ** 31 + 11):
    cell = tiny.cell(name, tiny.config_of(name))
    if name in {w["name"] for w in BENCH["workloads"]}:
        real = Cell(BENCH, name)
        cell.end_to_end, cell.per_layer = real.end_to_end, real.per_layer
    res, checks = run.measure(cell, seed, 0.5, False, torch.device("cpu"),
                              cache=str(tmp_path))
    return res, {k: v for k, v, _ in checks}


@pytest.mark.parametrize("name", TRAIN)
def test_sound_run_is_correct(name, tmp_path):
    res, got = measure(name, tmp_path)
    assert res["correct"], got
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device"}
    line = run.finish(res, [(k, v, 1.0) for k, v in got.items()],
                      {"platform": "gpu"})
    assert list(line)[-1] == "checks"
    for k, v in got.items():
        assert v <= 1e-4, (k, v)


def test_state_left_unchanged_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr("mvsdf_tpu_torch.train.step.adam_update",
                        lambda *a, **k: None)
    res, got = measure("dtu_kernels.train_c", tmp_path)
    assert not res["correct"]
    assert got["update_gap"] == pytest.approx(1.0)
    assert got["grad_gap"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from mvsdf_tpu_torch.train.device_data import DeviceSceneCache
    gather = DeviceSceneCache.gather

    def half(self, indices, sel):
        h = indices.shape[0] // 2
        return gather(self, torch.cat([indices[:h], indices[:h]]), sel)

    monkeypatch.setattr(DeviceSceneCache, "gather", half)
    res, got = measure("dtu_kernels.train_c", tmp_path)
    assert not res["correct"], got


def _driver(name, tmp_path, seed=2 ** 31 + 13):
    from portbench.common import driver_module
    cell = tiny.cell(name, tiny.config_of(name))
    drv = driver_module(cell.kind).Driver(cell, seed, torch.device("cpu"),
                                          False, cache=str(tmp_path))
    drv.setup()
    drv.release()
    return drv


@pytest.mark.parametrize("name", TRAIN)
def test_control_in_bfloat16_is_not_correct(name, tmp_path):
    """The reference in bfloat16 in the program's place fails one of the
    cell's limits."""
    drv = _driver(name, tmp_path)
    got = drv.readings(drv.in_place_of_program(
        drv.reference(control=True)))
    limits = drv.traffic["limits"]
    assert any(got[k] > limits[k] for k in limits), got
