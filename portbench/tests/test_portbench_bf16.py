"""The bf16 cells' driver (``drivers/train_bf16.py``) on the CPU at the
tiny size (``tiny.py``): a whole run through ``run.measure`` against the
bf16 reference, and the refusal of what the configuration's precision
rules out."""
import torch

from portbench import run
from portbench.common import Cell, driver_module, load_benchmark
from portbench.tests import tiny

NAME = "bf16_dtu_kernels.train_c"


def _cell():
    real = Cell(load_benchmark(), NAME)
    cell = tiny.cell(NAME, real.config_name)
    cell.end_to_end, cell.per_layer = real.end_to_end, real.per_layer
    return cell


def test_sound_run_is_correct(tmp_path):
    res, checks = run.measure(_cell(), 2 ** 31 + 31, 0.5, False,
                              torch.device("cpu"), cache=str(tmp_path))
    got = {k: v for k, v, _ in checks}
    assert res["correct"] and res["attempted"] > 0, got
    assert {"train_rays_per_s", "setup_s"} <= set(res["metrics"])
    assert got["loss_gap"] <= 1e-5 and got["grad_gap"] <= 2e-4, got


def test_f32_field_and_controls_are_not_correct(tmp_path):
    """The program's f32 field (no ``--bf16_acts``), the reference under
    bf16 autocast and half of each batch left out each fail a limit."""
    cell = _cell()
    cell.config["cli_args"] = ["--pallas"]
    drv = driver_module(cell.kind).Driver(cell, 2 ** 31 + 37,
                                          torch.device("cpu"), False,
                                          cache=str(tmp_path))
    drv.setup()
    drv.release()
    limits = drv.traffic["limits"]
    fails = lambda got: any(got[k] > limits[k] for k in limits)
    assert fails(drv.readings(drv.program())), "f32 field"
    ref = drv.reference()
    from portbench.calibrate import half_batch
    assert fails(drv.readings(drv.in_place_of_program(
        drv.reference(control=True)), ref))
    assert fails(drv.readings(half_batch(drv), ref))


def test_configuration_is_its_own():
    """The bf16 configuration names where its precision comes from, so
    its source and cuts are no other configuration's."""
    configs = load_benchmark()["configs"]
    mine = next(c for c in configs if c["name"] == "mvsdf_dtu_kernels_bf16")
    others = [(c["source"], c["reduced"]) for c in configs if c is not mine]
    assert (mine["source"], mine["reduced"]) not in others
