"""The data-parallel driver (``drivers/train_ddp.py``) on the CPU at the
tiny size (``tiny.py``), two gloo ranks: a whole run through
``run.measure``, the traced block's readings on every rank, and the
refusal of a program that does not fuse under a process group."""
import numpy as np
import pytest
import torch

from portbench import run
from portbench.common import Cell, driver_module, load_benchmark, \
    read_metrics
from portbench.tests import tiny

NAME = "ddp4_dtu_kernels.train_c"


def cell():
    real = Cell(load_benchmark(), NAME)
    c = tiny.cell(real.name, real.config_name)
    c.config["ranks"] = 2
    c.end_to_end, c.per_layer = real.end_to_end, real.per_layer
    return c


def test_a_run_is_correct_with_equal_replicas(tmp_path):
    res, checks = run.measure(cell(), 2 ** 31 + 17, 0.5, False,
                              torch.device("cpu"), cache=str(tmp_path))
    got = {k: v for k, v, _ in checks}
    assert res["correct"] and res["attempted"] > 0, got
    assert got["replica_gap"] == 0
    assert max(got[k] for k in ("loss_gap", "grad_gap", "update_gap")) \
        <= 1e-4, got
    assert {"train_rays_per_s", "setup_s"} <= set(res["metrics"])


def test_the_traced_block_reads_every_rank(tmp_path):
    c = cell()
    drv = driver_module(c.kind).Driver(c, 2 ** 31 + 19, torch.device("cpu"),
                                       True, cache=str(tmp_path))
    drv.setup()
    drv.window(0.2)
    got = drv._all("traced_block", 1, gather=True)
    drv.release()
    # the tiny scene's 9 views in batches of 2: 4 steps an epoch
    steps = c.traffic["chunk_epochs"] * 4
    for g in got:
        assert len(g["to_allreduce_ns"]) == len(g["allreduce_ns"]) == steps
        assert (g["allreduce_ns"] > 0).all()
        s = g["summary"]
        assert s["allreduces_per_step"] == 5
        assert s["step_stage_ms.allreduce"] > 0
    pre = np.stack([g["to_allreduce_ns"] for g in got])
    ctx = {"ddp": {"world": 2, "model": c.config["model"],
                   "allreduce_ms": float(np.median(got[0]["allreduce_ns"]))
                   / 1e6,
                   "rank_skew_ms": float(np.median(pre.max(0) - pre.min(0)))
                   / 1e6}}
    m = read_metrics(c.per_layer, ctx)
    assert {"allreduce_ms_per_step.train", "allreduce_busbw_share.train",
            "rank_skew_ms_per_step.train"} <= set(m)
    assert drv.check()[-1] == ("replica_gap", 0.0, 0)


def test_a_program_that_does_not_fuse_is_refused_before_spawning(
        tmp_path, monkeypatch):
    from mvsdf_tpu_torch.train import loop
    monkeypatch.delattr(loop, "fuses")
    c = cell()
    drv = driver_module(c.kind).Driver(c, 3, torch.device("cpu"), False,
                                       cache=str(tmp_path))
    with pytest.raises(SystemExit) as e:
        drv.setup()
    assert e.value.code == 2 and drv.procs == []
