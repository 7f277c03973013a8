"""The program's trace row counter against the plain reference's count, on
the CPU at the tiny size: the first step of a cell, traced, asks for the
SDF rows that ``reference/trace.py``'s ``Counter`` adds up for the same
batch and weights, within 1%; the plain field's tiles run at least those
rows."""
import pytest
import torch

from portbench.common import driver_module
from portbench.tests import tiny


@pytest.mark.parametrize("name", ("dtu_kernels.train_c",
                                  "dtu_plain.train_c"))
def test_first_step_rows_match_the_reference_trace(name, tmp_path,
                                                    monkeypatch):
    from mvsdf_tpu_torch.tracing.kernels.stamp import ACTIVE, COMPUTED
    from mvsdf_tpu_torch.train import cli
    from mvsdf_tpu_torch.train.loop import Trainer
    setup, dispatch = cli.setup, Trainer._dispatch
    rows = []

    def traced(argv):
        trainer, args = setup(argv)
        trainer.set_tracing(True)
        return trainer, args

    def recorded(self, step, plan, epochs):
        chunk = dispatch(self, step, plan, epochs)
        rows.append(chunk["stamps"])
        return chunk
    monkeypatch.setattr(cli, "setup", traced)
    monkeypatch.setattr(Trainer, "_dispatch", recorded)
    cell = tiny.cell(name, tiny.config_of(name))
    drv = driver_module(cell.kind).Driver(cell, 2 ** 31 + 17,
                                          torch.device("cpu"), False,
                                          cache=str(tmp_path))
    drv.setup()
    first = rows[0][0]
    # the reference on the first step's batch, at the seed's weights
    drv.trainer.state.net.load_state_dict(drv.weights0)
    want = drv._reference_counts()["trace_rows"]
    drv.release()
    active, computed = int(first[ACTIVE]), int(first[COMPUTED])
    assert abs(active - want) <= 0.01 * want, (active, want)
    assert computed >= active
    if name.startswith("dtu_plain"):
        assert computed > active
