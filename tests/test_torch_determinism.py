"""The repair of the port's run-to-run reproducibility
(``data/featext.deterministic_cudnn``) on the CPU.

- ``deterministic_cudnn()`` turns cuDNN's deterministic algorithms on and
  its autotuning off, and on leaving restores both as they were: from the
  defaults, from a caller's own settings, nested, and when the block
  raises.
- ``scene.frozen_features`` runs the FeatExt inside it (the network sees
  the flags set) and leaves them as they were; the shaded scene's features
  computed twice are equal, bit for bit.
- Two runs of 3 narrow bench-configuration training steps from seed 0,
  each in a process of its own (they step Adam), end with equal metrics
  and equal parameters, bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

from mvsdf_tpu_torch.data.featext import deterministic_cudnn
from mvsdf_tpu_torch.data.scene import frozen_features
from mvsdf_tpu_torch.data.synthetic import shaded_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flags():
    return (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


@pytest.fixture
def clean():
    saved = _flags()
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        saved


def test_the_context_turns_on_and_off_from_the_defaults(clean):
    before = _flags()
    assert before == (False, False)
    with deterministic_cudnn():
        assert _flags() == (True, False)
    assert _flags() == before


def test_the_context_restores_a_callers_own_settings(clean):
    torch.backends.cudnn.benchmark = True
    with deterministic_cudnn():
        assert _flags() == (True, False)
        with deterministic_cudnn():
            assert _flags() == (True, False)
        assert _flags() == (True, False)
    assert _flags() == (False, True)


def test_the_context_is_left_when_the_block_raises(clean):
    torch.backends.cudnn.benchmark = True
    with pytest.raises(KeyError):
        with deterministic_cudnn():
            raise KeyError("x")
    assert _flags() == (False, True)


class _Recording(nn.Module):
    """Stands in for the FeatExt: records the cuDNN flags it runs under and
    returns its input as each of the three heads."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))
        self.seen = []

    def forward(self, x):
        self.seen.append(_flags())
        return x, x, x * self.w


def test_frozen_features_run_on_deterministic_cudnn(clean):
    net = _Recording()
    torch.backends.cudnn.benchmark = True
    rgbs = [np.zeros((3, 8, 8), np.float32)] * 3
    out = frozen_features(net, rgbs, (8, 8))
    assert out.shape == (3, 3, 8, 8)
    assert net.seen == [(True, False)]
    assert _flags() == (False, True)


def test_shaded_features_twice_are_equal():
    rgbs = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    a = shaded_features(rgbs, 16, device="cpu")
    b = shaded_features(rgbs, 16, device="cpu")
    assert a.shape == (2, 32, 16, 16) and np.abs(a).max() > 0
    np.testing.assert_array_equal(a, b)


RUN = r"""
import dataclasses, sys
import numpy as np, torch
from mvsdf_tpu_torch import bench
from mvsdf_tpu_torch.train.step import (advance_epoch, init_train_state,
                                        make_train_step)
cfg = bench.bench_config({})
m = cfg.model
cfg = dataclasses.replace(cfg, train=dataclasses.replace(
    cfg.train, batch_size=2, num_pixels=128), model=dataclasses.replace(
    m, implicit=dataclasses.replace(m.implicit, dims=(64,) * 3,
                                    skip_in=(2,), feature_vector_size=16),
    render=dataclasses.replace(m.render, dims=(64,), feature_vector_size=16)))
dev = torch.device("cpu")
batch = bench.bench_batch(cfg, dev, img_hw=48, depth_hw=24, feat_ch=8)
out = {}
state = init_train_state(cfg, seed=0, device=dev)
step = make_train_step(cfg, phase_idx=1)
gen = torch.Generator().manual_seed(0)
for k in range(3):
    metrics = step(state, batch, cfg.schedule.weights(0.3), gen)
    advance_epoch(state)
    for n, v in metrics.items():
        out[f"m{k}:{n}"] = v.numpy()
for n, p in state.net.named_parameters():
    out[n] = p.detach().numpy()
np.savez(sys.argv[1], **out)
"""


def test_two_runs_agree_bit_for_bit(tmp_path):
    outs = []
    for r in range(2):
        out = tmp_path / f"run{r}.npz"
        res = subprocess.run([sys.executable, "-c", RUN, str(out)], cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=REPO,
                                      OMP_NUM_THREADS="2"),
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        outs.append(dict(np.load(out)))
    a, b = outs
    assert a.keys() == b.keys() and len(a) > 30
    assert np.isfinite(a["m2:loss"]) and a["m0:loss"] != a["m2:loss"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
