"""The port's benchmark (``mvsdf_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU.

- Every ``MVSDF_BENCH_*`` switch, alone and as the fused set, builds the
  configuration bench.py builds for the same environment: the port's
  ``bench_config(env)`` equals, field by field (``dataclasses.asdict``,
  exactly), the JAX ``MVSDFConfig`` made with bench.py's replacements
  (``bench.py:65-147``, repeated below as ``jax_bench_config``), but for
  ``MVSDF_BENCH_FUSEDGRAD``: it selects JAX's hand-derived value +
  gradient backward, a path the port does not have, so the port reads no
  such switch and the comparison leaves it at its default. The
  defaults equal ``chip_smoke.bench_config()`` and the fused set
  ``chip_smoke.fused_config()``.
- ``MVSDF_BENCH_PRECISION``: default and tensorfloat32 mean TF32, highest
  full f32; any other value raises before the device is touched.
- The bench's constants are bench.py's.
- ``run_bench`` at a narrow width (SDF 3 x 64, 2 images x 128 rays) with 1
  warm-up step and 2 windows of 1 step, in a subprocess (it steps Adam):
  stdout holds exactly one line, the JSON object of bench.py's four keys,
  with ``value`` = B x P over the median window rounded to 0.1 and
  ``vs_baseline`` = that rate / 1e4 rounded to 1e-3, both exactly.
- Without a GPU the CLI raises.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench as jax_bench
from mvsdf_tpu import config as jc
from mvsdf_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWITCHES = ("PALLAS", "MARCH", "INKPE", "SECANT", "FILLSKIP", "COMPACT",
            "MARCH_COMPACT", "SUPCOMPACT", "BF16ACT")
DEFAULTS = {"PALLAS": "1", "MARCH": "0", "INKPE": "0", "SECANT": "0",
            "FILLSKIP": "1", "COMPACT": "1", "MARCH_COMPACT": "1",
            "SUPCOMPACT": "1", "BF16ACT": "1"}


def jax_bench_config(env):
    """bench.py's configuration for ``env``, its replacements in its
    order (bench.py:65-147) but MVSDF_BENCH_FUSEDGRAD's."""
    cfg = jc.MVSDFConfig(train=jc.TrainConfig(batch_size=jax_bench.N_IMAGES,
                                              num_pixels=jax_bench.N_PIX))
    rep = dataclasses.replace
    if env.get("MVSDF_BENCH_PALLAS", "1") == "1":
        march = env.get("MVSDF_BENCH_MARCH", "0") == "1"
        inkpe = env.get("MVSDF_BENCH_INKPE", "0") == "1"
        secant = env.get("MVSDF_BENCH_SECANT", "0") == "1"
        cfg = rep(cfg, model=rep(
            cfg.model, use_pallas_trace=True, use_pallas_march=march,
            pallas_in_kernel_pe=inkpe, use_pallas_secant=secant))
    if env.get("MVSDF_BENCH_FILLSKIP", "1") == "1":
        cfg = rep(cfg, model=rep(cfg.model, tracer=rep(
            cfg.model.tracer, fill_misses=False)))
    if env.get("MVSDF_BENCH_COMPACT", "1") == "1":
        tr = rep(cfg.model.tracer, sampler_capacity_frac=0.25,
                 fill_capacity_frac=0.5,
                 fallback_capacity_frac=(0.0625, 0.09375, 0.375))
        cfg = rep(cfg, model=rep(cfg.model, tracer=tr))
    if env.get("MVSDF_BENCH_MARCH_COMPACT", "1") == "1":
        tr = rep(cfg.model.tracer, march_compact_schedule=(
            (0, (0.375, 0.5)), (1, (0.1875, 0.25)),
            (5, (0.0625, 0.125, 0.25))))
        cfg = rep(cfg, model=rep(cfg.model, tracer=tr))
    if env.get("MVSDF_BENCH_SUPCOMPACT", "1") == "1":
        cfg = rep(cfg, model=rep(cfg.model, supervised_compact_frac=(0.375,)))
    if env.get("MVSDF_BENCH_BF16ACT", "1") == "1":
        cfg = rep(cfg, model=rep(cfg.model, implicit=rep(
            cfg.model.implicit, bf16_activations=True)))
    return cfg


def _flipped(name):
    return {f"MVSDF_BENCH_{name}": "0" if DEFAULTS[name] == "1" else "1"}


ENVS = {"defaults": {}, "fused": dict(bench.FUSED_SWITCHES),
        "fused_no_pallas": dict(bench.FUSED_SWITCHES,
                                MVSDF_BENCH_PALLAS="0"),
        "all_off": {f"MVSDF_BENCH_{s}": "0" for s in SWITCHES},
        **{f"flip_{s}": _flipped(s) for s in SWITCHES}}


@pytest.mark.parametrize("case", list(ENVS))
def test_each_switch_builds_bench_py_configuration(case):
    env = ENVS[case]
    got = dataclasses.asdict(bench.bench_config(env))
    want = dataclasses.asdict(jax_bench_config(env))
    assert got == want


def test_defaults_and_fused_equal_chip_smokes_configurations():
    import chip_smoke
    assert bench.bench_config() == bench.bench_config({}) == \
        chip_smoke.bench_config()
    assert bench.fused_config() == chip_smoke.fused_config() == \
        bench.bench_config(bench.FUSED_SWITCHES)
    fused = bench.fused_config().model
    assert fused.use_pallas_march and fused.use_pallas_secant and \
        fused.pallas_in_kernel_pe


def test_switches_log_their_state():
    lines = []
    bench.bench_config({"MVSDF_BENCH_FUSEDGRAD": "1",
                        "MVSDF_BENCH_BF16ACT": "0"}, lines.append)
    text = "\n".join(lines)
    assert "fused march: False" in text and "fused value+grad" not in text
    assert "bf16 activations" not in text and len(lines) == 5


def test_constants_are_bench_pys():
    for name in ("V100_RAYS_S", "N_IMAGES", "N_PIX", "FEAT_CH", "WARMUP",
                 "WINDOWS", "WINDOW_ITERS"):
        assert getattr(bench, name) == getattr(jax_bench, name), name


@pytest.mark.parametrize("value,tf32", [(None, True), ("default", True),
                                        ("tensorfloat32", True),
                                        ("highest", False)])
def test_precision_maps_as_the_training_cli(value, tf32):
    env = {} if value is None else {"MVSDF_BENCH_PRECISION": value}
    assert bench.precision(env) == (value or "default", tf32)


def test_an_unknown_precision_raises(monkeypatch):
    with pytest.raises(ValueError, match="MVSDF_BENCH_PRECISION"):
        bench.precision({"MVSDF_BENCH_PRECISION": "bf16"})
    monkeypatch.setenv("MVSDF_BENCH_PRECISION", "fastest")
    with pytest.raises(ValueError, match="fastest"):
        bench.main()


def test_the_cli_needs_a_gpu(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    monkeypatch.delenv("MVSDF_BENCH_PRECISION", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()


RUN = r"""
import dataclasses, json, sys
import torch
from mvsdf_tpu_torch import bench
cfg = bench.bench_config({})
m = cfg.model
cfg = dataclasses.replace(cfg, train=dataclasses.replace(
    cfg.train, batch_size=2, num_pixels=128), model=dataclasses.replace(
    m, implicit=dataclasses.replace(m.implicit, dims=(64,) * 3,
                                    skip_in=(2,), feature_vector_size=16),
    render=dataclasses.replace(m.render, dims=(64,), feature_vector_size=16)))
dev = torch.device("cpu")
batch = bench.bench_batch(cfg, dev, img_hw=48, depth_hw=24, feat_ch=8)
res = bench.run_bench(cfg, batch, dev, warmup=1, windows=2, window_iters=1)
json.dump(res, open(sys.argv[1], "w"))
"""


def test_run_bench_prints_one_line_of_bench_pys_keys(tmp_path):
    out = tmp_path / "res.json"
    res = subprocess.run([sys.executable, "-c", RUN, str(out)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  OMP_NUM_THREADS="2"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "train_rays_per_s_per_chip"
    assert line["unit"] == "rays/s"
    full = json.load(open(out))
    assert len(full["window_s"]) == 2
    rays_s = 2 * 128 / float(np.median(full["window_s"]))
    assert line["value"] == round(rays_s, 1) > 0
    assert line["vs_baseline"] == round(rays_s / 1.0e4, 3)
    assert {k: full[k] for k in line} == line
    assert "window ms" in res.stderr and "kernel launches a step" in \
        res.stderr and "peak memory not measured" in res.stderr
