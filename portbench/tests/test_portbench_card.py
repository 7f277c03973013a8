"""The command end to end on the card, and without one."""
import json
import os
import subprocess
import sys

import pytest

from portbench.common import ROOT

RUN = [sys.executable, os.path.join("portbench", "run.py")]


def _run(*args, cwd=ROOT, timeout=900):
    return subprocess.run(RUN + list(args), cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def test_without_a_card_it_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _run("--workload", "dtu_kernels.train_c", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_nothing_loads_jax_or_the_ported_package(tmp_path):
    """A run's imports, in a process of its own: the harness, every
    driver, reader and reference module, and the program's modules a run
    reaches, then a tiny CPU run."""
    code = f"""
import sys, torch
sys.path.insert(0, {ROOT!r})
from portbench import run, calibrate
from portbench.common import load_benchmark, load_reader, forbidden_modules
from portbench.reference import field, scene, step, trace
from portbench.tests import tiny
bench = load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    load_reader(m["name"])
name = "dtu_kernels.train_c"
cell = tiny.cell(name, tiny.config_of(name))
cell.end_to_end = bench["end_to_end"]
run.measure(cell, 3, 0.2, False, torch.device("cpu"),
            cache={str(tmp_path)!r})
print("FOUND", forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, env=dict(os.environ,
                                                        JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "FOUND []"


def test_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
from portbench.reference import field, scene, step, trace
print(sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "flax", "mvsdf_tpu", "mvsdf_tpu_torch")))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_only_the_benchmarks_files_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    its paths, a run fails and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _run("--workload", "dtu_kernels.train_c", "--seed", "1",
             "--seconds", "1", "--trace", "0", cwd=str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _run("--workload", "dtu_kernels.train_c", "--seed", "5",
             "--seconds", "2", "--trace", "0")
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_rays_per_s", "peak_mem_gib",
                                    "setup_s"}
