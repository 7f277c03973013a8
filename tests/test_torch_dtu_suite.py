"""The port's multi-scan suite (``validation/dtu_suite``) against the JAX
repo's ``scripts/dtu_suite.py``, loaded as ``tests/unit/test_dtu_suite.py``
loads it.

- The helpers (``scan_id``, ``find_data_dir``, ``parse_psnr``,
  ``parse_chamfer``) give the JAX script's results, case by case, and
  ``REFERENCE_TABLE`` is its table.
- With ``run_cli`` replaced on both sides by a recorder that writes what
  each CLI would, the port runs the JAX script's argument lists for every
  combination of flags below, module names mapped
  (``mvsdf_tpu.*`` -> ``mvsdf_tpu_torch.*``), and writes the same
  SUITE.json (timings aside) and SUITE.md layout.
- The suite end to end on the CPU (``--platform cpu``, a small conf) over
  two shaded scans written by ``data/synthetic.write_shaded_scene_dir``,
  through the port's three CLIs in processes of their own: every CLI
  succeeds and both rows have a PSNR and the reference columns.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from mvsdf_tpu_torch.data.synthetic import write_shaded_scene_dir
from mvsdf_tpu_torch.validation import dtu_suite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "jax_dtu_suite", os.path.join(REPO, "scripts", "dtu_suite.py"))
jax_suite = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_suite)
SIDES = {"jax": (jax_suite, "mvsdf_tpu."), "port": (dtu_suite,
                                                     "mvsdf_tpu_torch.")}
CONF = """
train{
    num_pixels = 64
    sched_milestones = [4/6, 5/6]
    sched_factor = 0.1
    plot_freq = 1/2
}
model{
    feature_vector_size = 16
    implicit_network {
        dims = [64, 64, 64, 64]
        geometric_init = True
        bias = 0.6
        skip_in = [2]
        weight_norm = True
        multires = 6
    }
    rendering_network {
        mode = idr
        dims = [64, 64]
        weight_norm = True
        multires_view = 4
    }
}
"""


@pytest.mark.parametrize("name", ["scan114", "24", "scan_24_b", "nope", "",
                                  "imfunc4"])
def test_scan_id_matches_the_jax_script(name):
    assert dtu_suite.scan_id(name) == jax_suite.scan_id(name)


@pytest.mark.parametrize("layout", ["imfunc4", "flat", "other", "none",
                                    "both"])
def test_find_data_dir_matches_the_jax_script(tmp_path, layout):
    scan = tmp_path / "scan24"
    scan.mkdir()
    subs = {"imfunc4": ["imfunc4"], "flat": ["."], "other": ["scene"],
            "none": [], "both": ["b_scene", "imfunc4"]}[layout]
    for sub in subs:
        (scan / sub).mkdir(exist_ok=True)
        (scan / sub / "cameras_hd.npz").write_bytes(b"")
    (scan / "a_empty").mkdir()
    assert dtu_suite.find_data_dir(str(scan)) == \
        jax_suite.find_data_dir(str(scan))


@pytest.mark.parametrize("psnr,chamfer", [
    ("RENDERING EVALUATION x: psnr mean = 25.72 ; psnr std = 1.00\n",
     "DTU EVALUATION x: accuracy = 0.4000 ; completeness = 0.5000 ; "
     "overall = 0.4500\n"),
    ("no number here\n", "completeness = 1.25\n"),
    (None, None)])
def test_parsers_match_the_jax_script(tmp_path, psnr, chamfer):
    if psnr is not None:
        (tmp_path / "psnr.txt").write_text(psnr)
        (tmp_path / "chamfer.txt").write_text(chamfer)
    for fn in ("parse_psnr", "parse_chamfer"):
        assert getattr(dtu_suite, fn)(str(tmp_path)) == \
            getattr(jax_suite, fn)(str(tmp_path)), fn


def test_reference_table_is_the_jax_scripts():
    assert dtu_suite.REFERENCE_TABLE == jax_suite.REFERENCE_TABLE


def _data_root(root, gt):
    data = root / "data"
    for scan, sub in (("scan24", "imfunc4"), ("scan37", "."),
                      ("scan110", "scene")):
        d = data / scan / sub
        d.mkdir(parents=True, exist_ok=True)
        (d / "cameras_hd.npz").write_bytes(b"")
    (data / "notes").mkdir()
    if gt:
        (root / "gt" / "Points" / "stl").mkdir(parents=True)
        (root / "gt" / "ObsMask").mkdir(parents=True)
        (root / "gt" / "Points" / "stl" / "stl024_total.ply").write_text("")
        (root / "gt" / "ObsMask" / "ObsMask24_10.mat").write_text("")
        (root / "gt" / "ObsMask" / "Plane37.mat").write_text("")
        (root / "gt" / "Points" / "stl" / "stl037_total.ply").write_text("")
    return data


def _recorder(calls, prefix, fail_scan=None):
    """run_cli as the CLIs would leave things: a checkpoint from training,
    psnr.txt, chamfer.txt (with --dtu_stl) and a mesh from evaluation."""
    def run_cli(module, cli_args, log_path):
        calls.append((module[len(prefix):], list(cli_args),
                      os.path.basename(log_path)))
        if module.endswith("train.cli"):
            name = cli_args[cli_args.index("--expname") + 1]
            if name == fail_scan:
                return False
            exps = cli_args[cli_args.index("--exps_folder") + 1]
            os.makedirs(os.path.join(exps, name, "2026_01_01_00_00_00",
                                     "checkpoints"), exist_ok=True)
        elif module.endswith("eval.cli"):
            name = cli_args[cli_args.index("--expname") + 1]
            d = os.path.join(cli_args[cli_args.index("--evals_folder") + 1],
                             name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "psnr.txt"), "w") as f:
                f.write(f"psnr mean = {20 + len(name)}.5 ; psnr std = 1\n")
            if "--dtu_stl" in cli_args:
                with open(os.path.join(d, "chamfer.txt"), "w") as f:
                    f.write("accuracy = 0.3 ; completeness = 0.7 ; "
                            "overall = 0.5\n")
            for e in (2, 10):
                open(os.path.join(
                    d, f"surface_world_coordinates_{e}.obj"), "w").close()
        return True
    return run_cli


FLAGS = {
    "defaults": [],
    "synthetic": ["--pallas", "--allow_random_features", "--nepoch", "4",
                  "--resolution", "128", "--meshcut_thresh", "auto",
                  "--scans", "24,37"],
    "all": ["--scans", "scan37,110,24", "--pallas", "--bf16_acts",
            "--allow_random_features", "--platform", "cpu", "--conf",
            "small.conf", "--batch_size", "3", "--num_pixels", "64",
            "--no_rendering", "--meshcut_thresh", "15", "--dtu_max_dist",
            "7.5", "--dtu_downsample", "0.4", "--out", "RUN"],
    "gt": ["--dtu_gt_root", "GT", "--exps_folder", "e",
           "--evals_folder", "v"],
    "failed_training": ["--scans", "24,37"],
}


def _run_side(side, tmp_path, monkeypatch, flags, resume=False,
              fail_scan=None):
    mod, prefix = SIDES[side]
    root = tmp_path / side
    root.mkdir()
    data = _data_root(root, gt=True)
    monkeypatch.chdir(root)
    flags = [str(root / "gt") if f == "GT" else f for f in flags]
    calls = []
    monkeypatch.setattr(mod, "run_cli", _recorder(calls, prefix, fail_scan))
    argv = ["--data_root", str(data)] + flags
    mod.main(argv)
    if resume:
        mod.main(argv)
    out = "RUN" if "RUN" in flags else "SUITE"
    with open(out + ".json") as f:
        summary = json.load(f)
    with open(out + ".md") as f:
        md = f.read()
    calls = [(m, [a.replace(str(root), "ROOT") for a in args], log)
             for m, args, log in calls]
    return calls, summary, md


def _timeless(summary):
    s = dict(summary, wall_s=None)
    s["scans"] = [dict(r, train_s=None, eval_s=None) for r in s["scans"]]
    return s


@pytest.mark.parametrize("case", list(FLAGS) + ["resume"])
def test_the_suite_runs_the_jax_scripts_commands(tmp_path, monkeypatch,
                                                 case):
    flags = FLAGS.get(case, FLAGS["defaults"])
    kw = dict(resume=case == "resume",
              fail_scan="scan37" if case == "failed_training" else None)
    jax_calls, jax_summary, jax_md = _run_side("jax", tmp_path, monkeypatch,
                                               flags, **kw)
    calls, summary, md = _run_side("port", tmp_path, monkeypatch, flags,
                                   **kw)
    assert calls == jax_calls and len(calls) >= 3
    assert _timeless(summary) == _timeless(jax_summary)
    head = lambda t: [line.split("|")[1:2] for line in t.splitlines()]
    assert head(md) == head(jax_md)
    if case == "resume":   # the second pass skips training
        assert [m for m, _, _ in calls].count("train.cli") == 3


def test_the_suite_end_to_end_on_the_cpu(tmp_path):
    """Two shaded scans through the port's three CLIs (small conf,
    --platform cpu): every CLI succeeds, SUITE.json has both rows with a
    PSNR and the reference columns, and the logs name the port's CLIs."""
    data = tmp_path / "data"
    for scan in ("scan24", "scan37"):
        write_shaded_scene_dir(str(data / scan / "imfunc4"), views=4,
                               img_hw=32, depth_hw=16)
    (tmp_path / "small.conf").write_text(CONF)
    res = subprocess.run(
        [sys.executable, "-m", "mvsdf_tpu_torch.validation.dtu_suite",
         "--data_root", str(data), "--platform", "cpu", "--conf",
         "small.conf", "--pallas", "--allow_random_features", "--nepoch",
         "1", "--batch_size", "3", "--num_pixels", "64", "--resolution",
         "32", "--meshcut_thresh", "auto"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert res.returncode == 0 and "FAILED" not in res.stdout, \
        res.stdout[-3000:] + res.stderr[-3000:]
    summary = json.loads((tmp_path / "SUITE.json").read_text())
    rows = {r["scan"]: r for r in summary["scans"]}
    assert sorted(rows) == ["scan24", "scan37"]
    for scan, r in rows.items():
        assert isinstance(r["psnr"], float) and r["psnr"] > 0
        assert (r["ref_chamfer"], r["ref_psnr"]) == \
            dtu_suite.REFERENCE_TABLE[dtu_suite.scan_id(scan)]
        log = (tmp_path / f"suite_{scan}.log").read_text()
        mods = [line.split(" -m ", 1)[1].split()[0]
                for line in log.splitlines() if line.startswith("$ ")]
        assert mods == ["mvsdf_tpu_torch.train.cli",
                        "mvsdf_tpu_torch.eval.cli",
                        "mvsdf_tpu_torch.meshcut.cli"]
        assert any(f.endswith("_trimmed.obj")
                   for f in os.listdir(tmp_path / "evals" / scan))
    assert summary["mean_psnr"] is not None
    assert "| scan24 |" in (tmp_path / "SUITE.md").read_text()
