"""The training CLI on its fused default against --no_fused, per phase.

Writes chip_smoke.py phase 7's DTU-sized scene directory (49 views,
1600x1200 images, 800x600 depth maps) once, then runs the training CLI
(``--allow_random_features``, with ``--pallas`` unless ``--plain``, B=8 x
P=4096, full width, epochs 0..6: phases A, B, C) in a process of its own
for each arm, in the order of ``--arms`` (fused, --no_fused, --no_fused,
fused), for each cell of ``--cells``: cli_dtu49, and cli_cams with
--train_cameras (initial cameras 2 degrees and 1% off, as phase 9). For
each run: ms/step and rays/s per phase (``metrics.jsonl``'s
``ms_per_step``), the capture's seconds and graph pool per phase and the
peak allocation (the CLI's log), and the run's wall seconds. ``--repo``
runs another checkout's CLI (a parent unpacked beside this one) on the
same scene.

    python3 scripts/port_fused_cli.py [--nepoch 6] [--plain]
        [--cells cli_dtu49,cli_cams] [--arms fused,no_fused,no_fused,fused]
        [--repo DIR] [--out f]

Prints one JSON object (and writes it to --out if given). Needs a GPU.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CAPTURE = re.compile(r"phase (\d): step captured in ([0-9.]+) s, graph pool "
                     r"([-0-9.]+) MiB")
PEAK = re.compile(r"peak memory ([0-9.]+) GiB")


def run(repo, data_dir, exps, name, nepoch, extra):
    argv = ["--data_dir", data_dir, "--exps_folder", exps, "--expname",
            name, "--allow_random_features", "--nepoch", str(nepoch), *extra]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "mvsdf_tpu_torch.train.cli",
                          *argv], cwd=repo, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=repo))
    wall = time.perf_counter() - t0
    if res.returncode:
        raise RuntimeError(f"{name}: {res.stderr[-3000:]}")
    (stamp,) = os.listdir(os.path.join(exps, name))
    with open(os.path.join(exps, name, stamp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    phases = {}
    for ph, label in enumerate("ABC"):
        ms = [r["ms_per_step"] for r in rows if r["phase"] == ph]
        if ms:
            phases[label] = {"ms_per_step": ms,
                             "mean_ms": sum(ms) / len(ms),
                             "mean_after_first": (sum(ms[1:]) / len(ms[1:])
                                                  if len(ms) > 1 else None)}
    captures = {int(p): {"s": float(s), "graph_pool_mib": float(m)}
                for p, s, m in CAPTURE.findall(res.stdout)}
    peak = PEAK.findall(res.stdout)
    return {"wall_s": wall, "phases": phases, "captures": captures,
            "peak_gib": float(peak[-1]) if peak else None,
            "losses": [r["loss"] for r in rows]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nepoch", type=int, default=6)
    ap.add_argument("--plain", action="store_true",
                    help="the plain field's trace (no --pallas)")
    ap.add_argument("--cells", default="cli_dtu49,cli_cams")
    ap.add_argument("--arms", default="fused,no_fused,no_fused,fused")
    ap.add_argument("--repo", default=REPO,
                    help="the checkout whose training CLI runs")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    import torch
    if not torch.cuda.is_available():
        sys.exit("port_fused_cli: needs a CUDA GPU")
    from chip_smoke import CAMS_NOISE, CLI_DEPTH, CLI_IMG, CLI_VIEWS
    from mvsdf_tpu_torch.data.synthetic import write_pose_init, \
        write_scene_dir
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"device": smi, "repo": os.path.relpath(repo, REPO),
           "plain": args.plain, "runs": []}
    pallas = () if args.plain else ("--pallas",)
    with tempfile.TemporaryDirectory(prefix="mvsdf_fused_cli_") as tmp:
        data_dir = write_scene_dir(tmp, n_images=CLI_VIEWS, img_hw=CLI_IMG,
                                   depth_hw=CLI_DEPTH)
        write_pose_init(data_dir, *CAMS_NOISE)
        exps = os.path.join(tmp, "exps")
        i = 0
        for cell in args.cells.split(","):
            cams = {"cli_dtu49": (), "cli_cams": ("--train_cameras",)}[cell]
            for arm in args.arms.split(","):
                extra = pallas + cams + {"fused": (),
                                         "no_fused": ("--no_fused",)}[arm]
                r = run(repo, data_dir, exps, f"run{i}", args.nepoch, extra)
                r.update(cell=cell, path=arm)
                out["runs"].append(r)
                print(json.dumps({k: r[k] for k in ("cell", "path", "wall_s",
                                                    "captures", "peak_gib")})
                      + " " +
                      json.dumps({k: round(v["mean_ms"], 1)
                                  for k, v in r["phases"].items()}),
                      flush=True)
                i += 1
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
