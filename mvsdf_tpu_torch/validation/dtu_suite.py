"""Multi-scan DTU suite (counterpart of the JAX repo's
``scripts/dtu_suite.py``, same flags and outputs): per scan it runs the
port's training CLI (skipped when a checkpoint exists, unless --force),
its eval CLI (mesh, rendering PSNR, and the official-protocol chamfer when
the DTU ground truth is there) and optionally its trimming CLI, each in a
process of its own with its output in ``suite_<scan>.log``; then it sets
the per-scan numbers beside the reference's published 15-scan table
(mean chamfer 0.890, PSNR 25.72) in ``<out>.md`` and ``<out>.json``.

    python -m mvsdf_tpu_torch.validation.dtu_suite --data_root DATA \
        [--scans 24,37,...] [--dtu_gt_root SampleSet/MVS_Data] [--pallas] \
        [--platform cpu] ...

The CLIs run on the GPU unless ``--platform cpu`` is given; the scans run
one after another.

DTU ground-truth layout (the official SampleSet / "MVS Data" release):
    <gt_root>/Points/stl/stl{scan:03d}_total.ply
    <gt_root>/ObsMask/ObsMask{scan}_10.mat
    <gt_root>/ObsMask/Plane{scan}.mat
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Published reference results (ref README.md:45-62) for the comparison
# column; keyed by scan id.
REFERENCE_TABLE = {
    24: (0.846, 24.67), 37: (1.894, 20.15), 40: (0.895, 25.15),
    55: (0.435, 23.19), 63: (1.067, 26.24), 65: (0.903, 26.90),
    69: (0.746, 26.54), 83: (1.241, 25.15), 97: (1.009, 25.71),
    105: (1.320, 26.48), 106: (0.867, 28.81), 110: (0.842, 23.16),
    114: (0.340, 27.51), 118: (0.472, 28.46), 122: (0.466, 27.71),
}


def scan_id(name):
    m = re.search(r"(\d+)", name)
    return int(m.group(1)) if m else None


def find_data_dir(scan_root):
    """The actual --data_dir inside a scan dir: the reference layout is
    <root>/scan<N>/imfunc4 (ref README.md:38) — cameras_hd.npz marks it."""
    if os.path.exists(os.path.join(scan_root, "cameras_hd.npz")):
        return scan_root
    for sub in ("imfunc4",) + tuple(sorted(os.listdir(scan_root))):
        d = os.path.join(scan_root, sub)
        if os.path.isdir(d) and os.path.exists(
                os.path.join(d, "cameras_hd.npz")):
            return d
    return scan_root


def run_cli(module, cli_args, log_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", module] + cli_args
    with open(log_path, "a") as log:
        log.write("\n$ " + " ".join(cmd) + "\n")
        log.flush()
        rc = subprocess.call(cmd, stdout=log, stderr=subprocess.STDOUT,
                             env=env, cwd=os.getcwd())
    if rc != 0:
        print(f"  FAILED (rc={rc}) — see {log_path}")
    return rc == 0


def parse_psnr(evaldir):
    path = os.path.join(evaldir, "psnr.txt")
    if not os.path.exists(path):
        return None
    m = re.search(r"psnr mean = ([0-9.]+)", open(path).read())
    return float(m.group(1)) if m else None


def parse_chamfer(evaldir):
    path = os.path.join(evaldir, "chamfer.txt")
    if not os.path.exists(path):
        return None
    txt = open(path).read()
    out = {}
    for key in ("accuracy", "completeness", "overall"):
        m = re.search(rf"{key} = ([0-9.]+)", txt)
        if m:
            out[key] = float(m.group(1))
    return out or None


def main(argv=None):
    ap = argparse.ArgumentParser(description="DTU multi-scan suite "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--data_root", required=True,
                    help="directory containing per-scan data dirs "
                         "(scan24/, scan37/, ... in the reference layout)")
    ap.add_argument("--scans", default="",
                    help="comma list of scan dir names or ids "
                         "(default: every scan*/ under data_root)")
    ap.add_argument("--dtu_gt_root", default="",
                    help="official DTU SampleSet MVS-Data root (Points/stl "
                         "+ ObsMask); enables protocol chamfer per scan")
    ap.add_argument("--exps_folder", default="exps")
    ap.add_argument("--evals_folder", default="evals")
    ap.add_argument("--nepoch", type=int, default=1800)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_pixels", type=int, default=4096)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--conf", default="")
    ap.add_argument("--platform", default="", choices=["", "cpu", "cuda"],
                    help="passed to the CLIs: 'cpu' runs them on the "
                         "CPU; the default is the GPU")
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--bf16_acts", action="store_true")
    ap.add_argument("--allow_random_features", action="store_true",
                    help="smoke/synthetic runs only — see train CLI")
    ap.add_argument("--dtu_max_dist", type=float, default=20.0,
                    help="protocol distance truncation (mm for real DTU)")
    ap.add_argument("--dtu_downsample", type=float, default=0.2,
                    help="densify/downsample density (mm for real DTU)")
    ap.add_argument("--no_rendering", action="store_true",
                    help="skip the per-view rendering PSNR pass")
    ap.add_argument("--meshcut_thresh", default="0",
                    help="if > 0 (or 'auto'), trim each extracted mesh "
                         "with the meshcut CLI at this threshold (ref "
                         "default 15; 'auto' = Otsu split of the mesh's "
                         "own confidence modes — robust across training "
                         "budgets, PERF.md round 5)")
    ap.add_argument("--force", action="store_true",
                    help="retrain even when a checkpoint exists")
    ap.add_argument("--out", default="SUITE",
                    help="output basename -> <out>.md + <out>.json")
    args = ap.parse_args(argv)

    if args.scans:
        scans = []
        for tok in args.scans.split(","):
            tok = tok.strip()
            if (not os.path.isdir(os.path.join(args.data_root, tok))
                    and not tok.startswith("scan")):
                tok = f"scan{tok}"
            scans.append(tok)
    else:
        scans = sorted((d for d in os.listdir(args.data_root)
                        if d.startswith("scan") and
                        os.path.isdir(os.path.join(args.data_root, d))),
                       key=lambda d: scan_id(d) or 0)
    if not scans:
        raise SystemExit(f"no scan dirs under {args.data_root}")

    common = []
    if args.conf:
        common += ["--conf", args.conf]
    if args.platform:
        common += ["--platform", args.platform]

    results = []
    t_suite = time.time()
    for name in scans:
        data_dir = find_data_dir(os.path.join(args.data_root, name))
        log_path = f"suite_{name}.log"
        print(f"[{name}] data={data_dir}")
        t0 = time.time()

        exp_dir = os.path.join(args.exps_folder, name)
        have_ckpt = os.path.isdir(exp_dir) and any(
            os.path.isdir(os.path.join(exp_dir, ts, "checkpoints"))
            for ts in os.listdir(exp_dir))
        if have_ckpt and not args.force:
            print("  checkpoint exists — skipping training "
                  "(--force to retrain)")
            trained = True
        else:
            train_args = ["--data_dir", data_dir, "--expname", name,
                          "--exps_folder", args.exps_folder,
                          "--nepoch", str(args.nepoch),
                          "--batch_size", str(args.batch_size),
                          "--num_pixels", str(args.num_pixels)] + common
            for flag in ("pallas", "bf16_acts", "allow_random_features"):
                if getattr(args, flag):
                    train_args.append(f"--{flag}")
            trained = run_cli("mvsdf_tpu_torch.train.cli", train_args,
                              log_path)
        t_train = time.time() - t0

        row = {"scan": name, "id": scan_id(name),
               "train_s": round(t_train, 1)}
        if trained:
            eval_args = ["--data_dir", data_dir, "--expname", name,
                         "--exps_folder", args.exps_folder,
                         "--evals_folder", args.evals_folder,
                         "--resolution", str(args.resolution)] + common
            if args.pallas:
                eval_args.append("--pallas")
            if not args.no_rendering:
                eval_args.append("--eval_rendering")
            sid = row["id"]
            if args.dtu_gt_root and sid is not None:
                stl = os.path.join(args.dtu_gt_root, "Points", "stl",
                                   f"stl{sid:03d}_total.ply")
                obs = os.path.join(args.dtu_gt_root, "ObsMask",
                                   f"ObsMask{sid}_10.mat")
                plane = os.path.join(args.dtu_gt_root, "ObsMask",
                                     f"Plane{sid}.mat")
                if os.path.exists(stl):
                    eval_args += ["--dtu_stl", stl,
                                  "--dtu_max_dist", str(args.dtu_max_dist),
                                  "--dtu_downsample",
                                  str(args.dtu_downsample)]
                    if os.path.exists(obs):
                        eval_args += ["--dtu_obsmask", obs]
                    if os.path.exists(plane):
                        eval_args += ["--dtu_plane", plane]
                else:
                    print(f"  no GT STL at {stl} — chamfer skipped")
            t0 = time.time()
            ok = run_cli("mvsdf_tpu_torch.eval.cli", eval_args, log_path)
            row["eval_s"] = round(time.time() - t0, 1)
            evaldir = os.path.join(args.evals_folder, name)
            if ok:
                row["psnr"] = parse_psnr(evaldir)
                ch = parse_chamfer(evaldir)
                if ch:
                    row.update(ch)
                trim = args.meshcut_thresh
                if trim == "auto" or float(trim) > 0:
                    objs = sorted(
                        f for f in os.listdir(evaldir)
                        if f.startswith("surface_world_coordinates")
                        and f.endswith(".obj"))
                    if objs:
                        src = os.path.join(evaldir, objs[-1])
                        dst = src.replace(".obj", "_trimmed.obj")
                        run_cli("mvsdf_tpu_torch.meshcut.cli",
                                [src, dst, "--thresh", str(trim)],
                                log_path)
        ref = REFERENCE_TABLE.get(row.get("id"))
        if ref:
            row["ref_chamfer"], row["ref_psnr"] = ref
        results.append(row)
        print(f"  chamfer={row.get('overall')} psnr={row.get('psnr')} "
              f"(ref {ref})")

    chs = [r["overall"] for r in results if r.get("overall") is not None]
    pss = [r["psnr"] for r in results if r.get("psnr") is not None]
    summary = {
        "scans": results,
        "mean_chamfer": round(sum(chs) / len(chs), 4) if chs else None,
        "mean_psnr": round(sum(pss) / len(pss), 2) if pss else None,
        "reference_mean_chamfer": 0.890,
        "reference_mean_psnr": 25.72,
        "wall_s": round(time.time() - t_suite, 1),
    }
    with open(args.out + ".json", "w") as f:
        json.dump(summary, f, indent=1)

    lines = ["# DTU suite results", "",
             "| scan | chamfer | ref | PSNR | ref | train s | eval s |",
             "|---|---|---|---|---|---|---|"]
    for r in results:
        lines.append(
            "| {scan} | {ch} | {rch} | {ps} | {rps} | {tr} | {ev} |"
            .format(scan=r["scan"],
                    ch=_fmt(r.get("overall"), 3),
                    rch=_fmt(r.get("ref_chamfer"), 3),
                    ps=_fmt(r.get("psnr"), 2),
                    rps=_fmt(r.get("ref_psnr"), 2),
                    tr=r.get("train_s", "—"), ev=r.get("eval_s", "—")))
    lines += ["",
              f"**mean chamfer {_fmt(summary['mean_chamfer'], 3)}** "
              f"(reference 0.890) · "
              f"**mean PSNR {_fmt(summary['mean_psnr'], 2)}** "
              f"(reference 25.72) · wall {summary['wall_s']}s"]
    with open(args.out + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"\nwrote {args.out}.md / {args.out}.json — mean chamfer "
          f"{summary['mean_chamfer']} / mean PSNR {summary['mean_psnr']}")


def _fmt(x, nd):
    return f"{x:.{nd}f}" if isinstance(x, (int, float)) else "—"


if __name__ == "__main__":
    main()
