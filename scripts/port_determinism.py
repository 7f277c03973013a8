"""Run-to-run reproducibility of the port's training on one GPU.

Trains the validation capstone's configuration (``validation.full_training``:
the shaded scene, full width, B=8 x P=4096, seed 0, the trace through
``sdf_mlp``) for ``--epochs`` epochs, twice in each of two fresh processes,
under each variant:

  default     the code as it stands (the frozen features through cuDNN's
              deterministic algorithms, ``featext.deterministic_cudnn``)
  unrepaired  the same with the features computed without it, as the port
              computed them before
  det         default under ``torch.use_deterministic_algorithms(True,
              warn_only=True)`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``;
              lists the ops torch flags as nondeterministic
  highest     default with TF32 off in the step
  plain       default with the plain field in the trace (no kernel)

Every step records the loss terms and a bit checksum of each parameter
gradient, of each stage's output in ``render_forward`` (the trace, each
value + gradient group, the implicit-diff points, the shading) and of the
gradient flowing back into each stage; the scene's arrays are checksummed
too. For each variant it reports whether the runs agree bit for bit,
within a process and across two, and where the first pair parts: the
step, the stage, and the two checksums' float sums. The first default
process also launches ``sdf_mlp`` and the step's largest products
repeatedly on fixed inputs and says whether their bits repeat.

With ``--cost N``, in a process of its own and in turns (off, on, on,
off, twice): the frozen features (``scene.frozen_features``) of the
validation's 12 views at 96x96 and of 49 DTU-sized views at 1200x1600,
with cuDNN's deterministic algorithms off and on; and N steps of the
bench's phase-B step (``bench.bench_config``) without and with torch's
deterministic algorithms, the alternative the repair did not need.

    python3 scripts/port_determinism.py [--epochs 50]
        [--variants default,unrepaired] [--cost 10] [--out DIR]

Writes ``determinism.json`` into ``--out`` and prints its summary. Needs a
GPU unless ``--platform cpu`` (a rehearsal at a narrow size).
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VARIANTS = ("default", "unrepaired", "det", "highest", "plain")


def checksum(t):
    """(a position-weighted sum of the tensor's bits, its float sum): two
    tensors with equal bits give equal pairs."""
    import torch
    t = t.detach()
    if t.dtype == torch.bool:
        v = t.to(torch.int64)
    elif t.dtype == torch.float32:
        v = t.contiguous().view(torch.int32).to(torch.int64)
    elif t.dtype in (torch.bfloat16, torch.float16):
        v = t.contiguous().view(torch.int16).to(torch.int64)
    else:
        v = t.to(torch.int64)
    v = v.reshape(-1)
    w = torch.arange(v.numel(), device=v.device) % 8191 + 1
    return torch.stack([(v * w).sum().double(), t.double().sum()])


class Recorder:
    """Collects (label, checksum) pairs of one step, forward and backward,
    through wrappers around the renderer's stages and the step's clip."""

    def __init__(self):
        self.items = []
        self.counts = {}

    def add(self, label, t):
        import torch
        if not isinstance(t, torch.Tensor):
            return
        lab = self.label(label)
        self.items.append((lab, checksum(t)))
        if t.requires_grad:
            t.register_hook(lambda g: self.items.append(
                (self.label(f"{lab}.grad"), checksum(g))))

    def label(self, name):
        """``name#n``, n counting the name's earlier records this step (a
        stage's output may take gradients from more than one backward)."""
        n = self.counts.get(name, 0)
        self.counts[name] = n + 1
        return f"{name}#{n}"

    def take(self):
        import torch
        labels = [k for k, _ in self.items]
        vals = torch.stack([v for _, v in self.items]).cpu().tolist() \
            if self.items else []
        self.items, self.counts = [], {}
        return [[k, int(a), b] for k, (a, b) in zip(labels, vals)]


def install(rec):
    """Wraps the stages of render_forward and the step's clip so each
    records into ``rec``."""
    from mvsdf_tpu_torch.rendering import renderer
    from mvsdf_tpu_torch.train import step as step_mod

    def wrap(mod, name, record):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            record(name, out)
            return out
        setattr(mod, name, wrapped)

    def each(name, out):
        for i, t in enumerate(out if isinstance(out, tuple) else (out,)):
            rec.add(f"{name}[{i}]", t)

    for name in ("_frozen_trace", "full_value_and_grad",
                 "differentiable_surface_points", "render_apply"):
        wrap(renderer, name, each)
    clip = step_mod._clip_by_global_norm

    def clip_rec(grads, cap):
        for i, g in enumerate(grads):
            rec.add(f"param_grad[{i}]", g)
        return clip(grads, cap)
    step_mod._clip_by_global_norm = clip_rec


def repeat_check(device, n_rows=65537, reps=12):
    """sdf_mlp on fixed rows, and the supervised MLP's widest product and
    its weight gradient at the rows a step gives it: whether each call's
    bits equal the first call's."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.config import MVSDFConfig
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.train.step import init_params
    cfg = MVSDFConfig()
    net = init_params(cfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((n_rows, 3), generator=g, device=device) * 2 - 1
    out = {}
    with torch.no_grad():
        packed = K.pack_sdf_weights(net.implicit)
        pe = positional_encoding(x, cfg.model.implicit.multires).contiguous()
        first = K.sdf_mlp(packed, pe)
        out["sdf_mlp"] = sum(torch.equal(first, K.sdf_mlp(packed, pe))
                             for _ in range(reps - 1))
    rng = np.random.default_rng(0)
    for rows in (12288, 32768, 49152):
        a = torch.from_numpy(rng.standard_normal((rows, 512), np.float32)
                             ).to(device)
        w = torch.from_numpy(rng.standard_normal((512, 512), np.float32)
                             ).to(device).requires_grad_(True)
        ref = None
        same = 0
        for _ in range(reps):
            y = a @ w
            (gw,) = torch.autograd.grad((y * y).sum(), w)
            if ref is None:
                ref = (y.detach().clone(), gw.clone())
            else:
                same += torch.equal(ref[0], y) and torch.equal(ref[1], gw)
        out[f"matmul_{rows}x512x512_and_weight_grad"] = same
    out["reps_compared"] = reps - 1
    return out


def child(out_path, variant, epochs, ft_extra, repeats, kernel_check):
    import numpy as np
    import torch
    from mvsdf_tpu_torch.data import scene as scene_mod
    from mvsdf_tpu_torch.data.synthetic import make_scene_shaded
    from mvsdf_tpu_torch.validation import full_training as ft
    from mvsdf_tpu_torch.train import step as step_mod
    argv = ["--epochs", str(epochs), "--seed", "0", *ft_extra]
    if variant == "highest":
        argv += ["--precision", "highest"]
    if variant == "plain":
        argv += ["--no_pallas"]
    args = ft.parse_args(argv)
    device = torch.device("cpu" if args.platform == "cpu" else "cuda")
    ctx = contextlib.nullcontext()
    if variant == "unrepaired":
        scene_mod.deterministic_cudnn = contextlib.nullcontext
    if variant == "det":
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.simplefilter("always")
        ctx = warnings.catch_warnings(record=True)
    result = {"variant": variant, "env": os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG"), "runs": [], "seconds": []}
    with ctx as w:
        sc = make_scene_shaded(n=ft.N_VIEWS, img_hw=ft.IMG_HW,
                               n_pix=args.n_pix, sphere_radius=ft.RADIUS,
                               focal=args.focal_mult * ft.IMG_HW,
                               plane_r=args.plane_r, device=device)
        result["scene"] = {k: int(checksum(torch.as_tensor(v))[0])
                           for k, v in sorted(sc.items())
                           if isinstance(v, (np.ndarray, torch.Tensor))}
        cfg, _ = ft.make_config(args, sc, log=lambda m: None)
        rec = Recorder()
        install(rec)
        make = step_mod.make_train_step

        def make_recorded(cfg_, ph):
            step = make(cfg_, ph)

            def recorded(state, batch, weights, gen):
                metrics = step(state, batch, weights, gen)
                run.append({"metrics": {k: float(v)
                                        for k, v in metrics.items()},
                            "cks": rec.take()})
                return metrics
            return recorded
        step_mod.make_train_step = make_recorded
        torch.backends.cuda.matmul.allow_tf32 = args.precision != "highest"
        for _ in range(repeats):
            run = []
            t0 = time.perf_counter()
            ft.train(cfg, sc, np.random.default_rng(args.seed), device,
                     log=lambda m: None)
            result["seconds"].append(time.perf_counter() - t0)
            result["runs"].append(run)
        step_mod.make_train_step = make
        if kernel_check and device.type == "cuda":
            result["repeat"] = repeat_check(device)
        if variant == "det":
            seen = []
            for x in w:
                msg = str(x.message).split("\n")[0][:300]
                if msg not in seen:
                    seen.append(msg)
            result["flagged"] = seen
    with open(out_path, "w") as f:
        json.dump(result, f)


def first_parting(a, b):
    """Where two runs' step records first differ: None when they agree
    bit for bit, else (step, label, (sum a, sum b), metrics a, metrics
    b)."""
    for i, (sa, sb) in enumerate(zip(a, b)):
        ka = {k: (c, s) for k, c, s in sa["cks"]}
        kb = {k: (c, s) for k, c, s in sb["cks"]}
        for k, c, s in sa["cks"]:
            if k not in kb or kb[k][0] != c:
                return {"step": i, "label": k, "sums": [
                    s, kb[k][1] if k in kb else None],
                    "metrics": [sa["metrics"], sb["metrics"]]}
        if set(ka) != set(kb) or sa["metrics"] != sb["metrics"]:
            return {"step": i, "label": "metrics", "sums": None,
                    "metrics": [sa["metrics"], sb["metrics"]]}
    if len(a) != len(b):
        return {"step": min(len(a), len(b)), "label": "length"}
    return None


def cost_child(out_path, steps, platform, rounds=2):
    """The --cost timings (see the module's docstring), in turns; written
    to ``out_path``."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.bench import bench_batch, bench_config
    from mvsdf_tpu_torch.data import scene as scene_mod
    from mvsdf_tpu_torch.data.featext import init_feat_ext, make_feat_ext
    from mvsdf_tpu_torch.data.scene import frozen_features
    from mvsdf_tpu_torch.data.featext import deterministic_cudnn
    from mvsdf_tpu_torch.train.step import init_train_state, make_train_step
    device = torch.device("cpu" if platform == "cpu" else "cuda")
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    order = ["off", "on", "on", "off"] * rounds
    net = make_feat_ext(init_feat_ext(np.random.default_rng(0)), device)
    rng = np.random.default_rng(0)
    small = (96, 96) if platform != "cpu" else (32, 32)
    large = (1200, 1600) if platform != "cpu" else (48, 64)
    views = {"validation_12x96": [rng.uniform(-1, 1, (3,) + small).astype(
        np.float32) for _ in range(12)],
        "dtu_49x1200x1600": [rng.uniform(-1, 1, (3,) + large).astype(
            np.float32) for _ in range(49 if platform != "cpu" else 3)]}
    out = {"order": order, "features_s": {}, "step_ms": {"off": [],
                                                         "on": []}}
    for name, rgbs in views.items():
        times = {"off": [], "on": []}
        for mode in order:
            # frozen_features holds cuDNN to its deterministic algorithms;
            # "off" takes that away for the timing
            if mode == "off":
                scene_mod.deterministic_cudnn = contextlib.nullcontext
            try:
                frozen_features(net, rgbs[:2], rgbs[0].shape[1:])
                sync()
                t0 = time.perf_counter()
                frozen_features(net, rgbs, rgbs[0].shape[1:])
                sync()
            finally:
                scene_mod.deterministic_cudnn = deterministic_cudnn
            times[mode].append(time.perf_counter() - t0)
        out["features_s"][name] = times
    cfg = bench_config({})
    batch = bench_batch(cfg, device)
    state = init_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, phase_idx=1)
    weights = cfg.schedule.weights(0.3)
    gen = torch.Generator(device=device).manual_seed(0)
    for mode in order:
        torch.use_deterministic_algorithms(mode == "on")
        step(state, batch, weights, gen)
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, weights, gen)
        sync()
        out["step_ms"][mode].append((time.perf_counter() - t0) / steps * 1e3)
    torch.use_deterministic_algorithms(False)
    with open(out_path, "w") as f:
        json.dump(out, f)


def main():
    if sys.argv[1:2] == ["child"]:
        a = json.loads(sys.argv[3])
        return child(sys.argv[2], **a)
    if sys.argv[1:2] == ["cost"]:
        return cost_child(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--variants", default="default,unrepaired")
    ap.add_argument("--repeats", type=int, default=2,
                    help="runs within each process")
    ap.add_argument("--cost", type=int, default=0,
                    help="steps a block of the step's cost timing; 0 "
                         "skips the cost timings")
    ap.add_argument("--platform", default="", choices=["", "cpu"])
    ap.add_argument("--ft_args", default="",
                    help="more full_training arguments (a rehearsal's "
                         "sizes), space-separated")
    ap.add_argument("--out", default="chiprun_out/determinism")
    args = ap.parse_args()
    import torch
    if args.platform != "cpu" and not torch.cuda.is_available():
        sys.exit("port_determinism: needs a CUDA GPU (or --platform cpu)")
    os.makedirs(args.out, exist_ok=True)
    ft_extra = args.ft_args.split() + (
        ["--platform", "cpu"] if args.platform == "cpu" else [])
    report = {"device": (torch.cuda.get_device_name(0)
                         if args.platform != "cpu" else "cpu")}
    if args.platform != "cpu":
        report["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(report, flush=True)
    for variant in args.variants.split(","):
        env = dict(os.environ, PYTHONPATH=REPO)
        if variant == "det":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        res = []
        for p in range(2):
            path = os.path.join(args.out, f"{variant}_{p}.json")
            spec = {"variant": variant, "epochs": args.epochs,
                    "ft_extra": ft_extra, "repeats": args.repeats,
                    "kernel_check": variant == "default" and p == 0}
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "child", path, json.dumps(spec)], env=env,
                               capture_output=True, text=True)
            if r.returncode:
                print(f"[{variant}] process {p} failed: {r.stderr[-3000:]}",
                      flush=True)
                res = None
                break
            with open(path) as f:
                res.append(json.load(f))
            print(f"[{variant}] process {p}: "
                  f"{time.perf_counter() - t0:.1f} s, runs "
                  f"{[round(s, 1) for s in res[-1]['seconds']]} s",
                  flush=True)
        if res is None:
            report[variant] = "failed"
            continue
        a, b = res
        entry = {
            "scene_equal": a["scene"] == b["scene"],
            "in_process": first_parting(a["runs"][0], a["runs"][-1]),
            "across_processes": first_parting(a["runs"][0], b["runs"][0]),
            "last_metrics": [a["runs"][0][-1]["metrics"],
                             b["runs"][0][-1]["metrics"]],
            "steps": len(a["runs"][0]),
            "stages_a_step": len(a["runs"][0][0]["cks"]),
        }
        for key in ("flagged", "repeat"):
            if key in a:
                entry[key] = a[key]
        report[variant] = entry
        print(f"[{variant}] {json.dumps(entry)}", flush=True)
    if args.cost:
        path = os.path.join(args.out, "cost.json")
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "cost", path, str(args.cost), args.platform],
                           env=dict(os.environ, PYTHONPATH=REPO,
                                    CUBLAS_WORKSPACE_CONFIG=":4096:8"),
                           capture_output=True, text=True)
        if r.returncode:
            print(f"[cost] failed: {r.stderr[-3000:]}", flush=True)
            report["cost"] = "failed"
        else:
            with open(path) as f:
                report["cost"] = json.load(f)
            print(f"[cost] {json.dumps(report['cost'])}", flush=True)
    with open(os.path.join(args.out, "determinism.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: (v if not isinstance(v, dict) else {
        kk: vv for kk, vv in v.items() if kk != "last_metrics"})
        for k, v in report.items()}))


if __name__ == "__main__":
    main()
