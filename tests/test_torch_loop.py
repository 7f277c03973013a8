"""The port's training loop and CLI on the CPU, small width (SDF 4 x 64,
radiance 2 x 64), on a 3-5 image scene directory written by
``data/synthetic.write_scene_dir``.

- The host-side plan (each step's phase, image indices, pixel subset, loss
  weights, and the RNG stream) equals the JAX package's ``Trainer`` on the
  same scene, element for element; both sides' steps are replaced by
  recorders, so nothing trains.
- A run resumed from an epoch that drew a full render's view skips that
  draw in both packages; the port's resumed stream equals the JAX
  package's resumed stream.
- The trace's auto capacity helpers equal the JAX package's.
- The CLI trains (``--pallas --platform cpu``) in a subprocess: a torch
  optimizer step changes XLA:CPU results for the rest of its process.
  Resuming after 2 epochs gives parameters, Adam state and metrics
  bit-equal to 4 epochs straight.
- The CLI's refusals: batch size above the image count, a missing
  checkpoint, missing FeatExt weights, no GPU without ``--platform cpu``;
  ``--train_cameras`` is no longer refused and trains.
"""
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu import config as jc
from mvsdf_tpu.data.scene import SceneData as JScene
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.fields.sdf import ImplicitConfig as JImplicit
from mvsdf_tpu.tracing import sphere_trace as j_trace
from mvsdf_tpu.train.loop import Trainer as JTrainer
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.data.scene import SceneData
from mvsdf_tpu_torch.data.synthetic import write_scene_dir
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig as TImplicit
from mvsdf_tpu_torch.tracing import sphere_trace as t_trace
from mvsdf_tpu_torch.train import cli
from mvsdf_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICFG = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
RCFG = dict(feature_vector_size=16, dims=(64,) * 2)
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
METRICS = ("loss", "rgb_loss", "eikonal_loss", "depth_loss", "feat_loss",
           "surf_loss", "grad_norm", "lr", "hit_frac")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    conf = root / "small.conf"
    conf.write_text(CONF)
    return {"root": root, "conf": str(conf),
            "scene3": write_scene_dir(str(root / "s3"), n_images=3,
                                      img_hw=32, depth_hw=16),
            "scene5": write_scene_dir(str(root / "s5"), n_images=5,
                                      img_hw=(24, 32), depth_hw=(12, 16))}


def _cli_args(env, expname, exps, *extra):
    return ["--data_dir", env["scene3"], "--pallas",
            "--allow_random_features", "--platform", "cpu", "--conf",
            env["conf"], "--batch_size", "3", "--nepoch", "4",
            "--num_pixels", "64", "--expname", expname, "--exps_folder",
            str(exps), *extra]


def _run_cli(args):
    res = subprocess.run(
        [sys.executable, "-m", "mvsdf_tpu_torch.train.cli", *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def _exp_dir(exps, expname):
    base = os.path.join(str(exps), expname)
    (stamp,) = os.listdir(base)
    return os.path.join(base, stamp)


def _rows(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def straight(env):
    """4 epochs (0..4) straight through the CLI, the first one profiled,
    all of them traced."""
    exps = env["root"] / "exps"
    out = _run_cli(_cli_args(env, "straight", exps, "--profile_dir",
                             str(env["root"] / "profile"),
                             "--profile_epochs", "1", "--trace_dir",
                             str(env["root"] / "spans")))
    return _exp_dir(exps, "straight"), out


def test_cli_trains_a_scene_directory(env, straight):
    exp_dir, out = straight
    assert "fallback capacity cascade" in out and "plot failed" not in out
    rows = _rows(exp_dir)
    assert [r["step"] for r in rows] == [0, 1, 2, 3, 4]
    assert [r["phase"] for r in rows] == [0, 1, 2, 2, 2]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in METRICS), r
    # lr x0.1 from epoch int(4/6 * 4) = 2, x0.01 from int(5/6 * 4) = 3
    lr = [r["lr"] for r in rows]
    np.testing.assert_allclose(lr, np.array([1, 1, .1, .01, .01]) * 6e-4,
                               rtol=1e-6)
    ck = os.path.join(exp_dir, "checkpoints")
    assert sorted(os.listdir(ck)) == ["latest.txt", "step_2", "step_4"]
    assert open(os.path.join(ck, "latest.txt")).read() == "4"
    for e in (2, 4):
        obj = os.path.join(exp_dir, "plots", f"surface_{e}.obj")
        assert any(line.startswith("f ") for line in open(obj))
        assert os.path.exists(os.path.join(exp_dir, "plots",
                                           f"scene_{e}.html"))
    with open(env["root"] / "profile" / "trace.json") as f:
        trace = f.read()
    assert "epoch[0]" in trace and "epoch[1]" not in trace


def test_cli_trace_dir_writes_spans(env, straight):
    """--trace_dir: a Chrome trace-event file of the trainer's host spans,
    each step's device stages and its trace rows, on the profiler's time
    axis."""
    with open(env["root"] / "spans" / "spans.json") as f:
        spans = json.load(f)
    with open(env["root"] / "profile" / "trace.json") as f:
        prof = json.load(f)
    assert spans["baseTimeNanoseconds"] == prof["baseTimeNanoseconds"]
    events = spans["traceEvents"]
    threads = {e["args"]["name"]: e["tid"] for e in events
               if e["name"] == "thread_name"}
    host = {e["name"] for e in events if e.get("tid") == threads[
        "host spans"]}
    assert {"plan_chunk", "dispatch", "replay", "save", "plot"} <= host
    stages = [e for e in events if e.get("tid") == threads["device stages"]]
    assert {e["name"] for e in stages} >= {"forward", "trace", "backward",
                                           "update", "chunk_boundary"}
    # 5 epochs of one step each
    assert sum(e["name"] == "trace" for e in stages) == 5
    rows = [e for e in events if e["name"] == "trace_rows"]
    assert len(rows) == 5 and all(e["args"]["active"] > 0 for e in rows)
    assert spans["otherData"]["summary"]["steps"] == 5
    # the profiled epoch's plan span sits where the profiler saw it
    (p,) = [e for e in prof["traceEvents"] if e.get("name") == "plan_chunk"]
    (o,) = [e for e in events if e["name"] == "plan_chunk" and
            e["args"]["chunk"] == 0]
    assert o["ts"] <= p["ts"] and p["ts"] + p["dur"] <= o["ts"] + o["dur"]


def test_resume_after_two_epochs_is_bit_exact(env, straight):
    """The state after epoch 2 (as a run stopped there left it), resumed
    with --is_continue, trains epochs 3-4 to the bits of the straight
    run: parameters, Adam's moments and step, the scheduler, both RNGs and
    every metric (and the straight run's profiler and tracing changed
    none of them)."""
    exp_dir, _ = straight
    exps = env["root"] / "exps_resumed"
    resumed = os.path.join(str(exps), "resumed", os.path.basename(exp_dir))
    os.makedirs(os.path.join(resumed, "checkpoints"))
    shutil.copytree(os.path.join(exp_dir, "checkpoints", "step_2"),
                    os.path.join(resumed, "checkpoints", "step_2"))
    with open(os.path.join(resumed, "checkpoints", "latest.txt"), "w") as f:
        f.write("2")
    out = _run_cli(_cli_args(env, "resumed", exps, "--is_continue"))
    assert "resumed from epoch 2" in out
    a = torch.load(os.path.join(exp_dir, "checkpoints", "step_4",
                                "state.pt"), weights_only=False)
    b = torch.load(os.path.join(resumed, "checkpoints", "step_4",
                                "state.pt"), weights_only=False)
    assert a["epoch"] == b["epoch"] == 4
    for k, v in a["net"].items():
        assert torch.equal(v, b["net"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["scheduler"] == b["scheduler"]
    for name in ("rng.json",):
        assert open(os.path.join(exp_dir, "checkpoints", "step_4", name)
                    ).read() == open(os.path.join(
                        resumed, "checkpoints", "step_4", name)).read()
    ra, rb = _rows(exp_dir)[3:], _rows(resumed)
    assert [r["step"] for r in rb] == [3, 4]
    for x, y in zip(ra, rb):
        assert {k: x[k] for k in METRICS} == {k: y[k] for k in METRICS}


def _configs(nepochs, B, P):
    jcfg = jc.MVSDFConfig(
        model=jc.ModelConfig(implicit=JImplicit(**ICFG),
                             render=JRender(**RCFG)),
        train=jc.TrainConfig(batch_size=B, num_pixels=P, nepochs=nepochs,
                             seed=3))
    tcfg = tc.MVSDFConfig(
        model=tc.ModelConfig(implicit=TImplicit(**ICFG),
                             render=TRender(**RCFG)),
        train=tc.TrainConfig(batch_size=B, num_pixels=P, nepochs=nepochs,
                             seed=3))
    return jcfg, tcfg


def test_host_plan_matches_the_jax_trainer(env, tmp_path):
    """Three epochs across the A -> B phase boundary (nepochs 6), 5 images
    in batches of 2 (one dropped each epoch), 37 shared pixels: each step's
    phase, images, pixels, RGB and weights, and the host RNG after, are the
    JAX Trainer's."""
    jcfg, tcfg = _configs(6, 2, 37)
    jt = JTrainer(jcfg, JScene(env["scene5"], allow_random_features=True),
                  str(tmp_path / "j"), use_mesh=False, log_fn=lambda *a: 0)
    pt = Trainer(tcfg, SceneData(env["scene5"], allow_random_features=True,
                                 device="cpu"),
                 str(tmp_path / "t"), device="cpu", log_fn=lambda *a: 0)
    seen = {"jax": [], "port": []}

    def j_get_step(phase):
        def step(state, batch, w, key):
            seen["jax"].append((phase, np.asarray(batch["indices"]),
                                np.asarray(batch["uv"]),
                                np.asarray(batch["rgb"]), np.asarray(w)))
            return state, {k: jnp.zeros(()) for k in METRICS}
        return step

    def t_get_step(phase):
        def step(state, batch, w, generator):
            assert generator is pt.generator
            seen["port"].append((phase, batch["indices"].numpy(),
                                 batch["uv"].numpy(), batch["rgb"].numpy(),
                                 np.asarray(dataclasses.astuple(w),
                                            np.float32)))
            return {k: torch.zeros(()) for k in METRICS}
        return step

    jt._get_step, pt._get_step = j_get_step, t_get_step
    for epoch in range(3):
        jt.train_epoch(epoch)
        pt.train_epoch(epoch)
    assert len(seen["port"]) == len(seen["jax"]) == 6
    assert [s[0] for s in seen["port"]] == [0, 0, 1, 1, 1, 1]
    for ours, theirs in zip(seen["port"], seen["jax"]):
        assert ours[0] == theirs[0]
        for a, b in zip(ours[1:], theirs[1:]):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert pt.rng.bit_generator.state == jt.rng.bit_generator.state


def _recording_trainers(env, exp_dir, seen):
    """A JAX and a port Trainer over 6 epochs (nepochs 5) whose steps
    record their inputs into ``seen`` and whose snapshots run at a 16^3
    grid, with a plot every epoch and a full render at epoch 4; the JAX
    full render's chunk program is replaced by zeros (its view is still
    drawn from the host RNG), the port's renders."""
    jcfg, tcfg = _configs(5, 2, 37)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, plot_freq=0.2, fused_dispatch=False))
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, plot_freq=0.2, fused_dispatch=False))
    logs = []
    jt = JTrainer(jcfg, JScene(env["scene5"], allow_random_features=True),
                  os.path.join(exp_dir, "j"), use_mesh=False,
                  log_fn=logs.append)
    pt = Trainer(tcfg, SceneData(env["scene5"], allow_random_features=True,
                                 device="cpu"),
                 os.path.join(exp_dir, "t"), device="cpu",
                 log_fn=logs.append)

    def j_get_step(phase):
        def step(state, batch, w, key):
            seen["jax"].append((np.asarray(batch["indices"]),
                                np.asarray(batch["uv"])))
            return state, {k: jnp.zeros(()) for k in METRICS}
        return step

    def t_get_step(phase):
        def step(state, batch, w, generator):
            seen["port"].append((batch["indices"].numpy(),
                                 batch["uv"].numpy()))
            return {k: torch.zeros(()) for k in METRICS}
        return step

    jt._get_step, pt._get_step = j_get_step, t_get_step
    jt.plot = functools.partial(JTrainer.plot, jt, resolution=16)
    jt._full_render_fn = lambda p, uv, intr, pose, m: jnp.zeros(
        (uv.shape[0], 3))
    pt.plot = functools.partial(Trainer.plot, pt, resolution=16)
    return jt, pt, logs


def test_resume_from_an_epoch_with_a_full_render_matches_jax(env,
                                                             tmp_path):
    """Both packages save an epoch's checkpoint before its snapshot draws
    the full render's view from the host RNG, so a run resumed from such
    an epoch (4 here) skips that draw and its later epochs sample other
    pixels than the unbroken run's. The port keeps the JAX package's
    stream: resumed against resumed, and unbroken against unbroken, every
    step's images and pixels are equal, and so is the host RNG after."""
    runs = {}
    for tag in ("unbroken", "resumed"):
        seen = {"jax": [], "port": []}
        jt, pt, logs = _recording_trainers(env, str(tmp_path), seen)
        resume = tag == "resumed"
        jt.run(resume=resume, resume_step=4 if resume else None)
        pt.run(resume=resume, resume_step=4 if resume else None)
        assert not any("plot failed" in str(m) for m in logs), logs
        runs[tag] = seen
        assert pt.rng.bit_generator.state == jt.rng.bit_generator.state
    assert os.path.exists(os.path.join(str(tmp_path), "t", "plots",
                                       "rendering_4.png"))
    assert [len(runs[t]["port"]) for t in runs] == [12, 2]
    for tag, seen in runs.items():
        assert len(seen["jax"]) == len(seen["port"]), tag
        for ours, theirs in zip(seen["port"], seen["jax"]):
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)
    # the limit: epoch 5 resumed from epoch 4 is not epoch 5 unbroken
    assert not np.array_equal(runs["resumed"]["port"][0][1],
                              runs["unbroken"]["port"][10][1])


@pytest.mark.parametrize("keep_fill", [False, True])
def test_auto_capacities_match_jax(env, keep_fill):
    scene = SceneData(env["scene5"], load_features=False, device="cpu")
    uv_all = np.broadcast_to(scene.uv[None], (scene.n_images,) +
                             scene.uv.shape)
    isect = t_trace.ray_intersect_fraction(uv_all, scene.intrinsics,
                                           scene.poses)
    assert isect == j_trace.ray_intersect_fraction(uv_all, scene.intrinsics,
                                                   scene.poses)
    # and on a subsample, as at a DTU scene's size
    kw = dict(max_rays=100)
    assert t_trace.ray_intersect_fraction(
        uv_all, scene.intrinsics, scene.poses, **kw) == \
        j_trace.ray_intersect_fraction(uv_all, scene.intrinsics, scene.poses,
                                       **kw)
    obj = float(np.mean(scene.masks))
    for o, i in ((obj, isect), (0.3, 0.9), (0.8, 0.2), (0.5, None)):
        for name, kw in (("auto_fallback_cascade",
                          dict(intersect_frac=i, fill_misses=keep_fill)),
                         ("auto_fallback_capacity",
                          dict(intersect_frac=i, fill_misses=keep_fill)),
                         ("auto_march_schedule", dict(intersect_frac=i))):
            assert getattr(t_trace, name)(o, **kw) == \
                getattr(j_trace, name)(o, **kw), (name, o, i)
        assert t_trace.auto_supervised_cascade(i) == \
            j_trace.auto_supervised_cascade(i)


def test_resume_with_another_nepoch_follows_the_jax_lr_schedule(env,
                                                                 tmp_path):
    """A checkpoint of a 4-epoch run resumed with --nepoch 8: the
    milestones move to int(4/6 * 8), int(5/6 * 8), and every resumed
    epoch's lr is the JAX package's lr_for_epoch for 8 epochs."""
    from mvsdf_tpu.train.step import make_optimizer
    from mvsdf_tpu_torch.train.step import advance_epoch
    scene = SceneData(env["scene5"], load_features=False, device="cpu")
    _, cfg4 = _configs(4, 2, 16)
    short = Trainer(cfg4, scene, str(tmp_path), device="cpu",
                    log_fn=lambda *a: 0)
    for _ in range(3):   # epochs 0-2 done: past both 4-epoch milestones
        advance_epoch(short.state)
    short.save(2)
    jcfg8, cfg8 = _configs(8, 2, 16)
    longer = Trainer(cfg8, scene, str(tmp_path), device="cpu",
                     log_fn=lambda *a: 0)
    assert longer.maybe_resume(2) and longer.start_epoch == 3
    _, lr_for_epoch = make_optimizer(jcfg8)
    for epoch in range(3, 9):
        np.testing.assert_allclose(
            longer.state.optimizer.param_groups[0]["lr"],
            float(lr_for_epoch(epoch)), rtol=1e-6)
        advance_epoch(longer.state)


def test_batch_size_above_the_image_count_raises(env, tmp_path):
    _, tcfg = _configs(4, 6, 16)
    scene = SceneData(env["scene5"], load_features=False, device="cpu")
    with pytest.raises(ValueError, match="batch_size 6 > 5 images"):
        Trainer(tcfg, scene, str(tmp_path), device="cpu")


def test_cli_refusals(env, tmp_path, monkeypatch):
    """A missing --checkpoint N names the step's path; no FeatExt weights
    without --allow_random_features; no silent CPU without a GPU. The
    --train_cameras that was refused before camera optimisation was ported
    now trains (in a subprocess: a torch optimizer step): its checkpoint
    holds finite poses that moved from the scene's (ground-truth) initial
    ones."""
    exps = tmp_path / "exps"
    args = _cli_args(env, "refuse", exps)
    ck = os.path.join(_exp_dir_after_setup(args), "checkpoints")
    with pytest.raises(FileNotFoundError, match=os.path.join(ck, "step_7")):
        cli.main(args + ["--is_continue", "--checkpoint", "7"])
    monkeypatch.delenv("MVSDF_VISMVSNET_PT", raising=False)
    no_random = [a for a in args if a != "--allow_random_features"]
    with pytest.raises(FileNotFoundError, match="MVSDF_VISMVSNET_PT"):
        cli.main(no_random)
    out = _run_cli(_cli_args(env, "cams", exps, "--train_cameras",
                             "--nepoch", "1"))
    assert "training done" in out
    tree = torch.load(os.path.join(_exp_dir(exps, "cams"), "checkpoints",
                                   "step_1", "state.pt"), weights_only=False)
    start = SceneData(env["scene3"], load_features=False,
                      device="cpu").pose_init
    from mvsdf_tpu_torch.train.cameras_opt import pose_vecs_from_matrices
    moved = (tree["pose_vecs"].numpy() - pose_vecs_from_matrices(start))
    assert torch.isfinite(tree["pose_vecs"]).all()
    assert (np.abs(moved).max(1) > 0).all()
    assert int(tree["cam_opt"]["step"]) == 2
    if not torch.cuda.is_available():
        on_gpu = [a for a in args if a not in ("--platform", "cpu")]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(on_gpu)


def _exp_dir_after_setup(args):
    trainer, _ = cli.setup(args)
    return trainer.exp_dir
