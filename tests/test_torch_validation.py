"""The port's trained-quality validation (``validation/full_training``,
``validation/quality_pin``) and the shaded synthetic scene it trains on
(``data/synthetic``), against the JAX repo on the CPU.

- The shaded scene at n=4, 32x32 images, 16x16 depths equals
  ``tests/golden/scene_fixtures``': geometry, images, masks and depths
  within 1e-6 (equal measured); the frozen features within 1e-5 of the
  largest (3.6e-7 of 0.456 measured: the port resizes and convolves in
  torch, JAX through cv2 and XLA).
- The scene writer against ``scripts/make_synthetic_scene.py`` run in a
  subprocess at --views 3: the same files, equal decoded pixels, PFMs,
  npz arrays and text files.
- The host plan equals the JAX script's numpy sequence (its lines copied
  below) for 10 epochs and the points drawn after it, with the port's
  ``train`` driving a recording step.
- ``evaluate`` at a narrow width (SDF 3 x 64, skip at 2, radiance 2 x 64,
  16 features) on JAX weights carried by ``convert.params_from_jax``,
  against a JAX arm made of the script's own calls (``extract_mesh`` of
  ``sdf_apply``, ``dtu_style_eval``, ``render_forward``,
  ``implicit_apply``; the script's no-kernel path): vertex count equal,
  chamfer within 1e-5, PSNR within 1e-3 dB, indicator accuracy equal. The
  port takes its kernel path, whose plain versions run on CPU tensors.
- Three narrow epochs of the training loop in a subprocess (a torch
  optimizer step changes XLA:CPU results for the rest of its process):
  finite, with the JAX script's summary keys.
- The quality gate passes inside the bars and the pin, and fails on each
  key outside them.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu import config as jc
from mvsdf_tpu.eval.chamfer import dtu_style_eval as j_dtu_style_eval
from mvsdf_tpu.eval.marching import extract_mesh as j_extract_mesh
from mvsdf_tpu.eval.psnr import masked_psnr as j_masked_psnr
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.fields.sdf import ImplicitConfig as JImplicit
from mvsdf_tpu.fields.sdf import implicit_apply as j_implicit_apply
from mvsdf_tpu.fields.sdf import sdf_apply as j_sdf_apply
from mvsdf_tpu.rendering import render_forward as j_render_forward
from mvsdf_tpu.train.step import init_params as j_init_params
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data import formats
from mvsdf_tpu_torch.data import synthetic
from mvsdf_tpu_torch.fields.network import MVSDFNetwork
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig as TImplicit
from mvsdf_tpu_torch.validation import full_training as ft
from mvsdf_tpu_torch.validation import quality_pin as qp
from tests.golden import scene_fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICFG = dict(feature_vector_size=16, dims=(64,) * 3, skip_in=(2,))
RCFG = dict(feature_vector_size=16, dims=(64,) * 2)
SCENE = dict(n=4, img_hw=32, depth_hw=16, n_pix=256)
FEATURES = ("feat", "feat_src")


@pytest.fixture(scope="module")
def scenes():
    return (scene_fixtures.make_scene_shaded(**SCENE),
            synthetic.make_scene_shaded(**SCENE, device="cpu"))


def test_fibonacci_scene_matches_the_jax_fixture():
    kw = dict(n=5, img_hw=24, depth_hw=12, n_pix=64)
    ours = synthetic.make_scene_fibonacci(**kw)
    theirs = scene_fixtures.make_scene_fibonacci(**kw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("plane_r", [0.92, 0.0])
def test_shaded_renders_match_the_jax_fixture(plane_r):
    pos = synthetic.frontal_cap_positions(3)[1]
    E = synthetic.look_at_extrinsic(pos)
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]])
    ours = synthetic.render_shaded_sphere(pos, E, K, 32, 0.45,
                                          plane_r=plane_r)
    theirs = scene_fixtures.render_shaded_sphere(pos, E, K, 32, 0.45,
                                                 plane_r=plane_r)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_shaded_scene_geometry_and_images_match_the_jax_fixture(scenes):
    theirs, ours = scenes
    assert ours.keys() == theirs.keys()
    for k in ours:
        if k in FEATURES:
            continue
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("key", FEATURES)
def test_shaded_scene_features_match_the_jax_fixture(scenes, key):
    theirs, ours = scenes
    a, b = ours[key], np.asarray(theirs[key])
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("writer")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "make_synthetic_scene.py"),
         "--out", str(root / "jax" / "scene"), "--views", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    synthetic.main(["--out", str(root / "port" / "scene"), "--views", "3"])
    return root / "jax", root / "port"


def test_scene_writer_writes_the_jax_scripts_files(written):
    jax_dir, port_dir = written
    files = _tree(jax_dir)
    assert len(files) == 3 * 3 + 1 + 1 + 3
    assert _tree(port_dir) == files


@pytest.mark.parametrize("kind", ["image_hd", "mask_hd", "depth", "npz",
                                  "text"])
def test_scene_writer_contents_equal_the_jax_scripts(written, kind):
    jax_dir, port_dir = written
    files = [f for f in _tree(jax_dir) if
             (kind == "npz" and f.endswith(".npz")) or
             (kind == "text" and f.endswith(".txt")) or
             f.startswith(os.path.join("scene", kind))]
    assert files
    for f in files:
        a, b = str(jax_dir / f), str(port_dir / f)
        if f.endswith(".png"):
            x, y = imageio.imread(a), imageio.imread(b)
            assert x.shape == y.shape and x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, f)
        elif f.endswith(".pfm"):
            np.testing.assert_array_equal(formats.load_pfm(a),
                                          formats.load_pfm(b), f)
        elif f.endswith(".npz"):
            x, y = np.load(a), np.load(b)
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], k)
        else:
            assert open(a).read() == open(b).read(), f


def _jax_script_plan(seed, n_epochs, n_pixels, n_pix, batch):
    """The host draws of scripts/full_training_validation.py, its lines
    copied: ``batch_for`` each epoch, then gt_pts and rnd."""
    rng = np.random.default_rng(seed)
    train_views = np.arange(ft.N_VIEWS - 1)
    plan = []
    for _ in range(n_epochs):
        sel = rng.permutation(n_pixels)[:n_pix]
        views = rng.permutation(train_views)[:batch]
        plan.append((sel, views))
    gt_pts = rng.normal(size=(100_000, 3))
    gt_pts = gt_pts / np.linalg.norm(gt_pts, axis=1, keepdims=True) * 0.45
    rnd = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    return plan, gt_pts, rnd


def _narrow(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, implicit=TImplicit(**ICFG), render=TRender(**RCFG)))


def _args(*extra):
    return ft.parse_args(["--platform", "cpu", *extra])


@pytest.mark.parametrize("seed", [0, 3])
def test_host_plan_matches_the_jax_script(monkeypatch, seed):
    """The port's ``train`` over 10 epochs with the step replaced by a
    recorder (nothing trains) draws the JAX script's pixel subsets and
    views, and the points after it are the script's."""
    n_pix, batch, hw = 64, 3, 24
    sc = synthetic.make_scene_shaded(n=ft.N_VIEWS, img_hw=hw, depth_hw=12,
                                     n_pix=n_pix, device="cpu")
    args = _args("--epochs", "10", "--n_pix", str(n_pix), "--batch",
                 str(batch), "--seed", str(seed))
    cfg, _ = ft.make_config(args, sc, log=lambda *_: None)
    seen = []

    def make_step(cfg, phase_idx):
        def step(state, b, weights, gen):
            seen.append((b["uv"][0].numpy(), b["indices"].numpy(),
                         b["rgb"].numpy(), phase_idx))
            return {"grad_norm": torch.tensor(1.0),
                    **{k: torch.tensor(0.0) for k in ft.LOGGED},
                    "loss": torch.tensor(0.0)}
        return step

    monkeypatch.setattr("mvsdf_tpu_torch.train.step.make_train_step",
                        make_step)
    rng = np.random.default_rng(seed)
    _, stats = ft.train(_narrow(cfg), sc, rng, torch.device("cpu"),
                        log=lambda *_: None)
    plan, gt_pts, rnd = _jax_script_plan(seed, 10, hw * hw, n_pix, batch)
    assert len(seen) == 10 and stats["nonfinite"] == 0
    assert [s[3] for s in seen] == [0, 0, 1, 1, 1, 2, 2, 2, 2, 2]
    for (uv, views, rgb, _), (sel, jviews) in zip(seen, plan):
        np.testing.assert_array_equal(views, jviews)
        np.testing.assert_array_equal(uv, sc["uv_full"][sel])
        np.testing.assert_array_equal(rgb, sc["rgb_full"][jviews][:, sel])
    np.testing.assert_array_equal(ft.surface_points(rng), gt_pts)
    np.testing.assert_array_equal(ft.cube_points(rng), rnd)


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """(JAX arm's numbers, port's evaluate) on one narrow field: JAX's
    init weights with seeded noise, on a 12-view 32x32 shaded scene."""
    hw, res = 32, 64
    sc = synthetic.make_scene_shaded(n=ft.N_VIEWS, img_hw=hw, depth_hw=16,
                                     n_pix=64, focal=1.3 * hw, device="cpu")
    jcfg = jc.MVSDFConfig(model=jc.ModelConfig(
        implicit=JImplicit(**ICFG), render=JRender(**RCFG),
        implicit_diff_min_dot=1e-2))
    params = jax.tree_util.tree_map(np.asarray, j_init_params(jcfg, 3))
    noise = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * noise.normal(size=a.shape)).astype(a.dtype),
        params)

    # the JAX arm: the script's calls on its no-kernel path
    rng = np.random.default_rng(0)
    icfg = jcfg.model.implicit
    sdf = lambda x: j_sdf_apply(icfg, params["implicit"], x)
    verts, faces = j_extract_mesh(sdf, resolution=res, bounds=(-0.7, 0.7))
    gt_pts = rng.normal(size=(100_000, 3))
    gt_pts = gt_pts / np.linalg.norm(gt_pts, axis=1, keepdims=True) * 0.45
    bbox = np.array([[-0.55, -0.40, -0.55], [0.55, 0.55, 0.55]])
    ch = j_dtu_style_eval(verts, faces, gt_pts, n_samples=200_000,
                          max_dist=0.2, bbox=bbox)
    held = ft.HELD_OUT
    rows = []
    for s in range(0, hw * hw, 4608):
        sel = slice(s, min(s + 4608, hw * hw))
        inputs = {"uv": jnp.asarray(sc["uv_full"][sel][None]),
                  "intrinsics": jnp.asarray(sc["intrinsics"][held][None]),
                  "pose": jnp.asarray(sc["pose"][held][None]),
                  "object_mask": jnp.asarray(sc["mask_full"][held][sel][None])}
        out = j_render_forward(jcfg.model, params, inputs, training=False)
        rows.append(np.asarray(out.rgb_values[0]))
    pred = (np.concatenate(rows, 0).reshape(hw, hw, 3) + 1) / 2
    gt_img = (sc["rgb_full"][held].reshape(hw, hw, 3) + 1) / 2
    mask = sc["mask_full"][held].reshape(hw, hw, 1)
    psnr = j_masked_psnr(pred * mask, gt_img * mask, mask)
    on_l = np.asarray(j_implicit_apply(
        icfg, params["implicit"],
        jnp.asarray(gt_pts[:5000], jnp.float32))[..., 1])
    rnd = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    off_l = np.asarray(j_implicit_apply(icfg, params["implicit"],
                                        jnp.asarray(rnd))[..., 1])
    thresh = np.median(np.concatenate([on_l, off_l]))
    ind_acc = 0.5 * ((on_l > thresh).mean() + (off_l <= thresh).mean())
    jax_arm = {"mesh_verts": len(verts), "chamfer": ch, "psnr": psnr,
               "indicator_acc": float(ind_acc)}

    # the port: evaluate on the same weights through the kernel path
    cfg, _ = ft.make_config(_args(), sc, log=lambda *_: None)
    cfg = _narrow(cfg)
    net = MVSDFNetwork(cfg.model.implicit, cfg.model.render)
    net.load_state_dict(params_from_jax(params))
    out = tmp_path_factory.mktemp("eval")
    q = ft.evaluate(cfg, net, sc, np.random.default_rng(0),
                    torch.device("cpu"), resolution=res, out=str(out),
                    log=lambda *_: None)
    return jax_arm, q, out


def test_evaluate_mesh_and_chamfer_match_the_jax_script(eval_pair):
    jax_arm, q, out = eval_pair
    assert q["mesh_verts"] == jax_arm["mesh_verts"] > 0
    for k in ("accuracy", "completeness", "overall"):
        assert abs(q[f"chamfer_{k}"] - jax_arm["chamfer"][k]) <= 1e-5, k
    assert os.path.getsize(out / "surface.obj") > 0


def test_evaluate_psnr_and_indicator_match_the_jax_script(eval_pair):
    jax_arm, q, out = eval_pair
    assert np.isfinite(q["heldout_psnr"])
    assert abs(q["heldout_psnr"] - jax_arm["psnr"]) <= 1e-3
    assert q["indicator_acc"] == jax_arm["indicator_acc"]
    assert 0 < q["indicator_sigmoid_on_med"] < 1
    from mvsdf_tpu_torch.data.png import read_png
    for f in ("heldout_pred.png", "heldout_gt.png"):
        assert read_png(str(out / f)).shape == (32, 32, 3)


TRAIN3 = """
import dataclasses, json, sys
import numpy as np, torch
from mvsdf_tpu_torch.data.synthetic import make_scene_shaded
from mvsdf_tpu_torch.fields.radiance import RenderConfig
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig
from mvsdf_tpu_torch.validation import full_training as ft
args = ft.parse_args(["--platform", "cpu", "--epochs", "3", "--n_pix",
                      "128", "--batch", "3", "--resolution", "32",
                      "--out", sys.argv[1]])
dev = torch.device("cpu")
sc = make_scene_shaded(n=ft.N_VIEWS, img_hw=32, depth_hw=16, n_pix=128,
                       focal=1.3 * 32, device=dev)
cfg, sup = ft.make_config(args, sc)
cfg = dataclasses.replace(cfg, model=dataclasses.replace(
    cfg.model, implicit=ImplicitConfig(**%r), render=RenderConfig(**%r)))
rng = np.random.default_rng(args.seed)
net, stats = ft.train(cfg, sc, rng, dev)
q = ft.evaluate(cfg, net, sc, rng, dev, args.resolution, out=args.out)
print(json.dumps(ft.summarize(args, sup, stats, q, dev)))
""" % (ICFG, RCFG)


def test_three_narrow_epochs_train_and_summarise(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", TRAIN3, str(tmp_path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "[0] phase 0 loss=" in res.stdout
    assert "[2] phase 2 loss=" in res.stdout
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert tuple(summary) == ft.SUMMARY_KEYS + (
        "device", "matmul_precision", "sdf_mlp_launches")
    assert summary["epochs"] == 3 and summary["nonfinite_epochs"] == 0
    for k in ft.SUMMARY_KEYS:
        if k != "supervised_cascade":
            assert np.isfinite(summary[k]), k
    assert summary["device"] == "cpu" and summary["matmul_precision"] == "f32"
    assert summary["sdf_mlp_launches"] == {"train": 0, "grid": 0,
                                           "render": 0}


def test_the_cli_takes_the_jax_scripts_flags():
    a = ft.parse_args([])
    assert (a.epochs, a.resolution, a.n_pix, a.batch, a.seed) == \
        (600, 160, 4096, 8, 0)
    assert (a.plane_r, a.focal_mult, a.precision) == (0.92, 1.3, "default")
    assert a.supervised_compact == "auto" and not a.no_pallas
    a = ft.parse_args(["--bf16_acts", "--no_pallas", "--no_supervised_remat",
                       "--supervised_compact", "twotier", "--platform",
                       "cuda", "--precision", "highest", "--out", "x"])
    assert a.bf16_acts and a.no_pallas and a.no_supervised_remat


@pytest.mark.parametrize("mode,isect,want", [
    ("auto", 0.3, (0.3125,)), ("top", 0.3, (0.3125,)), ("auto", 0.9, ()),
    ("off", 0.3, ()), ("twotier", 0.3, (0.25, 0.3125)),
    ("twotier", 0.9, ()), ("bound", 0.9, (0.9375,)), ("bound", 0.97, ())])
def test_supervised_tiers_follow_the_jax_script(mode, isect, want):
    assert ft.supervised_tiers(mode, isect) == want


def test_make_config_is_the_jax_scripts():
    sc = synthetic.make_scene_shaded(n=ft.N_VIEWS, img_hw=24, depth_hw=12,
                                     n_pix=64, focal=1.3 * 24, device="cpu")
    cfg, sup = ft.make_config(_args(), sc, log=lambda *_: None)
    assert cfg.train.learning_rate == 5e-5
    assert cfg.train.skip_nonfinite_updates
    assert cfg.model.implicit_diff_min_dot == 1e-2
    assert cfg.model.use_pallas_trace and sup == ()
    tr = cfg.model.tracer
    assert (tr.sampler_capacity_frac, tr.fill_capacity_frac,
            tr.fill_misses) == (0.25, 0.5, False)
    cfg, sup = ft.make_config(_args("--no_pallas", "--bf16_acts"), sc,
                              log=lambda *_: None)
    assert not cfg.model.use_pallas_trace and sup == ()
    assert cfg.model.implicit.bf16_activations


def _inside():
    s = {k: v for k, (v, _) in qp.PIN.items()}
    s["nonfinite_epochs"] = 0
    return s


def test_quality_gate_passes_inside_the_bars_and_the_pin():
    s = _inside()
    assert qp.gate(s) == []
    for key, (op, limit) in qp.REFERENCE_BARS.items():
        assert qp.gate(dict(s, **{key: limit}), pin=False) == [], key


@pytest.mark.parametrize("key", list(qp.REFERENCE_BARS))
def test_quality_gate_fails_outside_each_reference_bar(key):
    op, limit = qp.REFERENCE_BARS[key]
    bad = limit + (1e-3 if op == "<=" else -1e-3)
    fails = qp.gate(dict(_inside(), **{key: bad}), pin=False)
    assert len(fails) == 1 and fails[0].startswith(key)


@pytest.mark.parametrize("key", list(qp.PIN))
def test_quality_gate_fails_outside_each_pinned_value(key):
    pinned, tol = qp.PIN[key]
    for bad in (pinned + 1.01 * tol, pinned - 1.01 * tol):
        fails = qp.gate(dict(_inside(), **{key: bad}), bars=False)
        assert len(fails) == 1 and fails[0].startswith(key)


def test_the_reference_bars_are_the_jax_pins():
    """(a) is JAX's seed-0 pin with its tolerance, and the cross-seed PSNR
    less twice its spread (TPU v5e quality)."""
    spec = importlib.util.spec_from_file_location(
        "jax_quality_pin", os.path.join(REPO, "scripts", "quality_pin.py"))
    jq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jq)
    ch, ch_tol = jq.PIN["chamfer_overall"]
    acc, acc_tol = jq.PIN["indicator_acc"]
    assert qp.REFERENCE_BARS["chamfer_overall"] == ("<=", ch + ch_tol)
    assert qp.REFERENCE_BARS["indicator_acc"] == (">=", acc - acc_tol)
    assert qp.REFERENCE_BARS["heldout_psnr"] == (">=", 19.0)
    assert qp.REFERENCE_BARS["nonfinite_epochs"] == ("<=", jq.NONFINITE_MAX)
    assert {k: t for k, (_, t) in qp.PIN.items()} == \
        {k: t for k, (_, t) in jq.PIN.items()}


@pytest.mark.parametrize("print_pin", [False, True])
def test_quality_pin_cli_runs_the_validation_and_gates(monkeypatch, capsys,
                                                       print_pin):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = "training...\n" + json.dumps(_inside()) + "\n"
        return subprocess.CompletedProcess(cmd, 0, out, "")

    monkeypatch.setattr(qp.subprocess, "run", fake_run)
    qp.main(["--epochs", "7"] + (["--print-pin"] if print_pin else []))
    assert calls == [[sys.executable, "-m",
                      "mvsdf_tpu_torch.validation.full_training", "--seed",
                      "0", "--epochs", "7"]]
    out = capsys.readouterr().out
    if print_pin:
        assert json.loads(out) == {k: v for k, (v, _) in qp.PIN.items()}
    else:
        assert out.startswith("quality pin OK:")

    def bad_run(cmd, **kw):
        s = dict(_inside(), heldout_psnr=10.0)
        return subprocess.CompletedProcess(cmd, 0, json.dumps(s), "")

    monkeypatch.setattr(qp.subprocess, "run", bad_run)
    with pytest.raises(SystemExit):
        qp.main([])
