"""The port's fused multi-epoch dispatch (``train/loop.py``'s chunk path:
on the CPU the captured step's plain version, run eagerly) against its
per-epoch path and against the JAX package's fused ``Trainer``, on the
configuration of ``tests/unit/test_fused_dispatch.py`` (its ``_cfg``: a
32-wide net, 3 march iterations, 12 samples, B=2 x P=32 on a 4-view
scene).

- ``_chunk_end`` equals the JAX Trainer's on every start epoch of that
  file's cases (phase changes, save epochs, the dispatch cap).
- Fused (``epochs_per_dispatch=3``) against per-epoch: the final
  parameters within the JAX test's bound (rtol 2e-5, atol 2e-6), a
  ``metrics.jsonl`` row for every epoch, and the host RNG after, equal.
- Fused against the JAX fused Trainer: every step's images and pixels, the
  epochs logged and the host RNG after, equal; the lr of each epoch the
  JAX schedule's within rtol 1e-6 (``tests/test_torch_loop.py``'s).
- Fused against the JAX fused Trainer, both training for real from the
  JAX Trainer's initial parameters, with the same draws at every step
  (each side's render_forward given one fixed noise dict, as
  ``tests/test_torch_step.py`` replays draws): every epoch's metrics within
  that file's loss bound (1e-4 relative + 1e-7), ``hit_frac`` equal, the
  lr within rtol 1e-6, and the final parameters within its Adam-step
  bounds (each entry lr / 2, the median 1e-6).
- A fused run resumed from its epoch-3 checkpoint ends with the full
  run's parameters, to the bit; so does one of 24 epochs (a save every 8)
  resumed from epoch 8 while the worker was drawing ahead, and the resumed
  plan is the full run's, row for row.
- The trainer's draws ahead (its worker draws the next chunk's pixel
  subsets and image orders while a chunk runs): over save epochs and
  phase changes, the plan rows and every checkpoint's host RNG state of a
  run equal those of the same run with every draw made in place, and the
  share of epochs drawn ahead is the one the chunk ends give;
  ``_plan_chunk`` asked directly for the next epoch takes its draws, and
  asked for another, raises.
- The CLI runs chunks by default and ``train_epoch`` under ``--no_fused``.

The port's training runs in subprocesses: a torch optimizer step changes
XLA:CPU results for the rest of its process.
"""
import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from mvsdf_tpu import config as jc
from mvsdf_tpu.data.scene import SceneData as JScene
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.fields.sdf import ImplicitConfig as JImplicit
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu.train.loop import Trainer as JTrainer
from mvsdf_tpu.train.step import make_optimizer
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.data.scene import SceneData
from mvsdf_tpu_torch.data.synthetic import write_scene_dir
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig as TImplicit
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer
from mvsdf_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("loss", "rgb_loss", "eikonal_loss", "depth_loss", "feat_loss",
           "surf_loss", "grad_norm", "lr", "hit_frac")


def _cfg(nepochs=5, fused=True, epochs_per_dispatch=16, num_pixels=32,
         supervised_compact_frac=(), plot_freq=1.0 / 12.0):
    """The port's counterpart of the JAX test's ``_cfg``."""
    return tc.MVSDFConfig(
        model=tc.ModelConfig(
            implicit=TImplicit(feature_vector_size=32, dims=(32,) * 2,
                               skip_in=(), multires=4),
            render=TRender(feature_vector_size=32, dims=(32,),
                           multires_view=2),
            tracer=TTracer(sphere_tracing_iters=3, n_steps=12,
                           n_secant_steps=2, sample_chunk=0),
            supervised_compact_frac=supervised_compact_frac),
        train=tc.TrainConfig(batch_size=2, num_pixels=num_pixels,
                             nepochs=nepochs,
                             fused_dispatch=fused,
                             epochs_per_dispatch=epochs_per_dispatch,
                             plot_freq=plot_freq))


RUN = r"""
import json, os, pickle, sys
import numpy as np, torch
from mvsdf_tpu_torch.data.scene import SceneData
from mvsdf_tpu_torch.train.loop import Trainer

scene_dir, out = sys.argv[1], sys.argv[2]
cfgs = pickle.load(open(os.path.join(out, "cfgs.pkl"), "rb"))
torch.set_num_threads(2)
sd = SceneData(scene_dir, allow_random_features=True, device="cpu")


def trainer(tag, cfg, trace=False):
    t = Trainer(cfg, sd, os.path.join(out, tag), device="cpu",
                log_fn=lambda *a: None, trace=trace)

    def plot(epoch, full=False, **kw):   # the full render's view draw only
        if full:
            t.rng.integers(t.scene.n_images)
    t.plot = plot
    return t


def params(t):
    return np.concatenate([p.detach().numpy().ravel()
                           for p in t.state.net.parameters()])


res = {}
plan = []
for tag in ("ref", "fused"):
    cfg = cfgs[tag]
    t = trainer(tag, cfg)
    if tag == "fused":
        inner = t._plan_chunk

        def record(e0, e1, step, inner=inner):
            rows, epochs, n_sel = inner(e0, e1, step)
            plan.append(rows)
            return rows, epochs, n_sel
        t._plan_chunk = record
    t.run(resume=False)
    res[tag] = params(t)
    res[tag + "_rng"] = json.dumps(t.rng.bit_generator.state)


def recorded(t):   # [(epoch, row)] of t's plans, as they are made
    rows = []
    inner = t._plan_chunk

    def record(e0, e1, step):
        plan, epochs, n_sel = inner(e0, e1, step)
        rows.extend(zip(epochs, plan))
        return plan, epochs, n_sel
    t._plan_chunk = record
    return rows


# each fused run with every host draw made in place (the worker never
# started), then as the trainer runs it; then resumed from a checkpoint
# after one chunk, the worker started on the next chunk's draws
for tag, at in (("full", 3), ("ahead3", 8), ("ahead16", None)):
    for arm in ("in_place", "ahead"):
        t = trainer(f"{tag}_{arm}", cfgs[tag], trace=True)
        if arm == "in_place":
            t._draw_ahead = lambda e1: None
        rows = recorded(t)
        t.run(resume=False)
        res[f"{tag}_{arm}_epochs"] = np.array([e for e, _ in rows])
        res[f"{tag}_{arm}_plan"] = np.stack([r for _, r in rows])
        ckpts = sorted(os.listdir(t.ckpt_dir))
        res[f"{tag}_{arm}_rngs"] = json.dumps({
            s: json.load(open(os.path.join(t.ckpt_dir, s, "rng.json")))[
                "np_rng"] for s in ckpts if s.startswith("step_")})
        res[f"{tag}_{arm}_share"] = t.tracer.summary()[
            "plan_drawn_ahead_share"]
        res[f"{tag}_{arm}"] = params(t)
    if at is None:
        continue
    half = trainer(f"{tag}_ahead", cfgs[tag])
    rows = recorded(half)
    half._train_chunk(0, half._chunk_end(0))
    half._flush_metrics()
    started = half._ahead is not None
    half.maybe_resume(at)
    res[f"{tag}_dropped"] = started and half._ahead is None and \
        not half._drawn
    half.run(resume=False)
    res[f"{tag}_resumed"] = params(half)
    res[f"{tag}_resumed_plan"] = np.stack([r for e, r in rows if e > at])
# the capturable step's Adam against torch.optim.Adam on the CPU
from mvsdf_tpu_torch.train.step import adam_scalars, adam_update
g = torch.Generator().manual_seed(0)
init = [torch.randn(s, generator=g) for s in ((64, 64), (64,), (1,))]
ref = [p.clone().requires_grad_(True) for p in init]
opt = torch.optim.Adam(ref, lr=1.6e-3, betas=(0.9, 0.999), eps=1e-8)
got = [p.clone() for p in init]
state = [(torch.zeros_like(p), torch.zeros_like(p), None) for p in got]
for t in range(1, 7):
    gs = [torch.randn(p.shape, generator=g) * 10.0 ** -t for p in got]
    for p, gr in zip(ref, gs):
        p.grad = gr.clone()
    opt.step()
    step_neg, bc2, _ = (torch.tensor(v) for v in adam_scalars(opt, t))
    adam_update(got, gs, state, step_neg, bc2, (0.9, 0.999), 1e-8)
adam_equal = all(torch.equal(a.detach(), b) for a, b in zip(ref, got))
np.savez(os.path.join(out, "port.npz"), plan=np.concatenate(plan),
         adam_equal=adam_equal, **res)
"""


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_scene_dir(str(tmp_path_factory.mktemp("data")),
                           n_images=4)


@pytest.fixture(scope="module")
def port_runs(scene_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    with open(out / "cfgs.pkl", "wb") as f:
        pickle.dump({"ref": _cfg(fused=False),
                     "fused": _cfg(fused=True, epochs_per_dispatch=3),
                     "full": _cfg(nepochs=6, epochs_per_dispatch=2),
                     # 24 epochs, a save every 8, phases from 4 and 12
                     "ahead3": _cfg(nepochs=24, epochs_per_dispatch=3,
                                    plot_freq=1 / 3),
                     "ahead16": _cfg(nepochs=24, epochs_per_dispatch=16,
                                     plot_freq=1 / 3)}, f)
    res = subprocess.run(
        [sys.executable, "-c", RUN, scene_dir, str(out)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return out, dict(np.load(out / "port.npz"))


def _jcfg(nepochs=5, fused=True, epochs_per_dispatch=16, num_pixels=32,
          supervised_compact_frac=()):
    return jc.MVSDFConfig(
        model=jc.ModelConfig(
            implicit=JImplicit(feature_vector_size=32, dims=(32,) * 2,
                               skip_in=(), multires=4),
            render=JRender(feature_vector_size=32, dims=(32,),
                           multires_view=2),
            tracer=JTracer(sphere_tracing_iters=3, n_steps=12,
                           n_secant_steps=2, sample_chunk=0),
            supervised_compact_frac=supervised_compact_frac),
        schedule=jc.Schedule(),
        train=jc.TrainConfig(batch_size=2, num_pixels=num_pixels,
                             nepochs=nepochs,
                             fused_dispatch=fused,
                             epochs_per_dispatch=epochs_per_dispatch))


def _rows(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("nepochs,epd", [(12, 50), (120, 50), (1200, 16),
                                         (5, 3), (6, 2)])
def test_chunk_end_matches_jax(scene_dir, tmp_path, nepochs, epd):
    jt = JTrainer(_jcfg(nepochs, epochs_per_dispatch=epd),
                  JScene(scene_dir, load_features=False),
                  str(tmp_path / "j"), use_mesh=False, log_fn=lambda *a: 0)
    pt = Trainer(_cfg(nepochs, epochs_per_dispatch=epd),
                 SceneData(scene_dir, load_features=False, device="cpu"),
                 str(tmp_path / "t"), device="cpu", log_fn=lambda *a: 0)
    assert pt.plot_freq == jt.plot_freq
    assert pt._dispatch_epochs() == jt._dispatch_epochs()
    ends = [pt._chunk_end(e) for e in range(nepochs + 1)]
    assert ends == [jt._chunk_end(e) for e in range(nepochs + 1)]
    # the JAX test's own cases
    want = {12: {0: 1}, 120: {0: 10, 11: 19, 20: 20, 21: 30, 61: 70},
            1200: {601: 616}}.get(nepochs, {})
    assert {e: ends[e] for e in want} == want


def test_fused_matches_per_epoch(port_runs):
    out, res = port_runs
    np.testing.assert_allclose(res["fused"], res["ref"], rtol=2e-5,
                               atol=2e-6)
    assert str(res["fused_rng"]) == str(res["ref_rng"])
    for d in ("ref", "fused"):
        rows = _rows(out / d)
        assert [r["step"] for r in rows] == list(range(6)), d
        assert all(np.isfinite(r[k]) for r in rows for k in METRICS), d


def test_fused_plan_matches_the_jax_fused_trainer(scene_dir, tmp_path,
                                                  port_runs):
    """JAX's scan steps are replaced by a recorder of their inputs (its
    padding rows dropped), its checkpoints and plots by the full render's
    view draw: the host plan alone is compared."""
    out, res = port_runs
    jcfg = _jcfg(fused=True, epochs_per_dispatch=3)
    jt = JTrainer(jcfg, JScene(scene_dir, allow_random_features=True),
                  str(tmp_path / "j"), use_mesh=False, log_fn=lambda *a: 0)
    seen = []

    def scan(state, indices, sel, weights, epochs, keys, active):
        act = np.asarray(active)
        seen.append((np.asarray(indices)[act], np.asarray(sel)[act]))
        return state, {k: jnp.zeros(indices.shape[0]) for k in METRICS}

    def plot(epoch, full=False, **kw):
        if full:
            jt.rng.integers(jt.scene.n_images)

    jt._get_scan_step = lambda phase: scan
    jt.save = lambda epoch: None
    jt.plot = plot
    jt.run(resume=False)
    B, P = jcfg.train.batch_size, jcfg.train.num_pixels
    plan = res["plan"]
    np.testing.assert_array_equal(plan[:, :B],
                                  np.concatenate([i for i, _ in seen]))
    np.testing.assert_array_equal(plan[:, B:B + P],
                                  np.concatenate([s for _, s in seen]))
    assert str(res["fused_rng"]) == json.dumps(jt.rng.bit_generator.state)
    rows, jrows = _rows(out / "fused"), _rows(tmp_path / "j")
    assert [r["step"] for r in rows] == [r["step"] for r in jrows]
    _, lr_for_epoch = make_optimizer(jcfg)
    np.testing.assert_allclose([r["lr"] for r in rows],
                               [float(lr_for_epoch(r["step"])) for r in rows],
                               rtol=1e-6)


JAX_NOISE_RUN = r"""
import os, pickle, sys
import numpy as np, torch
import mvsdf_tpu_torch.train.step as ts
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.scene import SceneData
from mvsdf_tpu_torch.train.loop import Trainer

scene_dir, out = sys.argv[1], sys.argv[2]
cfg, params0, noise = pickle.load(open(os.path.join(out, "in.pkl"), "rb"))
fixed = {k: torch.from_numpy(np.asarray(v)) for k, v in noise.items()}
render_forward = ts.render_forward


def replay(*args, **kw):   # every step's draws: the fixed noise
    kw["noise"] = fixed
    return render_forward(*args, **kw)


ts.render_forward = replay
torch.set_num_threads(2)
sd = SceneData(scene_dir, allow_random_features=True, device="cpu")
t = Trainer(cfg, sd, os.path.join(out, "port"), device="cpu",
            log_fn=lambda *a: None)
t.state.net.load_state_dict(params_from_jax(params0))


def plot(epoch, full=False, **kw):   # the full render's view draw only
    if full:
        t.rng.integers(t.scene.n_images)


t.plot = plot
t.run(resume=False)
np.savez(os.path.join(out, "port.npz"),
         **{k: v.numpy() for k, v in t.state.net.state_dict().items()})
"""


def test_fused_trains_as_the_jax_fused_trainer(scene_dir, tmp_path,
                                               monkeypatch):
    _train_against_jax(scene_dir, tmp_path, monkeypatch)


def test_fused_trains_as_the_jax_fused_trainer_compacted(scene_dir, tmp_path,
                                                         monkeypatch):
    """The same with ``supervised_compact_frac=(0.375,)`` at 2 x 512 rays
    (at 2 x 32 every tier is dropped): JAX's fused step takes its
    capacity cascade, the port's captured step's plain version
    ``bounded_cascade_call_into``."""
    hits = _train_against_jax(scene_dir, tmp_path, monkeypatch, P=512,
                              supervised_compact_frac=(0.375,))
    # the surface rows of some step reach past the 384-row tier
    assert max(hits) * 2 * 512 > 384, hits


def _train_against_jax(scene_dir, tmp_path, monkeypatch, P=32,
                       supervised_compact_frac=()):
    """Both fused trainers from the JAX Trainer's initial parameters, with
    the same draws at every step; returns the port's hit_frac by epoch."""
    import functools

    import jax

    import mvsdf_tpu.train.step as j_step
    B = 2
    sup = dict(num_pixels=P, supervised_compact_frac=supervised_compact_frac)
    jcfg = _jcfg(fused=True, epochs_per_dispatch=3, **sup)
    rng = np.random.default_rng(1)
    n, depth_rows = B * P // 2, B * 16 * 16   # the scene's 16x16 depths
    noise = {
        "minimal_steps": rng.uniform(size=12).astype(np.float32),
        "eik_points": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "dsurf_jitter_noise": rng.uniform(
            -0.1, 0.1, (depth_rows, 3)).astype(np.float32),
        "dsurf_on_idx": rng.integers(0, depth_rows, n),
        "dsurf_jitter_idx": rng.integers(0, depth_rows, n)}
    params0 = jax.tree_util.tree_map(
        np.asarray, j_step.init_params(jcfg, seed=jcfg.train.seed))
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump((_cfg(fused=True, epochs_per_dispatch=3, **sup),
                     params0, noise), f)
    res = subprocess.run(
        [sys.executable, "-c", JAX_NOISE_RUN, scene_dir, str(tmp_path)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    port = np.load(tmp_path / "port.npz")

    monkeypatch.setattr(j_step, "render_forward", functools.partial(
        j_step.render_forward,
        noise={k: jnp.asarray(v) for k, v in noise.items()}))
    jt = JTrainer(jcfg, JScene(scene_dir, allow_random_features=True),
                  str(tmp_path / "j"), use_mesh=False, log_fn=lambda *a: 0)
    jt.state = jt.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params0))

    def plot(epoch, full=False, **kw):
        if full:
            jt.rng.integers(jt.scene.n_images)

    jt.plot = plot
    jt.run(resume=False)

    rows, jrows = _rows(tmp_path / "port"), _rows(tmp_path / "j")
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == \
        list(range(6))
    for r, jr in zip(rows, jrows):
        for k in METRICS:
            if k == "hit_frac":
                assert r[k] == jr[k], (r["step"], k)
            elif k == "lr":
                np.testing.assert_allclose(r[k], jr[k], rtol=1e-6)
            else:
                assert abs(r[k] - jr[k]) <= 1e-4 * abs(jr[k]) + 1e-7, \
                    (r["step"], k, r[k], jr[k])
    lr = jcfg.train.learning_rate * B
    for net_name in ("implicit", "render"):
        for i, layer in enumerate(jt.state.params[net_name]):
            for k, v in layer.items():
                diff = np.abs(port[f"{net_name}.layers.{i}.{k}"] -
                              np.asarray(v))
                assert diff.max() <= lr / 2, (net_name, i, k, diff.max())
                assert np.median(diff) <= 1e-6, (net_name, i, k)
    return [r["hit_frac"] for r in rows]


def test_adam_update_equals_torch_adam(port_runs):
    """The captured step's Adam (``step.adam_update``) is torch.optim.Adam's
    CPU update to the bit, over 6 steps of shrinking gradients."""
    _, res = port_runs
    assert bool(res["adam_equal"])


@pytest.mark.parametrize("tag,at", [("full", 3), ("ahead3", 8)],
                         ids=["save_every_epoch", "drawn_ahead"])
def test_fused_resume_equals_the_full_run(port_runs, tag, at):
    """Resumed after one chunk of a fresh trainer, whose worker was then
    drawing the next chunk's draws: the restore drops them, and the plan
    from the checkpoint on and the final parameters are the full run's."""
    _, res = port_runs
    assert bool(res[f"{tag}_dropped"])
    np.testing.assert_array_equal(res[f"{tag}_resumed"], res[f"{tag}_ahead"])
    full = res[f"{tag}_ahead_plan"][res[f"{tag}_ahead_epochs"] > at]
    np.testing.assert_array_equal(res[f"{tag}_resumed_plan"], full)


# epochs whose draws the worker made ahead, by chunk, with nepochs 24 and a
# save every 8 (phases from 4 and 12): it draws after each chunk up to the
# next chunk's cap or the first save epoch, and nothing after a chunk that
# ends at one
#   3 a chunk: [0,2] 0, [3,3] 1, [4,6] 3, [7,8] 2, [9,11] 0, [12,14] 3,
#     [15,16] 2, [17,19] 0, [20,22] 3, [23,24] 2
#   16 (9: plot_freq + 1): [0,3] 0, [4,8] 5, [9,11] 0, [12,16] 5, [17,24] 0
@pytest.mark.parametrize("tag,share", [("ahead3", 16 / 25),
                                       ("ahead16", 10 / 25)],
                         ids=["3_a_chunk", "16_a_chunk"])
def test_draws_ahead_equal_draws_in_place(port_runs, tag, share):
    _, res = port_runs
    np.testing.assert_array_equal(res[f"{tag}_ahead_epochs"],
                                  res[f"{tag}_in_place_epochs"])
    np.testing.assert_array_equal(res[f"{tag}_ahead_epochs"],
                                  np.repeat(np.arange(25), 2))
    np.testing.assert_array_equal(res[f"{tag}_ahead_plan"],
                                  res[f"{tag}_in_place_plan"])
    rngs = json.loads(str(res[f"{tag}_ahead_rngs"]))
    assert sorted(rngs) == ["step_16", "step_24", "step_8"]
    assert rngs == json.loads(str(res[f"{tag}_in_place_rngs"]))
    assert float(res[f"{tag}_ahead_share"]) == pytest.approx(share)
    assert float(res[f"{tag}_in_place_share"]) == 0
    np.testing.assert_array_equal(res[f"{tag}_ahead"],
                                  res[f"{tag}_in_place"])


def test_plan_chunk_takes_the_draws_ahead_from_their_first_epoch(
        scene_dir, tmp_path):
    """``_plan_chunk`` called directly, as ``scripts/port_trace_pass.py``
    does, after the worker drew epochs 3-5: asked for epoch 4 it raises;
    asked for epoch 3 it takes its draws, and for 4-6 the rest and epoch 6
    drawn in place, all as one host RNG stream draws them."""
    cfg = _cfg(nepochs=24, epochs_per_dispatch=3, plot_freq=1 / 3)
    sd = SceneData(scene_dir, load_features=False, device="cpu")
    t = Trainer(cfg, sd, str(tmp_path), device="cpu", log_fn=lambda *a: 0,
                trace=True)
    step = t._get_fused_step(0, cfg.schedule.weights(0))
    B, P = cfg.train.batch_size, cfg.train.num_pixels
    ref = np.random.default_rng(cfg.train.seed)
    want = [(ref.permutation(sd.total_pixels)[:P],
             ref.permutation(sd.n_images)) for _ in range(7)]

    def check(plan, epochs, e0, e1):
        assert epochs == list(np.repeat(np.arange(e0, e1 + 1), 2))
        for k, (row, e) in enumerate(zip(plan, epochs)):
            sel, order = want[e]
            np.testing.assert_array_equal(row[:B], order[k % 2 * B:][:B])
            np.testing.assert_array_equal(row[B:B + P], sel)
    check(*t._plan_chunk(0, 2, step)[:2], 0, 2)
    t._draw_ahead(2)
    with pytest.raises(ValueError, match="epoch 3's"):
        t._plan_chunk(4, 4, step)
    check(*t._plan_chunk(3, 3, step)[:2], 3, 3)
    check(*t._plan_chunk(4, 6, step)[:2], 4, 6)
    assert t.rng.bit_generator.state == ref.bit_generator.state
    assert not t._drawn and t._ahead is None
    np.testing.assert_array_equal(sd.sampling_idx, want[6][0])
    (span,) = [s for s in t.tracer.spans if s[0] == "draw_ahead"]
    assert span[5] == {"e0": 3, "e1": 5}
    assert [(p["ahead"], p["epochs"]) for p in t.tracer.plans] == \
        [(0, 3), (1, 1), (2, 3)]


CLI_RUN = r"""
import json, sys
from mvsdf_tpu_torch.train import cli, loop

calls = {"chunks": [], "epochs": []}
chunk, epoch = loop.Trainer._train_chunk, loop.Trainer.train_epoch


def counted_chunk(self, e0, e1):
    calls["chunks"].append([e0, e1])
    return chunk(self, e0, e1)


def counted_epoch(self, e):
    calls["epochs"].append(e)
    return epoch(self, e)


loop.Trainer._train_chunk = counted_chunk
loop.Trainer.train_epoch = counted_epoch
cli.main(sys.argv[1:])
print(json.dumps(calls))
"""

from tests.test_torch_loop import CONF  # noqa: E402 (plot_freq 1/2)


@pytest.mark.parametrize("flags,want", [
    ((), {"chunks": [[0, 0], [1, 1], [2, 2], [3, 4]], "epochs": []}),
    (("--no_fused",), {"chunks": [], "epochs": [0, 1, 2, 3, 4]})],
    ids=["fused", "no_fused"])
def test_cli_path_by_flag(tmp_path, flags, want):
    """nepoch 4, a save every 2 epochs: chunks close at the phase changes
    (after epochs 0 and 1) and at the save epochs 2 and 4."""
    data = write_scene_dir(str(tmp_path), n_images=3, img_hw=32,
                           depth_hw=16)
    conf = tmp_path / "small.conf"
    conf.write_text(CONF)
    args = ["--data_dir", data, "--pallas", "--allow_random_features",
            "--platform", "cpu", "--conf", str(conf), "--batch_size", "3",
            "--nepoch", "4", "--num_pixels", "64", "--exps_folder",
            str(tmp_path / "exps"), *flags]
    res = subprocess.run([sys.executable, "-c", CLI_RUN, *args], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  OMP_NUM_THREADS="2"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == want
