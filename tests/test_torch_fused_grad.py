"""The port's fused value + spatial gradient (``fields/fused_grad.py``)
against the JAX package's ``fused_full_value_and_grad`` on the CPU, and
against the port's own autograd path.

- The unit grid: nets of ``tests/unit/test_fused_grad.py``'s size (SDF
  4 x 32, 8 features), weights from the geometric init perturbed by
  0.05 N(0, 1) so every PE channel carries gradient, 257 points; multires
  {0, 4} x skip {(), (2,)} x bf16 {off, on}. Compared: ``out``, ``g``, and
  the gradients of ``v``, ``g`` and ``b`` of every layer and of ``x``
  under the JAX test's loss (value heads, eikonal, a directional term
  that reads the whole Hessian).
  - Against JAX, f32: out and g within 1e-5, each gradient within 2e-5
    of its tensor's largest entry (the JAX test's own bounds; 7.2e-7,
    6.2e-6 and 3.9e-6 measured). bf16: out within 1e-3, g within 3e-3,
    gradients within 1.5e-3 of the largest entry (at most 1.2e-4, 6.4e-4
    and 8.8e-4 measured, all three in the multires 0, no-skip case; the
    others read below 3.3e-5): the two packages round the same operands
    to bf16, but f32 sums in another order move an activation across a
    bf16 rounding boundary now and then, and that step (2^-9 relative)
    travels on. The control, the port's f32 fused path (no rounding at
    all) against JAX's bf16 one, reads at least 4.0e-3, 9.2e-3 and 2.6e-2
    and fails in every case (asserted). A copy whose backward kept the
    cotangents unrounded read 1.8e-3 to 3.9e-3 on the gradients, one
    whose backward rounded nothing 6.2e-3 to 7.6e-3: the gradient limit
    sits below both.
  - Against the port's autograd path, f32: the JAX test's bounds (4.8e-7,
    9.5e-7 and 6.9e-7 measured). bf16: the two paths round at different points by design
    (autograd stores bf16 activations; the fused path rounds the matmul
    operands, cotangents included, and keeps f32 pre-activations), so they
    are held to what JAX's own two paths give on the same inputs, times 2.
- The Function's contract: leading dimensions, no graph under
  ``torch.no_grad()``, a loss that does not read ``g`` (the tangent chain
  skipped) equal to one that reads ``0 * g``, finite at 100 z << 0, and
  off by default.
- One phase-B step with ``fused_value_grad`` (the bench configuration's
  kernel-path trace and supervised compaction), cameras off and on,
  against the JAX package's fused step at the step parity's tolerances:
  loss terms within 1e-4 relative, field gradients within 2e-3 of each
  tensor's largest entry, the pose gradient within 1e-3 (measured: 7.6e-7
  and 3.4e-5 without cameras; 9.9e-6, 2.5e-4 and 9.0e-4 with them, where
  the port's autograd path lies as far from JAX's, 9.0e-4, and the fused
  path 3.5e-6 from the port's autograd path: rays from the pose vectors
  part in f32 rounding, and the trace and the implicit-diff division carry
  it on); and one Adam
  step through each ``make_train_step`` (the port's in a subprocess: a
  torch optimizer step changes XLA:CPU results for the rest of its
  process): losses within 1e-4 relative, weights within lr / 2 (median
  1e-6), poses within 1e-6.
- The same step in bf16, fused against autograd: each loss term and the
  gradient's global relative norm within twice what JAX's two paths give
  on the same inputs (JAX: 1.1e-3 and 3.6e-2; the port: 8.6e-4 and
  3.3e-2). These weights (the init plus 0.5 N(0, 1)) make bf16 chaotic:
  the port's and JAX's bf16 steps part by 1.3e-1 globally, and a fused
  path without rounding reads 3.8e-2 against autograd, as the sound one
  does. At the seed-0 init weights, the kind the card's bench step starts
  from, the two paths part by 2.4e-3 (JAX: 2.1e-3), and the port's fused
  bf16 step lies 3.7e-3 of a tensor's largest entry from JAX's, where the
  f32 fused path lies 1.25e-1 (``render.layers.0.b``: its gradient moves
  by 12.5% of its largest entry under bf16 in either package).
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvsdf_tpu.train.step as j_step_mod
from mvsdf_tpu import config as jc
from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu.fields.fused_grad import fused_full_value_and_grad as j_fused
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.rendering.renderer import render_forward as j_render
from mvsdf_tpu.supervision.losses import total_loss as j_total
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.fields import fused_grad
from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.network import MVSDFNetwork
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.rendering.renderer import render_forward as t_render
from mvsdf_tpu_torch.supervision.losses import total_loss as t_total
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer
from mvsdf_tpu_torch.train import cameras_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS = 257
GRID = [(m, s, b) for m in (0, 4) for s in ((), (2,)) for b in (False,
                                                                True)]
# (out, g, each gradient relative to its tensor's largest entry)
TOL_F32 = (1e-5, 1e-5, 2e-5)
TOL_JAX_BF16 = (1e-3, 3e-3, 1.5e-3)
STEP_BF16_TENSOR_TOL = 2e-2


def _kw(multires, skip, bf16):
    return dict(feature_vector_size=8, dims=(32,) * 4, skip_in=skip,
                multires=multires, bias=0.6, bf16_activations=bf16)


def _params(kw):
    """The JAX package's geometric init, perturbed, as numpy."""
    params = j_sdf.init_implicit(j_sdf.ImplicitConfig(**kw),
                                 np.random.default_rng(0))
    rng = np.random.default_rng(7)
    return [{k: (np.asarray(v) + 0.05 * rng.normal(size=v.shape)).astype(
        np.float32) for k, v in p.items()} for p in params]


def _points(n=N_PTS):
    return np.random.default_rng(1).uniform(-0.9, 0.9, (n, 3)).astype(
        np.float32)


def _j_loss(fn, x):
    out, g = fn(x)
    eik = jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)
    dirs = jnp.sin(x * 3.0)
    return (jnp.mean(out[..., 0] ** 2) + 0.3 * jnp.mean(out[..., 1:] ** 2) +
            eik + 0.7 * jnp.mean(jnp.sum(g * dirs, -1)))


def _t_loss(out, g, x):
    eik = ((torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2).mean()
    dirs = torch.sin(x * 3.0)
    return ((out[..., 0] ** 2).mean() + 0.3 * (out[..., 1:] ** 2).mean() +
            eik + 0.7 * (g * dirs).sum(-1).mean())


def _jax_run(kw, fused, params, x):
    """(out, g, [x grad, then v, g, b of each layer]) of JAX's path."""
    cfg = j_sdf.ImplicitConfig(fused_value_grad=fused, **kw)
    fn = functools.partial(j_fused, cfg) if fused else functools.partial(
        j_sdf.full_value_and_grad, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jx = jnp.asarray(x)
    out, g = fn(jp, jx)
    gp, gx = jax.grad(lambda p, xx: _j_loss(functools.partial(fn, p), xx),
                      argnums=(0, 1))(jp, jx)
    grads = [np.asarray(gx)] + [np.asarray(gp[l][k])
                                for l in range(len(params))
                                for k in ("v", "g", "b")]
    return np.asarray(out), np.asarray(g), grads


def _port_net(kw, fused, params):
    net = t_sdf.ImplicitNetwork(t_sdf.ImplicitConfig(
        fused_value_grad=fused, **kw))
    for layer, p in zip(net.layers, params):
        for k, v in p.items():
            getattr(layer, k).data.copy_(torch.from_numpy(v))
    return net


def _port_run(kw, fused, params, x):
    net = _port_net(kw, fused, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, g = t_sdf.full_value_and_grad(net, xt)
    grads = torch.autograd.grad(_t_loss(out, g, xt), [xt] + [
        getattr(layer, k) for layer in net.layers for k in ("v", "g", "b")])
    return out.detach().numpy(), g.detach().numpy(), [q.numpy()
                                                     for q in grads]


def _diffs(a, b):
    """(max |out|, max |g|, worst gradient difference relative to its
    tensor's largest entry)."""
    rel = max(np.abs(p - q).max() / max(np.abs(q).max(), 1e-12)
              for p, q in zip(a[2], b[2]))
    return (np.abs(a[0] - b[0]).max(), np.abs(a[1] - b[1]).max(), rel)


def _assert_within(d, tol):
    assert all(v <= t for v, t in zip(d, tol)), (d, tol)


@pytest.mark.parametrize("multires,skip,bf16", GRID)
def test_fused_matches_jax_fused(multires, skip, bf16):
    kw = _kw(multires, skip, bf16)
    params, x = _params(kw), _points()
    d = _diffs(_port_run(kw, True, params, x), _jax_run(kw, True, params, x))
    _assert_within(d, TOL_JAX_BF16 if bf16 else TOL_F32)


@pytest.mark.parametrize("multires,skip", [(m, s) for m, s, b in GRID
                                           if b])
def test_bf16_tolerance_rejects_the_unrounded_path(multires, skip):
    """The port's f32 fused path against JAX's bf16 fused path, which a
    fused path that skipped every bf16 rounding would read: outside
    TOL_JAX_BF16 in every case."""
    kw = _kw(multires, skip, True)
    params, x = _params(kw), _points()
    d = _diffs(_port_run(_kw(multires, skip, False), True, params, x),
               _jax_run(kw, True, params, x))
    assert any(v > t for v, t in zip(d, TOL_JAX_BF16)), (d, TOL_JAX_BF16)


@pytest.mark.parametrize("multires,skip,bf16", GRID)
def test_fused_matches_the_autograd_path(multires, skip, bf16):
    kw = _kw(multires, skip, bf16)
    params, x = _params(kw), _points()
    d = _diffs(_port_run(kw, True, params, x),
               _port_run(kw, False, params, x))
    if bf16:
        jd = _diffs(_jax_run(kw, True, params, x),
                    _jax_run(kw, False, params, x))
        tol = tuple(2 * v for v in jd)
    else:
        tol = TOL_F32
    _assert_within(d, tol)


def test_fused_keeps_leading_dims_and_builds_no_graph_under_no_grad():
    kw = _kw(4, (2,), False)
    params = _params(kw)
    net = _port_net(kw, True, params)
    x = torch.from_numpy(_points(4 * 33).reshape(4, 33, 3))
    out, g = t_sdf.full_value_and_grad(net, x)
    assert out.shape == (4, 33, 10) and g.shape == (4, 33, 3)
    assert out.requires_grad and g.requires_grad
    with torch.no_grad():
        out0, g0 = t_sdf.full_value_and_grad(net, x.requires_grad_(True))
    assert out0.grad_fn is None and g0.grad_fn is None
    assert not out0.requires_grad and not g0.requires_grad
    torch.testing.assert_close(out0, out.detach(), rtol=0, atol=0)
    torch.testing.assert_close(g0, g.detach(), rtol=0, atol=0)
    flat = _port_run(kw, True, params, x.detach().numpy().reshape(-1, 3))
    np.testing.assert_array_equal(out0.numpy().reshape(-1, 10), flat[0])


def test_a_loss_without_g_skips_the_tangent_chain_alike():
    """gbar None (no loss reads g) against gbar = 0 (a loss reading 0 * g),
    which runs the tangent chain: the same gradients."""
    kw = _kw(4, (2,), False)
    params = _params(kw)
    grads = []
    for with_g in (False, True):
        net = _port_net(kw, True, params)
        x = torch.from_numpy(_points()).requires_grad_(True)
        out, g = t_sdf.full_value_and_grad(net, x)
        loss = (out ** 2).mean() + (0.0 * g.sum() if with_g else 0.0)
        grads.append(torch.autograd.grad(loss, [x, *net.parameters()]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_fused_is_finite_where_100z_is_far_below_zero():
    """A first layer pushed to z ~ -60 at some points (100 z = -6000):
    sigmoid-based sigma' and sigma'' stay finite, and the gradients match
    the autograd path's."""
    kw = _kw(4, (2,), False)
    params = _params(kw)
    params[0]["b"] = params[0]["b"] - np.where(
        np.arange(params[0]["b"].size) % 2 == 0, 60.0, 0.0).astype(
        np.float32)
    x = _points()
    fused, auto = (_port_run(kw, f, params, x) for f in (True, False))
    assert all(np.isfinite(a).all() for a in (fused[0], fused[1],
                                              *fused[2]))
    _assert_within(_diffs(fused, auto), TOL_F32)


def test_fused_value_grad_is_off_by_default():
    assert t_sdf.ImplicitConfig().fused_value_grad is False
    assert tc.MVSDFConfig().model.implicit.fused_value_grad is False
    assert j_sdf.ImplicitConfig().fused_value_grad is False


def test_fused_backward_keeps_only_the_pre_activations():
    kw = _kw(4, (2,), False)
    net = _port_net(kw, True, _params(kw))
    x = torch.from_numpy(_points()).requires_grad_(True)
    out, g = t_sdf.full_value_and_grad(net, x)
    node = out.grad_fn.next_functions[0][0]       # past the reshape
    assert isinstance(node, torch.autograd.function.BackwardCFunction)
    assert node._forward_cls is fused_grad.FusedValueGrad
    n_layers = len(net.layers)
    saved = node.saved_tensors
    assert len(saved) == 1 + 2 * n_layers
    assert [tuple(t.shape) for t in saved[1 + n_layers:]] == [
        (N_PTS, o) for _, o in net.cfg.layer_shapes()]


# --- one phase-B step --------------------------------------------------------

B, P = 2, 256
ICFG = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,),
            fused_value_grad=True)
RCFG = dict(feature_vector_size=16, dims=(64,) * 2)
BENCH_TRACER = dict(
    fill_misses=False, sampler_capacity_frac=0.25, fill_capacity_frac=0.5,
    fallback_capacity_frac=(0.0625, 0.09375, 0.375),
    march_compact_schedule=((0, (0.375, 0.5)), (1, (0.1875, 0.25)),
                            (5, (0.0625, 0.125, 0.25))))
N_POSES = 4
INDICES = np.array([2, 1])


def _configs(cams):
    common = dict(implicit_diff_min_dot=0.0, supervised_compact_frac=(0.375,))
    jcfg = jc.MVSDFConfig(
        model=jc.ModelConfig(implicit=j_sdf.ImplicitConfig(**ICFG),
                             render=JRender(**RCFG),
                             tracer=JTracer(**BENCH_TRACER), **common),
        train=jc.TrainConfig(batch_size=B, num_pixels=P,
                             train_cameras=cams))
    tcfg = tc.MVSDFConfig(
        model=tc.ModelConfig(implicit=t_sdf.ImplicitConfig(**ICFG),
                             render=TRender(**RCFG),
                             tracer=TTracer(**BENCH_TRACER),
                             use_pallas_trace=True, **common),
        train=tc.TrainConfig(batch_size=B, num_pixels=P,
                             train_cameras=cams))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def step_data():
    """Weights (perturbed so the field has surface hits), the scene with
    the batch's rows of a 4-row pose table, the table's initial 7-d rows
    (the batch's true poses, perturbed) and every random draw."""
    jcfg, _ = _configs(False)
    params = jax.tree_util.tree_map(
        np.asarray, j_step_mod.init_params(jcfg, seed=0))
    rng = np.random.default_rng(1)
    params["implicit"] = [
        {k: (v + 0.5 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in p.items()} for p in params["implicit"]]
    sc = make_scene(n_images=B, n_pix=P, feat_ch=8, img_hw=96, depth_hw=24)
    sc["object_mask"] = rng.uniform(size=(B, P)) < 0.7
    sc["indices"] = INDICES
    n = B * P // 2
    depth_ok = np.flatnonzero(sc["depths"].reshape(-1) > 0)
    noise = {
        "minimal_steps": rng.uniform(size=100).astype(np.float32),
        "eik_points": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "dsurf_jitter_noise": rng.uniform(
            -0.1, 0.1, (sc["depths"].size, 3)).astype(np.float32),
        "dsurf_on_idx": rng.choice(depth_ok, n),
        "dsurf_jitter_idx": rng.choice(depth_ok, n),
    }
    table = np.concatenate([sc["pose"][::-1], sc["pose"][::-1]])
    pv0 = cameras_opt.pose_vecs_from_matrices(table)
    pv0 += (0.01 * rng.normal(size=pv0.shape)).astype(np.float32)
    return params, sc, pv0, noise


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("cams", [False, True], ids=["cams_off",
                                                     "cams_on"])
def test_fused_step_loss_and_gradients_match_jax(step_data, cams):
    params, sc, pv0, noise = step_data
    jcfg, tcfg = _configs(cams)
    gates = jcfg.schedule.gates_for_phase(1)
    weights = jcfg.schedule.weights(0.3)
    jbatch, jnoise = _jnp(sc), _jnp(noise)

    @jax.jit
    def j_loss(p, pv):
        inputs = dict(jbatch, pose=pv[jbatch["indices"]]) if cams else jbatch
        out = j_render(jcfg.model, p, inputs, training=True, gates=gates,
                       noise=jnoise)
        lt = j_total(out, jbatch, gates, jcfg.schedule, weights)
        return lt.loss, (lt, out.network_object_mask)

    (_, (j_lt, j_hit)), (j_grads, j_pose_grad) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(pv0))

    net = MVSDFNetwork(tcfg.model.implicit, tcfg.model.render)
    net.load_state_dict(params_from_jax(params))
    tbatch = _torch(sc)
    pv = torch.from_numpy(pv0).requires_grad_(True)
    inputs = dict(tbatch, pose=pv[tbatch["indices"]]) if cams else tbatch
    out = t_render(tcfg.model, net, inputs, training=True,
                   gates=tcfg.schedule.gates_for_phase(1),
                   noise=_torch(noise))
    t_lt = t_total(out, tbatch, tcfg.schedule.gates_for_phase(1),
                   tcfg.schedule, tcfg.schedule.weights(0.3))
    wrt = list(net.parameters()) + ([pv] if cams else [])
    grads = torch.autograd.grad(t_lt.loss, wrt)

    np.testing.assert_array_equal(out.network_object_mask.numpy(),
                                  np.asarray(j_hit))
    assert 0.05 < out.network_object_mask.float().mean().item() < 0.95
    for name in t_lt._fields:
        want = float(getattr(j_lt, name))
        got = float(torch.as_tensor(getattr(t_lt, name)).detach())
        assert abs(got - want) <= 1e-4 * abs(want) + 1e-7, (name, got, want)
    for (name, _), g in zip(net.named_parameters(), grads):
        net_name, _, l, k = name.split(".")
        want = np.asarray(j_grads[net_name][int(l)][k])
        assert np.abs(g.numpy() - want).max() <= 2e-3 * max(
            np.abs(want).max(), 1e-12), name
    if cams:
        want = np.asarray(j_pose_grad)
        assert (np.abs(want[INDICES]).max(1) > 1e-3).all()
        assert np.abs(grads[-1].numpy() - want).max() <= \
            1e-3 * np.abs(want).max()


PORT_ARM = r"""
import pickle, sys
import numpy as np, torch
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.train.step import init_train_state, make_train_step

cfg, params, scene, pv0, noise = pickle.load(open(sys.argv[1], "rb"))
t = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
state = init_train_state(cfg, seed=0, device="cpu",
                         pose_init=pv0 if cfg.train.train_cameras else None)
state.net.load_state_dict(params_from_jax(params))
step = make_train_step(cfg, phase_idx=1)
m = step(state, t(scene), cfg.schedule.weights(0.3), noise=t(noise))
out = {"losses": np.asarray([float(m["loss"]), float(m["grad_norm"])])}
if cfg.train.train_cameras:
    out["pose_vecs"] = state.pose_vecs.numpy()
for k, v in state.net.state_dict().items():
    out[k] = v.numpy()
np.savez(sys.argv[2], **out)
"""


@pytest.mark.parametrize("cams", [False, True], ids=["cams_off",
                                                     "cams_on"])
def test_fused_adam_step_matches_jax(step_data, tmp_path, monkeypatch,
                                     cams):
    params, sc, pv0, noise = step_data
    jcfg, tcfg = _configs(cams)
    lr = jcfg.train.learning_rate * B

    inp, outp = tmp_path / "in.pkl", tmp_path / "out.npz"
    with open(inp, "wb") as f:
        pickle.dump((tcfg, params, sc, pv0, noise), f)
    res = subprocess.run([sys.executable, "-c", PORT_ARM, str(inp),
                          str(outp)], env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    port = np.load(outp)

    monkeypatch.setattr(j_step_mod, "render_forward", functools.partial(
        j_step_mod.render_forward, noise=_jnp(noise)))
    state = j_step_mod.init_train_state(jcfg, seed=0,
                                        pose_init=pv0 if cams else None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    adam, _ = j_step_mod.make_optimizer(jcfg)
    state = state._replace(params=jp, opt_state=adam.init(jp))
    step = j_step_mod.make_train_step(jcfg, phase_idx=1, donate=False)
    state, m = step(state, _jnp(sc), j_step_mod.weights_to_array(
        jcfg.schedule.weights(0.3)), jax.random.PRNGKey(0))

    np.testing.assert_allclose(port["losses"], [float(m["loss"]),
                                                float(m["grad_norm"])],
                               rtol=1e-4)
    moved = 0
    for net_name in ("implicit", "render"):
        for l, layer in enumerate(state.params[net_name]):
            for k, v in layer.items():
                want = np.asarray(v)
                diff = np.abs(port[f"{net_name}.layers.{l}.{k}"] - want)
                assert diff.max() <= lr / 2, (net_name, l, k, diff.max())
                assert np.median(diff) <= 1e-6, (net_name, l, k)
                moved += np.abs(want - params[net_name][l][k]).max() > lr / 2
    assert moved > 0
    if cams:
        want = np.asarray(state.pose_vecs)
        np.testing.assert_allclose(port["pose_vecs"], want, rtol=0,
                                   atol=1e-6)
        assert np.abs(want[INDICES] - pv0[INDICES]).min() > 0


def _global_rel(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    return np.sqrt(num / sum(float((b[k] ** 2).sum()) for k in b))


def _step_grads(params, sc, noise, fused, bf16):
    """{"jax": ..., "port": ...}: each package's (loss terms, gradients by
    the port's parameter names) of one phase-B step, cameras off."""
    jcfg, tcfg = (_replace_implicit(c, fused_value_grad=fused,
                                    bf16_activations=bf16)
                  for c in _configs(False))
    gates = jcfg.schedule.gates_for_phase(1)
    weights = jcfg.schedule.weights(0.3)
    jbatch, jnoise = _jnp(sc), _jnp(noise)

    def j_loss(p):
        out = j_render(jcfg.model, p, jbatch, training=True, gates=gates,
                       noise=jnoise)
        lt = j_total(out, jbatch, gates, jcfg.schedule, weights)
        return lt.loss, lt

    (_, j_lt), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    net = MVSDFNetwork(tcfg.model.implicit, tcfg.model.render)
    net.load_state_dict(params_from_jax(params))
    tb = _torch(sc)
    out = t_render(tcfg.model, net, tb, training=True,
                   gates=tcfg.schedule.gates_for_phase(1),
                   noise=_torch(noise))
    t_lt = t_total(out, tb, tcfg.schedule.gates_for_phase(1),
                   tcfg.schedule, tcfg.schedule.weights(0.3))
    t_g = torch.autograd.grad(t_lt.loss, list(net.parameters()))
    names = [n for n, _ in net.named_parameters()]
    return {
        "jax": ({k: float(getattr(j_lt, k)) for k in j_lt._fields},
                {n: np.asarray(j_g[n.split(".")[0]][int(n.split(".")[2])]
                               [n.split(".")[3]]) for n in names}),
        "port": ({k: float(torch.as_tensor(getattr(t_lt, k)).detach())
                  for k in t_lt._fields},
                 {n: g.numpy() for n, g in zip(names, t_g)})}


def _loss_rel(a, b):
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b}


def _worst_tensor(a, b):
    return max(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-12)
               for k in b)


def test_bf16_fused_and_autograd_steps_part_as_in_jax(step_data):
    params, sc, _, noise = step_data
    runs = {fused: _step_grads(params, sc, noise, fused, True)
            for fused in (True, False)}
    for side in ("jax", "port"):
        (lf, gf), (la, ga) = runs[True][side], runs[False][side]
        runs[side] = (_loss_rel(lf, la), _global_rel(gf, ga))
    (jl, jg), (tl, tg) = runs["jax"], runs["port"]
    assert 0 < jg and tg <= 2 * jg, (tg, jg)
    for k in jl:
        assert tl[k] <= 2 * jl[k] + 1e-7, (k, tl[k], jl[k])


def test_bf16_fused_step_matches_jax_at_the_init_weights(step_data):
    """The bf16 fused step at the seed-0 init weights, the kind the card's
    bench step starts from: every gradient tensor within
    STEP_BF16_TENSOR_TOL of JAX's fused step's largest entry (3.7e-3
    measured), where the port's f32 fused path, a fused path that drops
    every bf16 rounding, lies 1.25e-1 from it (asserted above the limit);
    and the fused and autograd steps part by at most twice what JAX's two
    paths do (global 2.4e-3 against JAX's 2.1e-3; loss terms 1.6e-3 at
    most against 1.4e-3)."""
    _, sc, _, noise = step_data
    jcfg, _ = _configs(False)
    params = jax.tree_util.tree_map(np.asarray,
                                    j_step_mod.init_params(jcfg, seed=0))
    fb = _step_grads(params, sc, noise, True, True)
    ab = _step_grads(params, sc, noise, False, True)
    f32 = _step_grads(params, sc, noise, True, False)["port"]
    assert _worst_tensor(fb["port"][1], fb["jax"][1]) <= STEP_BF16_TENSOR_TOL
    assert _worst_tensor(f32[1], fb["jax"][1]) > STEP_BF16_TENSOR_TOL
    jg = _global_rel(fb["jax"][1], ab["jax"][1])
    tg = _global_rel(fb["port"][1], ab["port"][1])
    assert 0 < jg and tg <= 2 * jg, (tg, jg)
    jl = _loss_rel(fb["jax"][0], ab["jax"][0])
    tl = _loss_rel(fb["port"][0], ab["port"][0])
    for k in jl:
        assert tl[k] <= 2 * jl[k] + 1e-7, (k, tl[k], jl[k])


def _replace_implicit(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, implicit=dataclasses.replace(cfg.model.implicit, **kw)))
