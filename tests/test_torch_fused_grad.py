"""The port's value + spatial gradient with no autograd
(``fields/fused_grad.value_and_grad``, which the export's static render
calls) against the JAX package's hand-derived fused value + gradient
(``full_value_and_grad`` with ``fused_value_grad`` on) and against the
port's training path (``fields/sdf.full_value_and_grad``), on the CPU.

- The unit grid: nets of ``tests/unit/test_fused_grad.py``'s size (SDF
  4 x 32, 8 features), weights from the geometric init perturbed by
  0.05 N(0, 1) so every PE channel carries gradient, 257 points; multires
  {0, 4} x skip {(), (2,)} x bf16 {off, on}. Compared: ``out`` and ``g``.
  - Against JAX, f32: both within 1e-5. bf16: out within 1e-3, g within
    3e-3: the two packages round the same operands to bf16, but f32 sums
    in another order move an activation across a bf16 rounding boundary
    now and then. The control, the port's f32 forward (no rounding at
    all) against JAX's bf16 one, lies outside those limits in every case
    (asserted).
  - Against the training path, f32: within 1e-5. bf16: the two paths
    round at different points by design (the training path stores bf16
    activations; ``value_and_grad`` rounds the matmul operands, the
    reverse pass's cotangents included, and keeps f32 pre-activations),
    so they are held to what JAX's own two paths give on the same inputs,
    times 2.
- The contract: leading dimensions, no graph even where ``x`` requires
  grad, finite at 100 z << 0; ``fused_value_grad`` off by default and
  refused by the port when set.
- One phase-B step in bf16 in the bench configuration (its tracer,
  supervised compaction and kernel trace: the port's sdf_mlp plain
  version, JAX's Pallas trace in interpret mode; both traces are f32
  whatever ``bf16_activations`` says, the supervised path rounds to bf16
  on both sides) at the seed-0 init weights, the kind the card's bench
  step starts from, against the JAX package's bf16 step: every gradient
  tensor within STEP_BF16_TENSOR_TOL of JAX's largest entry (4.6e-3
  measured, ``implicit.layers.0.v``), where the port's f32 step, a step
  that drops every bf16 rounding, lies 1.31e-2 from it
  (``render.layers.0.b``; asserted above the limit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvsdf_tpu.train.step as j_step_mod
from mvsdf_tpu import config as jc
from mvsdf_tpu.fields import sdf as j_sdf
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

N_PTS = 257
GRID = [(m, s, b) for m in (0, 4) for s in ((), (2,)) for b in (False,
                                                                True)]
# (out, g)
TOL_F32 = (1e-5, 1e-5)
TOL_JAX_BF16 = (1e-3, 3e-3)
STEP_BF16_TENSOR_TOL = 7.5e-3


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


def _jax_run(kw, fused, params, x):
    """(out, g) of JAX's fused path, or of its autodiff path."""
    cfg = j_sdf.ImplicitConfig(fused_value_grad=fused, **kw)
    out, g = j_sdf.full_value_and_grad(
        cfg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def _port_net(kw, params):
    net = t_sdf.ImplicitNetwork(t_sdf.ImplicitConfig(**kw))
    for layer, p in zip(net.layers, params):
        for k, v in p.items():
            getattr(layer, k).data.copy_(torch.from_numpy(v))
    return net


def _port_vag(kw, params, x):
    """(out, g) of ``value_and_grad``."""
    out, g = fused_grad.value_and_grad(_port_net(kw, params),
                                       torch.from_numpy(x))
    return out.numpy(), g.numpy()


def _port_auto(kw, params, x):
    """(out, g) of the training path under ``torch.no_grad()``."""
    with torch.no_grad():
        out, g = t_sdf.full_value_and_grad(_port_net(kw, params),
                                           torch.from_numpy(x))
    return out.numpy(), g.numpy()


def _diffs(a, b):
    """(max |out|, max |g|) differences."""
    return tuple(np.abs(p - q).max() for p, q in zip(a, b))


def _assert_within(d, tol):
    assert all(v <= t for v, t in zip(d, tol)), (d, tol)


@pytest.mark.parametrize("multires,skip,bf16", GRID)
def test_fused_matches_jax_fused(multires, skip, bf16):
    kw = _kw(multires, skip, bf16)
    params, x = _params(kw), _points()
    d = _diffs(_port_vag(kw, params, x), _jax_run(kw, True, params, x))
    _assert_within(d, TOL_JAX_BF16 if bf16 else TOL_F32)


@pytest.mark.parametrize("multires,skip", [(m, s) for m, s, b in GRID
                                           if b])
def test_bf16_tolerance_rejects_the_unrounded_path(multires, skip):
    """The port's f32 ``value_and_grad`` against JAX's bf16 fused path,
    which a forward that skipped every bf16 rounding would read: outside
    TOL_JAX_BF16 in every case."""
    kw = _kw(multires, skip, True)
    params, x = _params(kw), _points()
    d = _diffs(_port_vag(_kw(multires, skip, False), params, x),
               _jax_run(kw, True, params, x))
    assert any(v > t for v, t in zip(d, TOL_JAX_BF16)), (d, TOL_JAX_BF16)


@pytest.mark.parametrize("multires,skip,bf16", GRID)
def test_fused_matches_the_autograd_path(multires, skip, bf16):
    """The export's normals against the training path's."""
    kw = _kw(multires, skip, bf16)
    params, x = _params(kw), _points()
    d = _diffs(_port_vag(kw, params, x), _port_auto(kw, params, x))
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
    net = _port_net(kw, params)
    x = torch.from_numpy(_points(4 * 33).reshape(4, 33, 3))
    out, g = fused_grad.value_and_grad(net, x.requires_grad_(True))
    assert out.shape == (4, 33, 10) and g.shape == (4, 33, 3)
    assert out.grad_fn is None and g.grad_fn is None
    assert not out.requires_grad and not g.requires_grad
    flat = _port_vag(kw, params, x.detach().numpy().reshape(-1, 3))
    np.testing.assert_array_equal(out.numpy().reshape(-1, 10), flat[0])
    np.testing.assert_array_equal(g.numpy().reshape(-1, 3), flat[1])


def test_fused_is_finite_where_100z_is_far_below_zero():
    """A first layer pushed to z ~ -60 at some points (100 z = -6000):
    ``value_and_grad`` stays finite and matches the training path, whose
    parameter gradients under a loss on g (a double backward through the
    activation) stay finite too."""
    kw = _kw(4, (2,), False)
    params = _params(kw)
    params[0]["b"] = params[0]["b"] - np.where(
        np.arange(params[0]["b"].size) % 2 == 0, 60.0, 0.0).astype(
        np.float32)
    x = _points()
    vag = _port_vag(kw, params, x)
    assert all(np.isfinite(a).all() for a in vag)
    _assert_within(_diffs(vag, _port_auto(kw, params, x)), TOL_F32)
    net = _port_net(kw, params)
    out, g = t_sdf.full_value_and_grad(net, torch.from_numpy(x))
    loss = (out[:, 0] ** 2).mean() + ((g.norm(dim=-1) - 1) ** 2).mean()
    assert all(torch.isfinite(d).all()
               for d in torch.autograd.grad(loss, list(net.parameters())))


def test_fused_value_grad_is_off_by_default():
    """Off by default on both sides; the port keeps JAX's field but has
    no hand-derived path, so setting it raises."""
    assert t_sdf.ImplicitConfig().fused_value_grad is False
    assert tc.MVSDFConfig().model.implicit.fused_value_grad is False
    assert j_sdf.ImplicitConfig().fused_value_grad is False
    with pytest.raises(ValueError, match="fused_value_grad"):
        t_sdf.ImplicitConfig(fused_value_grad=True)
    with pytest.raises(ValueError, match="fused_value_grad"):
        dataclasses.replace(tc.MVSDFConfig().model.implicit,
                            fused_value_grad=True)


# --- one phase-B step --------------------------------------------------------

B, P = 2, 256
ICFG = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
RCFG = dict(feature_vector_size=16, dims=(64,) * 2)
BENCH_TRACER = dict(
    fill_misses=False, sampler_capacity_frac=0.25, fill_capacity_frac=0.5,
    fallback_capacity_frac=(0.0625, 0.09375, 0.375),
    march_compact_schedule=((0, (0.375, 0.5)), (1, (0.1875, 0.25)),
                            (5, (0.0625, 0.125, 0.25))))


def _configs(bf16):
    common = dict(implicit_diff_min_dot=0.0, supervised_compact_frac=(0.375,))
    jcfg = jc.MVSDFConfig(
        model=jc.ModelConfig(
            implicit=j_sdf.ImplicitConfig(bf16_activations=bf16, **ICFG),
            render=JRender(**RCFG), tracer=JTracer(**BENCH_TRACER),
            use_pallas_trace=True, pallas_interpret=True, **common),
        train=jc.TrainConfig(batch_size=B, num_pixels=P))
    tcfg = tc.MVSDFConfig(
        model=tc.ModelConfig(
            implicit=t_sdf.ImplicitConfig(bf16_activations=bf16, **ICFG),
            render=TRender(**RCFG), tracer=TTracer(**BENCH_TRACER),
            use_pallas_trace=True, **common),
        train=tc.TrainConfig(batch_size=B, num_pixels=P))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def step_data():
    """The scene and every random draw of one step."""
    rng = np.random.default_rng(1)
    sc = make_scene(n_images=B, n_pix=P, feat_ch=8, img_hw=96, depth_hw=24)
    sc["object_mask"] = rng.uniform(size=(B, P)) < 0.7
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
    return sc, noise


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _step_grads(params, sc, noise, bf16):
    """{"jax": ..., "port": ...}: each package's gradients, by the port's
    parameter names, of one phase-B step."""
    jcfg, tcfg = _configs(bf16)
    gates = jcfg.schedule.gates_for_phase(1)
    weights = jcfg.schedule.weights(0.3)
    jbatch, jnoise = _jnp(sc), _jnp(noise)

    def j_loss(p):
        out = j_render(jcfg.model, p, jbatch, training=True, gates=gates,
                       noise=jnoise)
        return j_total(out, jbatch, gates, jcfg.schedule, weights).loss

    j_g = jax.jit(jax.grad(j_loss))(
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
        "jax": {n: np.asarray(j_g[n.split(".")[0]][int(n.split(".")[2])]
                              [n.split(".")[3]]) for n in names},
        "port": {n: g.numpy() for n, g in zip(names, t_g)}}


def _worst_tensor(a, b):
    return max(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-12)
               for k in b)


def test_bf16_fused_step_matches_jax_at_the_init_weights(step_data):
    """The bench configuration's bf16 step at the seed-0 init weights:
    every gradient tensor within STEP_BF16_TENSOR_TOL of JAX's bf16
    step's largest entry, where the port's f32 step lies outside it."""
    sc, noise = step_data
    params = jax.tree_util.tree_map(
        np.asarray, j_step_mod.init_params(_configs(False)[0], seed=0))
    bf16 = _step_grads(params, sc, noise, True)
    f32 = _step_grads(params, sc, noise, False)["port"]
    assert _worst_tensor(bf16["port"], bf16["jax"]) <= STEP_BF16_TENSOR_TOL
    assert _worst_tensor(f32, bf16["jax"]) > STEP_BF16_TENSOR_TOL
