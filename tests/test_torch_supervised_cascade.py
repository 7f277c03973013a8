"""The supervised path's capacity cascade with no host sync
(``compaction.bounded_cascade_call_into``, the BOUNDED renderer's rt_surf
value + gradient and shading) against the JAX package's compacting code,
on the CPU, at 1,024 rows: at fewer than 128 / frac rows every JAX tier is
the 128-row floor or is dropped, and no compact branch runs.

- (a) The cascade against JAX's ``compact_call_into(..., remat=True)`` on
  the 3 x 64 field's SDF, indicator logit and spatial gradient, caps of
  the fractions (0.375,) and (0.25, 0.5), at counts 0, 1, below the first
  cap, at it, between the caps, over the top one and all rows, with and
  without ``out_masks``: outputs, and the gradients of a loss on them
  (one that reads the spatial gradient, so second order) with respect to
  the inputs and the parameters, within rtol 1e-5 and an atol of 2e-5 of
  the tensor's largest entry (f32 sums over other row blocks, amplified
  by the second-order loss: 9.1e-6 measured, on gradients up to 3e5).
  The same with ``bf16_activations`` on both sides: an atol of 1.5e-2 of
  the largest entry (8.5e-3 measured, on the spatial input's gradient;
  a bf16 rounding boundary crossed in one package and not the other
  travels on), below what the f32 field reads against JAX's bf16 one:
  asserted outside the limit at every count of (0.375,) without
  ``out_masks`` (its worst tensor 4.4e-2 to 7.4e-2 of the largest
  entry; rows are computed at every count, count 0 included).
- (b) A skipped segment leaves its targets and contributes exactly zero
  gradient: NaN in its rows' inputs changes no bit of the outputs or of
  any gradient, and ``fn`` never sees its rows.
- (c) ``render_forward(mode="bounded")`` with the cascades (0.375,),
  (0.25, 0.5) and (0.125,) (which the surface rows overflow into its dense
  segment) against JAX's ``render_forward`` on the same configuration and
  replayed draws, at ``tests/test_torch_step.py``'s bounds (hit mask
  equal, every loss term within 1e-4 relative + 1e-7, every parameter
  gradient within 2e-3 of its tensor's largest entry, and the rgb, SDF
  and implicit-diff points within 2e-3 of max(1, their largest entry):
  6.9e-4 measured, as far as the per-epoch pass is from JAX); and against
  the port's per-epoch pass (``compact_call_into``: exactly the surface
  rows), RenderOut within 1e-6 (the SDF on the surface rows, the only
  ones the per-epoch pass writes), loss terms within 1e-6 relative +
  1e-7 and gradients within 1e-5 of the largest entry. 304 of the 1,024
  rays are surface rows: below (0.375,)'s cap, between (0.25, 0.5)'s,
  over (0.125,)'s.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvsdf_tpu.train.step as j_step_mod
from mvsdf_tpu import config as jc
from mvsdf_tpu.compaction import compact_call_into as j_cci
from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.rendering.renderer import render_forward as j_render
from mvsdf_tpu.supervision.losses import total_loss as j_total
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.compaction import (bounded_cascade_call_into,
                                        bounded_order)
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.rendering.renderer import render_forward as t_render
from mvsdf_tpu_torch.supervision.losses import total_loss as t_total
from mvsdf_tpu_torch.tracing.sphere_trace import BOUNDED
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer

from tests.test_torch_step import (BENCH_TRACER, RCFG, _jnp, _port_net,
                                   _torch)
from tests.test_torch_step import ICFG as STEP_ICFG

N = 1024
ICFG = dict(feature_vector_size=16, dims=(64,) * 3, skip_in=(2,))
FRACS = {"one_tier": (0.375,), "two_tiers": (0.25, 0.5)}
# (rtol, atol relative to the tensor's largest entry)
TOL_F32 = (1e-5, 2e-5)
TOL_BF16 = (1e-5, 1.5e-2)


def caps_of(fracs, n=N):
    """The renderer's tiers: max(128, int(n * f)) for each fraction."""
    return tuple(max(128, int(n * f)) for f in fracs)


@pytest.fixture(scope="module")
def field():
    jcfg = j_sdf.ImplicitConfig(**ICFG)
    params = jax.tree_util.tree_map(
        np.asarray, j_sdf.init_implicit(jcfg, np.random.default_rng(0)))
    rng = np.random.default_rng(1)
    params = [{k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
               for k, v in p.items()} for p in params]
    net = t_sdf.ImplicitNetwork(t_sdf.ImplicitConfig(**ICFG))
    state = params_from_jax({"implicit": params, "render": []})
    net.load_state_dict({k[len("implicit."):]: v for k, v in state.items()})
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    order = rng.permutation(N)
    row_w = rng.uniform(0.5, 1.5, N).astype(np.float32)
    targets = [rng.normal(size=(N, 2)).astype(np.float32),
               rng.normal(size=(N, 3)).astype(np.float32)]
    return jcfg, params, net, x, order, row_w, targets


def _mask(order, count):
    m = np.zeros(N, bool)
    m[order[:count]] = True
    return m


def _loss(o, g, w):
    """A loss on every row that reads the spatial gradient."""
    return (w * (o[:, 0] ** 2 + 0.5 * o[:, 1] +
                 ((g ** 2).sum(-1) - 1) ** 2)).sum()


def _counts(caps):
    return sorted({0, 1, caps[0] // 2, caps[0], (caps[0] + caps[-1]) // 2,
                   caps[-1] + 1, N})


def _port(net, x, mask, caps, targets, out_masks, row_w):
    def fn(p):
        out, g = t_sdf.full_value_and_grad(net, p)
        return out[..., :2], g

    xt = torch.from_numpy(x).requires_grad_(True)
    om = None if out_masks is None else [torch.from_numpy(m)
                                         for m in out_masks]
    o, g = bounded_cascade_call_into(
        fn, torch.from_numpy(mask), caps, [xt],
        [torch.from_numpy(t) for t in targets], out_masks=om, module=net)
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(_loss(o, g, torch.from_numpy(row_w)),
                                [xt, *params])
    out = [t.detach().numpy() for t in (o, g) + grads]
    return dict(zip(("out", "grad", "d_x") + names, out))


def _bf16(jcfg, net):
    """The JAX config and a copy of the port's net with bf16_activations
    on."""
    net = copy.deepcopy(net)
    net.cfg = dataclasses.replace(net.cfg, bf16_activations=True)
    return dataclasses.replace(jcfg, bf16_activations=True), net


def _cascades(field, jcfg, net, fracs, masked):
    """(count, port's, JAX's) for each count of ``_counts``: the outputs
    and gradients of the port's cascade on ``net`` and of JAX's
    ``compact_call_into(remat=True)`` on ``jcfg``, by the port's names."""
    _, params, _, x, order, row_w, targets = field
    caps = caps_of(FRACS[fracs])
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    sub_rng = np.random.default_rng(2)

    @jax.jit
    def jax_side(x, p, mask, om, w):
        def loss(x, p):
            def fn(q):
                out, g = j_sdf.full_value_and_grad(jcfg, p, q)
                return out[..., :2], g
            o, g = j_cci(fn, mask, caps, [x],
                         [jnp.asarray(t) for t in targets],
                         out_masks=om if masked else None, remat=True)
            return _loss(o, g, w), (o, g)
        (_, outs), grads = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            x, p)
        return outs, grads

    for count in _counts(caps):
        mask = _mask(order, count)
        sub = mask & (sub_rng.uniform(size=N) < 0.5)
        om = [mask, sub]
        (jo, jg), (jgx, jgp) = jax_side(jnp.asarray(x), jparams,
                                        jnp.asarray(mask),
                                        [jnp.asarray(m) for m in om],
                                        jnp.asarray(row_w))
        got = _port(net, x, mask, caps, targets, om if masked else None,
                    row_w)
        want = dict(out=jo, grad=jg, d_x=jgx, **{
            f"layers.{l}.{k}": v for l, layer in enumerate(jgp)
            for k, v in layer.items()})
        assert got.keys() == want.keys()
        yield count, got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("fracs,masked,bf16", [
    pytest.param(f, m, b, id=f"{f}-{'out_masks' if m else 'unpredicated'}"
                 + ("-bf16" if b else ""))
    for b in (False, True) for f in FRACS for m in (False, True)])
def test_cascade_matches_jax_compact_call_into(field, fracs, masked, bf16):
    jcfg, net = field[0], field[2]
    if bf16:
        jcfg, net = _bf16(jcfg, net)
    rtol, atol = TOL_BF16 if bf16 else TOL_F32
    for count, got, want in _cascades(field, jcfg, net, fracs, masked):
        for name, a in got.items():
            b = want[name]
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       atol=atol * np.abs(b).max(),
                                       err_msg=f"{count} {name}")


def test_bf16_tolerance_rejects_the_unrounded_cascade(field):
    """The control of the bf16 cases: the port's cascade on the f32 field
    against JAX's on the bf16 one lies outside TOL_BF16 in some tensor at
    every count."""
    jcfg, _ = _bf16(field[0], field[2])
    rtol, atol = TOL_BF16
    for count, got, want in _cascades(field, jcfg, field[2], "one_tier",
                                      False):
        outside = [name for name, a in got.items()
                   if (np.abs(a - want[name]) > atol * np.abs(
                       want[name]).max() + rtol * np.abs(want[name])).any()]
        assert outside, count


@pytest.mark.parametrize("count,skipped_from", [(100, 256), (300, 512)])
def test_a_skipped_segment_leaves_targets_and_no_gradient(field, count,
                                                          skipped_from):
    _, _, net, x, order, row_w, targets = field
    caps = caps_of(FRACS["two_tiers"])
    mask = _mask(order, count)
    perm, _, _ = bounded_order(torch.from_numpy(mask))
    skipped = perm[skipped_from:].numpy()
    seen = []

    def fn(p):
        seen.append(p.shape[0])
        out, g = t_sdf.full_value_and_grad(net, p)
        return out[..., :2], g

    def run(inputs):
        xt = torch.from_numpy(inputs).requires_grad_(True)
        o, g = bounded_cascade_call_into(
            fn, torch.from_numpy(mask), caps, [xt],
            [torch.from_numpy(t) for t in targets], module=net)
        grads = torch.autograd.grad(_loss(o, g, torch.from_numpy(row_w)),
                                    [xt] + list(net.parameters()))
        return [t.detach().numpy() for t in (o, g) + grads]

    clean = run(x)
    poisoned = x.copy()
    poisoned[skipped] = np.nan
    seen.clear()
    got = run(poisoned)
    # segment 0 and each later segment that runs, then each of those again
    # in its backward
    later = [e - s for s, e in zip(caps, caps[1:] + (N,)) if s < count]
    assert seen == [caps[0]] + later + later[::-1]
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)
        assert np.isfinite(a).all()
    for o, t in zip(got[:2], targets):
        np.testing.assert_array_equal(o[skipped], t[skipped])
    assert not got[2][skipped].any()


# (c): the renderer at 2 images x 512 rays, the bench tracer
B, P = 2, 512
RENDER_FRACS = dict(FRACS, overflow=(0.125,))


def _render_configs(fracs):
    common = dict(implicit_diff_min_dot=0.0, supervised_compact_frac=fracs)
    jcfg = jc.MVSDFConfig(
        model=jc.ModelConfig(implicit=j_sdf.ImplicitConfig(**STEP_ICFG),
                             render=JRender(**RCFG),
                             tracer=JTracer(**BENCH_TRACER), **common),
        train=jc.TrainConfig(batch_size=B, num_pixels=P))
    tcfg = tc.MVSDFConfig(
        model=tc.ModelConfig(implicit=t_sdf.ImplicitConfig(**STEP_ICFG),
                             render=TRender(**RCFG),
                             tracer=TTracer(**BENCH_TRACER),
                             use_pallas_trace=True, **common),
        train=tc.TrainConfig(batch_size=B, num_pixels=P))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def render_data():
    """``tests/test_torch_step.py``'s weights and draws, at 2 x 512 rays,
    with the sphere closer (focal 120) and the weights perturbed less, so
    the surface rows reach past the tiers' caps."""
    jcfg = _render_configs(())[0]
    params = jax.tree_util.tree_map(
        np.asarray, j_step_mod.init_params(jcfg, seed=0))
    rng = np.random.default_rng(1)
    params["implicit"] = [
        {k: (v + 0.02 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in p.items()} for p in params["implicit"]]
    sc = make_scene(n_images=B, n_pix=P, feat_ch=8, img_hw=96, depth_hw=24,
                    focal=120.0)
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
    return params, sc, noise


def _port_pass(tcfg, params, sc, noise, mode):
    net = _port_net(tcfg, params)
    gates = tcfg.schedule.gates_for_phase(1)
    batch = _torch(sc)
    out = t_render(tcfg.model, net, batch, training=True, gates=gates,
                   noise=_torch(noise), mode=mode)
    lt = t_total(out, batch, gates, tcfg.schedule,
                 tcfg.schedule.weights(0.3))
    grads = torch.autograd.grad(lt.loss, list(net.parameters()),
                                allow_unused=True)
    return net, out, lt, grads


@pytest.mark.parametrize("fracs", list(RENDER_FRACS))
def test_bounded_render_matches_jax_and_the_per_epoch_pass(render_data,
                                                           fracs):
    params, sc, noise = render_data
    jcfg, tcfg = _render_configs(RENDER_FRACS[fracs])
    gates = jcfg.schedule.gates_for_phase(1)
    weights = jcfg.schedule.weights(0.3)
    jnoise, jbatch = _jnp(noise), _jnp(sc)

    @jax.jit
    def j_loss(p):
        out = j_render(jcfg.model, p, jbatch, training=True, gates=gates,
                       noise=jnoise)
        lt = j_total(out, jbatch, gates, jcfg.schedule, weights)
        return lt.loss, (lt, out)

    (_, (j_lt, j_out)), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    net, out, lt, grads = _port_pass(tcfg, params, sc, noise, BOUNDED)
    _, g_out, g_lt, g_grads = _port_pass(tcfg, params, sc, noise, "gathered")

    hit = out.network_object_mask
    np.testing.assert_array_equal(hit.numpy(),
                                  np.asarray(j_out.network_object_mask))
    surface = int(out.surface_mask.sum())
    caps = caps_of(RENDER_FRACS[fracs], B * P)
    # the case's point: which tier the surface rows take (segments run)
    ran = 1 + sum(surface > c for c in caps)
    assert ran == {"one_tier": 1, "two_tiers": 2, "overflow": 2}[fracs], \
        surface
    sm = out.surface_mask.numpy()
    for name in ("rgb_values", "sdf_output", "diff_surf_pts"):
        a = getattr(out, name).detach().numpy()
        want = np.asarray(getattr(j_out, name))
        assert np.abs(a - want).max() <= 2e-3 * max(1.0, np.abs(want).max())
        per_epoch = getattr(g_out, name).detach().numpy()
        if name == "sdf_output":
            a, per_epoch = a[sm], per_epoch[sm]
        np.testing.assert_allclose(a, per_epoch, atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    for name in lt._fields:
        got = float(torch.as_tensor(getattr(lt, name)).detach())
        want = float(getattr(j_lt, name))
        assert abs(got - want) <= 1e-4 * abs(want) + 1e-7, (name, got, want)
        per_epoch = float(torch.as_tensor(getattr(g_lt, name)).detach())
        assert abs(got - per_epoch) <= 1e-6 * abs(per_epoch) + 1e-7, \
            (name, got, per_epoch)
    for (name, _), g, h in zip(net.named_parameters(), grads, g_grads):
        net_name, _, l, k = name.split(".")
        want = np.asarray(j_grads[net_name][int(l)][k])
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(g.numpy() - want).max() <= 2e-3 * scale, name
        assert np.abs(g.numpy() - h.numpy()).max() <= \
            1e-5 * max(np.abs(h.numpy()).max(), 1e-12), name
