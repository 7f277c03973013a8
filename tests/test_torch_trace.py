"""``trace_rays`` of the port against the JAX package's on the CPU: 1024
rays (2 images x 512), so that the JAX side's compaction tiers survive
``_normalize_caps`` and its compact branches run; half the object mask off,
so every miss-handling branch has rays. The SDF is the small field with
weights perturbed until some rays end the march unfinished; the port
traces through the fused SDF-MLP wrapper (its plain version on the CPU),
the JAX side through ``sdf_apply``.

Held: network_object_mask, sampler_mask and mask_intersect equal; dists
and points within 1e-4 absolute + 1e-4 relative: f32 sums in another
order move an SDF value by ~1e-7, and the secant divides by an SDF
difference, so a root on a steep, perturbed field moves by up to ~1e-4 at
distances ~3.4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu.geometry.cameras import get_camera_params
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu.tracing.sphere_trace import trace_rays as j_trace
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.embedder import positional_encoding
from mvsdf_tpu_torch.tracing.kernels.sdf_mlp import pack_sdf_weights, sdf_mlp
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer
from mvsdf_tpu_torch.tracing.sphere_trace import trace_rays as t_trace

ICFG = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
SCHED = ((0, (0.375, 0.5)), (1, (0.1875, 0.25)), (5, (0.0625, 0.125, 0.25)))
CASES = {
    "eval": (False, dict(sampler_capacity_frac=0.25)),
    "train_fill": (True, dict(sampler_capacity_frac=0.25,
                              fill_capacity_frac=(0.25, 0.5))),
    "train_nofill": (True, dict(fill_misses=False)),
    "train_unified_fill": (True, dict(fallback_capacity_frac=(0.25, 0.5),
                                      march_compact_schedule=SCHED)),
    "train_unified_nofill": (True, dict(
        fill_misses=False, fallback_capacity_frac=(0.0625, 0.09375, 0.375),
        march_compact_schedule=SCHED)),
}


@pytest.fixture(scope="module")
def setup():
    jcfg = j_sdf.ImplicitConfig(**ICFG)
    params = jax.tree_util.tree_map(
        np.asarray, j_sdf.init_implicit(jcfg, np.random.default_rng(0)))
    rng = np.random.default_rng(1)
    params = [{k: (v + 1.0 * rng.normal(size=v.shape)).astype(np.float32)
               for k, v in p.items()} for p in params]
    net = t_sdf.ImplicitNetwork(t_sdf.ImplicitConfig(**ICFG))
    state = params_from_jax({"implicit": params, "render": []})
    net.load_state_dict({k[len("implicit."):]: v for k, v in state.items()})
    sc = make_scene(n_images=2, n_pix=512, feat_ch=4, img_hw=96,
                    depth_hw=24)
    dirs, loc = get_camera_params(jnp.asarray(sc["uv"]),
                                  jnp.asarray(sc["pose"]),
                                  jnp.asarray(sc["intrinsics"]))
    dirs = np.array(dirs)
    org = np.broadcast_to(np.asarray(loc)[:, None], dirs.shape).copy()
    mask = rng.uniform(size=dirs.shape[:2]) < 0.5
    steps = rng.uniform(size=100).astype(np.float32)
    jparams = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    return jcfg, jparams, net, org, dirs, mask, steps


@pytest.mark.parametrize("case", list(CASES))
def test_trace_parity(setup, case):
    jcfg, jparams, net, org, dirs, mask, steps = setup
    training, kw = CASES[case]
    jt = dataclasses.replace(JTracer(), **kw)
    tt = dataclasses.replace(TTracer(), **kw)

    @jax.jit
    def run_jax(o, d, m, s):
        return j_trace(jt, lambda x: j_sdf.sdf_apply(jcfg, jparams, x), o, d,
                       m, training=training, minimal_steps=s)

    want = run_jax(jnp.asarray(org), jnp.asarray(dirs), jnp.asarray(mask),
                   jnp.asarray(steps))
    packed = pack_sdf_weights(net)

    def sdf_fn(x):
        pe = positional_encoding(x.reshape(-1, 3), 6)
        return sdf_mlp(packed, pe).reshape(x.shape[:-1])

    got = t_trace(tt, sdf_fn, torch.from_numpy(org), torch.from_numpy(dirs),
                  torch.from_numpy(mask), training=training,
                  minimal_steps=torch.from_numpy(steps))
    for name in ("network_object_mask", "sampler_mask", "mask_intersect"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    # every branch of the trace has rays in this fixture
    assert got.sampler_mask.any() and got.network_object_mask.any()
    assert (~got.mask_intersect).any()
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=1e-4, rtol=1e-4)


def test_compact_call_into_matches_jax():
    """Gathered rows only; out_masks merge each output into its own rows;
    rows outside the mask keep their targets; gradients flow through."""
    from mvsdf_tpu.compaction import compact_call_into as j_cci
    from mvsdf_tpu_torch.compaction import compact_call_into as t_cci
    rng = np.random.default_rng(0)
    R = 1024
    x = rng.normal(size=(R, 3)).astype(np.float32)
    mask = rng.uniform(size=R) < 0.3
    sub = mask & (rng.uniform(size=R) < 0.5)
    tgt = [rng.normal(size=(R, 3)).astype(np.float32),
           rng.normal(size=R).astype(np.float32)]
    j_fn = lambda a: (a * 2.0, jnp.sum(a, -1))
    want = j_cci(j_fn, jnp.asarray(mask), (256, 512), [jnp.asarray(x)],
                 [jnp.asarray(t) for t in tgt],
                 out_masks=[jnp.asarray(mask), jnp.asarray(sub)])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = t_cci(lambda a: (a * 2.0, a.sum(-1)), torch.from_numpy(mask), [xt],
                [torch.from_numpy(t) for t in tgt],
                out_masks=[torch.from_numpy(mask), torch.from_numpy(sub)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    (gx,) = torch.autograd.grad(got[0].sum() + got[1].sum(), xt)
    expect = 2.0 * mask[:, None] + 1.0 * sub[:, None]
    np.testing.assert_array_equal(gx.numpy(), np.broadcast_to(
        expect, (R, 3)).astype(np.float32))
    empty = t_cci(lambda a: (a,), torch.zeros(R, dtype=torch.bool),
                  [xt], [torch.from_numpy(tgt[0])])
    assert empty[0] is not None and torch.equal(empty[0],
                                                torch.from_numpy(tgt[0]))
