"""The compaction and trace that a CUDA graph captures, on the CPU.

- ``bounded_call_into`` against ``compact_call_into`` (equal bits) and
  against the JAX package's ``compact_call_into`` with a capacity cascade
  that overflows into its dense branch: random masks, none set, all set.
- The kernels' count entries: each plain version equals the plain kernel
  on the first ``count`` rows and is 0 past them, at count 0, a partial
  count and the full capacity; on CPU tensors the wrappers run them and
  count no launch.
- ``trace_rays(mode="bounded")`` against the JAX package's ``trace_rays`` at
  1,024 rays (2 images x 512, so the JAX side's tiers survive and its
  compact branches run), training mode, the compaction cascades the
  training CLI sets, at ``tests/test_torch_trace.py``'s tolerance (1e-4
  absolute + relative on dists and points: f32 sums in another order, and
  a secant that divides by an SDF difference); and against the port's own
  gathered trace, to the bit (the same per-row arithmetic on the CPU).
- ``bounded_rows``: the tiles that start below the count get ``fn``'s
  rows, each with its rows below the count, and the others keep what they
  held, at counts on, below and above tile edges.
- The renderer's bounded pass (its count-entry closures, the fused
  kernels' flags, the plain field; its torch work in one tile and in
  many) against the gathered pass, to the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu.compaction import compact_call_into as j_cci
from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu.tracing.sphere_trace import trace_rays as j_trace
from mvsdf_tpu_torch import compaction
from mvsdf_tpu_torch.compaction import (bounded_call_into, bounded_order,
                                        bounded_rows, compact_call_into)
from mvsdf_tpu_torch.fields.embedder import positional_encoding
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig, init_implicit
from mvsdf_tpu_torch.tracing.kernels import counts
from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
from mvsdf_tpu_torch.tracing.kernels import secant_kernel as S
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer
from mvsdf_tpu_torch.tracing.sphere_trace import trace_rays as t_trace

from tests.test_torch_trace import CASES, setup  # noqa: F401 (fixture)

R = 1024
MASKS = {"random": lambda rng: rng.uniform(size=R) < 0.3,
         "none": lambda rng: np.zeros(R, bool),
         "all": lambda rng: np.ones(R, bool)}


@pytest.mark.parametrize("kind", list(MASKS))
def test_bounded_call_into_matches_gathered_and_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(R, 3)).astype(np.float32)
    mask = MASKS[kind](rng)
    sub = mask & (rng.uniform(size=R) < 0.5)
    tgt = [rng.normal(size=(R, 3)).astype(np.float32),
           rng.normal(size=R).astype(np.float32)]
    # a cascade whose tiers the random and full masks overflow
    want = j_cci(lambda a: (a * 2.0, jnp.sum(a, -1)), jnp.asarray(mask),
                 (64, 128), [jnp.asarray(x)], [jnp.asarray(t) for t in tgt],
                 out_masks=[jnp.asarray(mask), jnp.asarray(sub)])
    seen = []

    def fn(count, a):
        seen.append((int(count), a.shape[0]))
        return a * 2.0, a.sum(-1)

    xt = torch.from_numpy(x).requires_grad_(True)
    m, s = torch.from_numpy(mask), torch.from_numpy(sub)
    got = bounded_call_into(fn, m, [xt], [torch.from_numpy(t) for t in tgt],
                            out_masks=[m, s])
    gathered = compact_call_into(lambda a: (a * 2.0, a.sum(-1)), m, [xt],
                                 [torch.from_numpy(t) for t in tgt],
                                 out_masks=[m, s])
    assert seen == [(int(mask.sum()), R)]
    for g, h, w in zip(got, gathered, want):
        assert torch.equal(g, h)
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    (gx,) = torch.autograd.grad(got[0].sum() + got[1].sum(), xt)
    expect = 2.0 * mask[:, None] + 1.0 * sub[:, None]
    np.testing.assert_array_equal(gx.numpy(), np.broadcast_to(
        expect, (R, 3)).astype(np.float32))


def test_bounded_order_is_a_stable_permutation():
    mask = torch.from_numpy(np.random.default_rng(1).uniform(size=(4, 77))
                            < 0.4)
    perm, pos, count = bounded_order(mask)
    flat = mask.reshape(-1)
    assert count.dtype == torch.int32 and int(count) == int(flat.sum())
    act = flat.nonzero().squeeze(-1)
    rest = (~flat).nonzero().squeeze(-1)
    assert torch.equal(perm, torch.cat([act, rest]))
    assert torch.equal(perm[pos], torch.arange(flat.numel()))


@pytest.fixture(scope="module")
def packed():
    net = init_implicit(ImplicitConfig(feature_vector_size=16,
                                       dims=(64,) * 4, skip_in=(2,)),
                        np.random.default_rng(0))
    with torch.no_grad():
        return K.pack_sdf_weights(net)


@pytest.mark.parametrize("count", [0, 37, 200])
def test_count_entries_compute_the_first_rows(packed, count):
    n = 200
    g = torch.Generator().manual_seed(0)
    x = torch.rand((n, 3), generator=g) * 2 - 1
    pe = positional_encoding(x, 6)
    c = torch.tensor(count, dtype=torch.int32)
    d = torch.nn.functional.normalize(torch.rand((n, 3), generator=g) - 0.5,
                                      dim=-1)
    o = -2.0 * d
    z_lo, z_hi = torch.full((n,), 1.2), torch.full((n,), 2.8)
    s_lo = K.sdf_mlp_xyz_reference(packed, 6, o + z_lo[:, None] * d)
    s_hi = K.sdf_mlp_xyz_reference(packed, 6, o + z_hi[:, None] * d)
    sec = (o, d, z_lo, z_hi, s_lo, s_hi)
    before = counts.snapshot()
    first = lambda *a: [t[:count] for t in a]
    cases = (
        (K.sdf_mlp_count(packed, pe, c),
         K.sdf_mlp_reference(packed, *first(pe))),
        (K.sdf_mlp_xyz_count(packed, 6, x, c),
         K.sdf_mlp_xyz_reference(packed, 6, *first(x))),
        (S.secant_count(packed, 6, 8, *sec, c),
         S.secant_reference(packed, 6, 8, *first(*sec))))
    assert counts.since(before) == {k: 0 for k in before}
    for got, plain in cases:
        assert got.shape == (n,)
        assert torch.equal(got[:count], plain)
        assert not got[count:].any()


def _sdf_fns(net):
    packed = K.pack_sdf_weights(net)

    def gathered(x):
        pe = positional_encoding(x.reshape(-1, 3), 6)
        return K.sdf_mlp(packed, pe).reshape(x.shape[:-1])

    def bounded(x, count):
        return K.sdf_mlp_count(packed, positional_encoding(x, 6), count)

    return gathered, bounded


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0]])
def test_bounded_trace_matches_jax_and_the_gathered_trace(setup, case):
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
    gathered, bounded = _sdf_fns(net)
    args = (torch.from_numpy(org), torch.from_numpy(dirs),
            torch.from_numpy(mask))
    got = t_trace(tt, bounded, *args, training=training,
                  minimal_steps=torch.from_numpy(steps), mode="bounded")
    ref = t_trace(tt, gathered, *args, training=training,
                  minimal_steps=torch.from_numpy(steps))
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in ("network_object_mask", "sampler_mask", "mask_intersect"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.sampler_mask.any() and got.network_object_mask.any()
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=1e-4, rtol=1e-4)


def test_static_and_bounded_are_exclusive(setup):
    """A trace takes one mode: anything but MODES raises."""
    _, _, net, org, dirs, mask, steps = setup
    _, bounded = _sdf_fns(net)
    with pytest.raises(ValueError, match="takes a mode of"):
        t_trace(TTracer(), bounded, torch.from_numpy(org),
                torch.from_numpy(dirs), torch.from_numpy(mask),
                training=False, mode="static+bounded")


@pytest.mark.parametrize("count", [0, 1, 63, 64, 65, 150, 200])
def test_bounded_rows_runs_the_tiles_below_the_count(count):
    n, tile = 200, 64
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    seen = []

    def fn(a, c):
        seen.append(int(c))
        return a.sum(-1)

    out = bounded_rows(fn, x, torch.tensor(count, dtype=torch.int32),
                       torch.full((n,), -1.0), tile=tile)
    live = min(-(-count // tile) * tile, n)
    assert torch.equal(out[:live], x[:live].sum(-1))
    assert (out[live:] == -1).all()
    assert seen == [min(tile, count - s) for s in range(0, live, tile)]


@pytest.mark.parametrize("flags,tile", [
    (dict(), None), (dict(use_pallas_secant=True, pallas_in_kernel_pe=True),
                     None),
    (dict(use_pallas_trace=False), None), (dict(use_pallas_trace=False), 64),
    (dict(), 64)],
    ids=["sdf_mlp", "secant_inkpe", "plain", "plain_tiles", "sdf_mlp_tiles"])
def test_renderer_bounded_trace_matches_gathered(setup, flags, tile,
                                                 monkeypatch):
    """``_frozen_trace(mode="bounded")``: the count entries of the SDF-MLP
    (with and without the PE in the kernel) and of the secant, and the
    plain field, give the gathered trace's bits, with the torch work of a
    block (the plain field, the PE) in one tile or in tiles of 64 rows."""
    from mvsdf_tpu_torch.config import ModelConfig
    from mvsdf_tpu_torch.fields.network import MVSDFNetwork
    from mvsdf_tpu_torch.fields.radiance import RenderConfig
    from mvsdf_tpu_torch.rendering.renderer import _frozen_trace
    _, _, implicit, org, dirs, mask, steps = setup
    tracer = dataclasses.replace(TTracer(), **CASES["train_unified_nofill"][1])
    if tile is not None:
        monkeypatch.setattr(compaction, "TILE_ROWS", tile)
        monkeypatch.setattr(compaction, "MAX_TILES", 1 << 20)
    cfg = ModelConfig(implicit=implicit.cfg, tracer=tracer,
                      **dict(dict(use_pallas_trace=True), **flags))
    net = MVSDFNetwork(implicit.cfg, RenderConfig(feature_vector_size=16,
                                                  dims=(64,)))
    net.implicit = implicit
    args = (cfg, net, torch.from_numpy(org), torch.from_numpy(dirs),
            torch.from_numpy(mask), True, torch.from_numpy(steps))
    got = _frozen_trace(*args, mode="bounded")
    ref = _frozen_trace(*args)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
