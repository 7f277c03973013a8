"""The port's driver entry points (``mvsdf_tpu_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU.

- ``entry(device="cpu")``: the same 1,024 rays and the same seed-0
  full-width weights as JAX's ``entry()``; its three outputs against
  JAX's, with the eval-render parity tolerances the port's tests use: hit
  masks equal, rgb within 1e-5 (``tests/test_torch_export.py``), the hits'
  dists within 1e-4 + 1e-4 relative (``tests/test_torch_trace.py``). The
  misses' dists are the miss fill's, which no rgb reads: at full width its
  pick follows the 512-wide sums' rounding (6.4e-4 measured on 3 of the
  774 misses, the rest within 3.4e-6), so they are held within 1e-3.
- The dry run's two legs: their configurations equal, field by field, the
  ones ``__graft_entry__._dryrun_one`` builds (repeated below), and the
  host plan is its draws.
- The tiny leg's one-process step against JAX's one-device step of the
  same configuration, on the same batch with the same random draws (the
  ``noise=`` replay), the JAX SDF and secant kernels in interpret mode:
  every loss term within 1e-4 relative and every parameter gradient
  within 2e-3 of its tensor's largest entry (``tests/test_torch_step.py``'s
  tolerances). No optimizer steps, so both arms run here.
- ``dryrun_multichip(2, fullsize=False, device="cpu")`` passes its bounds
  (its ranks and its single process are subprocesses), and a sabotaged
  run, in which rank 1 skips its gradient sum, fails the gradient bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from mvsdf_tpu import config as jc
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.fields.sdf import ImplicitConfig as JImplicit
from mvsdf_tpu.rendering.renderer import render_forward as j_render
from mvsdf_tpu.supervision.losses import total_loss as j_total
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu.train.step import init_params as j_init_params
from mvsdf_tpu_torch import graft_entry
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.train.device_data import DeviceSceneCache
from mvsdf_tpu_torch.train.step import init_params


def jax_leg(n_devices, fullsize):
    """``__graft_entry__._dryrun_one``'s configuration (off the TPU)."""
    if fullsize:
        n_pix, batch_size = 4096, 8
        model = jc.ModelConfig(implicit=JImplicit(), render=JRender(),
                               tracer=JTracer(fill_misses=False),
                               shard_map_trace=True)
    else:
        feat, n_pix, batch_size = 16, max(8 * n_devices, 32), 2
        model = jc.ModelConfig(
            implicit=JImplicit(feature_vector_size=feat, dims=(64,) * 3,
                               skip_in=(2,), multires=6),
            render=JRender(feature_vector_size=feat, dims=(64,),
                           multires_view=4),
            tracer=JTracer(sphere_tracing_iters=5, n_steps=20,
                           n_secant_steps=4, sample_chunk=0,
                           sampler_capacity_frac=0.9, fill_capacity_frac=0.9,
                           fallback_capacity_frac=0.9, fill_misses=False),
            shard_map_trace=True, use_pallas_trace=True,
            use_pallas_secant=True, pallas_interpret=True, pallas_block=128)
    return jc.MVSDFConfig(model=model, schedule=jc.Schedule(),
                          train=jc.TrainConfig(batch_size=batch_size,
                                               num_pixels=n_pix, nepochs=12))


@pytest.fixture(scope="module")
def entries():
    jfn, jargs = jax_entry.entry()
    jout = jax.jit(jfn)(*jargs)
    fn, args = graft_entry.entry(device="cpu")
    return jargs, [np.asarray(o) for o in jout], args, fn(*args)


def test_entry_has_jax_entrys_inputs_and_weights(entries):
    jargs, _, args, _ = entries
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jargs[0]))
    assert args[0].keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(args[0][k], v, rtol=0, atol=0)
    for a, b in zip(args[1:], jargs[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert args[1].shape == (1, graft_entry.ENTRY_RAYS, 2)


def test_entry_outputs_equal_jax_entrys(entries):
    _, (j_rgb, j_mask, j_dists), _, (rgb, mask, dists) = entries
    assert rgb.shape == (1, 1024, 3) and mask.shape == dists.shape == \
        (1, 1024)
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    assert 0 < mask.float().mean() < 1
    np.testing.assert_allclose(rgb.numpy(), j_rgb, rtol=0, atol=1e-5)
    hit = mask.numpy()
    np.testing.assert_allclose(dists.numpy()[hit], j_dists[hit], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dists.numpy()[~hit], j_dists[~hit], rtol=0,
                               atol=1e-3)


def test_entry_takes_its_weights_from_params(entries):
    _, _, args, (rgb, _, _) = entries
    fn, _ = graft_entry.entry(device="cpu")
    params = {k: v * 1.01 for k, v in args[0].items()}
    other = fn(params, *args[1:])[0]
    assert not torch.equal(other, rgb)


@pytest.mark.parametrize("fullsize", [False, True])
def test_leg_configurations_equal_the_jax_dry_runs(fullsize):
    cfg, sizes = graft_entry.leg(2, fullsize)
    want = jax_leg(2, fullsize)
    got = dataclasses.asdict(cfg)
    want = dataclasses.asdict(want)
    # off the TPU the JAX dry run interprets its kernels; the port reads
    # no such field
    assert got["model"].pop("pallas_interpret") is False
    assert want["model"].pop("pallas_interpret") is (not fullsize)
    assert got == want
    assert sizes["steps"] == (1 if fullsize else 2)


def test_host_plan_is_the_jax_dry_runs_draws():
    _, sizes = graft_entry.leg(2, False)
    idx, sel = graft_entry.host_plan(sizes, 32)
    rng = np.random.default_rng(0)
    want_idx = np.stack([rng.permutation(3)[:2] for _ in range(2)])
    want_sel = np.stack([rng.permutation(32)[:32] for _ in range(2)])
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(sel, want_sel)


def test_tiny_leg_step_equals_the_jax_one_device_step():
    cfg, sizes = graft_entry.leg(1, False)
    jcfg = jax_leg(1, False)
    sc = graft_entry._scene(sizes["n_images"], sizes["n_pix"],
                            sizes["feat"], sizes["depth_hw"], sizes["img_hw"])
    idx, sel = graft_entry.host_plan(sizes, sc["uv"].shape[1])
    cache = DeviceSceneCache(graft_entry._SceneView(sc), "cpu")
    batch = cache.gather(torch.from_numpy(idx[0]), torch.from_numpy(sel[0]))
    B, P = sizes["batch_size"], sizes["n_pix"]
    rng = np.random.default_rng(3)
    n = B * P // 2
    depth_ok = np.flatnonzero(batch["depths"].numpy().reshape(-1) > 0)
    noise = {
        "minimal_steps": rng.uniform(size=20).astype(np.float32),
        "eik_points": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "dsurf_jitter_noise": rng.uniform(
            -0.1, 0.1, (batch["depths"].numel(), 3)).astype(np.float32),
        "dsurf_on_idx": rng.choice(depth_ok, n),
        "dsurf_jitter_idx": rng.choice(depth_ok, n),
    }
    params = jax.tree_util.tree_map(np.asarray, j_init_params(jcfg, seed=0))
    net = init_params(cfg, seed=0, device="cpu")
    for k, v in params_from_jax(params).items():
        assert torch.equal(net.state_dict()[k], v), k
    lt, grads = graft_entry.loss_and_grads(
        cfg, net, batch, 1, 0.3,
        noise={k: torch.from_numpy(np.asarray(v)) for k, v in noise.items()})

    gates = jcfg.schedule.gates_for_phase(1)
    weights = jcfg.schedule.weights(0.3)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jnoise = {k: jnp.asarray(v) for k, v in noise.items()}

    @jax.jit
    def j_loss(p):
        out = j_render(jcfg.model, p, jbatch, training=True, gates=gates,
                       noise=jnoise)
        terms = j_total(out, jbatch, gates, jcfg.schedule, weights)
        return terms.loss, terms

    (_, j_lt), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    assert float(j_lt.feat_loss) > 0 and float(j_lt.surf_loss) > 0
    for name in lt._fields:
        want = float(getattr(j_lt, name))
        got = float(torch.as_tensor(getattr(lt, name)).detach())
        assert abs(got - want) <= 1e-4 * abs(want) + 1e-7, (name, got, want)
    for (name, _), g in zip(net.named_parameters(), grads):
        net_name, _, l, k = name.split(".")
        want = np.asarray(j_grads[net_name][int(l)][k])
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(g.numpy() - want).max() <= 2e-3 * scale, name


def test_dryrun_multichip_passes_on_two_gloo_ranks(capsys):
    (res,) = graft_entry.dryrun_multichip(2, fullsize=False, device="cpu")
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip(2, fullsize=False): loss=")
    assert "2 gloo ranks" in line and "max|dgrad|rel=" in line
    assert res["backend"] == "gloo" and np.isfinite(res["loss"])
    assert res["d_grad_rel"] <= graft_entry.GRAD_RTOL
    assert res["d_loss"] <= graft_entry.LOSS_TOL


def test_a_rank_that_skips_its_sum_fails_the_gradient_bound():
    with pytest.raises(AssertionError, match="gradients diverge"):
        graft_entry._dryrun_one(2, False, device="cpu", skip_sum_rank=1)
