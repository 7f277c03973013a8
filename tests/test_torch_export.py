"""The port's serving export (``mvsdf_tpu_torch/eval/export.py``) and the
static trace it captures, on the CPU at small width.

- The static formulation of ``trace_rays`` (fixed iteration counts, masks
  in place of gathers) against the gathered trace, per ray, on 1024 rays
  of a perturbed field in every configuration ``tests/test_torch_trace.py``
  holds to the JAX package: masks equal, dists and points within 1e-6
  absolute + 1e-6 relative (the same arithmetic a ray; only the rows
  beside it in a matmul differ).
- The export round trip (export, save to a file, load, call), as
  ``tests/unit/test_export.py`` does it for the JAX package: the artifact
  equals the live ``make_render_fn`` within 1e-6 for the weights it was
  traced with and for a second seed's, which it tells apart.
- The loaded artifact against the JAX package's ``make_render_fn`` on the
  same weights (``convert.params_from_jax``): hit masks equal, rgb within
  1e-5 (measured 1.4e-7; the trace's f32 sums in another order).
- The CLI writes a loadable artifact with ``--platform cpu``, and without
  it raises here (no GPU), as the loader does.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu import config as jc
from mvsdf_tpu.eval.export import make_render_fn as j_make_render_fn
from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.geometry.cameras import get_camera_params
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu.train.step import init_params as j_init_params
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.eval import export
from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer
from mvsdf_tpu_torch.tracing.sphere_trace import trace_rays
from mvsdf_tpu_torch.train.step import init_params

CHUNK = 64
TINY = dict(
    implicit=dict(feature_vector_size=16, dims=(64,) * 3, skip_in=(2,),
                  multires=6),
    render=dict(feature_vector_size=16, dims=(64,), multires_view=4),
    tracer=dict(sphere_tracing_iters=4, n_steps=16, n_secant_steps=3,
                sample_chunk=0))
CONF = """
model{
    feature_vector_size = 16
    implicit_network {
        dims = [64, 64, 64]
        skip_in = [2]
        multires = 6
    }
    rendering_network {
        mode = idr
        dims = [64]
        multires_view = 4
    }
}
"""
SCHED = ((0, (0.375, 0.5)), (1, (0.1875, 0.25)), (5, (0.0625, 0.125, 0.25)))
TRACE_CASES = {
    "eval": (False, dict(sampler_capacity_frac=0.25)),
    "eval_march_compact": (False, dict(march_compact_schedule=SCHED)),
    "train_fill": (True, dict(sampler_capacity_frac=0.25,
                              fill_capacity_frac=(0.25, 0.5))),
    "train_nofill": (True, dict(fill_misses=False)),
    "train_unified_fill": (True, dict(fallback_capacity_frac=(0.25, 0.5),
                                      march_compact_schedule=SCHED)),
    "train_unified_nofill": (True, dict(
        fill_misses=False, fallback_capacity_frac=(0.0625, 0.09375, 0.375),
        march_compact_schedule=SCHED)),
}


def _tiny(module):
    """The tiny architecture in the JAX package (module jc) or the
    port's."""
    if module is jc:
        imp, ren, tr = j_sdf.ImplicitConfig, JRender, JTracer
    else:
        imp, ren, tr = t_sdf.ImplicitConfig, TRender, TTracer
    return module.MVSDFConfig(model=module.ModelConfig(
        implicit=imp(**TINY["implicit"]), render=ren(**TINY["render"]),
        tracer=tr(**TINY["tracer"])))


def _inputs():
    sc = make_scene(n_images=1, n_pix=CHUNK, feat_ch=16, depth_hw=16,
                    img_hw=32)
    return (sc["uv"].astype(np.float32), sc["intrinsics"].astype(np.float32),
            sc["pose"].astype(np.float32), sc["object_mask"].astype(bool))


def _torch(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.fixture(scope="module")
def traced():
    """A perturbed field that leaves some rays unfinished, and 1024 rays
    with half the object mask off (as tests/test_torch_trace.py)."""
    icfg = t_sdf.ImplicitConfig(feature_vector_size=16, dims=(64,) * 4,
                                skip_in=(2,))
    net = t_sdf.init_implicit(icfg, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    sc = make_scene(n_images=2, n_pix=512, feat_ch=4, img_hw=96,
                    depth_hw=24)
    dirs, loc = get_camera_params(jnp.asarray(sc["uv"]),
                                  jnp.asarray(sc["pose"]),
                                  jnp.asarray(sc["intrinsics"]))
    dirs = torch.from_numpy(np.array(dirs))
    org = torch.from_numpy(np.broadcast_to(np.asarray(loc)[:, None],
                                           dirs.shape).copy())
    mask = torch.from_numpy(rng.uniform(size=dirs.shape[:2]) < 0.5)
    steps = torch.from_numpy(rng.uniform(size=100).astype(np.float32))
    return net, org, dirs, mask, steps


@pytest.fixture(scope="module")
def artifact():
    """The tiny architecture's renderer, exported once from seed-0 weights
    (an artifact serves every checkpoint of its architecture)."""
    cfg = _tiny(tc)
    params = init_params(cfg, seed=0, device="cpu").state_dict()
    return export.export_renderer(cfg, params, chunk=CHUNK,
                                  platforms=("cpu",), device="cpu")


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_static_trace_equals_the_gathered_trace_per_ray(traced, case):
    net, org, dirs, mask, steps = traced
    training, kw = TRACE_CASES[case]
    cfg = dataclasses.replace(TTracer(), **kw)
    sdf = lambda x: t_sdf.sdf_apply(net, x)
    out = [trace_rays(cfg, sdf, org, dirs, mask, training=training,
                      minimal_steps=steps, mode=mode)
           for mode in ("gathered", "static")]
    gathered, static = out
    unfinished = gathered.sampler_mask.float().mean().item()
    hits = gathered.network_object_mask.float().mean().item()
    assert 0.01 < unfinished < 0.99 and 0.05 < hits < 0.95
    for name in ("network_object_mask", "sampler_mask", "mask_intersect"):
        assert torch.equal(getattr(gathered, name), getattr(static, name)), \
            name
    for name in ("dists", "points"):
        a, b = getattr(gathered, name), getattr(static, name)
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


def test_export_round_trip_serves_every_checkpoint(artifact, tmp_path):
    cfg = _tiny(tc)
    params_a = init_params(cfg, seed=0, device="cpu").state_dict()
    params_b = init_params(cfg, seed=7, device="cpu").state_dict()
    path = tmp_path / "renderer.pt2"
    path.write_bytes(artifact)
    served = export.load_renderer(str(path), device="cpu")
    live = export.make_render_fn(cfg)
    args = _torch(_inputs())
    for params in (params_a, params_b):
        with torch.no_grad():
            got, want = served(params, *args), live(params, *args)
        assert got.shape == (1, CHUNK, 3)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with torch.no_grad():
        a, b = served(params_a, *args), served(params_b, *args)
    assert not torch.allclose(a, b)
    # the bytes load as well as the file
    with torch.no_grad():
        torch.testing.assert_close(
            export.load_renderer(artifact, device="cpu")(params_a, *args), a,
            rtol=0, atol=0)


def test_the_artifact_matches_the_jax_export_function(artifact):
    jcfg = _tiny(jc)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     j_init_params(jcfg, seed=3))
    params = params_from_jax(jparams)
    served = export.load_renderer(artifact, device="cpu")
    inputs = _inputs()
    with torch.no_grad():
        got = served(params, *_torch(inputs)).numpy()
    want = np.asarray(jax.jit(j_make_render_fn(jcfg))(
        jparams, *[jnp.asarray(a) for a in inputs]))
    hit = np.abs(want - 1.0).max(-1) > 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(np.abs(got - 1.0).max(-1) > 0, hit)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_the_cli_writes_a_loadable_artifact(tmp_path, capsys):
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF)
    out = tmp_path / "r.pt2"
    export.main(["--out", str(out), "--conf", str(conf), "--chunk", "32",
                 "--platforms", "cpu", "--platform", "cpu"])
    assert "exported renderer" in capsys.readouterr().out
    fn = export.load_renderer(str(out), device="cpu")
    uv, intr, pose, mask = _torch(_inputs())
    from mvsdf_tpu_torch.hocon import config_from_hocon
    params = init_params(config_from_hocon(str(conf)), seed=0,
                         device="cpu").state_dict()
    with torch.no_grad():
        rgb = fn(params, uv[:, :32], intr, pose, mask[:, :32])
    assert rgb.shape == (1, 32, 3) and torch.isfinite(rgb).all()


def test_without_a_gpu_the_export_and_the_loader_raise(artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = _tiny(tc)
    params = init_params(cfg, seed=0, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main(["--out", str(tmp_path / "r.pt2")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export_renderer(cfg, params, chunk=16, platforms=("cpu",))
    # checking the artifact on a device that is not there
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export_renderer(cfg, params, chunk=16,
                               platforms=("cpu", "cuda"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_renderer(artifact)
    assert not os.path.exists(tmp_path / "r.pt2")
