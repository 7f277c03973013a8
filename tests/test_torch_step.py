"""The port's training path against the JAX package's on the CPU, small
width, 2 images x 256 rays, identical weights and identical random draws
(the ``noise=`` replay of render_forward), implicit_diff_min_dot = 0.

- render_forward + total_loss in phase A (dsurf groups, geometry detached
  for the rgb) and phase B (the bench configuration: kernel-path trace,
  unified fallback, no miss fill, supervised compaction), and phase B in
  the fused-trace configuration (the fused march and secant kernels and the
  in-kernel positional encoding; the JAX side runs its Pallas kernels in
  interpret mode): every loss term within 1e-4 relative and every
  parameter gradient within 2e-3 of its tensor's largest entry (f32 sums in
  another order, amplified by the implicit-diff division and the trace's
  secant).
- Two Adam steps: the port's run in a subprocess (a torch optimizer step
  changes XLA:CPU results for the rest of its process), compared through
  npz files with the JAX package's ``make_train_step``.
"""
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
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.fields.sdf import ImplicitConfig as JImplicit
from mvsdf_tpu.rendering.renderer import render_forward as j_render
from mvsdf_tpu.supervision.losses import total_loss as j_total
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.fields.network import MVSDFNetwork
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig as TImplicit
from mvsdf_tpu_torch.rendering.renderer import render_forward as t_render
from mvsdf_tpu_torch.supervision.losses import total_loss as t_total
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P = 2, 256
ICFG = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
RCFG = dict(feature_vector_size=16, dims=(64,) * 2)
BENCH_TRACER = dict(
    fill_misses=False, sampler_capacity_frac=0.25, fill_capacity_frac=0.5,
    fallback_capacity_frac=(0.0625, 0.09375, 0.375),
    march_compact_schedule=((0, (0.375, 0.5)), (1, (0.1875, 0.25)),
                            (5, (0.0625, 0.125, 0.25))))
FUSED = dict(use_pallas_trace=True, use_pallas_march=True,
             use_pallas_secant=True, pallas_in_kernel_pe=True)
# case -> (phase, tracer kw, model kw for both sides, port-only model kw,
#          JAX-only model kw)
CASES = {
    "phaseA": (0, {}, {}, {}, {}),
    "phaseB_bench": (1, BENCH_TRACER, dict(supervised_compact_frac=(0.375,)),
                     dict(use_pallas_trace=True), {}),
    "phaseB_fused": (1, BENCH_TRACER,
                     dict(supervised_compact_frac=(0.375,), **FUSED), {},
                     dict(pallas_interpret=True)),
}


def _configs(case):
    phase, tr, model, port_only, jax_only = CASES[case]
    common = dict(implicit_diff_min_dot=0.0, **model)
    jcfg = jc.MVSDFConfig(
        model=jc.ModelConfig(implicit=JImplicit(**ICFG),
                             render=JRender(**RCFG), tracer=JTracer(**tr),
                             **common, **jax_only),
        train=jc.TrainConfig(batch_size=B, num_pixels=P))
    tcfg = tc.MVSDFConfig(
        model=tc.ModelConfig(implicit=TImplicit(**ICFG),
                             render=TRender(**RCFG), tracer=TTracer(**tr),
                             **common, **port_only),
        train=tc.TrainConfig(batch_size=B, num_pixels=P))
    return phase, jcfg, tcfg


@pytest.fixture(scope="module")
def data():
    """Weights (perturbed so the field has surface hits and unfinished
    rays), the scene and every random draw, as numpy."""
    jcfg = _configs("phaseA")[1]
    params = jax.tree_util.tree_map(
        np.asarray, j_step_mod.init_params(jcfg, seed=0))
    rng = np.random.default_rng(1)
    params["implicit"] = [
        {k: (v + 0.5 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in p.items()} for p in params["implicit"]]
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
    return params, sc, noise


def _port_net(tcfg, params):
    net = MVSDFNetwork(tcfg.model.implicit, tcfg.model.render)
    net.load_state_dict(params_from_jax(params))
    return net


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_render_loss_and_gradients(data, case):
    params, sc, noise = data
    phase, jcfg, tcfg = _configs(case)
    gates = jcfg.schedule.gates_for_phase(phase)
    weights = jcfg.schedule.weights([0.05, 0.3][phase])
    jnoise, jbatch = _jnp(noise), _jnp(sc)

    @jax.jit
    def j_loss(p):
        out = j_render(jcfg.model, p, jbatch, training=True, gates=gates,
                       noise=jnoise)
        lt = j_total(out, jbatch, gates, jcfg.schedule, weights)
        return lt.loss, (lt, out.network_object_mask)

    (_, (j_lt, j_hit)), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))

    net = _port_net(tcfg, params)
    tbatch = _torch(sc)
    out = t_render(tcfg.model, net, tbatch, training=True,
                   gates=tcfg.schedule.gates_for_phase(phase),
                   noise=_torch(noise))
    t_lt = t_total(out, tbatch, tcfg.schedule.gates_for_phase(phase),
                   tcfg.schedule, tcfg.schedule.weights([0.05, 0.3][phase]))
    grads = torch.autograd.grad(t_lt.loss, list(net.parameters()),
                                allow_unused=True)

    np.testing.assert_array_equal(out.network_object_mask.numpy(),
                                  np.asarray(j_hit))
    hit = out.network_object_mask.float().mean().item()
    assert 0.05 < hit < 0.95
    for name in t_lt._fields:
        want = float(getattr(j_lt, name))
        got = float(torch.as_tensor(getattr(t_lt, name)).detach())
        assert abs(got - want) <= 1e-4 * abs(want) + 1e-7, (name, got, want)
    if phase == 0:
        assert float(j_lt.feat_loss) == 0.0 and float(j_lt.surf_loss) == 0.0
    else:
        assert float(j_lt.feat_loss) > 0 and float(j_lt.surf_loss) > 0
    for (name, _), g in zip(net.named_parameters(), grads):
        net_name, _, l, k = name.split(".")
        want = np.asarray(j_grads[net_name][int(l)][k])
        got = np.zeros_like(want) if g is None else g.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= 2e-3 * scale, name


PORT_ARM = r"""
import pickle, sys
import numpy as np, torch
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.train.step import init_train_state, make_train_step

cfg, params, scene, noise = pickle.load(open(sys.argv[1], "rb"))
state = init_train_state(cfg, seed=0, device="cpu")
state.net.load_state_dict(params_from_jax(params))
step = make_train_step(cfg, phase_idx=1)
t = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
losses = []
for _ in range(2):
    m = step(state, t(scene), cfg.schedule.weights(0.3), noise=t(noise))
    losses.append([float(m["loss"]), float(m["grad_norm"])])
out = {"losses": np.asarray(losses)}
for k, v in state.net.state_dict().items():
    out[k] = v.numpy()
np.savez(sys.argv[2], **out)
"""


def test_two_adam_steps_match(data, tmp_path, monkeypatch):
    params, sc, noise = data
    _, jcfg, tcfg = _configs("phaseB_bench")
    lr = jcfg.train.learning_rate * B

    # the port's arm, in its own process
    inp, outp = tmp_path / "in.pkl", tmp_path / "out.npz"
    with open(inp, "wb") as f:
        pickle.dump((tcfg, params, sc, noise), f)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", PORT_ARM, str(inp),
                          str(outp)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    port = np.load(outp)

    # the JAX package's arm: its own make_train_step, with render_forward
    # replaying the same draws
    monkeypatch.setattr(j_step_mod, "render_forward", functools.partial(
        j_step_mod.render_forward, noise=_jnp(noise)))
    state = j_step_mod.init_train_state(jcfg, seed=0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    adam, _ = j_step_mod.make_optimizer(jcfg)
    state = state._replace(params=jp, opt_state=adam.init(jp))
    step = j_step_mod.make_train_step(jcfg, phase_idx=1, donate=False)
    w = j_step_mod.weights_to_array(jcfg.schedule.weights(0.3))
    losses = []
    for _ in range(2):
        state, m = step(state, _jnp(sc), w, jax.random.PRNGKey(0))
        losses.append([float(m["loss"]), float(m["grad_norm"])])

    np.testing.assert_allclose(port["losses"], np.asarray(losses),
                               rtol=1e-4)
    # Adam's first steps move each entry by ~lr * sign(grad); an entry whose
    # gradient is at rounding level can take either sign, so entries are
    # held to lr / 2 and the bulk to 1e-6
    moved = 0
    for net_name in ("implicit", "render"):
        for l, layer in enumerate(state.params[net_name]):
            for k, v in layer.items():
                want = np.asarray(v)
                got = port[f"{net_name}.layers.{l}.{k}"]
                diff = np.abs(got - want)
                assert diff.max() <= lr / 2, (net_name, l, k, diff.max())
                assert np.median(diff) <= 1e-6, (net_name, l, k)
                moved += np.abs(want - params[net_name][l][k]).max() > lr
    assert moved > 0
