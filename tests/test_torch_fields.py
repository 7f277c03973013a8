"""Parity of the port's fields (embedder, weight-norm linear, implicit SDF
field, radiance field) with the JAX package on the CPU, at a small width:
dims (64,)*4 with the skip at layer 2, 16 feature lanes. Same numpy inputs
and the same weights (through convert.params_from_jax) on both sides.

Tolerances: f32 forward 2e-5 absolute on outputs of order 1; gradients 1e-4
relative to each tensor's largest entry (f32 sums in another order on each
side). The bf16-activation mode rounds activations to bf16 (8 bits of
mantissa) on both sides at the same points; an accumulation-order
difference can move a value across a bf16 rounding boundary, so it is held
to 2e-2 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvsdf_tpu.fields import embedder as j_emb
from mvsdf_tpu.fields import mlp as j_mlp
from mvsdf_tpu.fields import radiance as j_rad
from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.fields import embedder as t_emb
from mvsdf_tpu_torch.fields import radiance as t_rad
from mvsdf_tpu_torch.fields import sdf as t_sdf

ICFG = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
RCFG = dict(feature_vector_size=16, dims=(64,) * 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _implicit_pair(bf16=False, seed=0, perturb=0.05):
    """JAX params and the port's network with identical weights; the
    geometric init is perturbed so no layer is trivially structured."""
    jcfg = j_sdf.ImplicitConfig(bf16_activations=bf16, **ICFG)
    params = _np(j_sdf.init_implicit(jcfg, np.random.default_rng(seed)))
    rng = np.random.default_rng(seed + 100)
    params = [{k: (v + perturb * rng.normal(size=v.shape)).astype(
        np.float32) for k, v in layer.items()} for layer in params]
    tcfg = t_sdf.ImplicitConfig(bf16_activations=bf16, **ICFG)
    net = t_sdf.ImplicitNetwork(tcfg)
    state = params_from_jax({"implicit": params, "render": []})
    net.load_state_dict({k[len("implicit."):]: v for k, v in state.items()})
    return jcfg, [jax.tree_util.tree_map(jnp.asarray, p) for p in params], \
        net


def _points(n=300, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(
        np.float32)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-12)


def test_positional_encoding_parity():
    x = _points()
    for multires in (0, 4, 6):
        np.testing.assert_allclose(
            t_emb.positional_encoding(torch.from_numpy(x), multires).numpy(),
            np.asarray(j_emb.positional_encoding(jnp.asarray(x), multires)),
            atol=1e-6)
        assert t_emb.embed_dim(multires) == j_emb.embed_dim(multires)


def test_init_draws_the_jax_weights():
    """Same seed, same numpy draws: the port's init equals the JAX init."""
    for kw in (ICFG, {}):
        jp = _np(j_sdf.init_implicit(j_sdf.ImplicitConfig(**kw),
                                     np.random.default_rng(3)))
        net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**kw),
                                  np.random.default_rng(3))
        for l, layer in enumerate(jp):
            for k, v in layer.items():
                np.testing.assert_array_equal(
                    getattr(net.layers[l], k).detach().numpy(), v)


def test_effective_weight_and_linear_parity():
    _, params, net = _implicit_pair()
    x = _points(50)
    pe = t_emb.positional_encoding(torch.from_numpy(x), 6)
    for l in (0, 1):
        np.testing.assert_allclose(
            net.layers[l].effective_weight().detach().numpy(),
            np.asarray(j_mlp.effective_weight(params[l])), rtol=1e-6,
            atol=1e-7)
    np.testing.assert_allclose(
        net.layers[0](pe).detach().numpy(),
        np.asarray(j_mlp.linear_apply(params[0], jnp.asarray(pe.numpy()))),
        atol=2e-5)


def test_implicit_apply_parity():
    jcfg, params, net = _implicit_pair()
    x = _points()
    want = np.asarray(j_sdf.implicit_apply(jcfg, params, jnp.asarray(x)))
    got = t_sdf.implicit_apply(net, torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (300, 18)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(
        t_sdf.sdf_apply(net, torch.from_numpy(x)).detach().numpy(),
        want[:, 0], atol=2e-5)


def _value_grad_loss_parity(bf16, tol):
    """Value, spatial gradient, and the parameter gradient of a scalar
    mixing both (random numpy cotangents)."""
    jcfg, params, net = _implicit_pair(bf16=bf16)
    x = _points()
    rng = np.random.default_rng(7)
    c_out = rng.normal(size=(300, 18)).astype(np.float32)
    c_g = rng.normal(size=(300, 3)).astype(np.float32)

    def j_loss(p):
        out, g = j_sdf.full_value_and_grad(jcfg, p, jnp.asarray(x))
        return jnp.sum(out * c_out) + jnp.sum(g * c_g), (out, g)

    (j_val, (j_out, j_g)), j_grads = jax.value_and_grad(
        j_loss, has_aux=True)(params)
    t_out, t_g = t_sdf.full_value_and_grad(net, torch.from_numpy(x))
    t_val = (t_out * torch.from_numpy(c_out)).sum() + \
        (t_g * torch.from_numpy(c_g)).sum()
    t_grads = torch.autograd.grad(t_val, list(net.parameters()),
                                  allow_unused=True)
    assert _rel(t_out.detach().numpy(), j_out) < tol
    assert _rel(t_g.detach().numpy(), j_g) < tol
    names = [n for n, _ in net.named_parameters()]
    for name, g in zip(names, t_grads):
        l, k = name.split(".")[1:]
        want = np.asarray(j_grads[int(l)][k])
        got = np.zeros_like(want) if g is None else g.numpy()
        assert _rel(got, want) < tol * 5, name


def test_full_value_and_grad_parity_f32():
    _value_grad_loss_parity(bf16=False, tol=2e-5)


def test_full_value_and_grad_parity_bf16_activations():
    _value_grad_loss_parity(bf16=True, tol=2e-2)


def test_full_value_and_grad_no_grad_mode_is_detached():
    _, _, net = _implicit_pair()
    with torch.no_grad():
        out, g = t_sdf.full_value_and_grad(net, torch.from_numpy(_points()))
    assert not out.requires_grad and not g.requires_grad
    assert torch.isfinite(g).all()


def test_softplus_second_derivative_is_finite():
    """The parameter gradient of an eikonal-style loss reaches the
    softplus's second derivative; it must stay finite where 100x is far
    below zero (torch.logaddexp's own backward gives NaN there)."""
    x = torch.tensor([-50.0, -1.0, 0.0, 1e-3, 2.0], requires_grad=True)
    (d,) = torch.autograd.grad(t_sdf.softplus100(x).sum(), x,
                               create_graph=True)
    (dd,) = torch.autograd.grad(d.sum(), x)
    s = torch.sigmoid(100 * x.detach())
    np.testing.assert_allclose(d.detach().numpy(), s.numpy(), rtol=1e-6)
    np.testing.assert_allclose(dd.numpy(), (100 * s * (1 - s)).numpy(),
                               rtol=1e-5, atol=1e-30)


def test_render_apply_parity():
    jcfg = j_rad.RenderConfig(**RCFG)
    params = _np(j_rad.init_render(jcfg, np.random.default_rng(4)))
    tnet = t_rad.init_render(t_rad.RenderConfig(**RCFG),
                             np.random.default_rng(4))
    for l, layer in enumerate(params):
        for k, v in layer.items():
            np.testing.assert_array_equal(
                getattr(tnet.layers[l], k).detach().numpy(), v)
    rng = np.random.default_rng(5)
    args = [rng.normal(size=(200, d)).astype(np.float32)
            for d in (3, 3, 3, 16)]
    want = np.asarray(j_rad.render_apply(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params),
        *map(jnp.asarray, args)))
    got = t_rad.render_apply(tnet, *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-6)
