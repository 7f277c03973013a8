"""The port's fused SDF-MLP (tracing/kernels/sdf_mlp.py) against the JAX
package's Pallas kernel and field.

On the CPU the wrapper runs the kernel's plain version, so these tests hold
``pack_sdf_weights`` + ``sdf_mlp_reference`` against
``pallas_sdf_apply(interpret=True)`` and ``sdf_apply`` (2e-5 absolute on
SDF values of order 1, as the JAX package's own kernel test). The CUDA
kernel itself runs only on a GPU: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu.tracing.pallas import pack_sdf_weights as j_pack
from mvsdf_tpu.tracing.pallas import pallas_sdf_apply
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.embedder import positional_encoding
from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K

SMALL = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
NO_SKIP = dict(feature_vector_size=16, dims=(96,) * 3, skip_in=())


def _pair(kw, seed=0):
    jcfg = j_sdf.ImplicitConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, j_sdf.init_implicit(jcfg, np.random.default_rng(seed)))
    rng = np.random.default_rng(seed + 1)
    params = [{k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
               for k, v in p.items()} for p in params]
    net = t_sdf.ImplicitNetwork(t_sdf.ImplicitConfig(**kw))
    state = params_from_jax({"implicit": params, "render": []})
    net.load_state_dict({k[len("implicit."):]: v for k, v in state.items()})
    return jcfg, [jax.tree_util.tree_map(jnp.asarray, p) for p in params], \
        net


def _x(n, seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(
        np.float32)


def _port_sdf(net, x):
    packed = K.pack_sdf_weights(net)
    pe = positional_encoding(torch.from_numpy(x), net.cfg.multires)
    return K.sdf_mlp(packed, pe).numpy()


@pytest.mark.parametrize("kw", [SMALL, NO_SKIP, {}],
                         ids=["small_skip_padded", "no_skip", "full_size"])
def test_reference_matches_pallas_and_field(kw):
    n = 777 if kw else 300  # ragged against the 256-row Pallas block
    jcfg, params, net = _pair(kw)
    x = _x(n)
    got = _port_sdf(net, x)
    field = np.asarray(j_sdf.sdf_apply(jcfg, params, jnp.asarray(x)))
    pallas = np.asarray(pallas_sdf_apply(jcfg, j_pack(jcfg, params),
                                         jnp.asarray(x), block=256,
                                         interpret=True))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, field, atol=2e-5, rtol=1e-5)


def test_packed_weights_match_jax_packing():
    """Same effective matrices as the JAX packing, in the port's layout:
    hidden width padded to 64 (the 25-wide pre-skip layer pads with zero
    columns, and the next matrix has zero rows there)."""
    jcfg, params, net = _pair(SMALL)
    jp = j_pack(jcfg, params)
    tp = K.pack_sdf_weights(net)
    assert tp.H == 64 and tp.d_pe == 39 and tp.skip == (False, True, False)
    kinds = [e[0] for e in jp["layers"]]
    assert kinds == ["in", "hid", "skip", "hid", "out"]
    lay = jp["layers"]
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    close(tp.w_in, lay[0][1][:39, :64])
    close(tp.b_in, lay[0][2][0, :64])
    close(tp.w_hid[0], lay[1][1][:64, :64])
    close(tp.w_hid[1], lay[2][1][:64, :64])
    close(tp.w_skip_pe[0], lay[2][2][:39, :64])
    close(tp.w_hid[2], lay[3][1][:64, :64])
    close(tp.w_out, lay[4][1][:64, 0])
    close(tp.b_out, lay[4][2][0, :1])
    assert not tp.w_hid[0][:, 25:].any() and not tp.b_hid[0][25:].any()
    assert not tp.w_hid[1][25:].any()


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    _, _, net = _pair(SMALL)
    packed = K.pack_sdf_weights(net)
    pe = positional_encoding(torch.from_numpy(_x(33)), 6)
    before = K.sdf_mlp.launches
    np.testing.assert_array_equal(K.sdf_mlp(packed, pe).numpy(),
                                  K.sdf_mlp_reference(packed, pe).numpy())
    assert K.sdf_mlp.launches == before
    with pytest.raises(ValueError):
        K.sdf_mlp(packed, pe.double())
    with pytest.raises(ValueError):
        K.sdf_mlp(packed, pe.to("meta"))


def test_flops_per_point_full_size():
    # 39x512 + 2*512x512 + 512x473 + 512x512 (skip) + 3*512x512 + 512x1
    assert K.flops_per_point(t_sdf.ImplicitConfig()) == 2 * 1_835_520
