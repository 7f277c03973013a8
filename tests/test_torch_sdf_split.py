"""The split arithmetic of the port's tensor-core SDF-MLP tile
(tracing/kernels/sdf_mlp.py, csrc/mlp_tile_tc.cuh), on the CPU.

The kernels compute every product h @ W as three bf16 products of operands
split into hi = bf16(v) and lo = bf16(v - hi), summed in f32. These tests
hold the plain version of that arithmetic (``sdf_mlp_split_reference``) to
the f32 plain version the kernels are gated against, pin why one bf16 pass
is not enough, and check the packed weight stream the kernel reads: its
layout, its padding and that it round-trips to the f32 weights. The CUDA
kernels themselves run only on a GPU: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.embedder import positional_encoding
from mvsdf_tpu_torch.fields.sdf import softplus100
from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K

SMALL = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
H96 = dict(feature_vector_size=16, dims=(96,) * 3, skip_in=())      # -> 128
H200 = dict(feature_vector_size=16, dims=(200,) * 3, skip_in=(1,))  # -> 256
NO_HIDDEN = dict(feature_vector_size=16, dims=(64,), skip_in=())
NETS = pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "full"])
NOISE = pytest.mark.parametrize("noise", [0.0, 0.05],
                                ids=["seed0", "noise0.05"])
PADDED = pytest.mark.parametrize(
    "kw", [SMALL, H96, H200, NO_HIDDEN, {}],
    ids=["small", "h96_to_128", "h200_to_256", "no_hidden", "full"])


def _packed(kw, noise=0.0):
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**kw),
                              np.random.default_rng(0))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.from_numpy(
                (noise * rng.normal(size=tuple(p.shape))).astype(np.float32)))
        return K.pack_sdf_weights(net)


def _pe(n, seed=2):
    x = np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)
    return positional_encoding(torch.from_numpy(x), 6)


def _one_pass(a, w, acc=None):
    """acc + a @ w as one bf16 tensor-core pass would take it: hi x hi
    alone."""
    out = a.bfloat16().float() @ w.bfloat16().float()
    return out if acc is None else acc + out


def _layer_matrices(packed):
    return K.layer_matrices(packed.w_in, packed.w_hid, packed.w_skip_pe,
                            packed.skip)


def _untile(w_tc, shapes):
    """Inverse of ``tile_split_weights``: the (hi, lo) bf16 matrices of the
    stream, for matrices of the given (K, HP) shapes."""
    mats, at = [], 0
    for Kr, HP in shapes:
        n = 2 * Kr * HP
        t = w_tc[at:at + n].reshape(Kr // 16, 2, 2, HP // 8, 8, 8)
        at += n
        # (k-step, hi/lo, kg, ng, n8, k8) -> (hi/lo, k-step, kg, k8, ng, n8)
        hi, lo = t.permute(1, 0, 2, 5, 3, 4).reshape(2, Kr, HP)
        mats.append((hi, lo))
    assert at == w_tc.numel()
    return mats


def _stream_sdf(packed, pe):
    """The SDF column evaluated from the packed stream alone (w_tc, v_tc,
    b_out), at the padded widths and in the kernel's order of layers."""
    mats = _layer_matrices(packed)
    tiles = iter(_untile(packed.w_tc, [m.shape for m in mats]))
    HP, KP = mats[1].shape[1] if len(mats) > 1 else mats[0].shape[1], \
        mats[0].shape[0]
    pe_p = torch.zeros(pe.shape[0], KP)
    pe_p[:, :pe.shape[1]] = pe

    def product(a):
        w_hi, w_lo = (t.float() for t in next(tiles))
        a_hi, a_lo = (t.float() for t in K.split_bf16(a))
        return a_hi @ w_hi + a_lo @ w_hi + a_hi @ w_lo

    h = softplus100(product(pe_p) + packed.v_tc[0])
    for j, is_skip in enumerate(packed.skip):
        z = product(h)
        if is_skip:
            z = (z + product(pe_p)) * np.float32(1.0 / np.sqrt(2.0))
        h = softplus100(z + packed.v_tc[j + 1])
    assert h.shape[1] == HP and next(tiles, None) is None
    return h @ packed.v_tc[-1] + packed.b_out


@NETS
@NOISE
def test_split_reference_matches_f32_plain_version(kw, noise):
    """Three bf16 passes keep 16 mantissa bits of each operand: measured
    0.7e-5 to 1.6e-5 on SDF values of order 1 through the 9 layers; the
    bound 5e-5 is half the kernels' gate of 1e-4."""
    packed, pe = _packed(kw, noise), _pe(1024)
    ref = K.sdf_mlp_reference(packed, pe)
    got = K.sdf_mlp_split_reference(packed, pe)
    assert got.shape == ref.shape == (1024,)
    assert (got - ref).abs().max().item() <= 5e-5


@NETS
@NOISE
def test_one_bf16_pass_breaks_the_gate(kw, noise):
    """Why the split exists: hi x hi alone (one tensor-core pass) misses the
    kernels' gate of 1e-4 by more than an order of magnitude."""
    packed, pe = _packed(kw, noise), _pe(1024)
    ref = K.sdf_mlp_reference(packed, pe)
    one = K.mlp_chain(packed, pe, _one_pass)
    assert (one - ref).abs().max().item() > 1e-3


@NETS
@NOISE
def test_hi_plus_lo_reproduces_a_weight_to_16_bits(kw, noise):
    packed = _packed(kw, noise)
    for w in (packed.w_in, packed.w_hid, packed.w_skip_pe):
        hi, lo = K.split_bf16(w)
        assert hi.dtype == lo.dtype == torch.bfloat16
        err = (w - hi.float() - lo.float()).abs()
        assert (err <= 2.0 ** -16 * w.abs()).all()
        # and the split is what the stream stores: lo is the rounded rest
        assert torch.equal(lo, (w - hi.float()).to(torch.bfloat16))


@PADDED
def test_stream_round_trips_to_the_f32_weights(kw):
    """Untiling w_tc gives back every layer's matrix at the padded shape:
    hi + lo within 2^-16 relative of the f32 weight, exact zeros in the
    padded rows and columns."""
    packed = _packed(kw, 0.05)
    mats = _layer_matrices(packed)
    HP, KP = K.tc_width(packed.H), 48
    assert packed.w_tc.dtype == torch.bfloat16
    assert packed.w_tc.numel() == 2 * sum(m.numel() for m in mats)
    assert mats[0].shape == (KP, HP)
    assert packed.v_tc.shape == (len(packed.skip) + 2, HP)
    back = _untile(packed.w_tc, [m.shape for m in mats])
    for m, (hi, lo) in zip(mats, back):
        assert m.shape[0] % 16 == 0 and m.shape[1] == HP
        assert ((m - hi.float() - lo.float()).abs()
                <= 2.0 ** -16 * m.abs()).all()
        assert not hi[:, packed.H:].any() and not lo[:, packed.H:].any()
    hi, lo = back[0]
    assert not hi[packed.d_pe:].any() and not lo[packed.d_pe:].any()
    np.testing.assert_array_equal(packed.v_tc[0, :packed.H].numpy(),
                                  packed.b_in.numpy())
    np.testing.assert_array_equal(packed.v_tc[-1, :packed.H].numpy(),
                                  packed.w_out.numpy())
    assert not packed.v_tc[:, packed.H:].any()


def test_tile_layout_is_wgmmas_k_major_core_matrices():
    """W[k][n] of a k-step's tile sits at element ((k // 8) * (HP // 8) +
    n // 8) * 64 + (n % 8) * 8 + k % 8; the hi tile precedes the lo tile and
    k-steps follow each other."""
    HP, Kr = 64, 32
    w = torch.arange(Kr * HP, dtype=torch.float32).reshape(Kr, HP) / 8
    hi, lo = K.split_bf16(w)
    s = K.tile_split_weights([w])
    assert s.shape == (2 * Kr * HP,)
    for k, n in ((0, 0), (1, 0), (0, 1), (7, 7), (8, 0), (15, 63), (16, 0),
                 (23, 9), (31, 63)):
        step, kk = divmod(k, 16)
        at = ((kk // 8) * (HP // 8) + n // 8) * 64 + (n % 8) * 8 + kk % 8
        base = step * 2 * 16 * HP
        assert s[base + at] == hi[k, n], (k, n)
        assert s[base + 16 * HP + at] == lo[k, n], (k, n)


@PADDED
def test_padded_lanes_change_nothing(kw):
    """The kernel's view (PE padded 39 -> 48 with zeros, every width padded
    to 64, 128, 256 or 512, softplus(0) in the padded lanes) gives the
    split reference's values at the true widths: zero rows annihilate the
    padding. 2e-6 for the f32 sums' order."""
    packed, pe = _packed(kw, 0.05), _pe(300)
    got = _stream_sdf(packed, pe)
    ref = K.sdf_mlp_split_reference(packed, pe)
    assert got.shape == (300,)
    assert (got - ref).abs().max().item() <= 2e-6


@pytest.mark.parametrize("H,HP", [(32, 64), (64, 64), (96, 128), (224, 256),
                                  (288, 512), (512, 512)])
def test_tc_width(H, HP):
    assert K.tc_width(H) == HP


def test_tc_width_rejects_wider_nets():
    with pytest.raises(ValueError):
        K.tc_width(544)


def test_tc_weight_args_check_the_stream():
    packed = _packed(SMALL)
    cpu = torch.device("cpu")
    args = K.tc_weight_args(packed, cpu)
    assert args[:4] == [39, 64, 3, 0b010]
    assert len(args) == len(K.TC_WEIGHT_ARGTYPES)
    with pytest.raises(ValueError):
        K.tc_weight_args(packed._replace(w_tc=packed.w_tc[:-16]), cpu)
    with pytest.raises(ValueError):
        K.tc_weight_args(packed._replace(w_tc=packed.w_tc.float()), cpu)
    with pytest.raises(ValueError):
        K.tc_weight_args(packed._replace(v_tc=packed.v_tc[:, :32]), cpu)


@pytest.mark.parametrize("c,terms,want", [
    # 1 + 3 2^-25: the exact sum's bits below 2^-24 are cut; nearest gives
    # 1 + 2^-23
    (0.0, [(1.0, 1.0), (2.0 ** -12, 3 * 2.0 ** -13)], 1.0),
    (1.0, [(2.0 ** -12, 3 * 2.0 ** -13)], 1.0),
    (-1.0, [(-(2.0 ** -12), 3 * 2.0 ** -13)], -1.0),
    # aligned to the operands' exponent sum (0 for 1.5 x 1.5 = 2.25): a
    # term of 2^-25 survives the cut at 2^-25, and 2.25 + 2^-25 cuts to
    # 2.25 in f32
    (0.0, [(1.5, 1.5), (2.0 ** -12, 2.0 ** -13)], 2.25),
    # exact sums stay exact
    (0.5, [(1.5, 1.5), (-0.25, 2.0)], 2.25),
])
def test_tensor_core_k_step_model(c, terms, want):
    """``tc_k_step`` on hand-made k-steps: where f32 would round to nearest
    it cuts toward zero."""
    a = torch.tensor([[x for x, _ in terms]], dtype=torch.bfloat16).float()
    w = torch.tensor([[y] for _, y in terms], dtype=torch.bfloat16).float()
    acc = torch.tensor([[c]], dtype=torch.float32)
    assert K.tc_k_step(acc, a, w).item() == want


def test_tensor_core_k_step_model_on_random_sums():
    """Over random bf16 k-steps: never farther from the exact sum than the
    17 cuts (each below 2^-25 of 2^E <= the largest term) and the final cut
    (below 2^-23 of the sum) allow, and never above it in magnitude where
    every term is positive."""
    gen = torch.Generator().manual_seed(0)
    a = (torch.randn(256, 16, generator=gen) * 4).bfloat16().float()
    w = (torch.randn(16, 8, generator=gen) * 4).bfloat16().float()
    acc = torch.randn(256, 8, generator=gen)
    exact = acc.double() + a.double() @ w.double()
    got = K.tc_k_step(acc, a, w)
    big = torch.maximum((a.double()[:, :, None] * w.double()[None]).abs()
                        .amax(1), acc.double().abs())
    assert ((got.double() - exact).abs() <=
            17 * 2.0 ** -25 * big + 2.0 ** -23 * exact.abs()).all()
    pos = K.tc_k_step(acc.abs(), a.abs(), w.abs())
    assert (pos.double() <= acc.double().abs() + a.double().abs()
            @ w.double().abs()).all()


@pytest.mark.parametrize("kw", [SMALL, H96], ids=["small", "h96_to_128"])
def test_tensor_core_split_reference_stays_within_the_gate(kw):
    """The split arithmetic with the tensor cores' sums (the model the card
    reproduces) against the f32 plain version: within the same 5e-5 as the
    f32-summed split, and not equal to that split (the sums are cut)."""
    packed, pe = _packed(kw, 0.05), _pe(256)
    ref = K.sdf_mlp_reference(packed, pe)
    tc = K.sdf_mlp_split_reference(packed, pe, "tensor_core")
    split = K.sdf_mlp_split_reference(packed, pe)
    assert tc.shape == (256,)
    assert (tc - ref).abs().max().item() <= 5e-5
    assert not torch.equal(tc, split)
    with pytest.raises(ValueError):
        K.sdf_mlp_split_reference(packed, pe, "f64")
