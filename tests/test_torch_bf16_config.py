"""The bf16 configuration (``--pallas --bf16_acts``: the JAX package's
``bf16_activations``) on the CPU, where its operators run their plain
versions: the operators (``mlp.bf16_linear``, ``softplus100_*`` on bf16
operands)
against the chain of PyTorch's ops the field ran before them, to the bit,
in the field's value, spatial gradient and parameter gradients; and the
port's bf16 step held to the benchmark's bf16 reference
(``portbench/reference/bf16.py``, plain PyTorch in f32 with the
configuration's roundings) at a tiny size. No JAX needed.
"""
import tempfile

import numpy as np
import pytest
import torch

from mvsdf_tpu_torch.fields import mlp
from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.embedder import positional_encoding
from mvsdf_tpu_torch.tracing.kernels import softplus100 as SP

SMALL = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,),
             bf16_activations=True)
BF16 = torch.bfloat16


def _net(seed=0, **kw):
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**dict(SMALL, **kw)),
                              np.random.default_rng(seed))
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator(
            ).manual_seed(seed + p.numel())))
    return net


def _chain_apply(net, x):
    """The field's bf16 form before its operators: f32 copies of the bf16
    activation and weight multiplied, the activation cast after."""
    c = net.cfg
    inp = positional_encoding(x, c.multires).to(BF16)
    h = inp
    n = len(net.layers)
    for l, layer in enumerate(net.layers):
        if l in c.skip_in:
            h = (torch.cat([h, inp], -1) / np.sqrt(2)).to(BF16)
        y = h.float() @ layer.effective_weight().to(BF16).float()
        if l < n - 1:
            h = t_sdf.softplus100(y + layer.b).to(BF16)
        else:
            h = y + layer.b
    return h


def _value_grads(net, apply, x):
    xg = x.detach().requires_grad_(True)
    out = apply(net, xg)
    (g,) = torch.autograd.grad(out[..., 0].sum(), xg, create_graph=True)
    loss = (out ** 2).sum() + ((g.norm(dim=-1) - 1) ** 2).sum()
    return [out, g, *torch.autograd.grad(loss, list(net.parameters()))]


@pytest.mark.parametrize("shape", [(2, 37, 3), (50, 3)])
def test_field_through_the_operators_equals_the_plain_chain_to_the_bit(
        shape):
    """Value, spatial gradient and every parameter's gradient of a loss on
    both, through the bf16 operators, equal the plain chain's to the bit
    (3-d points: the supervised groups' (B, n, 3); 2-d: the trace's)."""
    net = _net()
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    got = _value_grads(net, t_sdf.implicit_apply, x)
    want = _value_grads(net, _chain_apply, x)
    assert got[0].dtype == torch.float32
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bf16_linear_equals_the_f32_product_of_its_bf16_values():
    """``bf16_linear`` and its first and second derivatives against the
    plain ops ``x.float() @ w`` (w the bf16 weight's f32 values), to the
    bit; x's cotangent bf16."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((3, 5, 40), generator=gen).to(BF16).requires_grad_(True)
    W = torch.randn((40, 24), generator=gen, requires_grad=True)
    gy = torch.randn((3, 5, 24), generator=gen)

    def both(fn):
        w16 = W.to(BF16)
        y = fn(x, w16)
        (dx,) = torch.autograd.grad(y, x, gy, create_graph=True)
        return [y, dx, *torch.autograd.grad((dx.float() ** 2).sum() +
                                            (y ** 2).sum(), (x, W))]

    got = both(lambda x, w16: mlp.bf16_linear(x, w16.float(), w16))
    want = both(lambda x, w16: x.float() @ w16.float())
    assert got[1].dtype == BF16
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_activation_bf16_operators_equal_the_cast_chain_to_the_bit():
    """``softplus100_bias``'s h in bf16 (``h_bf16``) and the gradients
    through it (first and second order, the cotangent of h in bf16) equal
    those of the f32 h cast to bf16, the field's chain before them."""
    gen = torch.Generator().manual_seed(3)
    y = (torch.rand((33, 20), generator=gen) - 0.5).requires_grad_(True)
    b = ((torch.rand(20, generator=gen) - 0.5) * 0.1).requires_grad_(True)
    gh = torch.randn((33, 20), generator=gen).to(BF16).requires_grad_(True)

    def both(fn):
        h = fn(y, b)
        dy, db = torch.autograd.grad(h, (y, b), gh, create_graph=True)
        second = torch.autograd.grad((dy ** 2).sum() + db.sum(),
                                     (y, b, gh))
        return [h, dy, db, *second]

    got = both(lambda y, b: SP.softplus100_bias(y, b.expand_as(y), True,
                                                True)[1])
    want = both(lambda y, b: SP.softplus100_bias(y, b.expand_as(y),
                                                 True)[1].to(BF16))
    assert got[0].dtype == BF16 and got[-1].dtype == BF16
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


def test_bf16_operators_count_nothing_off_the_card():
    """The plain versions launch nothing: the bf16 entries' launch counts
    and the bf16 products' rows stay where they were."""
    from mvsdf_tpu_torch.tracing.kernels import counts
    before = counts.snapshot()
    _value_grads(_net(), t_sdf.implicit_apply, torch.rand((4, 3)))
    n = counts.since(before)
    assert all(n[k] == 0 for k in counts.ACT_KERNEL_BF16 +
               ("bf16_gemm_rows",))


def test_field_against_the_bf16_reference():
    """The port's bf16 field (value, spatial gradient, the gradients of a
    loss on both) against the benchmark's bf16 reference from the same
    weights. The two round at the same points; their Softplus forms
    (logaddexp against ``F.softplus``) part by f32 units, and where a bf16
    rounding falls between them a value moves by 2^-8 of itself. Bounds:
    1e-3 relative (value, gradient), 5e-3 (each parameter's gradient);
    measured on seeds 4, 7, 9: 0 (value), 1e-7 to 9.3e-5 (gradient), 4.6e-6
    to 4.9e-4 (parameters). The f32 field from the same weights reads
    2.2e-3 to 2.7e-3, 8.2e-3 to 8.8e-3 and 1.4e-2 to 1.9e-2 there."""
    from portbench.reference import bf16 as ref
    icfg = {"multires": 6, "skip_in": SMALL["skip_in"]}
    x = torch.rand((2, 300, 3), generator=torch.Generator().manual_seed(5)) \
        * 1.6 - 0.8
    rel = lambda a, b: float((a - b).detach().norm() / b.detach().norm())

    def field(net):
        xg = x.detach().requires_grad_(True)
        out = t_sdf.implicit_apply(net, xg)
        (g,) = torch.autograd.grad(out[..., 0].sum(), xg, create_graph=True)
        return out, g, list(net.parameters())

    def reference(net):
        leaves = [v.detach().clone().requires_grad_(True)
                  for v in net.state_dict().values()]
        params = {"implicit." + k: v for k, v in
                  zip(net.state_dict(), leaves)}
        return (*ref.value_and_grad(params, icfg, x), leaves)

    def grads(out, g, leaves):
        loss = (out ** 2).mean() + ((g.norm(dim=-1) - 1) ** 2).mean()
        return torch.autograd.grad(loss, leaves)

    r_out, r_g, r_leaves = reference(_net(seed=4))
    r_grads = grads(r_out, r_g, r_leaves)
    out, g, leaves = field(_net(seed=4))
    assert rel(out, r_out) <= 1e-3 and rel(g, r_g) <= 1e-3
    for a, b in zip(grads(out, g, leaves), r_grads):
        assert rel(a, b) <= 5e-3
    out32, g32, _ = field(_net(seed=4, bf16_activations=False))
    assert rel(out32, r_out) > 1e-3 and rel(g32, r_g) > 1e-3


@pytest.fixture(scope="module")
def tiny_bf16_driver():
    """The bf16 cell at the tiny size (``portbench/tests/tiny.py``) on the
    CPU: the program's three steps and their readings against the bf16
    reference."""
    from portbench.common import driver_module
    from portbench.tests import tiny
    cell = tiny.cell("bf16_dtu_kernels.train_c", "mvsdf_dtu_kernels_bf16")
    drv = driver_module(cell.kind).Driver(cell, 2 ** 31 + 23,
                                          torch.device("cpu"), False,
                                          cache=tempfile.mkdtemp())
    drv.setup()
    drv.release()
    return drv


def test_bf16_step_against_the_bf16_reference(tiny_bf16_driver):
    """Step 2's loss and clipped gradient and three steps' Adam updates of
    the port's bf16 step (f32 products in its backward, on the CPU)
    against the bf16 reference's: loss within 1e-5, the worst leaf's
    gradient within 2e-4, update within 1e-2 (measured at most 1.4e-7,
    3.0e-5 and 1.0e-3 over four seeds: a bf16 rounding that the Softplus
    forms put on either side). The reference under bf16 autocast fails
    the gradient's limit (3.6e-2 to 7.7e-2), and so does the one whose
    backward rounds its f32 operands to bf16 (5.1e-4 to 1.8e-3)."""
    drv = tiny_bf16_driver
    ref = drv.reference()
    got = drv.readings(drv.program(), ref)
    assert got["loss_gap"] <= 1e-5 and got["grad_gap_worst"] <= 2e-4 and \
        got["update_gap"] <= 1e-2, got
    for kw in ({"control": True}, {"backward_bf16": True}):
        ctl = drv.readings(drv.in_place_of_program(drv.reference(**kw)),
                           ref)
        assert ctl["grad_gap_worst"] > 2e-4, (kw, ctl)
