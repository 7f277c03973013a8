"""The SDF network's bias + Softplus(beta=100) as operators
(``tracing/kernels/softplus100.py``: ``mvsdf::softplus100_bias``,
``softplus100_grad``, ``softplus100_grad_grad``; ``fields/sdf.py``:
``bias_softplus100``) on the CPU, where they run their plain versions:
their value and first and second derivatives against ``softplus100``, the
operators' shapes without data (what ``torch.export`` traces), the export
that records them, the launch counters, the launch wrappers' operand
checks, and the field's value, spatial gradient and parameter gradients
against the chain the field ran before the layers' bias moved into the
activation. No JAX needed; the card's side is in
``tests/test_torch_cuda.py``.
"""
import io

import numpy as np
import pytest
import torch

from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.tracing.kernels import counts
from mvsdf_tpu_torch.tracing.kernels import softplus100 as SP
from mvsdf_tpu_torch.train.metrics import Tracer

SMALL = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))


def _node(y, b):
    return SP.softplus100_bias(y, b.expand_as(y), True)[1]


def _yb(shape, dtype, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = (torch.rand(shape, generator=g, dtype=dtype) - 0.5) * scale
    b = (torch.rand(shape[-1:], generator=g, dtype=dtype) - 0.5) * scale
    return y.requires_grad_(True), b.requires_grad_(True)


def test_nodes_equal_softplus100_value_and_first_derivative():
    """f32, |100 z| up to 50: h, and the VJPs with respect to y and b, to
    the bit of ``softplus100(y + b)``'s (the same ops in the same
    order)."""
    y, b = _yb((33, 20), torch.float32)
    gh = torch.rand((33, 20), generator=torch.Generator().manual_seed(1))
    h = _node(y, b)
    ref = t_sdf.softplus100(y + b)
    assert torch.equal(h, ref)
    got = torch.autograd.grad(h, (y, b), gh)
    want = torch.autograd.grad(ref, (y, b), gh)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_nodes_pass_gradcheck_and_gradgradcheck_in_float64():
    """Both differentiable operators' first and second derivatives against
    finite differences, |100 z| up to 50; ``softplus100_grad`` in g, z and
    the gradient it adds."""
    y, b = _yb((5, 7), torch.float64)
    assert torch.autograd.gradcheck(_node, (y, b))
    assert torch.autograd.gradgradcheck(_node, (y, b))
    g, z = _yb((5, 7), torch.float64, seed=2)
    z = z.detach()[None].expand(5, 7).clone().requires_grad_(True)
    a = torch.rand((5, 7), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(SP.softplus100_grad, (g, z, a))
    assert torch.autograd.gradcheck(
        lambda g, z: SP.softplus100_grad(g, z, None), (g, z))


def test_second_derivative_matches_softplus100_and_is_finite_at_extremes():
    """The spatial-gradient pattern (a loss on the input gradient, taken
    with ``create_graph``) at |100 z| up to 1e4: every derivative finite
    and equal to ``softplus100``'s to the bit, in f32."""
    z = torch.linspace(-100.0, 100.0, 401)
    y = z[:, None].repeat(1, 8).requires_grad_(True)
    b = torch.zeros(8, requires_grad=True)
    outs = []
    for f in (_node, lambda y, b: t_sdf.softplus100(y + b)):
        h = f(y, b)
        (gy,) = torch.autograd.grad(h.sum(), y, create_graph=True)
        loss = (gy ** 2).sum() + (h ** 2).sum()
        outs.append([gy.detach(), *torch.autograd.grad(loss, (y, b))])
    for a, w in zip(*outs):
        assert torch.isfinite(a).all()
        assert torch.equal(a, w)


def test_nan_in_nan_out():
    """A NaN input gives NaN where it lies, in h, its gradient and its
    second derivative, and leaves the other entries finite."""
    y = torch.tensor([[0.01, float("nan"), -0.02]], requires_grad=True)
    b = torch.zeros(3, requires_grad=True)
    h = _node(y, b)
    (gy,) = torch.autograd.grad(h.sum(), y, create_graph=True)
    (gyy,) = torch.autograd.grad(gy.sum(), y)
    for t in (h.detach(), gy.detach(), gyy):
        assert t[0, 1].isnan() and torch.isfinite(t[0, [0, 2]]).all()
    dg, dz = SP.softplus100_grad_grad(torch.ones(1, 3), torch.ones(1, 3),
                                      y.detach(), True, True)
    assert dg[0, 1].isnan() and dz[0, 1].isnan()


def test_export_records_the_operator_and_runs_it_where_it_is_loaded():
    """``torch.export`` of the field's forward records one
    ``softplus100_bias`` a hidden layer (z not kept: no gradient), and the
    saved and loaded program equals the live field to the bit on the
    CPU (called without a gradient, as it was traced)."""
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**SMALL),
                              np.random.default_rng(0))
    x = torch.rand((32, 3)) - 0.5

    class Field(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            return t_sdf.implicit_apply(self.net, x)

    with torch.no_grad():
        ep = torch.export.export(Field(), (x,), strict=False)
        want = t_sdf.implicit_apply(net, x)
    calls = [n for n in ep.graph.nodes if n.op == "call_function" and
             "softplus100_bias" in str(n.target)]
    assert len(calls) == len(net.layers) - 1
    assert all(n.args[2] is False for n in calls)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    with torch.no_grad():
        got = torch.export.load(buf).module()(x)
    assert torch.equal(got, want)


def test_dispatch_cpu_keep_z_and_shapes_without_data():
    """On the CPU the operators run PyTorch's ops and launch nothing; z is
    kept only where a gradient will be taken (and asking for a gradient
    without it raises); on tensors without data (the meta device, as
    ``torch.export`` traces) they give their outputs' shapes; the launch
    wrappers refuse any tensor off the card."""
    y, b = _yb((4, 6), torch.float32)
    before = counts.snapshot()
    h = t_sdf.bias_softplus100(y, b)
    assert h.requires_grad
    assert torch.equal(h, t_sdf.softplus100(y + b))
    with torch.no_grad():
        z, h0 = SP.softplus100_bias(y, b.expand_as(y), False)
        assert torch.equal(h0, h) and z.numel() == 0
        assert t_sdf.bias_softplus100(y, b).grad_fn is None
    with pytest.raises(ValueError, match="keep_z"):
        SP.softplus100_bias(y, b.expand_as(y), False)
    assert all(v == 0 for v in counts.since(before).values())
    ym, bm = y.detach().to("meta"), b.detach().to("meta")
    z, h = SP.softplus100_bias(ym, bm.expand_as(ym), True)
    assert z.shape == h.shape == (4, 6) and h.device.type == "meta"
    assert SP.softplus100_grad(ym, ym, None).shape == (4, 6)
    dg, dz = SP.softplus100_grad_grad(ym, ym, ym, False, True)
    assert dg.numel() == 0 and dz.shape == (4, 6)
    for launch, args in ((SP.forward, (y, b)), (SP.grad, (y, y)),
                         (SP.grad_grad, (y, y, y))):
        with pytest.raises(ValueError, match="launches on cuda"):
            launch(*(t.detach() for t in args))


def test_the_spatial_gradient_sums_no_bias_gradient():
    """The bias goes into the operator broadcast, so its row sum is the
    expand's backward: the spatial gradient's backward (taken for the
    points alone) runs no row sum, the loss's backward one a hidden layer
    at least."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class RowSums(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.sum.dim_IntList
            return func(*args, **(kwargs or {}))
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**SMALL),
                              np.random.default_rng(0))
    with RowSums() as spatial:
        out, g = t_sdf.full_value_and_grad(net, torch.rand((16, 3)))
    with RowSums() as loss:
        torch.autograd.grad((g ** 2).sum() + out[:, 0].sum(),
                            list(net.parameters()))
    assert spatial.n == 0
    assert loss.n >= len(net.layers) - 1


def test_counters_are_carried_by_counts():
    """The kernel's three entries are counters of ``counts`` (carried
    through graph replays), and the field on the CPU launches none of
    them."""
    assert set(counts.ACT_KERNEL) <= set(counts.snapshot())
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**SMALL),
                              np.random.default_rng(0))
    before = counts.snapshot()
    out, g = t_sdf.full_value_and_grad(net, torch.rand((8, 3)))
    torch.autograd.grad(out.sum() + g.sum(), list(net.parameters()))
    n = counts.since(before)
    assert all(n[k] == 0 for k in counts.ACT_KERNEL)
    assert [counts.snapshot()[k] for k in counts.ACT_KERNEL] == [
        SP.forward.launches, SP.grad.launches, SP.grad_grad.launches]


def test_wrappers_take_row_strides_and_refuse_other_layouts():
    """The kernel's operands as (rows, cols) views: any row stride, a unit
    inner stride, the shape of z and f32, or a ValueError; the bias as
    the one row it broadcasts, leading dimensions of 1 included."""
    base = torch.zeros((6, 512))
    t = SP._rows("g", base[:, :473], (6, 473), base.device)
    assert t.shape == (6, 473) and t.stride() == (512, 1)
    assert SP._rows("z", base.reshape(2, 3, 512), (2, 3, 512),
                    base.device).shape == (6, 512)
    for bad, shape in ((base.t(), (512, 6)), (base.double(), (6, 512)),
                       (base, (6, 511))):
        with pytest.raises(ValueError):
            SP._rows("x", bad, shape, base.device)
    b = torch.arange(512.0)
    for y in (base, base[:1], base.reshape(2, 3, 512), base[:1, None]):
        row = SP._bias_row(b.expand_as(y), y)
        assert row.numel() == 512 and row.data_ptr() == b.data_ptr()
    with pytest.raises(ValueError, match="broadcast"):
        SP._bias_row(base + b, base)


def _implicit_before(net, x):
    """``implicit_apply`` as the field ran it before its hidden layers'
    bias moved into the activation: ``softplus100(layer(h))``."""
    cfg = net.cfg
    inp = t_sdf.positional_encoding(x, cfg.multires)
    h = inp
    for l, layer in enumerate(net.layers):
        if l in cfg.skip_in:
            h = torch.cat([h, inp], dim=-1) / np.sqrt(2)
        h = layer(h)
        if l < len(net.layers) - 1:
            h = t_sdf.softplus100(h)
    return h


@pytest.mark.parametrize("shape", [(64, 3), (4, 16, 3)],
                         ids=["rows", "batched"])
def test_full_value_and_grad_equals_the_chain_before(monkeypatch, shape):
    """The full-width field (9 x 512, the 473-wide layer before the skip)
    from the seed's weights, 64 points as rows or as a batch of rays:
    output, spatial gradient and every parameter's gradient of a loss on
    both equal to the bit to those of the chain before the change (the
    bias gradients as row sums over every leading dimension)."""
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(),
                              np.random.default_rng(0))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, shape).astype(np.float32))
    params = list(net.parameters())

    def run():
        out, g = t_sdf.full_value_and_grad(net, x)
        loss = ((g.norm(dim=-1) - 1) ** 2).sum() + out[..., :2].sum() + \
            out[..., 2:].square().mean()
        return [out.detach(), g.detach(),
                *torch.autograd.grad(loss, params)]

    monkeypatch.setattr(t_sdf, "implicit_apply", _implicit_before)
    want = run()
    monkeypatch.undo()
    got = run()
    for i, (a, w) in enumerate(zip(got, want)):
        assert torch.equal(a, w), i


def test_tracer_reports_the_activation_launches_a_replay():
    """``Tracer.summary`` gives the activation kernel's launches over the
    replays of the chunks that counted them (the capture's warm-up takes
    no part), None where none did."""
    tr = Tracer(on=True)
    ms = 10 ** 6
    row = lambda t0: [v * ms for v in (t0, t0 + 1, t0 + 2, t0 + 3, t0 + 4,
                                       t0 + 5)] + [0, 0]
    tr.add_chunk(0, np.array([row(0), row(10), row(20)]),
                 [False, True, True], 10.0, 2, act=384)
    tr.add_chunk(1, np.array([row(30), row(40)]), [True, True], 10.0, 2,
                 act=384)
    got = tr.summary()
    assert got["act_kernel_launches_per_step"] == pytest.approx(192)
    bare = Tracer(on=True)
    bare.add_chunk(0, np.array([row(0)]), [True], 1.0, 1)
    assert bare.summary()["act_kernel_launches_per_step"] is None
