"""The reference of the bf16 configuration (``mvsdf_dtu_kernels_bf16``): the
plain reference's training step with the SDF network's supervised
evaluations in the JAX package's ``bf16_activations`` precision, in plain
PyTorch and f32, TF32 off by the caller.

Rounded to bf16 (``.to(torch.bfloat16).float()``), and nowhere else: the
encoded input, each hidden activation, the skip's concatenation over
sqrt(2), and each layer's effective weight where it multiplies. The
products and their sums are f32. A rounding's gradient is autograd's, so
the cotangent of a rounded value is rounded too: that of a bf16 tensor is
bf16. So a layer's input, a bf16 value, passes through one more rounding
(an identity forward) that rounds its cotangent where the layer gives it,
and the skip's scaling is rounded on both sides, as bf16 arithmetic
divides a bf16 cotangent. The backward's products multiply f32 operands.
The trace's SDF (the ``sdf_mlp`` kernel's, f32 in the program), the
radiance network, the losses, the clip and Adam are the plain reference's
own (``reference/step.py``, ``field.py``), called with this field in the
place of the supervised evaluations.

``backward_bf16`` is a control, not the configuration: each linear
layer's backward also rounds its f32 cotangent to bf16 before the
products that take it (dy @ W^T and x^T @ dy), the shortcut the
configuration's precision forbids.
"""
from __future__ import annotations

import contextlib
import math
import types

import torch
import torch.nn.functional as F

from . import field
from . import step as ref_step


def r16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, in f32."""
    return t.to(torch.bfloat16).float()


class _LinearBackwardBf16(torch.autograd.Function):
    """x @ W whose backward rounds the cotangent to bf16 before both
    products (the control); twice differentiable."""

    @staticmethod
    def forward(ctx, x, W):
        ctx.save_for_backward(x, W)
        return x @ W

    @staticmethod
    def backward(ctx, dy):
        x, W = ctx.saved_tensors
        d = r16(dy)
        dx = d @ W.t()
        dW = x.reshape(-1, x.shape[-1]).t() @ d.reshape(-1, d.shape[-1])
        return dx, dW


def linear(params: dict, prefix: str, x: torch.Tensor,
           backward_bf16: bool = False) -> torch.Tensor:
    v, g = params[prefix + ".v"], params[prefix + ".g"]
    W = r16(v * (g / torch.linalg.vector_norm(v, dim=0).clamp_min(1e-12)))
    x = r16(x)   # its cotangent is bf16
    y = _LinearBackwardBf16.apply(x, W) if backward_bf16 else x @ W
    return y + params[prefix + ".b"]


def sdf_net(params: dict, icfg: dict, x: torch.Tensor,
            backward_bf16: bool = False) -> torch.Tensor:
    """x (..., 3) -> (..., 2 + features), the field of ``field.sdf_net``
    with the configuration's roundings."""
    pe = r16(field.encode(x, icfg["multires"]))
    h = pe
    n = field.n_layers(params, "implicit")
    for l in range(n):
        if l in icfg["skip_in"]:
            h = r16(r16(torch.cat([h, pe], -1)) / math.sqrt(2))
        h = linear(params, f"implicit.layers.{l}", h, backward_bf16)
        if l < n - 1:
            h = r16(F.softplus(h, beta=100))
    return h


def value_and_grad(params: dict, icfg: dict, x: torch.Tensor,
                   backward_bf16: bool = False):
    """``field.value_and_grad`` through this field."""
    xg = x if x.requires_grad else x.detach().requires_grad_(True)
    out = sdf_net(params, icfg, xg, backward_bf16)
    (g,) = torch.autograd.grad(out[..., 0].sum(), xg, create_graph=True)
    return out, g


@contextlib.contextmanager
def supervised_in_bf16(backward_bf16: bool = False):
    """The plain reference's step (``reference/step.py``) with its
    supervised evaluations (``field.value_and_grad``) through this field;
    the trace and the radiance network as they are."""
    saved = ref_step.field
    ref_step.field = types.SimpleNamespace(
        sdf_value=field.sdf_value, radiance=field.radiance,
        value_and_grad=lambda p, c, x: value_and_grad(p, c, x,
                                                      backward_bf16))
    try:
        yield
    finally:
        ref_step.field = saved


def train_steps(*args, backward_bf16: bool = False, **kw):
    """``reference/step.train_steps`` with the supervised evaluations in
    the configuration's precision."""
    with supervised_in_bf16(backward_bf16):
        return ref_step.train_steps(*args, **kw)
