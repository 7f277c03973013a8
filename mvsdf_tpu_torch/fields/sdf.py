"""Implicit geometry field (port of ``mvsdf_tpu/fields/sdf.py``): a point
maps to (SDF value, surface-indicator logit, feature vector).

9 weight-normalized linear layers 39 -> 512x8 -> 258 with the embedded input
re-concatenated at layer 4 (scaled 1/sqrt(2)), Softplus(beta=100)
activations, and a geometric init that makes the SDF approximate a sphere
of radius ``bias``. The spatial gradient is one ``torch.autograd.grad``
with ``create_graph=True`` and cotangent e0, so it stays differentiable
with respect to the parameters.

A hidden layer's bias and activation are one operator
(``bias_softplus100``, ``tracing/kernels/softplus100.py``), and so are
the activation's VJP in the spatial gradient and that VJP's in the loss's
backward: on the card each is one launch of the hand-written kernel of
``tracing/kernels/csrc/softplus100.cu``, elsewhere PyTorch's ops in the
order ``softplus100(x @ W + b)`` takes them.

With ``bf16_activations`` (the JAX package's: the encoded input, each
hidden activation and the skip's concatenation stored in bf16) a hidden
layer is one bf16 product (``mlp.bf16_linear``) and one launch of the
activation kernel (``bias_softplus100_bf16``), which writes h in bf16
itself: no f32 copy of an activation, no separate cast.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..tracing.kernels import softplus100 as SP
from .embedder import embed_dim, positional_encoding
from .mlp import WNLinear, linear_apply


@dataclasses.dataclass(frozen=True)
class ImplicitConfig:
    feature_vector_size: int = 256
    d_in: int = 3
    d_out: int = 1
    dims: Tuple[int, ...] = (512,) * 8
    geometric_init: bool = True
    bias: float = 0.6
    skip_in: Tuple[int, ...] = (4,)
    weight_norm: bool = True
    multires: int = 6
    # Store hidden activations in bf16; products and sums stay f32 (see
    # mlp.linear_apply).
    bf16_activations: bool = False
    # The JAX package's hand-derived value + gradient backward: kept so
    # the schema is JAX's, and refused when set (autograd's double
    # backward is the port's one path).
    fused_value_grad: bool = False

    def __post_init__(self):
        if self.fused_value_grad:
            raise ValueError("fused_value_grad: the port has one value + "
                             "gradient path, autograd's; leave it False")

    @property
    def layer_dims(self) -> Tuple[int, ...]:
        d0 = embed_dim(self.multires, self.d_in)
        return (d0,) + tuple(self.dims) + (
            self.d_out + 1 + self.feature_vector_size,)

    def layer_shapes(self):
        """(d_in, d_out) of each linear layer; a layer feeding a skip
        outputs dims[l+1] - dims[0] so the concat restores the width."""
        dims = self.layer_dims
        shapes = []
        for l in range(len(dims) - 1):
            out_dim = dims[l + 1] - dims[0] if (l + 1) in self.skip_in \
                else dims[l + 1]
            shapes.append((dims[l], out_dim))
        return shapes


class ImplicitNetwork(nn.Module):
    def __init__(self, cfg: ImplicitConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            WNLinear(i, o, cfg.weight_norm) for i, o in cfg.layer_shapes())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return implicit_apply(self, x)


def init_implicit(cfg: ImplicitConfig, rng: np.random.Generator
                  ) -> ImplicitNetwork:
    """Geometric init to an approximate sphere of radius cfg.bias, drawing
    from ``rng`` in the JAX package's order (same seed, same weights)."""
    net = ImplicitNetwork(cfg)
    n_layers = len(cfg.layer_dims)
    for l, (in_dim, out_dim) in enumerate(cfg.layer_shapes()):
        if cfg.geometric_init:
            if l == n_layers - 2:
                W = rng.normal(np.sqrt(np.pi) / np.sqrt(in_dim), 1e-4,
                               size=(out_dim, in_dim))
                b = np.full((out_dim,), -cfg.bias)
            elif cfg.multires > 0 and l == 0:
                W = np.zeros((out_dim, in_dim))
                W[:, :3] = rng.normal(0.0, np.sqrt(2) / np.sqrt(out_dim),
                                      size=(out_dim, 3))
                b = np.zeros((out_dim,))
            elif cfg.multires > 0 and l in cfg.skip_in:
                W = rng.normal(0.0, np.sqrt(2) / np.sqrt(out_dim),
                               size=(out_dim, in_dim))
                W[:, -(cfg.layer_dims[0] - 3):] = 0.0
                b = np.zeros((out_dim,))
            else:
                W = rng.normal(0.0, np.sqrt(2) / np.sqrt(out_dim),
                               size=(out_dim, in_dim))
                b = np.zeros((out_dim,))
        else:
            bound = 1.0 / np.sqrt(in_dim)
            W = rng.uniform(-bound, bound, size=(out_dim, in_dim))
            b = rng.uniform(-bound, bound, size=(out_dim,))
        net.layers[l].set_from_init(W, b)
    return net


class _Softplus100(torch.autograd.Function):
    """Softplus(beta=100), the kernels layer's plain expression
    (``SP.softplus100``), with the derivative sigmoid(100x)
    (``SP.grad_reference``). ``torch.logaddexp``'s own second derivative
    overflows to NaN for large negative inputs; this backward is built from
    differentiable ops, so the spatial gradient's parameter gradient (a
    double backward) stays finite."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return SP.softplus100(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return SP.grad_reference(grad, x)


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus(beta=100) in the stable ``logaddexp(0, 100x) / 100`` form,
    twice differentiable: the plain version the card tests and
    ``chip_smoke.py`` hold the activation kernel to."""
    return _Softplus100.apply(x)


def bias_softplus100(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """softplus100(y + b) for y (..., C) and the bias b (C,), through the
    operator ``mvsdf::softplus100_bias``: one kernel launch on the card,
    PyTorch's ops elsewhere. z = y + b is kept only where a gradient will
    be taken. The bias goes in broadcast to y's shape, so that its row sum
    is the expand's backward, which the spatial gradient's backward (taken
    for the points alone) skips."""
    keep_z = torch.is_grad_enabled() and (y.requires_grad or b.requires_grad)
    return SP.softplus100_bias(y, b.expand_as(y), keep_z)[1]


def bias_softplus100_bf16(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``bias_softplus100`` with the activation stored in bf16 (the
    operator's ``h_bf16``): softplus100(y + b).to(bfloat16) in one launch
    on the card."""
    keep_z = torch.is_grad_enabled() and (y.requires_grad or b.requires_grad)
    return SP.softplus100_bias(y, b.expand_as(y), keep_z, True)[1]


def bf16_rows(t: torch.Tensor) -> torch.Tensor:
    """``t.to(bfloat16)`` in one copy, as a view of rows padded to 16
    bytes (8 values): the tensor cores' products read a 39-wide encoded
    input at an aligned row stride, where its own 78 bytes would send
    them to a kernel for unaligned rows. The padding is never read."""
    d = t.shape[-1]
    out = t.new_empty(t.shape[:-1] + (-(-d // 8) * 8,),
                      dtype=torch.bfloat16)[..., :d]
    return out.copy_(t)


def implicit_apply(net: ImplicitNetwork, x: torch.Tensor) -> torch.Tensor:
    """x (..., 3) -> (..., 2 + feature_vector_size) f32:
    [sdf, surface-indicator logit, feature]."""
    cfg = net.cfg
    bf16 = cfg.bf16_activations
    inp = positional_encoding(x, cfg.multires)
    act = bias_softplus100
    if bf16:
        inp = bf16_rows(inp)
        act = bias_softplus100_bf16
    h = inp
    n_layers = len(net.layers)
    for l, layer in enumerate(net.layers):
        if l in cfg.skip_in:
            # bf16 in, bf16 out where the activations are
            h = torch.cat([h, inp], dim=-1) / np.sqrt(2)
        if l < n_layers - 1:
            h = linear_apply(layer, h, act)
        else:
            h = layer(h)
    return h


def sdf_apply(net: ImplicitNetwork, x: torch.Tensor) -> torch.Tensor:
    """x (..., 3) -> sdf (...,)."""
    return implicit_apply(net, x)[..., 0]


def full_value_and_grad(net: ImplicitNetwork, x: torch.Tensor):
    """(full output (..., 2+F), spatial SDF gradient (..., 3)) from one
    forward pass. When grad mode is on, the gradient keeps its graph
    (``create_graph=True``) so losses on it reach the parameters and, if
    ``x`` itself requires grad, whatever ``x`` was computed from. Under
    ``torch.no_grad()`` both results come back detached."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if (create and x.requires_grad) else \
            x.detach().requires_grad_(True)
        out = implicit_apply(net, xg)
        (g,) = torch.autograd.grad(out[..., 0].sum(), xg,
                                   create_graph=create)
    if not create:
        out = out.detach()
    return out, g
