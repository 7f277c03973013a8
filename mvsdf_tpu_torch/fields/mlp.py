"""Weight-normalized linear layers (port of ``mvsdf_tpu/fields/mlp.py``).

Weight normalization follows ``nn.utils.weight_norm`` (dim=0) semantics: the
effective weight of output row o is ``g[o] * V[o] / ||V[o]||``. V is stored
transposed as (d_in, d_out), the JAX package's layout, so parameters convert
one to one (``convert.params_from_jax``) and the forward is ``x @ W + b``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..tracing.kernels.counts import HostCount


class WNLinear(nn.Module):
    """Linear layer with parameters ``v`` (d_in, d_out), ``g`` (d_out,),
    ``b`` (d_out,); or ``w`` (d_in, d_out), ``b`` without weight norm."""

    def __init__(self, d_in: int, d_out: int, weight_norm: bool = True):
        super().__init__()
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(d_in, d_out))
            self.g = nn.Parameter(torch.empty(d_out))
        else:
            self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.empty(d_out))

    @torch.no_grad()
    def set_from_init(self, W, b):
        """Set from a raw init weight W (d_out, d_in) and bias b (d_out,):
        ``g = ||W[o]||`` and ``V = W`` so the effective weight equals W."""
        W = np.asarray(W, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        if self.weight_norm:
            self.v.copy_(torch.from_numpy(np.ascontiguousarray(W.T)))
            self.g.copy_(torch.from_numpy(np.linalg.norm(W, axis=1)))
        else:
            self.w.copy_(torch.from_numpy(np.ascontiguousarray(W.T)))
        self.b.copy_(torch.from_numpy(b))

    def effective_weight(self) -> torch.Tensor:
        """(d_in, d_out) effective weight; the norm is clipped at 1e-12."""
        if self.weight_norm:
            norm = torch.linalg.vector_norm(self.v, dim=0, keepdim=True)
            return self.v * (self.g[None, :] / norm.clamp_min(1e-12))
        return self.w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_apply(self, x)


def linear_apply(layer: WNLinear, x: torch.Tensor,
                 act=None) -> torch.Tensor:
    """x (..., d_in) -> (..., d_out) in f32: ``x @ W + b``, or with ``act``
    ``act(x @ W, b)``, an activation that adds the bias itself. A bf16
    input selects the bf16 path (``bf16_linear``): the weight rounded to
    bf16, products and sums in f32 (a product of two bf16 values is exact
    in f32), as JAX's ``dot_general`` with
    ``preferred_element_type=float32``.
    """
    W = layer.effective_weight()
    if x.dtype == torch.bfloat16:
        w16 = W.to(torch.bfloat16)
        y = bf16_linear(x, w16.float(), w16)
    else:
        y = x @ W
    return y + layer.b if act is None else act(y, layer.b)


# rows contracted by the bf16 products on the card (one count a row of
# each launch), carried through CUDA-graph replays by
# ``tracing/kernels/counts`` as ``bf16_gemm_rows``
BF16_GEMM_ROWS = HostCount()


@torch.library.custom_op("mvsdf::bf16_linear", mutates_args=(),
                         schema="(Tensor x, Tensor w, Tensor w16) -> Tensor")
def bf16_linear(x, w, w16):
    """x (..., K) bf16 times the bf16 weight (K, N) -> (..., N) f32,
    summed in f32. ``w16`` is the weight in bf16, ``w`` the same values
    in f32 (what the gradient reaches). Off the card the plain version:
    the f32 product of x's f32 copy and ``w``. On the card one bf16
    tensor-core product (cuBLAS, f32 output; no f32 copy of x).
    Differentiable twice: x's gradient (dy @ w^T, rounded to bf16 as the
    cotangent of a bf16 tensor is) and w's (x^T @ dy) are f32 products
    at the process's matmul precision, as the plain version's autograd
    takes them."""
    return torch.matmul(x.float(), w)


@bf16_linear.register_kernel("cuda")
def _(x, w, w16):
    K, N = w16.shape
    x2 = x.reshape(-1, K)
    y = torch.ops.aten.mm.dtype(x2, w16, torch.float32)
    BF16_GEMM_ROWS.launches += x2.shape[0]
    return y.reshape(x.shape[:-1] + (N,))


@bf16_linear.register_fake
def _(x, w, w16):
    return x.new_empty(x.shape[:-1] + w.shape[1:], dtype=torch.float32)


def _linear_setup(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w)


def _runs(ctx, i: int) -> bool:
    """Whether this backward pass reaches input i's gradient: the input
    needs one and the engine runs the node it goes to. The spatial
    gradient's pass (taken for the points alone) skips w's product, as
    autograd's own matmul does."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if node is None:
        return False
    # the engine does not say this of a leaf's node: take it
    return node.name() == "torch::autograd::AccumulateGrad" or \
        torch._C._will_engine_execute_node(node)


def _linear_backward(ctx, gy):
    x, w = ctx.saved_tensors
    K, N = w.shape
    g2 = gy.reshape(-1, N)
    dx = dw = None
    if _runs(ctx, 0):
        dx = g2.mm(w.t()).reshape(x.shape).to(torch.bfloat16)
    if _runs(ctx, 1):
        dw = x.reshape(-1, K).float().t().mm(g2)
    return dx, dw, None


bf16_linear.register_autograd(_linear_backward, setup_context=_linear_setup)


def torch_linear_default_init(rng: np.random.Generator, d_in, d_out):
    """nn.Linear default init: W, b ~ U(-1/sqrt(d_in), 1/sqrt(d_in)), drawn
    from ``rng`` in the JAX package's order. Returns W (d_out, d_in), b."""
    bound = 1.0 / np.sqrt(d_in)
    W = rng.uniform(-bound, bound, size=(d_out, d_in))
    b = rng.uniform(-bound, bound, size=(d_out,))
    return W, b
