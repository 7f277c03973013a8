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


def linear_apply(layer: WNLinear, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) -> (..., d_out) in f32. A bf16 input selects the bf16
    path: input and weight rounded to bf16, products and sums in f32 (a
    product of two bf16 values is exact in f32), as JAX's ``dot_general``
    with ``preferred_element_type=float32``."""
    W = layer.effective_weight()
    if x.dtype == torch.bfloat16:
        return x.float() @ W.to(torch.bfloat16).float() + layer.b
    return x @ W + layer.b


def torch_linear_default_init(rng: np.random.Generator, d_in, d_out):
    """nn.Linear default init: W, b ~ U(-1/sqrt(d_in), 1/sqrt(d_in)), drawn
    from ``rng`` in the JAX package's order. Returns W (d_out, d_in), b."""
    bound = 1.0 / np.sqrt(d_in)
    W = rng.uniform(-bound, bound, size=(d_out, d_in))
    b = rng.uniform(-bound, bound, size=(d_out,))
    return W, b
