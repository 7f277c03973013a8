"""NeRF-style positional encoding (port of ``mvsdf_tpu/fields/embedder.py``).

output = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]
"""
from __future__ import annotations

import torch


def embed_dim(multires: int, d_in: int = 3) -> int:
    if multires <= 0:
        return d_in
    return d_in * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """x (..., d) -> (..., d * (1 + 2*multires)). Identity if multires <= 0."""
    if multires <= 0:
        return x
    parts = [x]
    for i in range(multires):
        xf = x * (2.0 ** i)
        parts.append(torch.sin(xf))
        parts.append(torch.cos(xf))
    return torch.cat(parts, dim=-1)
