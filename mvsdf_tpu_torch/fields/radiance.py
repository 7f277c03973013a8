"""Surface light-field MLP (port of ``mvsdf_tpu/fields/radiance.py``):
(point, normal, view dir, feature) -> RGB in [-1, 1]. Input concat
[point, PE(view_dir), normal, feature] in mode 'idr', 4 hidden layers of 512
with ReLU, tanh output, weight norm, nn.Linear-default init.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .embedder import embed_dim, positional_encoding
from .mlp import WNLinear, torch_linear_default_init


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    feature_vector_size: int = 256
    mode: str = "idr"  # 'idr' | 'no_view_dir' | 'no_normal'
    d_in: int = 9
    d_out: int = 3
    dims: Tuple[int, ...] = (512,) * 4
    weight_norm: bool = True
    multires_view: int = 4

    @property
    def layer_dims(self) -> Tuple[int, ...]:
        d0 = self.d_in + self.feature_vector_size
        if self.multires_view > 0:
            d0 += embed_dim(self.multires_view, 3) - 3
        return (d0,) + tuple(self.dims) + (self.d_out,)


class RenderingNetwork(nn.Module):
    def __init__(self, cfg: RenderConfig):
        super().__init__()
        self.cfg = cfg
        dims = cfg.layer_dims
        self.layers = nn.ModuleList(
            WNLinear(dims[l], dims[l + 1], cfg.weight_norm)
            for l in range(len(dims) - 1))

    def forward(self, points, normals, view_dirs, features):
        return render_apply(self, points, normals, view_dirs, features)


def init_render(cfg: RenderConfig, rng: np.random.Generator
                ) -> RenderingNetwork:
    net = RenderingNetwork(cfg)
    dims = cfg.layer_dims
    for l in range(len(dims) - 1):
        W, b = torch_linear_default_init(rng, dims[l], dims[l + 1])
        net.layers[l].set_from_init(W, b)
    return net


def render_apply(net: RenderingNetwork, points, normals, view_dirs,
                 features) -> torch.Tensor:
    """All inputs (..., d); returns RGB (..., 3) in [-1, 1]."""
    cfg = net.cfg
    if cfg.multires_view > 0:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    if cfg.mode == "idr":
        h = torch.cat([points, view_dirs, normals, features], dim=-1)
    elif cfg.mode == "no_view_dir":
        h = torch.cat([points, normals, features], dim=-1)
    elif cfg.mode == "no_normal":
        h = torch.cat([points, view_dirs, features], dim=-1)
    else:
        raise ValueError(f"unknown mode {cfg.mode}")
    n_layers = len(net.layers)
    for l, layer in enumerate(net.layers):
        h = layer(h)
        if l < n_layers - 1:
            h = torch.relu(h)
    return torch.tanh(h)
