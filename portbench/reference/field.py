"""The two fields of MVSDF, plain PyTorch over a dict of parameters in the
program's state-dict layout (``<net>.layers.<l>.{v, g, b}``, weight norm
over the input axis of ``v`` (d_in, d_out)).

- SDF network (IDR's ImplicitNetwork): positional encoding of ``multires``
  frequencies, weight-normalized linear layers with Softplus(beta=100),
  the encoded input concatenated again before each layer in ``skip_in``
  (scaled by 1/sqrt(2)); outputs [sdf, indicator logit, features].
- Radiance network (IDR's RenderingNetwork, mode 'idr'): [point, encoded
  view direction, normal, features] through ReLU layers, tanh output.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    if multires <= 0:
        return x
    parts = [x]
    for i in range(multires):
        parts += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(parts, -1)


def linear(params: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    v, g = params[prefix + ".v"], params[prefix + ".g"]
    W = v * (g / torch.linalg.vector_norm(v, dim=0).clamp_min(1e-12))
    return x @ W + params[prefix + ".b"]


def n_layers(params: dict, net: str) -> int:
    return sum(k.startswith(net + ".layers.") and k.endswith(".b")
               for k in params)


def sdf_net(params: dict, icfg: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., 3) -> (..., 2 + features)."""
    pe = encode(x, icfg["multires"])
    h = pe
    n = n_layers(params, "implicit")
    for l in range(n):
        if l in icfg["skip_in"]:
            h = torch.cat([h, pe], -1) / math.sqrt(2)
        h = linear(params, f"implicit.layers.{l}", h)
        if l < n - 1:
            h = F.softplus(h, beta=100)
    return h


def sdf_value(params: dict, icfg: dict, x: torch.Tensor) -> torch.Tensor:
    return sdf_net(params, icfg, x)[..., 0]


def value_and_grad(params: dict, icfg: dict, x: torch.Tensor):
    """(outputs (..., 2 + features), spatial SDF gradient (..., 3)); the
    gradient keeps its graph, so losses on it reach the parameters and, if
    ``x`` requires grad, what ``x`` was made from."""
    xg = x if x.requires_grad else x.detach().requires_grad_(True)
    out = sdf_net(params, icfg, xg)
    (g,) = torch.autograd.grad(out[..., 0].sum(), xg, create_graph=True)
    return out, g


def radiance(params: dict, rcfg: dict, points, normals, view_dirs, feats):
    h = torch.cat([points, encode(view_dirs, rcfg["multires_view"]), normals,
                   feats], -1)
    n = n_layers(params, "render")
    for l in range(n):
        h = linear(params, f"render.layers.{l}", h)
        h = torch.relu(h) if l < n - 1 else torch.tanh(h)
    return h
