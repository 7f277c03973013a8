"""A cell's initial weights, made from ``--seed`` on the run's device with a
``torch.Generator`` and handed alike to the program and to the reference.

The layout is the program's module state (``implicit.layers.<l>.{v, g,
b}`` and ``render.layers.<l>.{v, g, b}``: weight norm as ``v`` (d_in,
d_out), ``g`` = the column norms of ``v``, bias ``b``). The SDF network
takes the geometric init of IDR (an SDF close to a sphere of radius
``bias``), the radiance network ``nn.Linear``'s default uniform init, as
the MVSDF reference does.
"""
from __future__ import annotations

import math

import torch


def embed_dim(multires: int, d: int = 3) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def implicit_shapes(icfg: dict):
    """(d_in, d_out) of each SDF layer: a layer that feeds a skip gives
    dims[l + 1] - dims[0] outputs, so the concatenation restores the
    width."""
    d0 = embed_dim(icfg["multires"])
    dims = [d0] + list(icfg["dims"]) + [icfg["d_out"] + 1 +
                                        icfg["feature_vector_size"]]
    return [(dims[l], dims[l + 1] - d0 if l + 1 in icfg["skip_in"]
             else dims[l + 1]) for l in range(len(dims) - 1)]


def render_shapes(rcfg: dict):
    d0 = rcfg["d_in"] + rcfg["feature_vector_size"] + \
        embed_dim(rcfg["multires_view"]) - 3
    dims = [d0] + list(rcfg["dims"]) + [rcfg["d_out"]]
    return [(dims[l], dims[l + 1]) for l in range(len(dims) - 1)]


def make_weights(model: dict, seed: int, device) -> dict:
    """{name: f32 tensor on ``device``} for the configuration's ``model``
    entry, drawn from a generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    icfg, rcfg = model["implicit"], model["render"]
    shapes = implicit_shapes(icfg)
    d_pe = embed_dim(icfg["multires"])
    out = {}
    # every standard normal of the SDF network in one draw
    sizes = [o * (3 if l == 0 else i) for l, (i, o) in enumerate(shapes)]
    normal = torch.randn(sum(sizes), generator=gen, **f32).split(sizes)
    for l, ((i, o), z) in enumerate(zip(shapes, normal)):
        if l == len(shapes) - 1:
            W = z.reshape(o, i) * 1e-4 + math.sqrt(math.pi) / math.sqrt(i)
            b = torch.full((o,), -icfg["bias"], **f32)
        else:
            std = math.sqrt(2) / math.sqrt(o)
            if l == 0:
                W = torch.zeros(o, i, **f32)
                W[:, :3] = z.reshape(o, 3) * std
            else:
                W = z.reshape(o, i) * std
                if l in icfg["skip_in"]:
                    W[:, -(d_pe - 3):] = 0.0
            b = torch.zeros(o, **f32)
        _put(out, f"implicit.layers.{l}", W, b)
    rshapes = render_shapes(rcfg)
    sizes = [o * i + o for i, o in rshapes]
    uniform = torch.rand(sum(sizes), generator=gen, **f32).split(sizes)
    for l, ((i, o), u) in enumerate(zip(rshapes, uniform)):
        bound = 1.0 / math.sqrt(i)
        u = u * (2 * bound) - bound
        _put(out, f"render.layers.{l}", u[:o * i].reshape(o, i), u[o * i:])
    return out


def _put(out, prefix, W, b):
    out[prefix + ".v"] = W.T.contiguous()
    out[prefix + ".g"] = torch.linalg.vector_norm(W, dim=1)
    out[prefix + ".b"] = b.contiguous()
