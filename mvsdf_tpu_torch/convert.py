"""Parameter conversion between the JAX package's params pytree and the
port's state dict.

The JAX pytree is ``{"implicit": [layer, ...], "render": [layer, ...]}``
with each layer ``{"v": (d_in, d_out), "g": (d_out,), "b": (d_out,)}`` (or
``{"w", "b"}`` without weight norm), as numpy arrays. The port keeps the
same layout, so the state dict key of ``params["implicit"][l]["v"]`` is
``implicit.layers.{l}.v``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

NETS = ("implicit", "render")


def params_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy arrays) -> the port's state dict
    (``MVSDFNetwork.load_state_dict``)."""
    state = {}
    for net in NETS:
        for l, layer in enumerate(params_np[net]):
            for k, a in layer.items():
                state[f"{net}.layers.{l}.{k}"] = torch.from_numpy(
                    np.array(a, dtype=np.float32))
    return state


def params_to_jax(state_dict) -> dict:
    """The port's state dict -> JAX params pytree of numpy arrays."""
    out = {net: [] for net in NETS}
    for key, t in state_dict.items():
        net, _, l, k = key.split(".")
        layers = out[net]
        while len(layers) <= int(l):
            layers.append({})
        layers[int(l)][k] = t.detach().cpu().numpy()
    return out
