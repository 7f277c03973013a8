"""Parameter conversion between the JAX package's params pytrees and the
port's state dicts: the SDF and radiance MLPs both ways, the frozen
FeatExt CNN (``featext_params_from_jax``), and the camera-optimisation
state (``cam_state_from_jax``).

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


def cam_state_from_jax(pose_vecs, cam_opt, device="cpu"):
    """The JAX package's ``TrainState.pose_vecs`` (n, 7) and
    ``cam_opt`` (``SparseAdamState``: m, v, step), as numpy arrays or
    anything ``np.asarray`` takes -> (pose_vecs, the port's
    ``SparseAdamState``), tensors on ``device``."""
    from .train.cameras_opt import SparseAdamState
    t = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt)).to(device)
    m, v, step = cam_opt
    return t(pose_vecs, np.float32), SparseAdamState(
        m=t(m, np.float32), v=t(v, np.float32), step=t(step, np.int32))


def _bn_from_jax(p, prefix):
    return {prefix + ".weight": p["gamma"], prefix + ".bias": p["beta"],
            prefix + ".running_mean": p["mean"],
            prefix + ".running_var": p["var"]}


def _block_from_jax(p, prefix):
    sd = {prefix + ".conv1.weight": p["conv1"],
          **_bn_from_jax(p["bn1"], prefix + ".bn1"),
          prefix + ".conv2.weight": p["conv2"],
          **_bn_from_jax(p["bn2"], prefix + ".bn2")}
    if "down_conv" in p:
        sd[prefix + ".downsample.0.weight"] = p["down_conv"]
        sd.update(_bn_from_jax(p["down_bn"], prefix + ".downsample.1"))
    return sd


def featext_params_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """The JAX package's FeatExt parameter tree (``init_feat_ext`` /
    ``from_torch_state`` layout, numpy arrays) -> the port's ``FeatExt``
    state dict (the reference's key names; ``load_state_dict``-ready)."""
    from .data.featext import DEC_NAMES, ENC_NAMES
    sd = {"init_conv.0.weight": params_np["stem_conv"],
          **_bn_from_jax(params_np["stem_bn"], "init_conv.1")}
    for name, blocks in zip(ENC_NAMES, params_np["enc"]):
        for b, p in enumerate(blocks):
            sd.update(_block_from_jax(p, f"unet.enc_blocks.{name}.{b}"))
    for name, dec in zip(DEC_NAMES, params_np["dec"]):
        prefix = f"unet.dec_blocks.{name}"
        sd[prefix + ".0.weight"] = dec["deconv"]
        sd[prefix + ".1.weight"] = dec["post"]
        sd.update(_block_from_jax(dec["res"][0], prefix + ".2.0"))
    for i in (1, 2, 3):
        sd[f"final_conv_{i}.weight"] = params_np[f"head{i}"]
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32))
           for k, v in sd.items()}
    out.update({k[:-len("running_var")] + "num_batches_tracked":
                torch.zeros((), dtype=torch.int64)
                for k in sd if k.endswith(".running_var")})
    return out
