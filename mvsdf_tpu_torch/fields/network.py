"""The two MLPs of a model as one module: ``implicit`` (geometry) and
``render`` (radiance). Its state dict is what ``convert.params_from_jax``
produces."""
from __future__ import annotations

from torch import nn

from .radiance import RenderConfig, RenderingNetwork
from .sdf import ImplicitConfig, ImplicitNetwork


class MVSDFNetwork(nn.Module):
    def __init__(self, implicit_cfg: ImplicitConfig,
                 render_cfg: RenderConfig):
        super().__init__()
        self.implicit = ImplicitNetwork(implicit_cfg)
        self.render = RenderingNetwork(render_cfg)
