"""Implicit-function differentiation of the ray-SDF intersection (port of
``mvsdf_tpu/rendering/implicit_diff.py``):

    t(theta) = t0 - (f_theta(x0) - sg[f_theta0(x0)]) / sg[grad f . v]
    x(theta) = c + t(theta) * v

At the current parameters t(theta) == t0; its derivative is the implicit
function gradient.
"""
from __future__ import annotations

import torch


def differentiable_surface_points(sdf_vals, sdf_vals_detached, grads_detached,
                                  dists, cam_loc, ray_dirs, valid_mask=None,
                                  min_dot: float = 0.0):
    """Per-ray inputs with any leading shape, (L...,) / (L..., 3).

    valid_mask guards the division on lanes that did not hit a surface;
    min_dot > 0 clamps |grad . dir| away from zero (0 = reference-exact)."""
    dot = torch.sum(grads_detached * ray_dirs.detach(), dim=-1)
    if min_dot > 0.0:
        clamp = torch.where(dot < 0, -min_dot, min_dot).to(dot.dtype)
        dot = torch.where(dot.abs() < min_dot, clamp, dot)
    if valid_mask is not None:
        dot = torch.where(valid_mask, dot, torch.ones_like(dot))
    dists_theta = dists - (sdf_vals - sdf_vals_detached) / dot
    return cam_loc + dists_theta[..., None] * ray_dirs
