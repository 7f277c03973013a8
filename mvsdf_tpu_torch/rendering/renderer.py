"""Differentiable SDF renderer (port of ``mvsdf_tpu/rendering/renderer.py``).

Layout is (B, P): B images per batch, P rays per image. Sample groups that
feed the carving and eikonal losses:
  rt_surf       SDF + grad at the traced ray points (mask = surface hits)
  eik           uniform random points in the bounding cube, B*P//2 of them
  dsurf_on      MVS depth maps unprojected to world, unit-normalized (phase A)
  dsurf_jitter  same points + U(-0.1, 0.1) jitter (phase A)

The trace runs under ``torch.no_grad()`` on the current parameters, through
the fused SDF-MLP kernel when ``ModelConfig.use_pallas_trace`` is set.
Random draws come from a ``torch.Generator``; the ``noise=`` dict replays
given draws instead (``minimal_steps``, ``eik_points``,
``dsurf_jitter_noise``, ``dsurf_on_idx``, ``dsurf_jitter_idx``) so tests can
feed the JAX package and this port identical randomness.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..compaction import compact_call_into
from ..config import Gates, ModelConfig
from ..fields.embedder import positional_encoding
from ..fields.network import MVSDFNetwork
from ..fields.radiance import render_apply
from ..fields.sdf import full_value_and_grad, implicit_apply, sdf_apply
from ..geometry import projections as proj
from ..geometry.cameras import get_camera_params
from ..tracing.kernels.sdf_mlp import pack_sdf_weights, sdf_mlp
from ..tracing.sphere_trace import TraceResult, trace_rays
from .implicit_diff import differentiable_surface_points


class RenderOut(NamedTuple):
    points: torch.Tensor                 # (B, P, 3) traced/filled ray points
    rgb_values: torch.Tensor             # (B, P, 3); non-hits = 1
    sdf_output: torch.Tensor             # (B, P) live-gradient SDF at points
    network_object_mask: torch.Tensor    # (B, P) bool
    object_mask: torch.Tensor            # (B, P) bool (ones if use_mask off)
    object_mask_true: torch.Tensor       # (B, P) bool (the real mask)
    surface_mask: torch.Tensor           # (B, P) bool: differentiable surface
    dists: torch.Tensor                  # (B, P)
    diff_surf_pts: torch.Tensor          # (B, P, 3) implicit-diff points
    groups: Optional[Dict]               # sample groups (training only)
    surf_logits_pos: Optional[torch.Tensor]       # (B, P) indicator logits
    surf_logits_pos_mask: Optional[torch.Tensor]  # (B, P) bool label-1 lanes
    surf_logits_neg: Optional[torch.Tensor]       # (B, P//2) eik logits


def _unproject_depth_maps(depths, depth_cams):
    """depths (N, 1, h, w), depth_cams (N, 2, 4, 4) -> world points
    (N, h, w, 3) + validity (N, h, w)."""
    _, _, h, w = depths.shape
    grid = proj.pixel_grid(h, w, device=depths.device)   # (h, w, 3)
    cams = depth_cams[:, None, None]                     # (N, 1, 1, 2, 4, 4)
    d = depths[:, 0]
    pc = proj.img_to_cam(grid, d, cams)
    pw = proj.cam_to_world(pc, cams)
    return pw[..., :3], d > 0


def _sample_masked(points, valid, n, generator):
    """Uniformly sample n rows of ``points`` among ``valid`` without
    replacement: top-k of uniform scores, -1 on invalid rows. Returns
    (pts (n, 3), ok (n,) bool)."""
    u = torch.rand(points.shape[0], generator=generator,
                   device=points.device)
    score = torch.where(valid, u, torch.full_like(u, -1.0))
    idx = torch.topk(score, n).indices
    return points[idx], valid[idx]


def _dsurf_samples(cfg: ModelConfig, inputs, n_dsurf, generator, noise):
    """Depth-surface sample groups. Returns flat (n_dsurf, 3) arrays +
    validity for the on-surface and jittered groups."""
    depths = inputs["depths"]        # (B, V, 1, h, w)
    cams = inputs["depth_cams"]      # (B, V, 2, 4, 4)
    center = inputs["center"].reshape(-1, 3)[0]
    size = inputs["size"].reshape(-1)[0]
    pts, valid = _unproject_depth_maps(depths.flatten(0, 1),
                                       cams.flatten(0, 1))
    pts = pts.reshape(-1, 3)
    valid = valid.reshape(-1)
    pts_norm = (pts - center) / size * 2.0
    r = cfg.tracer.object_bounding_sphere
    jitter_rad = 0.1
    if noise and "dsurf_jitter_noise" in noise:
        jn = noise["dsurf_jitter_noise"]
    else:
        jn = torch.rand(pts_norm.shape, generator=generator,
                        device=pts_norm.device) * 2 * jitter_rad - jitter_rad
    pts_jit = pts_norm + jn
    out = []
    for p, idx_key in ((pts_norm, "dsurf_on_idx"),
                       (pts_jit, "dsurf_jitter_idx")):
        if noise and idx_key in noise:
            idx = noise[idx_key]
            out.append((p[idx], torch.ones(idx.shape[0], dtype=torch.bool,
                                           device=p.device)))
            continue
        inb = torch.sum((p.abs() < r).float(), -1) > 2.9
        out.append(_sample_masked(p, valid & inb, n_dsurf, generator))
    (on_pts, on_ok), (ji_pts, ji_ok) = out
    return on_pts, on_ok, ji_pts, ji_ok


def _frozen_trace(cfg: ModelConfig, net: MVSDFNetwork, org, dirs,
                  object_mask, training, min_steps) -> TraceResult:
    """The no-grad trace on the current parameters, through the fused
    SDF-MLP kernel when cfg.use_pallas_trace is set."""
    if cfg.use_pallas_march or cfg.use_pallas_secant or \
            cfg.pallas_in_kernel_pe:
        raise NotImplementedError(
            "the fused march, fused secant and in-kernel PE kernels are not "
            "ported yet")
    with torch.no_grad():
        if cfg.use_pallas_trace:
            packed = pack_sdf_weights(net.implicit)
            multires = net.implicit.cfg.multires

            def sdf_fn(x):
                pe = positional_encoding(x.reshape(-1, 3), multires)
                return sdf_mlp(packed, pe).reshape(x.shape[:-1])
        else:
            def sdf_fn(x):
                return sdf_apply(net.implicit, x)
        return trace_rays(cfg.tracer, sdf_fn, org, dirs, object_mask,
                          training=training, minimal_steps=min_steps)


def render_forward(cfg: ModelConfig, net: MVSDFNetwork, inputs, *,
                   training: bool, gates: Gates = Gates(),
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[dict] = None) -> RenderOut:
    """One renderer forward pass over a batch of pixel rays.

    inputs: uv (B, P, 2), intrinsics (B, 4, 4), pose (B, 4, 4) | (B, 7),
    object_mask (B, P); plus depths / depth_cams / center / size when the
    dsurf groups are gated on. Training mode needs ``generator`` or a
    ``noise`` dict holding every draw it makes."""
    tcfg = cfg.tracer
    uv = inputs["uv"]
    B, P, _ = uv.shape
    dev = uv.device

    object_mask_true = inputs["object_mask"].reshape(B, P).bool()
    object_mask = object_mask_true if cfg.use_mask else torch.ones(
        (B, P), dtype=torch.bool, device=dev)
    ray_dirs, cam_loc = get_camera_params(uv, inputs["pose"],
                                          inputs["intrinsics"])
    org = cam_loc[:, None, :].expand(B, P, 3)

    def need_generator(what):
        if generator is None:
            raise ValueError(f"training render_forward needs a generator "
                             f"or noise[{what!r}]")
        return generator

    if noise and "minimal_steps" in noise:
        min_steps = noise["minimal_steps"]
    elif training:
        min_steps = torch.rand(tcfg.n_steps,
                               generator=need_generator("minimal_steps"),
                               device=dev)
    else:
        min_steps = None
    tr = _frozen_trace(cfg, net, org.detach(), ray_dirs.detach(),
                       object_mask, training, min_steps)
    dists = tr.dists.detach()
    net_obj_mask = tr.network_object_mask
    points = org + dists[..., None] * ray_dirs

    groups = None
    surf_logits_pos = surf_logits_pos_mask = surf_logits_neg = None
    if training:
        surface_mask = net_obj_mask & object_mask
        r = tcfg.object_bounding_sphere
        if noise and "eik_points" in noise:
            eik_pts = noise["eik_points"].reshape(B, P // 2, 3)
        else:
            eik_pts = torch.rand((B, P // 2, 3),
                                 generator=need_generator("eik_points"),
                                 device=dev) * (2 * r) - r
        ones = torch.ones((B, P // 2), device=dev)
        group_list = [("rt_surf", points, surface_mask.float()),
                      ("eik", eik_pts, ones)]
        if gates.use_dsurf:
            if generator is None:
                for nk in ("dsurf_jitter_noise", "dsurf_on_idx",
                           "dsurf_jitter_idx"):
                    if not noise or nk not in noise:
                        raise ValueError(
                            f"noise-replay dsurf sampling needs {nk!r}")
            on_pts, on_ok, ji_pts, ji_ok = _dsurf_samples(
                cfg, inputs, (B * P) // 2, generator, noise)
            group_list.append(("dsurf_on", on_pts.reshape(B, P // 2, 3),
                               on_ok.reshape(B, P // 2).float()))
            group_list.append(("dsurf_jitter", ji_pts.reshape(B, P // 2, 3),
                               ji_ok.reshape(B, P // 2).float()))

        if cfg.supervised_compact_frac:
            # Every consumer of the rt_surf group masks non-surface lanes to
            # zero, so its value + gradient run on the surface lanes only;
            # the other lanes hold zeros. Only the SDF and indicator columns
            # are needed at full size.
            N = B * P

            def sdf_logit_grad(p):
                out, g = full_value_and_grad(net.implicit, p)
                return out[..., :2], g

            o_flat, gr_flat = compact_call_into(
                sdf_logit_grad, surface_mask.reshape(N),
                [points.reshape(N, 3)],
                [torch.zeros((N, 2), device=dev),
                 torch.zeros((N, 3), device=dev)])
            full_out = o_flat.reshape(B, P, 2)
            g_rt = gr_flat.reshape(B, P, 3)
            groups = {"rt_surf": {"points": points, "sdf": full_out[..., 0],
                                  "grad": g_rt,
                                  "mask": surface_mask.float()}}
            rest = group_list[1:]
            rest_out, rest_g = full_value_and_grad(
                net.implicit, torch.cat([p for _, p, _ in rest], dim=1))
            off = 0
            for name, pts, mask in rest:
                sl = slice(off, off + pts.shape[1])
                groups[name] = {"points": pts, "sdf": rest_out[:, sl, 0],
                                "grad": rest_g[:, sl], "mask": mask}
                off += pts.shape[1]
            eik_out = rest_out[:, :P // 2]
        else:
            # one forward for every sample group, concatenated on the ray
            # axis
            all_out, all_g = full_value_and_grad(
                net.implicit, torch.cat([p for _, p, _ in group_list],
                                        dim=1))
            groups = {}
            off = 0
            for name, pts, mask in group_list:
                sl = slice(off, off + pts.shape[1])
                groups[name] = {"points": pts, "sdf": all_out[:, sl, 0],
                                "grad": all_g[:, sl], "mask": mask}
                off += pts.shape[1]
            full_out = all_out[:, :P]
            eik_out = all_out[:, P:P + P // 2]
        sdf_output = full_out[..., 0]
        surf_logits_pos = full_out[..., 1]
        surf_logits_pos_mask = surface_mask & object_mask_true
        surf_logits_neg = eik_out[..., 1]
        diff_surf_pts = differentiable_surface_points(
            sdf_output, sdf_output.detach(),
            groups["rt_surf"]["grad"].detach(), dists, org, ray_dirs,
            valid_mask=surface_mask, min_dot=cfg.implicit_diff_min_dot)
    else:
        sdf_output = implicit_apply(net.implicit, points)[..., 0]
        surface_mask = net_obj_mask
        diff_surf_pts = points

    # --- shading ---------------------------------------------------------
    view = -ray_dirs
    detach_geo = (training and gates.detach_geometry_for_rgb) or \
        cfg.disable_rgb_grad

    def shade(p, v):
        out_s, nrm = full_value_and_grad(net.implicit, p)
        feats = out_s[..., 2:]
        if detach_geo:
            p, nrm, v = p.detach(), nrm.detach(), v.detach()
        return (render_apply(net.render, p, nrm, v, feats),)

    if training and cfg.supervised_compact_frac:
        # shading reads only surface lanes; the rest keep rgb = 1
        N = B * P
        sm_flat = surface_mask.reshape(N)
        (rgb_flat,) = compact_call_into(
            shade, sm_flat, [diff_surf_pts.reshape(N, 3), view.reshape(N, 3)],
            [torch.ones((N, 3), device=dev)], out_masks=[sm_flat])
        rgb_values = rgb_flat.reshape(B, P, 3)
    else:
        (rgb,) = shade(diff_surf_pts, view)
        rgb_values = torch.where(surface_mask[..., None], rgb,
                                 torch.ones_like(rgb))

    return RenderOut(
        points=points, rgb_values=rgb_values, sdf_output=sdf_output,
        network_object_mask=net_obj_mask, object_mask=object_mask,
        object_mask_true=object_mask_true, surface_mask=surface_mask,
        dists=dists, diff_surf_pts=diff_surf_pts, groups=groups,
        surf_logits_pos=surf_logits_pos,
        surf_logits_pos_mask=surf_logits_pos_mask,
        surf_logits_neg=surf_logits_neg)
