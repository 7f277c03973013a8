"""Differentiable SDF renderer (port of ``mvsdf_tpu/rendering/renderer.py``).

Layout is (B, P): B images per batch, P rays per image. Sample groups that
feed the carving and eikonal losses:
  rt_surf       SDF + grad at the traced ray points (mask = surface hits)
  eik           uniform random points in the bounding cube, B*P//2 of them
  dsurf_on      MVS depth maps unprojected to world, unit-normalized (phase A)
  dsurf_jitter  same points + U(-0.1, 0.1) jitter (phase A)

The trace runs under ``torch.no_grad()`` on the current parameters, through
the fused SDF-MLP kernel when ``ModelConfig.use_pallas_trace`` is set, and
then through the fused march and secant kernels and the in-kernel
positional encoding where their flags ask for them.
Random draws come from a ``torch.Generator``; the ``noise=`` dict replays
given draws instead (``minimal_steps``, ``eik_points``,
``dsurf_jitter_noise``, ``dsurf_on_idx``, ``dsurf_jitter_idx``) so tests can
feed the JAX package and this port identical randomness.
``render_view`` renders a whole view in eval mode, in fixed chunks of rays
(the eval CLI and the training loop's full render).

Data parallel (``parallel/``): a rank's batch holds its share of the ray
axis, P of the world size's P_glob. Every random draw of a training pass
is made at the global shape, from a generator seeded alike on every rank,
and the rank keeps its share: ``minimal_steps`` whole, the eikonal points
and the depth-surface groups (B, P_glob // 2) by ``shard_bounds`` on axis
1, after a top-k over the replicated depth maps. So the ranks' samples
together are the single-process pass's, and so are replayed noise dicts,
which hold the global draws.

``mode=STATIC`` (eval mode) traces with no data-dependent control flow
(``trace_rays(mode=STATIC)``) and takes the shading normals from the
hand-derived value + gradient instead of autograd, so the pass can be
captured by ``torch.export`` (``eval/export.py``).

``mode=BOUNDED`` is the pass a CUDA graph captures (the graph-replayed
training step, ``train/step.CapturableStep``): the trace's bounded
formulation (``trace_rays(mode=BOUNDED)``), its SDF evaluations and secant
through the kernels' count entries, and, where ``supervised_compact_frac``
asks for it, the rt_surf value + gradient and the shading through the JAX
package's capacity cascade with no host sync
(``compaction.bounded_cascade_call_into``: the tiers after the first are
conditional nodes of the graph, recomputed in the backward as JAX's
``supervised_remat`` does). The per-epoch pass gathers exactly the surface
rows instead (``compact_call_into``); both give JAX's per-row results.
Under the traced step's ``stamp.StepProbe`` the pass stamps s1 and s2
around the trace and counts the trace's SDF rows; with none it launches
nothing more.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..compaction import (bounded_cascade_call_into, bounded_rows,
                          compact_call_into)
from ..config import Gates, ModelConfig
from ..fields.embedder import positional_encoding
from ..fields.network import MVSDFNetwork
from ..fields.radiance import render_apply
from ..fields.fused_grad import value_and_grad as explicit_value_and_grad
from ..fields.sdf import full_value_and_grad, implicit_apply, sdf_apply
from ..geometry import projections as proj
from ..geometry.cameras import get_camera_params
from ..parallel import shard_bounds, world_size
from ..tracing.kernels import stamp
from ..tracing.kernels.march_kernel import sphere_march
from ..tracing.kernels.sdf_mlp import (pack_sdf_weights, sdf_mlp,
                                       sdf_mlp_count, sdf_mlp_xyz,
                                       sdf_mlp_xyz_count)
from ..tracing.kernels.secant_kernel import secant, secant_count
from ..tracing.sphere_trace import (BOUNDED, GATHERED, STATIC, TraceResult,
                                    trace_rays)
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
                  object_mask, training, min_steps,
                  mode: str = GATHERED) -> TraceResult:
    """The no-grad trace on the current parameters. With
    cfg.use_pallas_trace, its SDF evaluations go through the fused SDF-MLP
    kernel (with the positional encoding in the kernel when
    cfg.pallas_in_kernel_pe), and cfg.use_pallas_march and
    cfg.use_pallas_secant hand the march and the secant to their fused
    kernels; all of them share one packing of the weights. Without
    use_pallas_trace those three flags are not read, as in the JAX
    package. TracerConfig.sample_chunk has no effect on either path.
    BOUNDED traces in the formulation a CUDA graph captures, the SDF
    evaluations and the secant through the kernels' count entries; the
    torch work of a block (the plain field, the positional encoding before
    the SDF-MLP kernel) runs on its tiles below the count
    (``compaction.bounded_rows``: conditional nodes of the graph)."""
    tcfg = cfg.tracer
    march_fn = secant_fn = None
    bounded = mode == BOUNDED
    with torch.no_grad():
        if cfg.use_pallas_trace:
            packed = pack_sdf_weights(net.implicit)
            multires = net.implicit.cfg.multires
            if bounded and cfg.pallas_in_kernel_pe:
                def sdf_fn(x, count):
                    return sdf_mlp_xyz_count(packed, multires, x, count)
            elif bounded:
                def sdf_fn(x, count):
                    pe = bounded_rows(
                        lambda a, c: positional_encoding(a, multires), x,
                        count, x.new_empty((x.shape[0], packed.d_pe)))
                    return sdf_mlp_count(packed, pe, count)
            elif cfg.pallas_in_kernel_pe:
                def sdf_fn(x):
                    return sdf_mlp_xyz(packed, multires, x.reshape(-1, 3)
                                       ).reshape(x.shape[:-1])
            else:
                def sdf_fn(x):
                    pe = positional_encoding(x.reshape(-1, 3), multires)
                    return sdf_mlp(packed, pe).reshape(x.shape[:-1])
            if cfg.use_pallas_march:
                def march_fn(o, d, mi, t_near, t_far):
                    return sphere_march(tcfg, packed, multires, o, d, mi,
                                        t_near, t_far)
            if cfg.use_pallas_secant and bounded:
                def secant_fn(o, d, z_lo, z_hi, s_lo, s_hi, count):
                    return secant_count(packed, multires,
                                        tcfg.n_secant_steps, o, d, z_lo,
                                        z_hi, s_lo, s_hi, count)
            elif cfg.use_pallas_secant:
                def secant_fn(o, d, z_lo, z_hi, s_lo, s_hi):
                    return secant(packed, multires, tcfg.n_secant_steps, o,
                                  d, z_lo, z_hi, s_lo, s_hi)
        elif bounded:
            def sdf_fn(x, count):
                return bounded_rows(lambda a, c: sdf_apply(net.implicit, a),
                                    x, count, x.new_zeros(x.shape[0]),
                                    sdf_rows=True)
        else:
            def sdf_fn(x):
                return sdf_apply(net.implicit, x)
        return trace_rays(tcfg, sdf_fn, org, dirs, object_mask,
                          training=training, minimal_steps=min_steps,
                          march_fn=march_fn, secant_fn=secant_fn,
                          mode=mode)


def render_forward(cfg: ModelConfig, net: MVSDFNetwork, inputs, *,
                   training: bool, gates: Gates = Gates(),
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[dict] = None,
                   mode: str = GATHERED) -> RenderOut:
    """One renderer forward pass over a batch of pixel rays.

    inputs: uv (B, P, 2), intrinsics (B, 4, 4), pose (B, 4, 4) | (B, 7),
    object_mask (B, P); plus depths / depth_cams / center / size when the
    dsurf groups are gated on. Training mode needs ``generator`` or a
    ``noise`` dict holding every draw it makes. ``mode`` is the trace's
    (``sphere_trace.MODES``): STATIC (eval mode only) gives the export's
    formulation, BOUNDED the one a CUDA graph captures (module
    docstring)."""
    static = mode == STATIC
    if static and training:
        raise ValueError("the static formulation is eval mode only")
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
    stamp.mark(1)
    tr = _frozen_trace(cfg, net, org.detach(), ray_dirs.detach(),
                       object_mask, training, min_steps, mode)
    stamp.mark(2)
    compact = bool(cfg.supervised_compact_frac)
    # JAX's tiers: the capacities of the supervised cascade over B*P rows
    caps = tuple(max(128, int(B * P * f)) for f in cfg.supervised_compact_frac)

    def compact_into(fn, mask, inputs, targets, out_masks=None, module=None):
        if mode == BOUNDED:
            return bounded_cascade_call_into(fn, mask, caps, inputs, targets,
                                             out_masks, module)
        return compact_call_into(fn, mask, inputs, targets, out_masks)
    dists = tr.dists.detach()
    net_obj_mask = tr.network_object_mask
    points = org + dists[..., None] * ray_dirs

    groups = None
    surf_logits_pos = surf_logits_pos_mask = surf_logits_neg = None
    if training:
        surface_mask = net_obj_mask & object_mask
        r = tcfg.object_bounding_sphere
        # the sample groups are drawn at the global shape (B, P_glob // 2);
        # this rank keeps columns [lo, hi)
        half = P * world_size() // 2
        lo, hi = shard_bounds(half)
        if noise and "eik_points" in noise:
            eik_pts = noise["eik_points"].reshape(B, half, 3)
        else:
            eik_pts = torch.rand((B, half, 3),
                                 generator=need_generator("eik_points"),
                                 device=dev) * (2 * r) - r
        eik_pts = eik_pts[:, lo:hi]
        ones = torch.ones((B, hi - lo), device=dev)
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
                cfg, inputs, B * half, generator, noise)
            for name, pts, ok in (("dsurf_on", on_pts, on_ok),
                                  ("dsurf_jitter", ji_pts, ji_ok)):
                group_list.append(
                    (name, pts.reshape(B, half, 3)[:, lo:hi],
                     ok.reshape(B, half)[:, lo:hi].float()))

        if compact:
            # Every consumer of the rt_surf group masks non-surface lanes to
            # zero, so its value + gradient run on the surface lanes only;
            # the other lanes hold zeros. Only the SDF and indicator columns
            # are needed at full size.
            N = B * P

            def sdf_logit_grad(p):
                out, g = full_value_and_grad(net.implicit, p)
                return out[..., :2], g

            o_flat, gr_flat = compact_into(
                sdf_logit_grad, surface_mask.reshape(N),
                [points.reshape(N, 3)],
                [torch.zeros((N, 2), device=dev),
                 torch.zeros((N, 3), device=dev)],
                module=net.implicit)
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
            eik_out = rest_out[:, :hi - lo]
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
            eik_out = all_out[:, P:P + hi - lo]
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

    value_and_grad = explicit_value_and_grad if static else \
        full_value_and_grad

    def shade(p, v):
        out_s, nrm = value_and_grad(net.implicit, p)
        feats = out_s[..., 2:]
        if detach_geo:
            p, nrm, v = p.detach(), nrm.detach(), v.detach()
        return (render_apply(net.render, p, nrm, v, feats),)

    if training and compact:
        # shading reads only surface lanes; the rest keep rgb = 1
        N = B * P
        sm_flat = surface_mask.reshape(N)
        (rgb_flat,) = compact_into(
            shade, sm_flat, [diff_surf_pts.reshape(N, 3), view.reshape(N, 3)],
            [torch.ones((N, 3), device=dev)], out_masks=[sm_flat],
            module=net)
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


def render_view(model, net, uv: torch.Tensor, intr: torch.Tensor,
                pose: torch.Tensor, mask: torch.Tensor,
                chunk: int) -> np.ndarray:
    """One view's rays through the eval-mode renderer in fixed chunks of
    ``chunk`` rays (the tail padded with ray 0): uv (HW, 2), intr (1, 4,
    4), pose (1, 4, 4) or a (1, 7) quaternion + translation row, mask (HW,)
    on the device -> rgb (HW, 3) in [-1, 1]."""
    total = uv.shape[0]
    n_chunks = -(-total // chunk)
    sel_all = torch.cat([
        torch.arange(total),
        torch.zeros(n_chunks * chunk - total, dtype=torch.int64)]
    ).reshape(n_chunks, chunk).to(uv.device)
    out = []
    with torch.no_grad():
        for s in sel_all:
            inputs = {"uv": uv[s][None], "intrinsics": intr, "pose": pose,
                      "object_mask": mask[s][None]}
            out.append(render_forward(model, net, inputs,
                                      training=False).rgb_values[0])
    return torch.cat(out)[:total].cpu().numpy()
