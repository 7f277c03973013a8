"""The five-term MVSDF loss, fixed-shape masked (port of
``mvsdf_tpu/supervision/losses.py``).

  rgb      L1 over hit&mask rays / total ray count
  eikonal  mean (|grad|-1)^2 over gated sample groups
  depth    L1 between SDF and -carved distance, attenuated
  feat     |1 - cos| of warped frozen-CNN features, inliers, / (S * m_i)
  surf     BCE of surface-indicator logits

Data parallel (``parallel/``): a rank's batch holds its share of the rays.
Every count a loss divides by (the masked means' denominators, the
per-image hits of the feature loss, the indicator's sample count, the rgb
loss's B * P) is summed over the ranks with no gradient, so each rank's
terms are its share of the single-process terms and add up to them; the
step then sums the ranks' gradients. One process: the counts are its own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Gates, Schedule, Weights
from ..geometry import projections as proj
from ..parallel import sum_counts, world_size
from .carving import carving


def _safe_norm(x, dim=-1, eps=1e-18):
    """L2 norm whose backward is finite (zero) at the zero vector: the max
    keeps sum(x^2) away from 0 inside the sqrt. Equal to the plain norm
    whenever sum(x^2) > eps."""
    sq = torch.sum(x * x, dim=dim)
    return torch.sqrt(torch.clamp_min(sq, eps))


def _scalar(a):
    return a.reshape(-1)[0]


class LossTerms(NamedTuple):
    loss: torch.Tensor
    rgb_loss: torch.Tensor
    eikonal_loss: torch.Tensor
    depth_loss: torch.Tensor
    feat_loss: torch.Tensor
    surf_loss: torch.Tensor


def _masked_mean(num, den):
    """num / den with den summed over the ranks; 0 where it is 0."""
    den = sum_counts(den)
    return torch.where(den > 0, num / den.clamp_min(1.0),
                       torch.zeros_like(num))


def rgb_loss(rgb_values, rgb_gt, network_object_mask, object_mask):
    """(B, P, 3) each; L1 over hit&mask lanes / B*P (the global count)."""
    m = (network_object_mask & object_mask)[..., None]
    n = rgb_values.shape[0] * rgb_values.shape[1] * world_size()
    return torch.sum((rgb_values - rgb_gt).abs() * m) / n


def eikonal_loss(groups, gates: Gates):
    """Masked mean of (|grad|-1)^2 over the gated groups."""
    use = {"rt_surf": gates.eik_use_rt_surf, "eik": gates.eik_use_eik,
           "dsurf_on": gates.eik_use_dsurf_on,
           "dsurf_jitter": gates.eik_use_dsurf_jitter}
    num = den = 0.0
    for name, grp in groups.items():
        if not use.get(name, False):
            continue
        term = (_safe_norm(grp["grad"]) - 1.0) ** 2
        num = num + torch.sum(term * grp["mask"])
        den = den + torch.sum(grp["mask"])
    return _masked_mean(num, den)


def depth_loss(groups, gates: Gates, depths, depth_cams, size, center,
               sched: Schedule, weights: Weights):
    """MVS-depth carving loss over the gated sample groups. depths (V, 1, h,
    w), depth_cams (V, 2, 4, 4); size scalar-like, center (…, 3)."""
    use = {"rt_surf": gates.d_use_rt_surf, "eik": gates.d_use_eik,
           "dsurf_on": gates.d_use_dsurf_on,
           "dsurf_jitter": gates.d_use_dsurf_jitter}
    size = _scalar(size)
    center = center.reshape(-1, 3)[0]
    num = den = 0.0
    for name, grp in groups.items():
        if not use.get(name, False):
            continue
        pts = grp["points"].detach()
        lead = pts.shape[:-1]
        pts_world = (pts / 2.0 * size + center).reshape(-1, 3)
        dist, _, in_range = carving(pts_world, depths, depth_cams,
                                    out_thresh_perc=sched.out_thresh_perc,
                                    use_invalid=sched.use_invalid)
        dist, in_range = dist.reshape(lead), in_range.reshape(lead)
        dist_r = torch.clamp(dist / size * 2.0 + (-1.25) * (~in_range),
                             -1.25, 1.25)
        far_w = torch.where(dist_r.abs() > sched.far_thresh,
                            weights.far_att, 1.0)
        near_w = torch.where(dist_r.abs() < sched.near_thresh,
                             weights.near_att, 1.0)
        per = (grp["sdf"] + dist_r).abs()
        m = grp["mask"]
        num = num + torch.sum(per * far_w * near_w * in_range * m)
        den = den + torch.sum(m)
    return _masked_mean(num, den)


def feat_consistency_loss(diff_surf_pts, hit_mask, feat, cam, feat_src,
                          src_cams, size, center, feat_img_scale=2.0):
    """Multi-view feature consistency. diff_surf_pts (B, P, 3) unit-cube
    coords; hit_mask (B, P) bool; feat (B, C, h, w); cam (B, 2, 4, 4);
    feat_src (B, S, C, h, w); src_cams (B, S, 2, 4, 4)."""
    B, P, _ = diff_surf_pts.shape
    S = feat_src.shape[1]
    h, w = feat.shape[-2:]
    size = _scalar(size)
    center = center.reshape(-1, 3)[0]
    pts_hom = proj.to_hom(diff_surf_pts / 2.0 * size + center)  # (B, P, 4)
    # reference view and S source views of each image: (B, 1+S, ...)
    fmaps = torch.cat([feat[:, None], feat_src], dim=1)
    cams = torch.cat([cam[:, None], src_cams], dim=1)
    pc = proj.world_to_cam(pts_hom[:, None], cams[:, :, None])  # (B,1+S,P,4)
    xy = proj.cam_to_img(pc, cams[:, :, None])[..., :2]
    grid_n = proj.normalize_pixel_coords(xy / feat_img_scale, h, w)
    inr = proj.in_range_mask(grid_n)                            # (B,1+S,P)
    g = proj.grid_sample_bilinear(fmaps.flatten(0, 1), grid_n.flatten(0, 1))
    g = g.reshape(B, 1 + S, P, -1)
    g_ref, g_srcs = g[:, :1], g[:, 1:]
    n_ref = _safe_norm(g_ref)
    n_src = _safe_norm(g_srcs)
    corr = torch.sum(g_ref * g_srcs, dim=-1) / n_ref.clamp_min(1e-9) / \
        n_src.clamp_min(1e-9)
    corr_loss = (1.0 - corr).abs()                               # (B, S, P)
    valid = inr[:, :1] & inr[:, 1:]
    sel = valid & (corr_loss < 0.5) & hit_mask[:, None]
    hits = sum_counts(hit_mask.sum(-1).to(corr_loss.dtype))
    s = torch.sum(corr_loss * sel, dim=(1, 2))
    per = torch.where(hits > 0, s / (S * hits).clamp_min(1.0),
                      torch.zeros_like(s))
    return per.mean()


def _bce_with_logits(x, y):
    return torch.clamp_min(x, 0.0) - x * y + torch.log1p(torch.exp(-x.abs()))


def surf_indicator_loss(logits_pos, pos_mask, logits_neg):
    """BCE: traced-surface-in-mask lanes -> 1, eikonal points -> 0."""
    pos = _bce_with_logits(logits_pos, 1.0) * pos_mask
    neg = _bce_with_logits(logits_neg, 0.0)
    n = sum_counts(pos_mask.sum() + logits_neg.numel())
    return (pos.sum() + neg.sum()) / n.clamp_min(1.0)


def total_loss(out, ground_truth, gates: Gates, sched: Schedule,
               weights: Weights) -> LossTerms:
    """Weighted total over a training-mode RenderOut. ground_truth: rgb
    (B, P, 3), depths (B, V, 1, h, w) whose (B, V) axes are merged into
    carving views, depth_cams, size, center, feat, cam, feat_src,
    src_cams."""
    l_rgb = rgb_loss(out.rgb_values, ground_truth["rgb"],
                     out.network_object_mask, out.object_mask)
    l_eik = eikonal_loss(out.groups, gates)
    depths = ground_truth["depths"]
    depth_cams = ground_truth["depth_cams"]
    l_depth = depth_loss(out.groups, gates, depths.flatten(0, 1),
                         depth_cams.flatten(0, 1), ground_truth["size"],
                         ground_truth["center"], sched, weights)
    zero = torch.zeros((), device=l_rgb.device)
    if gates.enable_feat:
        l_feat = feat_consistency_loss(
            out.diff_surf_pts, out.network_object_mask & out.object_mask,
            ground_truth["feat"], ground_truth["cam"],
            ground_truth["feat_src"], ground_truth["src_cams"],
            ground_truth["size"], ground_truth["center"],
            feat_img_scale=float(sched.feat_img_scale))
    else:
        l_feat = zero
    if gates.enable_surf:
        l_surf = surf_indicator_loss(out.surf_logits_pos,
                                     out.surf_logits_pos_mask,
                                     out.surf_logits_neg)
    else:
        l_surf = zero
    loss = (l_rgb * weights.rgb + l_eik * weights.eikonal +
            l_surf * weights.surf + l_feat * weights.feat +
            l_depth * weights.depth)
    return LossTerms(loss=loss, rgb_loss=l_rgb, eikonal_loss=l_eik,
                     depth_loss=l_depth, feat_loss=l_feat, surf_loss=l_surf)
