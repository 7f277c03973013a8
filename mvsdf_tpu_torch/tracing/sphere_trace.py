"""Ray tracing of the SDF (port of ``mvsdf_tpu/tracing/sphere_trace.py``):
bidirectional sphere tracing with line search, a uniform-sampling fallback
with first-sign-crossing pick and bracketed secant, and training-mode miss
handling.

The JAX package keeps every ray in a fixed lane and freezes converged lanes
with masks, because XLA needs static shapes. Here the lanes are kept the
same way, but each SDF evaluation runs only on the lanes whose value is
used (a boolean gather), and the fallback stages run on the gathered active
rays (``compaction.compact_call_into``). Masked lanes are no-ops in the JAX
formulation, so results are the same per ray.

The ``lax.while_loop``s become Python loops that stop when no lane is
active; each ``.any()`` test costs one host sync per iteration.

Stages:
  1. ray/bounding-sphere intersection
  2. bidirectional sphere tracing + line search
  3. uniform interval sampler, first sign crossing via the sign*arange
     argmin trick (first index on ties)
  4. bracketed secant refinement, fixed steps
  5. training-mode miss handling: origin projection for rays that miss the
     sphere, min-SDF point along the ray otherwise (``fill_misses``)
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from ..compaction import compact_call_into


@dataclasses.dataclass(frozen=True)
class TracerConfig:
    object_bounding_sphere: float = 1.0
    sdf_threshold: float = 5.0e-5
    line_search_step: float = 0.5
    line_step_iters: int = 3
    sphere_tracing_iters: int = 10
    n_steps: int = 100
    n_secant_steps: int = 8
    dist_clip: float = 0.5
    # Accepted so JAX configs carry over; the port evaluates all samples of
    # the gathered rays at once, so sample_chunk has no effect.
    sample_chunk: int = 20
    # Capacity fractions of the JAX package's fallback compaction. The port
    # gathers exactly the active rays, so these do not change results;
    # fallback_capacity_frac > 0 (or a non-empty tuple) still selects the
    # unified fallback, one evaluation for sampler and fill rays.
    sampler_capacity_frac: Union[float, Tuple[float, ...]] = 1.0
    fill_capacity_frac: Union[float, Tuple[float, ...]] = 1.0
    fallback_capacity_frac: Union[float, Tuple[float, ...]] = 0.0
    # ((start_iter, capacity_frac), ...): from each start_iter on, the march
    # runs on the rays still marching, gathered at the segment start.
    # Capacities do not change results.
    march_compact_schedule: Tuple[Tuple[int, Any], ...] = ()
    # Training-mode min-SDF fill of missed rays. Its outputs are dead in
    # the training step (every loss masks those lanes to zero), so False
    # skips it with the same losses and gradients.
    fill_misses: bool = True


class TraceResult(NamedTuple):
    points: torch.Tensor               # (L..., 3) surface / fallback points
    network_object_mask: torch.Tensor  # (L...) bool: ray hit the SDF surface
    dists: torch.Tensor                # (L...) distance along ray
    sampler_mask: torch.Tensor         # (L...) bool: handled by the sampler
    mask_intersect: torch.Tensor       # (L...) bool: ray meets the sphere


def _take(a, idx):
    """a (L..., S[, 3]), idx (L...) -> (L...[, 3])."""
    if a.dim() == idx.dim() + 2:
        i = idx[..., None, None].expand(idx.shape + (1, a.shape[-1]))
        return torch.gather(a, -2, i).squeeze(-2)
    return torch.gather(a, -1, idx[..., None]).squeeze(-1)


def _mask_update(unfin2, next2, thr):
    """Loop-top bookkeeping: converged lanes (|next| <= thr) stop."""
    curr2 = torch.where(unfin2, next2, torch.zeros_like(next2))
    curr2 = torch.where(curr2 <= thr, torch.zeros_like(curr2), curr2)
    return unfin2 & (curr2 > thr), curr2


def _eval_where(sdf_fn, org2, dirs2, t2, sel, clip, base):
    """``base`` with lanes ``sel`` replaced by clip(sdf(org + t dirs))."""
    out = base.clone()
    if sel.any():
        p = org2[sel] + t2[sel][:, None] * dirs2[sel]
        out[sel] = sdf_fn(p).clamp(-clip, clip)
    return out


def _march_iters(cfg: TracerConfig, sdf_fn, org, dirs, unfin2, t2, next2,
                 i0: int, i1: int, init: bool):
    """Bidirectional march iterations [i0, i1) on flat (N,)-ray state.

    org, dirs (N, 3); unfin2, t2, next2 (2, N): start and end march states
    stacked on axis 0. ``init`` also computes the pre-loop evaluation at the
    seeded t values. Inactive lanes keep their t and a next value of 0."""
    thr = cfg.sdf_threshold
    clip = cfg.dist_clip
    org2 = org.expand(2, *org.shape)
    dirs2 = dirs.expand(2, *dirs.shape)
    sign2 = torch.tensor([[1.0], [-1.0]], dtype=t2.dtype, device=t2.device)
    zeros = torch.zeros_like(t2)

    if init:
        next2 = _eval_where(sdf_fn, org2, dirs2, t2, unfin2, clip, zeros)

    i = i0
    while i < i1 and bool(unfin2.any()):
        unfin2, curr2 = _mask_update(unfin2, next2, thr)
        t2 = t2 + sign2 * curr2
        next2 = _eval_where(sdf_fn, org2, dirs2, t2, unfin2, clip, zeros)
        # line search halving the overshoot: the start march steps t down,
        # the end march steps t up
        not_proj = next2 < 0
        j = 0
        while j < cfg.line_step_iters and bool(not_proj.any()):
            step = ((1 - cfg.line_search_step) / (2.0 ** j)) * curr2
            t2 = torch.where(not_proj, t2 - sign2 * step, t2)
            next2 = _eval_where(sdf_fn, org2, dirs2, t2, not_proj, clip,
                                next2)
            not_proj = next2 < 0
            j += 1
        unfin2 = unfin2 & (t2[0] < t2[1])[None]
        i += 1
    return unfin2, t2, next2


def _segments(cfg: TracerConfig):
    """[(i0, i1, compact)] from march_compact_schedule."""
    iters = cfg.sphere_tracing_iters
    starts = [s for s, _ in cfg.march_compact_schedule if s < iters]
    if not starts:
        return [(0, iters, False)]
    if starts != sorted(starts) or len(set(starts)) != len(starts):
        raise ValueError("march_compact_schedule starts must be strictly "
                         f"increasing: {cfg.march_compact_schedule}")
    segs = [(0, starts[0], False)] if starts[0] > 0 else []
    for k, s in enumerate(starts):
        e = starts[k + 1] if k + 1 < len(starts) else iters
        segs.append((s, e, True))
    return segs


def _sphere_trace(cfg: TracerConfig, sdf_fn, org, dirs, mask_intersect,
                  t_near, t_far):
    """Bidirectional sphere tracing. org, dirs (L..., 3); mask_intersect,
    t_near, t_far (L...). Returns (unfinished_start, t_start, t_end)."""
    lead = mask_intersect.shape
    R = mask_intersect.numel()
    orgf = org.reshape(R, 3)
    dirsf = dirs.reshape(R, 3)
    mi = mask_intersect.reshape(R)

    unfin2 = torch.stack([mi, mi])
    t2 = torch.where(unfin2, torch.stack([t_near.reshape(R),
                                          t_far.reshape(R)]),
                     torch.zeros((), dtype=t_near.dtype,
                                 device=t_near.device))
    next2 = torch.zeros_like(t2)

    for i0, i1, compact in _segments(cfg):
        init = i0 == 0
        if not compact:
            unfin2, t2, next2 = _march_iters(cfg, sdf_fn, orgf, dirsf,
                                             unfin2, t2, next2, i0, i1, init)
            continue
        active = mi if init else (unfin2[0] | unfin2[1])

        def seg_fn(o, d, u, tt, nx, i0=i0, i1=i1, init=init):
            u2, t2c, n2c = _march_iters(cfg, sdf_fn, o, d, u.T, tt.T, nx.T,
                                        i0, i1, init)
            return u2.T, t2c.T, n2c.T

        u_o, t_o, n_o = compact_call_into(
            seg_fn, active, [orgf, dirsf, unfin2.T, t2.T, next2.T],
            [unfin2.T, t2.T, next2.T])
        unfin2, t2, next2 = u_o.T, t_o.T, n_o.T

    # final bookkeeping-only pass (the reference breaks after the mask
    # update at iters == sphere_tracing_iters)
    unfin2, _ = _mask_update(unfin2, next2, cfg.sdf_threshold)
    return (unfin2[0].reshape(lead), t2[0].reshape(lead),
            t2[1].reshape(lead))


def _sample_points(org, dirs, t_lo, t_hi, steps):
    """Sample distances ts (N, S) and points (N, S, 3); steps (S,) or
    (N, S) in [0, 1]."""
    ts = t_lo[:, None] + steps * (t_hi - t_lo)[:, None]
    pts = org[:, None, :] + ts[..., None] * dirs[:, None, :]
    return ts, pts


def _sampler_logic(cfg: TracerConfig, sdf_fn, org, dirs, object_mask, ts,
                   pts, sdf_val, training: bool):
    """Sampler post-processing on flat (N,) rays with samples (N, S): first
    sign crossing, min-SDF fallback, secant. Returns (points, net_surface,
    dists)."""
    S = cfg.n_steps
    weight = torch.arange(S, 0, -1, dtype=sdf_val.dtype,
                          device=sdf_val.device)
    ind = torch.argmin(torch.sign(sdf_val) * weight, dim=-1)
    net_surface = _take(sdf_val, ind) < 0

    p_out = ~(object_mask & net_surface)
    out_ind = torch.argmin(sdf_val, dim=-1)
    pick = torch.where(p_out, out_ind, ind)
    d = _take(ts, pick)
    p = _take(pts, pick)

    secant_sel = (net_surface & object_mask) if training else net_surface
    if bool(secant_sel.any()):
        z_high = _take(ts, ind)
        sdf_high = _take(sdf_val, ind)
        ind_lo = (ind - 1) % S  # negative index wraps, as in torch indexing
        z_low = _take(ts, ind_lo)
        sdf_low = _take(sdf_val, ind_lo)
        s = secant_sel
        z_pred = _secant(cfg, sdf_fn, org[s], dirs[s], z_low[s], z_high[s],
                         sdf_low[s], sdf_high[s])
        d = d.clone()
        p = p.clone()
        d[s] = z_pred
        p[s] = org[s] + z_pred[:, None] * dirs[s]
    return p, net_surface, d


def _secant(cfg: TracerConfig, sdf_fn, org, dirs, z_low, z_high, sdf_low,
            sdf_high):
    """Fixed-iteration bracketed secant root find on (N,) rays; the
    denominator is kept at least 1e-12 in magnitude."""
    def z_of(sl, sh, zl, zh):
        denom = sh - sl
        tiny = torch.where(denom < 0, -1e-12, 1e-12).to(denom.dtype)
        denom = torch.where(denom.abs() < 1e-12, tiny, denom)
        return -sl * (zh - zl) / denom + zl

    z_pred = z_of(sdf_low, sdf_high, z_low, z_high)
    for _ in range(cfg.n_secant_steps):
        sdf_mid = sdf_fn(org + z_pred[:, None] * dirs)
        pos = sdf_mid > 0
        neg = sdf_mid < 0
        z_low = torch.where(pos, z_pred, z_low)
        sdf_low = torch.where(pos, sdf_mid, sdf_low)
        z_high = torch.where(neg, z_pred, z_high)
        sdf_high = torch.where(neg, sdf_mid, sdf_high)
        z_pred = z_of(sdf_low, sdf_high, z_low, z_high)
    return z_pred


def _linspace(cfg: TracerConfig, like):
    return torch.linspace(0.0, 1.0, cfg.n_steps, dtype=like.dtype,
                          device=like.device)


def _ray_sampler(cfg: TracerConfig, sdf_fn, org, dirs, object_mask, t_min,
                 t_max, training: bool):
    """Uniform interval sampling + secant on flat (N,) rays."""
    ts, pts = _sample_points(org, dirs, t_min, t_max, _linspace(cfg, t_min))
    sdf_val = sdf_fn(pts)
    return _sampler_logic(cfg, sdf_fn, org, dirs, object_mask, ts, pts,
                          sdf_val, training)


def _minimal_sdf_points(cfg: TracerConfig, sdf_fn, org, dirs, t_min, t_max,
                        steps01):
    """Min-SDF point along each flat ray over the stratified samples
    steps01 (n_steps,) in [0, 1). Returns (points, dists)."""
    ts, pts = _sample_points(org, dirs, t_min, t_max, steps01)
    idx = torch.argmin(sdf_fn(pts), dim=-1)
    return _take(pts, idx), _take(ts, idx)


def _unified_fallback(cfg: TracerConfig, sdf_fn, org, dirs, object_mask,
                      is_smp, t_lo, t_hi, steps01, training: bool):
    """One n_steps-sample evaluation serving both fallback stages: sampler
    rows (is_smp) use the uniform linspace, fill rows the stratified
    steps01. Returns (points, net_surface, dists) on flat (N,) rays."""
    steps = torch.where(is_smp[:, None], _linspace(cfg, t_lo)[None, :],
                        steps01[None, :])
    ts, pts = _sample_points(org, dirs, t_lo, t_hi, steps)
    sdf_val = sdf_fn(pts)
    smp_p, smp_net, smp_d = _sampler_logic(
        cfg, sdf_fn, org, dirs, object_mask, ts, pts, sdf_val, training)
    idx = torch.argmin(sdf_val, dim=-1)
    mn_p, mn_d = _take(pts, idx), _take(ts, idx)
    p = torch.where(is_smp[:, None], smp_p, mn_p)
    d = torch.where(is_smp, smp_d, mn_d)
    return p, smp_net, d


def _fracs(f):
    return tuple(f) if isinstance(f, (tuple, list)) else \
        ((f,) if f > 0 else ())


@torch.no_grad()
def trace_rays(cfg: TracerConfig, sdf_fn, org, dirs, object_mask,
               training: bool, generator: Optional[torch.Generator] = None,
               minimal_steps: Optional[torch.Tensor] = None) -> TraceResult:
    """Full tracing pipeline. org, dirs (L..., 3); object_mask (L...) bool.
    ``sdf_fn`` maps points (..., 3) to SDF values (...). ``minimal_steps``
    (n_steps,) in [0, 1) fixes the stratified fill samples; otherwise they
    are drawn from ``generator`` when the training trace needs them."""
    lead = org.shape[:-1]
    R = org[..., 0].numel()
    r_sph = cfg.object_bounding_sphere
    d_dot_o = torch.sum(dirs * org, dim=-1)
    under = d_dot_o ** 2 - (torch.sum(org ** 2, dim=-1) - r_sph ** 2)
    mask_intersect = under > 0
    zero = torch.zeros_like(under)
    sq = torch.sqrt(torch.where(mask_intersect, under, zero))
    t_near = torch.where(mask_intersect, -d_dot_o - sq, zero).clamp_min(0.0)
    t_far = torch.where(mask_intersect, -d_dot_o + sq, zero).clamp_min(0.0)

    unfin_s, t_s, t_e = _sphere_trace(cfg, sdf_fn, org, dirs, mask_intersect,
                                      t_near, t_far)
    min_dis = torch.where(mask_intersect, t_near, zero)
    max_dis = torch.where(mask_intersect, t_far, zero)

    net_obj_mask = t_s < t_e
    points = org + t_s[..., None] * dirs
    dists = t_s
    sampler_mask = unfin_s

    def draw_steps():
        if minimal_steps is not None:
            return minimal_steps
        if generator is None:
            raise ValueError("training trace needs generator or "
                             "minimal_steps")
        return torch.rand(cfg.n_steps, generator=generator,
                          dtype=org.dtype, device=org.device)

    flat = lambda a: a.reshape(R, *a.shape[len(lead):])
    t_proj = -torch.sum(dirs * org, dim=-1)

    if training and _fracs(cfg.fallback_capacity_frac):
        # unified fallback: sampler rays and fill rays are disjoint, so one
        # n_steps-sample evaluation serves both
        in_mask = ~net_obj_mask & object_mask & ~sampler_mask
        out_mask = ~object_mask & ~sampler_mask
        left_out = (in_mask | out_mask) & ~mask_intersect
        if cfg.fill_misses:
            fill = (in_mask | out_mask) & mask_intersect
        else:
            fill = torch.zeros_like(sampler_mask)
        min_dis = torch.where(net_obj_mask & out_mask, dists, min_dis)
        steps01 = draw_steps()
        active = sampler_mask | fill
        t_lo = torch.where(sampler_mask, t_s, min_dis)
        t_hi = torch.where(sampler_mask, t_e, max_dis)
        fn = lambda o, d, m, sm, lo, hi: _unified_fallback(
            cfg, sdf_fn, o, d, m, sm, lo, hi, steps01, training)
        p_f, net_f, d_f = compact_call_into(
            fn, flat(active),
            [flat(org), flat(dirs), flat(object_mask), flat(sampler_mask),
             flat(t_lo), flat(t_hi)],
            [flat(points), flat(net_obj_mask), flat(dists)],
            out_masks=[flat(active), flat(sampler_mask), flat(active)])
        points = p_f.reshape(lead + (3,))
        net_obj_mask = net_f.reshape(lead)
        dists = d_f.reshape(lead)
        points = torch.where(left_out[..., None],
                             org + t_proj[..., None] * dirs, points)
        dists = torch.where(left_out, t_proj, dists)
        return TraceResult(points, net_obj_mask, dists, sampler_mask,
                           mask_intersect)

    smp_t_min = torch.where(sampler_mask, t_s, zero)
    smp_t_max = torch.where(sampler_mask, t_e, zero)
    fn = lambda o, d, m, lo, hi: _ray_sampler(cfg, sdf_fn, o, d, m, lo, hi,
                                              training)
    smpf = flat(sampler_mask)
    p_f, net_f, d_f = compact_call_into(
        fn, smpf, [flat(org), flat(dirs), flat(object_mask),
                   flat(smp_t_min), flat(smp_t_max)],
        [flat(points), flat(net_obj_mask), flat(dists)],
        out_masks=[smpf, smpf, smpf])
    points = p_f.reshape(lead + (3,))
    net_obj_mask = net_f.reshape(lead)
    dists = d_f.reshape(lead)
    if not training:
        return TraceResult(points, net_obj_mask, dists, sampler_mask,
                           mask_intersect)

    # training: every ray needs a point
    in_mask = ~net_obj_mask & object_mask & ~sampler_mask
    out_mask = ~object_mask & ~sampler_mask
    left_out = (in_mask | out_mask) & ~mask_intersect
    points = torch.where(left_out[..., None], org + t_proj[..., None] * dirs,
                         points)
    dists = torch.where(left_out, t_proj, dists)
    if not cfg.fill_misses:
        return TraceResult(points, net_obj_mask, dists, sampler_mask,
                           mask_intersect)
    fill = (in_mask | out_mask) & mask_intersect
    min_dis = torch.where(net_obj_mask & out_mask, dists, min_dis)
    steps01 = draw_steps()
    fn = lambda o, d, lo, hi: _minimal_sdf_points(cfg, sdf_fn, o, d, lo, hi,
                                                  steps01)
    fillf = flat(fill)
    p_f, d_f = compact_call_into(
        fn, fillf, [flat(org), flat(dirs), flat(min_dis), flat(max_dis)],
        [flat(points), flat(dists)], out_masks=[fillf, fillf])
    return TraceResult(p_f.reshape(lead + (3,)), net_obj_mask,
                       d_f.reshape(lead), sampler_mask, mask_intersect)
