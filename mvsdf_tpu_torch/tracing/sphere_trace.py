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
active; each ``.any()`` test costs one host sync per iteration. The fused
march and secant kernels (``trace_rays(march_fn=, secant_fn=)``) run those
loops on the device instead.

``trace_rays(mode=STATIC)`` is the JAX formulation itself, for
``torch.export`` (the serving export): every lane runs the fixed iteration
counts with converged lanes frozen by the same masks, each SDF evaluation
and each fallback stage runs on every ray and keeps its result where the
mask says (``compaction.masked_call_into``), and nothing gathers or tests
a mask on the host. It reuses the stages below, so a ray's result is the
gathered path's.

``trace_rays(mode=BOUNDED)`` is the formulation a CUDA graph captures (the
graph-replayed training step): the same fixed iteration counts and
masks, but each SDF evaluation, each fallback stage and the secant run on
a block ordered on the device with the active rows first
(``compaction.bounded_call_into``), and ``sdf_fn`` / ``secant_fn`` take
the active count as a 0-d device tensor, so the kernels' count entries
compute those rows alone. No host sync, no shape that depends on the
data; a ray's result is again the gathered path's.

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

import numpy as np
import torch

from ..compaction import (bounded_call_into, compact_call_into,
                          masked_call_into)

# The trace's formulations (module docstring): the gathered one (host-read
# masks, exact gathers), the static one for torch.export, the bounded one
# a CUDA graph captures.
GATHERED, STATIC, BOUNDED = "gathered", "static", "bounded"
MODES = (GATHERED, STATIC, BOUNDED)


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


def _eval_where(sdf_fn, org2, dirs2, t2, sel, clip, base, mode=GATHERED):
    """``base`` with lanes ``sel`` replaced by clip(sdf(org + t dirs));
    STATIC evaluates every lane, BOUNDED the block of ``bounded_call_into``
    (``sdf_fn(points, count)``)."""
    if mode == STATIC:
        val = sdf_fn(org2 + t2[..., None] * dirs2).clamp(-clip, clip)
        return torch.where(sel, val, base)
    if mode == BOUNDED:
        pts = (org2 + t2[..., None] * dirs2).reshape(-1, 3)
        (out,) = bounded_call_into(
            lambda c, p: (sdf_fn(p, c).clamp(-clip, clip),), sel.reshape(-1),
            [pts], [base.reshape(-1)])
        return out.reshape(base.shape)
    out = base.clone()
    if sel.any():
        p = org2[sel] + t2[sel][:, None] * dirs2[sel]
        out[sel] = sdf_fn(p).clamp(-clip, clip)
    return out


def _march_iters(cfg: TracerConfig, sdf_fn, org, dirs, unfin2, t2, next2,
                 i0: int, i1: int, init: bool, mode: str = GATHERED):
    """Bidirectional march iterations [i0, i1) on flat (N,)-ray state.

    org, dirs (N, 3); unfin2, t2, next2 (2, N): start and end march states
    stacked on axis 0. ``init`` also computes the pre-loop evaluation at the
    seeded t values. Inactive lanes keep their t and a next value of 0, so
    the iterations that STATIC and BOUNDED run past the last active lane
    change nothing."""
    thr = cfg.sdf_threshold
    clip = cfg.dist_clip
    fixed = mode != GATHERED
    org2 = org.expand(2, *org.shape)
    dirs2 = dirs.expand(2, *dirs.shape)
    # [[1], [-1]], made on the device (a graph captures no host copy)
    sign2 = 1.0 - 2.0 * torch.arange(2, dtype=t2.dtype,
                                     device=t2.device)[:, None]
    zeros = torch.zeros_like(t2)

    if init:
        next2 = _eval_where(sdf_fn, org2, dirs2, t2, unfin2, clip, zeros,
                            mode)

    i = i0
    while i < i1 and (fixed or bool(unfin2.any())):
        unfin2, curr2 = _mask_update(unfin2, next2, thr)
        t2 = t2 + sign2 * curr2
        next2 = _eval_where(sdf_fn, org2, dirs2, t2, unfin2, clip, zeros,
                            mode)
        # line search halving the overshoot: the start march steps t down,
        # the end march steps t up
        not_proj = next2 < 0
        j = 0
        while j < cfg.line_step_iters and (fixed or bool(not_proj.any())):
            step = ((1 - cfg.line_search_step) / (2.0 ** j)) * curr2
            t2 = torch.where(not_proj, t2 - sign2 * step, t2)
            next2 = _eval_where(sdf_fn, org2, dirs2, t2, not_proj, clip,
                                next2, mode)
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
                  t_near, t_far, mode: str = GATHERED):
    """Bidirectional sphere tracing. org, dirs (L..., 3); mask_intersect,
    t_near, t_far (L...). Returns (unfinished_start, t_start, t_end).
    STATIC and BOUNDED march every lane through all iterations, with no
    segment gathers (BOUNDED evaluates each step's active lanes on a
    device-ordered block)."""
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

    segments = [(0, cfg.sphere_tracing_iters, False)] if mode != GATHERED \
        else _segments(cfg)
    for i0, i1, compact in segments:
        init = i0 == 0
        if not compact:
            unfin2, t2, next2 = _march_iters(cfg, sdf_fn, orgf, dirsf,
                                             unfin2, t2, next2, i0, i1, init,
                                             mode)
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
                   pts, sdf_val, training: bool, secant_fn=None,
                   mode: str = GATHERED, block=None):
    """Sampler post-processing on flat (N,) rays with samples (N, S): first
    sign crossing, min-SDF fallback, secant (``secant_fn`` when given, on
    the rays it refines only; STATIC: on every ray, kept on those). In
    BOUNDED mode the rays are a ``bounded_call_into`` block and ``block``
    is (its count-taking sdf_fn, its live rows (N,) bool): the secant then
    runs on a block of its own, its rays first, and ``secant_fn`` takes
    their count. Returns (points, net_surface, dists)."""
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
    if mode == BOUNDED:
        count_sdf, live = block
        s = secant_sel & live
        z_high, sdf_high = _take(ts, ind), _take(sdf_val, ind)
        ind_lo = (ind - 1) % S
        args = [org, dirs, _take(ts, ind_lo), z_high, _take(sdf_val, ind_lo),
                sdf_high]
        if secant_fn is None:
            fn = lambda c, *a: (_secant(cfg.n_secant_steps,
                                        lambda x: count_sdf(x, c), *a),)
        else:
            fn = lambda c, *a: (secant_fn(*a, c),)
        (d,) = bounded_call_into(fn, s, args, [d])
        p = torch.where(s[:, None], org + d[:, None] * dirs, p)
        return p, net_surface, d
    static = mode == STATIC
    if static or bool(secant_sel.any()):
        z_high = _take(ts, ind)
        sdf_high = _take(sdf_val, ind)
        ind_lo = (ind - 1) % S  # negative index wraps, as in torch indexing
        z_low = _take(ts, ind_lo)
        sdf_low = _take(sdf_val, ind_lo)
        s = secant_sel
        if static:
            args = (org, dirs, z_low, z_high, sdf_low, sdf_high)
            z_pred = _secant(cfg.n_secant_steps, sdf_fn, *args) if \
                secant_fn is None else secant_fn(*args)
            d = torch.where(s, z_pred, d)
            p = torch.where(s[:, None], org + z_pred[:, None] * dirs, p)
            return p, net_surface, d
        args = (org[s], dirs[s], z_low[s], z_high[s], sdf_low[s],
                sdf_high[s])
        if secant_fn is None:
            z_pred = _secant(cfg.n_secant_steps, sdf_fn, *args)
        else:
            z_pred = secant_fn(*args)
        d = d.clone()
        p = p.clone()
        d[s] = z_pred
        p[s] = org[s] + z_pred[:, None] * dirs[s]
    return p, net_surface, d


def _secant(n_steps: int, sdf_fn, org, dirs, z_low, z_high, sdf_low,
            sdf_high):
    """Bracketed secant root find, n_steps steps, on (N,) rays; the
    denominator is kept at least 1e-12 in magnitude."""
    def z_of(sl, sh, zl, zh):
        denom = sh - sl
        tiny = torch.where(denom < 0, -1e-12, 1e-12).to(denom.dtype)
        denom = torch.where(denom.abs() < 1e-12, tiny, denom)
        return -sl * (zh - zl) / denom + zl

    z_pred = z_of(sdf_low, sdf_high, z_low, z_high)
    for _ in range(n_steps):
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
                 t_max, training: bool, secant_fn=None, mode=GATHERED,
                 block=None):
    """Uniform interval sampling + secant on flat (N,) rays."""
    ts, pts = _sample_points(org, dirs, t_min, t_max, _linspace(cfg, t_min))
    sdf_val = sdf_fn(pts)
    return _sampler_logic(cfg, sdf_fn, org, dirs, object_mask, ts, pts,
                          sdf_val, training, secant_fn, mode, block)


def _minimal_sdf_points(cfg: TracerConfig, sdf_fn, org, dirs, t_min, t_max,
                        steps01):
    """Min-SDF point along each flat ray over the stratified samples
    steps01 (n_steps,) in [0, 1). Returns (points, dists)."""
    ts, pts = _sample_points(org, dirs, t_min, t_max, steps01)
    idx = torch.argmin(sdf_fn(pts), dim=-1)
    return _take(pts, idx), _take(ts, idx)


def _unified_fallback(cfg: TracerConfig, sdf_fn, org, dirs, object_mask,
                      is_smp, t_lo, t_hi, steps01, training: bool,
                      secant_fn=None, mode: str = GATHERED, block=None):
    """One n_steps-sample evaluation serving both fallback stages: sampler
    rows (is_smp) use the uniform linspace, fill rows the stratified
    steps01. Returns (points, net_surface, dists) on flat (N,) rays."""
    steps = torch.where(is_smp[:, None], _linspace(cfg, t_lo)[None, :],
                        steps01[None, :])
    ts, pts = _sample_points(org, dirs, t_lo, t_hi, steps)
    sdf_val = sdf_fn(pts)
    smp_p, smp_net, smp_d = _sampler_logic(
        cfg, sdf_fn, org, dirs, object_mask, ts, pts, sdf_val, training,
        secant_fn, mode, block)
    idx = torch.argmin(sdf_val, dim=-1)
    mn_p, mn_d = _take(pts, idx), _take(ts, idx)
    p = torch.where(is_smp[:, None], smp_p, mn_p)
    d = torch.where(is_smp, smp_d, mn_d)
    return p, smp_net, d


def _fracs(f):
    return tuple(f) if isinstance(f, (tuple, list)) else \
        ((f,) if f > 0 else ())


def sphere_intersection(org, dirs, radius: float):
    """Where the rays org + t dirs (L..., 3) meet the bounding sphere:
    (mask_intersect, t_near, t_far), each (L...); t is clamped at 0 and is
    0 on rays that miss."""
    d_dot_o = torch.sum(dirs * org, dim=-1)
    under = d_dot_o ** 2 - (torch.sum(org ** 2, dim=-1) - radius ** 2)
    mask_intersect = under > 0
    zero = torch.zeros_like(under)
    sq = torch.sqrt(torch.where(mask_intersect, under, zero))
    t_near = torch.where(mask_intersect, -d_dot_o - sq, zero).clamp_min(0.0)
    t_far = torch.where(mask_intersect, -d_dot_o + sq, zero).clamp_min(0.0)
    return mask_intersect, t_near, t_far


@torch.no_grad()
def trace_rays(cfg: TracerConfig, sdf_fn, org, dirs, object_mask,
               training: bool, generator: Optional[torch.Generator] = None,
               minimal_steps: Optional[torch.Tensor] = None,
               march_fn=None, secant_fn=None,
               mode: str = GATHERED) -> TraceResult:
    """Full tracing pipeline. org, dirs (L..., 3); object_mask (L...) bool.
    ``sdf_fn`` maps points (..., 3) to SDF values (...). ``minimal_steps``
    (n_steps,) in [0, 1) fixes the stratified fill samples; otherwise they
    are drawn from ``generator`` when the training trace needs them.

    ``march_fn(org, dirs, mask_intersect, t_near, t_far) -> (unfin_s, t_s,
    t_e)`` replaces the march (``_sphere_trace``; the march compaction
    schedule then does not apply), and ``secant_fn(org, dirs, z_low,
    z_high, sdf_low, sdf_high) -> z_pred`` the secant, on (N,) rays: the
    fused kernels take these places. ``mode`` is one of MODES: STATIC
    gives the formulation with no data-dependent control flow or shape
    (module docstring), BOUNDED the one a CUDA graph captures: there
    ``sdf_fn(points (M, 3), count)`` need only compute the first ``count``
    rows (a 0-d int32 on the device) and ``secant_fn`` takes that count as
    a last argument."""
    if mode not in MODES:
        raise ValueError(f"trace_rays takes a mode of {MODES}, not {mode!r}")
    lead = org.shape[:-1]
    R = org[..., 0].numel()
    mask_intersect, t_near, t_far = sphere_intersection(
        org, dirs, cfg.object_bounding_sphere)
    zero = torch.zeros_like(t_near)

    if mode == STATIC:
        call_into = masked_call_into
    elif mode == BOUNDED:
        def call_into(fn, mask, inputs, targets, out_masks=None):
            # fn runs on the device-ordered block: its SDF evaluations
            # compute the rows of the first `count` rays alone
            def run_block(c, *a):
                n = a[0].shape[0]
                live = torch.arange(n, device=a[0].device) < c

                def rows_sdf(x):
                    per = x[..., 0].numel() // max(n, 1)
                    return sdf_fn(x.reshape(-1, 3), c * per).reshape(
                        x.shape[:-1])
                return fn(*a, sdf=rows_sdf, block=(sdf_fn, live))
            return bounded_call_into(run_block, mask, inputs, targets,
                                     out_masks)
    else:
        call_into = compact_call_into
    if march_fn is None:
        unfin_s, t_s, t_e = _sphere_trace(cfg, sdf_fn, org, dirs,
                                          mask_intersect, t_near, t_far,
                                          mode)
    else:
        unfin_s, t_s, t_e = march_fn(org, dirs, mask_intersect, t_near,
                                     t_far)
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
        fn = lambda o, d, m, sm, lo, hi, sdf=sdf_fn, block=None: \
            _unified_fallback(cfg, sdf, o, d, m, sm, lo, hi, steps01,
                              training, secant_fn, mode, block)
        p_f, net_f, d_f = call_into(
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
    fn = lambda o, d, m, lo, hi, sdf=sdf_fn, block=None: _ray_sampler(
        cfg, sdf, o, d, m, lo, hi, training, secant_fn, mode, block)
    smpf = flat(sampler_mask)
    p_f, net_f, d_f = call_into(
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
    fn = lambda o, d, lo, hi, sdf=sdf_fn, block=None: _minimal_sdf_points(
        cfg, sdf, o, d, lo, hi, steps01)
    fillf = flat(fill)
    p_f, d_f = call_into(
        fn, fillf, [flat(org), flat(dirs), flat(min_dis), flat(max_dis)],
        [flat(points), flat(dists)], out_masks=[fillf, fillf])
    return TraceResult(p_f.reshape(lead + (3,)), net_obj_mask,
                       d_f.reshape(lead), sampler_mask, mask_intersect)


# ---------------------------------------------------------------------------
# Capacity helpers of the JAX package's compaction. The port gathers exactly
# the active rays, so the capacities they choose do not change results; the
# training CLI computes, prints and carries them as the JAX package does.
# ---------------------------------------------------------------------------

def auto_fallback_capacity(object_frac: float, sampler_margin: float = 0.30,
                           granularity: float = 1 / 16,
                           intersect_frac: Optional[float] = None,
                           fill_misses: bool = True) -> float:
    """Scene-aware capacity for the unified fallback stage.

    The fallback's active set is (march-unfinished rays) ∪ (every
    out-of-object-mask ray that intersects the bounding sphere) — the
    reference evaluates exactly this set by boolean indexing
    (ref ray_tracing.py:44-94). The out-of-mask part is STATIC per scene
    (1 - object_frac of rays, nearly all of which hit the bounding
    sphere), so a fixed capacity below it guarantees the dense overflow
    branch every step: the round-2 capstone scene (object_frac 0.38) ran
    active=0.84 against capacity 0.5 and paid dense 100-sample evals on
    all rays. Size the capacity as out-of-mask + a march-unfinished
    margin, rounded up for shape stability; >= 0.9 collapses to 1.0
    (pure dense, no gather — a near-full gather costs more than it saves).

    EVERY fallback ray additionally intersects the bounding sphere
    (both the sampler and fill sets require mask_intersect; left_out rays
    take the origin-projection branch instead, ref :79-84), so the
    scene's sphere-intersect fraction — pure camera geometry, no SDF —
    is a hard upper bound on the active set. Pass ``intersect_frac``
    (mean over sampled pixels of ray/bounding-sphere intersection) to
    apply it: on wide-FoV scenes where much of the frame misses the
    sphere it is far tighter than the mask bound (bench fixture: 0.33
    intersect vs all-ones masks).

    object_frac: mean of the scene's object masks over all images/pixels.
    fill_misses: False = the trace skips the min-SDF fill (see
    TracerConfig.fill_misses), so the active set is ONLY the
    march-unfinished sampler rays — the static out-of-mask term vanishes
    and the capacity is the sampler margin under the intersect bound.
    """
    if not fill_misses:
        frac = sampler_margin
        if intersect_frac is not None:
            frac = min(frac, intersect_frac + granularity)
    elif intersect_frac is not None:
        # the hard bound: active ⊆ intersecting rays, +granularity slack
        frac = intersect_frac + granularity
    else:
        frac = (1.0 - object_frac) + sampler_margin
    frac = np.ceil(frac / granularity) * granularity
    if frac >= 0.9:
        return 1.0
    return float(max(frac, granularity))


def auto_fallback_cascade(object_frac: float, sampler_margin: float = 0.30,
                          granularity: float = 1 / 16,
                          intersect_frac: Optional[float] = None,
                          fill_misses: bool = True):
    """Capacity cascade for the unified fallback.

    Top tier: the guaranteed static bound (sphere-intersect fraction when
    known, else the mask heuristic). Lower tiers (the mask heuristic, or
    half the top) engage automatically once training shrinks the miss set
    (the surface forms, fill rays become hits). Exact at every tier —
    overflow falls through to the next tier / dense.

    fill_misses=False (the fill-skipping trace, TracerConfig.fill_misses):
    the active set is only the march-unfinished rays — tiers are fractions
    of the sampler margin under the intersect bound, plus the intersect
    bound itself as the overflow tier (dense beyond it is impossible in
    exact arithmetic but kept as the cascade's safety property).
    """
    top = auto_fallback_capacity(object_frac, sampler_margin, granularity,
                                 intersect_frac, fill_misses=fill_misses)
    if top >= 1.0:
        return (1.0,)
    tiers = {top}
    if not fill_misses:
        half = float(max(np.ceil(top / 2 / granularity) * granularity,
                         2 * granularity))
        if half < top:
            tiers.add(half)
        if intersect_frac is not None:
            over = auto_fallback_capacity(object_frac, sampler_margin,
                                          granularity, intersect_frac)
            if 1.0 > over > top:
                tiers.add(over)
        return tuple(sorted(tiers))
    if intersect_frac is not None:
        mask_tier = auto_fallback_capacity(object_frac, sampler_margin,
                                           granularity)
        if mask_tier < top:
            tiers.add(mask_tier)
    if len(tiers) == 1:
        half = float(max(np.ceil(top / 2 / granularity) * granularity,
                         2 * granularity))
        if half < top:
            tiers.add(half)
    return tuple(sorted(tiers))


def auto_supervised_cascade(intersect_frac: Optional[float] = None,
                            granularity: float = 1 / 16):
    """Capacity ladder for the supervised-path compaction
    (ModelConfig.supervised_compact_frac). The compacted set is the
    surface-hit lanes, bounded above by the sphere-intersect fraction (a
    non-intersecting ray can never be a hit), so a tier at that bound can
    never overflow. As in the JAX package: one tier at the bound, and ()
    when the bound is 0.5 or more (gathering most rows costs more than it
    saves there)."""
    if intersect_frac is None:
        return ()
    bound = float(np.ceil(intersect_frac / granularity) * granularity)
    if bound >= 0.5:
        return ()
    return (max(bound, 2 * granularity),)


def ray_intersect_fraction(uv, intrinsics, pose, radius: float = 1.0,
                           max_rays: int = 200_000) -> float:
    """Fraction of pixel rays that intersect the bounding sphere — the
    hard geometric bound on the fallback active set. Host-side over a pixel
    subsample (every ``B * P // max_rays``-th pixel of each image, taken
    before anything is copied, so a broadcast ``uv`` costs nothing); f32 on
    the CPU, as the JAX package computes it.

    uv (B, P, 2) pixel coords, intrinsics (B, 4, 4), pose (B, 4, 4).
    """
    from ..geometry.cameras import get_camera_params
    uv = np.asarray(uv)
    B, P, _ = uv.shape
    stride = max(1, (B * P) // max_rays)
    uv = torch.from_numpy(np.ascontiguousarray(uv[:, ::stride], np.float32))
    dirs, org = get_camera_params(
        uv, torch.from_numpy(np.asarray(pose, np.float32)),
        torch.from_numpy(np.asarray(intrinsics, np.float32)))
    dirs, org = dirs.numpy(), org.numpy()
    org = np.broadcast_to(org[:, None, :], dirs.shape)
    d_dot_o = np.sum(dirs * org, -1)
    under = d_dot_o ** 2 - (np.sum(org ** 2, -1) - radius ** 2)
    return float(np.mean(under > 0))


def auto_march_schedule(object_frac: float, granularity: float = 1 / 16,
                        intersect_frac: Optional[float] = None):
    """Scene-aware mid-march compaction schedule.

    Object rays converge within ~2 iterations; background (out-of-mask)
    rays march until their start/end fronts cross, so the late-iteration
    active fraction tracks the background fraction (the JAX package's
    measured decay, scripts/march_decay.py). Each segment gets a tight
    tier from that decay plus a looser overflow tier from the
    early-training bound.

    Marching rays all intersect the bounding sphere, so ``intersect_frac``
    (see auto_fallback_capacity) additionally caps every segment — on
    wide-FoV scenes it also enables an iteration-0 segment (the march
    starts with exactly the intersecting rays active).
    """
    bg = 1.0 - object_frac

    def cap(x):
        if intersect_frac is not None:
            x = min(x, intersect_frac + granularity)
        x = np.ceil(x / granularity) * granularity
        return float(np.clip(x, 2 * granularity, 1.0))

    # tight tier: 0.95, 0.8, 0.62 of the background after iterations 1,
    # 4, 7; over tier from the loose early-training bound
    sched = [(1, 0.95 * bg + 0.03, bg + 0.25),
             (5, 0.80 * bg + 0.03, bg + 0.05),
             (8, 0.62 * bg + 0.03, 0.75 * bg + 0.05)]
    if intersect_frac is not None and cap(1.0) < 0.95:
        sched.insert(0, (0, 1.0, 2.0))
    out = []
    for s, tight, over in sched:
        tight, over = cap(tight), cap(over)
        if tight < 0.95 and (not out or tight < out[-1][1][0]):
            out.append((s, (tight, over) if over > tight and over < 0.95
                        else (tight,)))
    return tuple(out)
