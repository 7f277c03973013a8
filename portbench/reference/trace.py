"""IDR's ray tracer in plain PyTorch (MVSDF ``ray_tracing.py``), as the
training step uses it: the rays' bounding-sphere interval, sphere tracing
from both ends with a line search on overshoot, then, on the rays whose
march did not converge, 100 uniform samples, the first sign change (the
minimal SDF where there is none) and 8 secant steps; rays that miss the
sphere take the point nearest the origin. The training step runs with the
miss fill off, so the min-SDF points of rays that marched through nothing
are not computed.

``sdf`` maps points (M, 3) to values (M,). Each evaluation runs on the rays
whose value is used; ``Counter`` adds up those rows.
"""
from __future__ import annotations

import torch


class Counter:
    """An SDF that adds up the rows it evaluates."""

    def __init__(self, sdf):
        self.sdf_fn = sdf
        self.rows = 0

    def __call__(self, x):
        self.rows += x[..., 0].numel()
        return self.sdf_fn(x.reshape(-1, 3)).reshape(x.shape[:-1])


def _eval(sdf, org, dirs, t, sel, base, clip):
    out = base.clone()
    if bool(sel.any()):
        out[sel] = sdf(org[sel] + t[sel][:, None] * dirs[sel]).clamp(-clip,
                                                                      clip)
    return out


def march(cfg, sdf, org, dirs, mi, t_near, t_far):
    """Sphere tracing from the near end (row 0) and the far end (row 1).
    Returns (unfinished at the near end, t near, t far)."""
    thr, clip = cfg["sdf_threshold"], cfg["dist_clip"]
    unfin = torch.stack([mi, mi])
    t = torch.where(unfin, torch.stack([t_near, t_far]),
                    torch.zeros_like(unfin, dtype=t_near.dtype))
    sign = torch.tensor([[1.0], [-1.0]], device=t.device)
    org2, dirs2 = org.expand(2, *org.shape), dirs.expand(2, *dirs.shape)
    zeros = torch.zeros_like(t)
    nxt = _eval(sdf, org2, dirs2, t, unfin, zeros, clip)

    def settle(unfin, nxt):
        curr = torch.where(unfin, nxt, zeros)
        curr = torch.where(curr <= thr, zeros, curr)
        return unfin & (curr > thr), curr

    for _ in range(cfg["sphere_tracing_iters"]):
        if not bool(unfin.any()):
            break
        unfin, curr = settle(unfin, nxt)
        t = t + sign * curr
        nxt = _eval(sdf, org2, dirs2, t, unfin, zeros, clip)
        over = nxt < 0
        for j in range(cfg["line_step_iters"]):
            if not bool(over.any()):
                break
            step = ((1 - cfg["line_search_step"]) / 2.0 ** j) * curr
            t = torch.where(over, t - sign * step, t)
            nxt = _eval(sdf, org2, dirs2, t, over, nxt, clip)
            over = nxt < 0
        unfin = unfin & (t[0] < t[1])[None]
    unfin, _ = settle(unfin, nxt)
    return unfin[0], t[0], t[1]


def _pick(a, idx):
    if a.dim() == idx.dim() + 2:
        return torch.gather(a, -2, idx[..., None, None].expand(
            idx.shape + (1, a.shape[-1]))).squeeze(-2)
    return torch.gather(a, -1, idx[..., None]).squeeze(-1)


def secant(cfg, sdf, org, dirs, z_lo, z_hi, s_lo, s_hi):
    def z_of(sl, sh, zl, zh):
        den = sh - sl
        tiny = torch.where(den < 0, -1e-12, 1e-12).to(den.dtype)
        den = torch.where(den.abs() < 1e-12, tiny, den)
        return -sl * (zh - zl) / den + zl

    z = z_of(s_lo, s_hi, z_lo, z_hi)
    for _ in range(cfg["n_secant_steps"]):
        mid = sdf(org + z[:, None] * dirs)
        pos, neg = mid > 0, mid < 0
        z_lo, s_lo = torch.where(pos, z, z_lo), torch.where(pos, mid, s_lo)
        z_hi, s_hi = torch.where(neg, z, z_hi), torch.where(neg, mid, s_hi)
        z = z_of(s_lo, s_hi, z_lo, z_hi)
    return z


def sample(cfg, sdf, org, dirs, obj, t_lo, t_hi):
    """The sampler on (N,) rays: (points, hit, distance)."""
    S = cfg["n_steps"]
    steps = torch.linspace(0.0, 1.0, S, device=org.device)
    ts = t_lo[:, None] + steps * (t_hi - t_lo)[:, None]
    pts = org[:, None] + ts[..., None] * dirs[:, None]
    val = sdf(pts)
    weight = torch.arange(S, 0, -1, dtype=val.dtype, device=val.device)
    ind = torch.argmin(torch.sign(val) * weight, -1)
    hit = _pick(val, ind) < 0
    pick = torch.where(~(obj & hit), torch.argmin(val, -1), ind)
    d, p = _pick(ts, pick), _pick(pts, pick)
    s = hit & obj
    if bool(s.any()):
        lo = (ind - 1) % S
        z = secant(cfg, sdf, org[s], dirs[s], _pick(ts, lo)[s],
                   _pick(ts, ind)[s], _pick(val, lo)[s], _pick(val, ind)[s])
        d, p = d.clone(), p.clone()
        d[s] = z
        p[s] = org[s] + z[:, None] * dirs[s]
    return p, hit, d


def trace(cfg, sdf, org, dirs, obj):
    """Training-mode trace of flat rays org, dirs (N, 3), object mask
    obj (N,). Returns (points, hit, dists, sampler rays)."""
    r = cfg["object_bounding_sphere"]
    d_o = torch.sum(dirs * org, -1)
    under = d_o ** 2 - (torch.sum(org ** 2, -1) - r ** 2)
    mi = under > 0
    sq = torch.sqrt(torch.where(mi, under, torch.zeros_like(under)))
    zero = torch.zeros_like(under)
    t_near = torch.where(mi, -d_o - sq, zero).clamp_min(0.0)
    t_far = torch.where(mi, -d_o + sq, zero).clamp_min(0.0)
    unfin, t_s, t_e = march(cfg, sdf, org, dirs, mi, t_near, t_far)
    hit = t_s < t_e
    points = org + t_s[:, None] * dirs
    dists = t_s
    smp = unfin
    if bool(smp.any()):
        p, h, d = sample(cfg, sdf, org[smp], dirs[smp], obj[smp], t_s[smp],
                         t_e[smp])
        points, hit, dists = points.clone(), hit.clone(), dists.clone()
        points[smp], hit[smp], dists[smp] = p, h, d
    # rays that miss the sphere: the point of the ray nearest the origin
    left_out = ~mi & ~smp & ~(hit & obj)
    t_proj = -d_o
    points = torch.where(left_out[:, None], org + t_proj[:, None] * dirs,
                         points)
    dists = torch.where(left_out, t_proj, dists)
    return points, hit, dists, smp
