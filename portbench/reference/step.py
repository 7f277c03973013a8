"""MVSDF's training step in plain PyTorch: the batch's rays traced on the
current SDF, the traced points made differentiable by implicit
differentiation, the SDF, indicator and features at the sample groups
(traced surface points, uniform eikonal points and, where the phase asks
for them, points on and near the MVS depth surfaces), the shading of the
surface points, the five losses, the global gradient clip and Adam. The
configuration's ``schedule`` entry gives each phase's gates and weights.

Random draws come from a ``torch.Generator`` in the order the training
step makes them: the fill's stratified steps, the eikonal points, then,
with the depth-surface groups, their jitter and the two samplings.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import field
from .trace import Counter, trace


def phase_of(sched: dict, epoch: int, nepochs: int) -> int:
    tp = epoch / nepochs
    return sum(tp >= b for b in sched["phase"])


def gates_weights(sched: dict, epoch: int, nepochs: int):
    """(gates, weights) of the epoch's phase."""
    i = phase_of(sched, epoch, nepochs)
    ds = sched["use_dsurf_phase"][i]
    gates = {"dsurf": ds, "detach_geometry": i == 0, "feat": i > 0,
             "surf": i > 0}
    tp = epoch / nepochs
    weights = {"rgb": sched["rgb_weight"][i],
               "eikonal": sched["eikonal_weight"],
               "surf": sched["surf_weight"], "feat": sched["feat_weight"][i],
               "depth": sched["depth_weight"][i],
               "far_att": sched["far_att"][i],
               "near_att": sched["near_att"][i],
               "grad_cap": sched["grad_cap"][i] if tp >= sched["phase"][0]
               else 0.0}
    return gates, weights


def camera_rays(uv, pose, intr):
    """Pixel centres -> unit world directions (B, P, 3), centres (B, 3)."""
    fx, fy = intr[:, 0, 0, None], intr[:, 1, 1, None]
    cx, cy, sk = intr[:, 0, 2, None], intr[:, 1, 2, None], intr[:, 0, 1, None]
    x, y = uv[..., 0] + 0.5, uv[..., 1] + 0.5
    xc = (x - cx + cy * sk / fy - sk * y / fy) / fx
    yc = (y - cy) / fy
    cam = torch.stack([xc, yc, torch.ones_like(x), torch.ones_like(x)], -1)
    world = torch.einsum("bij,bpj->bpi", pose, cam)[..., :3]
    loc = pose[:, :3, 3]
    d = world - loc[:, None]
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True), loc


def _hom(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _project(pts_h, cams):
    """World points (..., 4) through MVS cameras (..., 2, 4, 4) ->
    (camera-frame points (..., 4), pixel coords (..., 2))."""
    pc = (cams[..., 0, :, :] @ pts_h[..., None])[..., 0]
    pc = pc / (pc[..., 3:] + 1e-9)
    p3 = pc[..., :3] / (pc[..., 3:] + 1e-9)
    pix = (cams[..., 1, :3, :3] @ p3[..., None])[..., 0]
    return pc, (pix / (pix[..., 2:] + 1e-9))[..., :2]


def _norm_coords(xy, h, w):
    size = torch.tensor([w, h], dtype=xy.dtype, device=xy.device)
    g = (xy / size * 2 - 1).clamp(-1.1, 1.1)
    return g, torch.all((g >= -1) & (g <= 1), -1)


def carving(pts, depths, cams, out_perc):
    """Signed distance of world points (M, 3) to V depth maps (V, 1, h, w):
    the nearest inside distance where most views see the point in front of
    their surface, else the farthest outside one. Returns (dist,
    inside, support)."""
    V, _, h, w = depths.shape
    big = 1e30 / V
    pc, xy = _project(_hom(pts)[None], cams[:, None])
    g, inr = _norm_coords(xy, h, w)
    got = F.grid_sample(depths, g[:, :, None], mode="nearest",
                        padding_mode="zeros", align_corners=False)[:, 0, :, 0]
    valid = (got > 0) & inr
    inside = (pc[..., 2] > got * 0.99) & valid
    outside = valid & ~inside
    dist = (pc[..., 2] - got) * valid
    pos = torch.where(inside, dist, torch.full_like(dist, big)).amin(0)
    neg = torch.where(outside, dist, torch.full_like(dist, -big)).amax(0)
    pos = torch.where(inside.any(0), pos, torch.full_like(pos, big))
    neg = torch.where(outside.any(0), neg, torch.full_like(neg, -big))
    n_valid, n_in = valid.sum(0), inside.sum(0)
    perc = (n_valid - n_in) / (n_valid + 1e-9)
    support = n_valid > 0
    out = (perc > out_perc) & support
    ins = support ^ out
    return pos * ins + neg * out, ins, support


def _safe_norm(x):
    return torch.sqrt(torch.clamp_min(torch.sum(x * x, -1), 1e-18))


def _dsurf(batch, r, n, gen):
    """The depth-surface groups: n points on the MVS surfaces and n
    jittered by U(-0.1, 0.1), drawn among those inside the cube."""
    depths, cams = batch["depths"], batch["depth_cams"]
    N, _, h, w = depths.shape
    x = torch.arange(w, dtype=torch.float32, device=depths.device) + 0.5
    y = torch.arange(h, dtype=torch.float32, device=depths.device) + 0.5
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)], -1)[None]
    d = depths[:, 0]
    K = cams[:, 1, :3, :3][:, None, None]
    pc = (torch.linalg.inv(K) @ pix[..., None])[..., 0]
    pc = _hom(pc / (pc[..., 2:] + 1e-9) * d[..., None])
    E = torch.linalg.inv(cams[:, 0])[:, None, None]
    pw = (E @ pc[..., None])[..., 0]
    pw = (pw / (pw[..., 3:] + 1e-9))[..., :3].reshape(-1, 3)
    valid = (d > 0).reshape(-1)
    pts = (pw - batch["center"]) / batch["size"] * 2.0
    jit = pts + (torch.rand(pts.shape, generator=gen, device=pts.device)
                 * 0.2 - 0.1)
    out = []
    for p in (pts, jit):
        ok = valid & (torch.sum((p.abs() < r).float(), -1) > 2.9)
        u = torch.rand(p.shape[0], generator=gen, device=p.device)
        idx = torch.topk(torch.where(ok, u, torch.full_like(u, -1.0)),
                         n).indices
        out.append((p[idx], ok[idx]))
    return out


def losses(cfg: dict, params: dict, batch: dict, gates: dict, weights: dict,
           gen):
    """The weighted loss of one batch and its five terms."""
    icfg, rcfg = cfg["model"]["implicit"], cfg["model"]["render"]
    tcfg, sched = cfg["model"]["tracer"], cfg["schedule"]
    uv = batch["uv"]
    B, P, _ = uv.shape
    dev = uv.device
    obj_true = batch["object_mask"].bool()
    obj = obj_true if cfg["model"]["use_mask"] else torch.ones_like(obj_true)
    dirs, loc = camera_rays(uv, batch["pose"], batch["intrinsics"])
    org = loc[:, None].expand(B, P, 3)
    # the fill's stratified steps: drawn, and unused with the fill off
    torch.rand(tcfg["n_steps"], generator=gen, device=dev)
    detached = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        _, hit, dists, _ = trace(
            tcfg, Counter(lambda x: field.sdf_value(detached, icfg, x)),
            org.reshape(-1, 3), dirs.reshape(-1, 3), obj.reshape(-1))
    hit, dists = hit.reshape(B, P), dists.reshape(B, P)
    points = org + dists[..., None] * dirs
    surface = hit & obj
    r = tcfg["object_bounding_sphere"]
    half = P // 2
    eik = torch.rand((B, half, 3), generator=gen, device=dev) * (2 * r) - r
    groups = [("rt_surf", points, surface.float()),
              ("eik", eik, torch.ones((B, half), device=dev))]
    if gates["dsurf"]:
        for name, (p, ok) in zip(("dsurf_on", "dsurf_jitter"),
                                 _dsurf(batch, r, B * half, gen)):
            groups.append((name, p.reshape(B, half, 3),
                           ok.reshape(B, half).float()))
    out, grad = field.value_and_grad(
        params, icfg, torch.cat([p for _, p, _ in groups], 1))
    g = {}
    off = 0
    for name, p, m in groups:
        n = p.shape[1]
        g[name] = (p, out[:, off:off + n], grad[:, off:off + n], m)
        off += n
    sdf = g["rt_surf"][1][..., 0]
    # implicit differentiation of the traced points
    dot = torch.sum(g["rt_surf"][2].detach() * dirs, -1)
    dot = torch.where(dot.abs() < 1e-2,
                      torch.where(dot < 0, -1e-2, 1e-2).to(dot.dtype), dot)
    dot = torch.where(surface, dot, torch.ones_like(dot))
    t = dists - (sdf - sdf.detach()) / dot
    surf_pts = org + t[..., None] * dirs
    # shading
    o_s, nrm = field.value_and_grad(params, icfg, surf_pts)
    p_s, v_s = surf_pts, -dirs
    if gates["detach_geometry"]:
        p_s, nrm, v_s = p_s.detach(), nrm.detach(), v_s.detach()
    rgb = field.radiance(params, rcfg, p_s, nrm, v_s, o_s[..., 2:])
    rgb = torch.where(surface[..., None], rgb, torch.ones_like(rgb))

    l_rgb = torch.sum((rgb - batch["rgb"]).abs() * (hit & obj)[..., None]) \
        / (B * P)
    num = den = 0.0
    for name in ("rt_surf", "eik", "dsurf_on", "dsurf_jitter"):
        if name in g:
            num = num + torch.sum((_safe_norm(g[name][2]) - 1.0) ** 2 *
                                  g[name][3])
            den = den + torch.sum(g[name][3])
    l_eik = num / den if float(den) > 0 else torch.zeros((), device=dev)

    size, center = batch["size"], batch["center"]
    num = den = 0.0
    for name in ("rt_surf", "eik", "dsurf_on", "dsurf_jitter"):
        if name not in g:
            continue
        p, o, _, m = g[name]
        pw = (p.detach() / 2.0 * size + center).reshape(-1, 3)
        dist, _, sup = carving(pw, batch["depths"], batch["depth_cams"],
                               sched["out_thresh_perc"])
        dist, sup = dist.reshape(m.shape), sup.reshape(m.shape)
        dr = torch.clamp(dist / size * 2.0 - 1.25 * (~sup), -1.25, 1.25)
        fw = torch.where(dr.abs() > sched["far_thresh"], weights["far_att"],
                         1.0)
        nw = torch.where(dr.abs() < sched["near_thresh"], weights["near_att"],
                         1.0)
        num = num + torch.sum((o[..., 0] + dr).abs() * fw * nw * sup * m)
        den = den + torch.sum(m)
    l_depth = num / den if float(den) > 0 else torch.zeros((), device=dev)

    zero = torch.zeros((), device=dev)
    l_feat = _feat_loss(surf_pts, hit & obj, batch, sched) if gates["feat"] \
        else zero
    if gates["surf"]:
        bce = lambda x, y: torch.clamp_min(x, 0.0) - x * y + \
            torch.log1p(torch.exp(-x.abs()))
        pos_m = surface & obj_true
        neg = g["eik"][1][..., 1]
        l_surf = (torch.sum(bce(g["rt_surf"][1][..., 1], 1.0) * pos_m) +
                  bce(neg, 0.0).sum()) / max(int(pos_m.sum()) + neg.numel(),
                                             1)
    else:
        l_surf = zero
    loss = (l_rgb * weights["rgb"] + l_eik * weights["eikonal"] +
            l_surf * weights["surf"] + l_feat * weights["feat"] +
            l_depth * weights["depth"])
    return loss, (l_rgb, l_eik, l_depth, l_feat, l_surf)


def _feat_loss(pts, hit, batch, sched):
    """|1 - cos| between each surface point's feature in its image and in
    its two source views, over the pairs that see it and agree within 0.5,
    per image over S times its hits, then the mean over images."""
    feat, fsrc = batch["feat"], batch["feat_src"]
    B, P, _ = pts.shape
    S = fsrc.shape[1]
    h, w = feat.shape[-2:]
    pw = _hom(pts / 2.0 * batch["size"] + batch["center"])
    fmaps = torch.cat([feat[:, None], fsrc], 1)
    cams = torch.cat([batch["cam"][:, None], batch["src_cams"]], 1)
    _, xy = _project(pw[:, None], cams[:, :, None])
    grid, inr = _norm_coords(xy / float(sched["feat_img_scale"]), h, w)
    smp = F.grid_sample(fmaps.flatten(0, 1), grid.flatten(0, 1)[:, :, None],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)[..., 0]
    smp = smp.reshape(B, 1 + S, -1, P).transpose(-1, -2)
    ref, src = smp[:, :1], smp[:, 1:]
    corr = torch.sum(ref * src, -1) / _safe_norm(ref).clamp_min(1e-9) / \
        _safe_norm(src).clamp_min(1e-9)
    cl = (1.0 - corr).abs()
    sel = inr[:, :1] & inr[:, 1:] & (cl < 0.5) & hit[:, None]
    hits = hit.sum(-1).float()
    s = torch.sum(cl * sel, (1, 2))
    per = torch.where(hits > 0, s / (S * hits).clamp_min(1.0),
                      torch.zeros_like(s))
    return per.mean()


class Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8) at lr, the parameters' gradients
    clipped to a global norm of ``cap`` first (none where cap <= 0), a
    non-finite gradient applied as zeros."""

    def __init__(self, params: dict, lr: float):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def clip(self, grads: dict, cap: float) -> dict:
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                              for g in grads.values())).float()
        if cap > 0:
            coef = torch.clamp_max(cap / (norm + 1e-6), 1.0)
            grads = {k: g * coef for k, g in grads.items()}
        if not bool(torch.isfinite(norm)):
            grads = {k: torch.zeros_like(g) for k, g in grads.items()}
        return grads

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                den = self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t) + 1e-8
                p.sub_(self.lr / (1 - b1 ** self.t) * self.m[k] / den)


def train_steps(cfg: dict, params: dict, scene, plan, epoch: int, seed: int,
                device, start: dict = None):
    """The first ``len(plan)`` training steps from ``params`` (modified in
    place) on ``plan``: (image indices, pixel ids) per step, all of epoch
    ``epoch``'s phase. ``start`` maps a step's index to the weights it
    starts from instead (the draws still follow the seed). Returns (each
    step's loss, each step's clipped gradients, the weights after each
    step, on the host)."""
    train = cfg["train"]
    gates, weights = gates_weights(cfg["schedule"], epoch, train["nepochs"])
    opt = Adam(params, train["learning_rate"] * train["batch_size"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out, grads_of, weights_of = [], [], []
    for i, (indices, sel) in enumerate(plan):
        if start and i in start:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(start[i][k])
        for p in params.values():
            p.requires_grad_(True)
        batch = scene.batch(indices, sel)
        loss, _ = losses(cfg, params, batch, gates, weights, gen)
        keys = list(params)
        gs = torch.autograd.grad(loss, [params[k] for k in keys],
                                 allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g.detach()
                 for k, g in zip(keys, gs)}
        grads = opt.clip(grads, weights["grad_cap"])
        for p in params.values():
            p.requires_grad_(False)
        opt.step(params, grads)
        out.append(float(loss.detach()))
        grads_of.append({k: g.cpu() for k, g in grads.items()})
        weights_of.append({k: p.detach().cpu().clone()
                           for k, p in params.items()})
    return out, grads_of, weights_of
