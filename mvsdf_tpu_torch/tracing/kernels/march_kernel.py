"""Fused bidirectional sphere-trace march: plain versions and CUDA wrapper.

Replaces the TPU kernel ``mvsdf_tpu/tracing/pallas/march_kernel.py``
(``pallas_sphere_trace``, ``pl.pallas_call`` at line 258). The kernel is
``csrc/march.cu``: the whole march in one launch of persistent blocks, one
an SM. A block keeps 32 rays in the slots of one 64-row tensor-core SDF-MLP
tile (start points in rows 0-31, end points in rows 32-63), advances each
ray by its own state machine, and refills a slot from a global queue of ray
indices the moment its ray ends, so the march needs no gather and no host
sync. Its header says what bounds it and what its design does about it.
``sphere_march`` is a drop-in for ``sphere_trace._sphere_trace`` (whose
``march_compact_schedule`` does not apply here, as in the JAX package).

- ``sphere_march_reference`` is the plain version and the definition:
  every ray in lockstep through a fixed number of trips, the results kept
  only on the rows the march uses.
- ``sphere_march_slots_reference`` is a plain model of the kernel's
  scheduler (queue, slots, per-ray state machine, refill). Every decision
  of the march is per ray, so rays advancing at their own pace give the
  lockstep result; the tests hold the model to it, and the model says how
  many tile rows a set of rays costs. Nothing on the main path calls it.
- ``sphere_march`` runs the plain version for tensors on the CPU, and for
  CUDA tensors launches the kernel or raises. ``sphere_march.launches``
  counts kernel launches.

All three add to ``rows``, when given (an int64 pair on the inputs'
device), [rows evaluated, rows used]. The rows used are those whose value
the march keeps. The kernel and its model evaluate 64 (``2 * slots``) rows
per tile evaluation; the lockstep version evaluates every row at every
trip.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..sphere_trace import TracerConfig, _mask_update
from . import build
from .sdf_mlp import (INT, PTR, TC_WEIGHT_ARGTYPES, PackedSDF,
                      check_multires, check_tensors, on_cpu, raise_on_error,
                      sdf_mlp_xyz_reference, stream, tc_weight_args)


def _flat_rays(org, dirs, mask_intersect, t_near, t_far):
    R = mask_intersect.numel()
    return (org.reshape(R, 3), dirs.reshape(R, 3), mask_intersect.reshape(R),
            t_near.reshape(R), t_far.reshape(R))


def sphere_march_reference(tcfg: TracerConfig, packed: PackedSDF,
                           multires: int, org, dirs, mask_intersect, t_near,
                           t_far, rows: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel; arguments as ``sphere_march``."""
    lead = mask_intersect.shape
    o, d, mi, tn, tf = _flat_rays(org, dirs, mask_intersect, t_near, t_far)
    unfin = torch.stack([mi, mi])           # (2, R): start, end
    t = torch.where(unfin, torch.stack([tn, tf]), torch.zeros_like(tn))
    sign = torch.tensor([[1.0], [-1.0]], dtype=t.dtype, device=t.device)
    counts = torch.zeros(2, dtype=torch.int64, device=t.device)
    clip, thr = tcfg.dist_clip, tcfg.sdf_threshold

    def evaluate(t, sel, base):
        """``base`` with rows ``sel`` replaced by the clipped SDF at t."""
        counts[0] += t.numel()
        counts[1] += sel.sum()
        v = sdf_mlp_xyz_reference(packed, multires,
                                  (o + t[..., None] * d).reshape(-1, 3))
        return torch.where(sel, v.reshape(t.shape).clamp(-clip, clip), base)

    zeros = torch.zeros_like(t)
    nxt = evaluate(t, unfin, zeros)
    for _ in range(tcfg.sphere_tracing_iters):
        unfin, curr = _mask_update(unfin, nxt, thr)
        t = t + sign * curr
        nxt = evaluate(t, unfin, zeros)
        for j in range(tcfg.line_step_iters):
            not_proj = nxt < 0
            step = ((1 - tcfg.line_search_step) / (2.0 ** j)) * curr
            t = torch.where(not_proj, t - sign * step, t)
            nxt = evaluate(t, not_proj, nxt)
        unfin = unfin & (t[0] < t[1])
    unfin, _ = _mask_update(unfin, nxt, thr)
    if rows is not None:
        rows += counts
    return unfin[0].reshape(lead), t[0].reshape(lead), t[1].reshape(lead)


def sphere_march_slots_reference(tcfg: TracerConfig, packed: PackedSDF,
                                 multires: int, org, dirs, mask_intersect,
                                 t_near, t_far,
                                 rows: Optional[torch.Tensor] = None,
                                 slots: int = 32, blocks: int = 1,
                                 detail: Optional[dict] = None):
    """Plain PyTorch model of the kernel's scheduler; arguments as
    ``sphere_march``, with ``slots`` rays a block and ``blocks`` blocks.

    A block with free slots claims that many ray indices from the queue,
    keeps those that meet the sphere and claims again until its slots are
    full or the queue is empty; rays that miss get t = 0 and cost no row.
    One tile evaluation (``2 * slots`` rows for every block with a live
    ray) gives a value to each row that waits for one: a ray's first
    evaluation, an iteration's step, or a line-search back-step. A ray
    whose rows are both through an iteration applies ``t_s < t_e`` and
    starts the next; after ``sphere_tracing_iters``, or with neither row
    unfinished, it takes the final mask update and frees its slot. The
    blocks here advance in rounds and claim in order; on the card they run
    free, so the kernel's evaluated count differs a little from the
    model's, and its results not at all.

    ``detail``, when given, receives ``rounds`` (the tile evaluations of
    the block that made most: the march's length in tile times),
    ``drained`` (the evaluations before the one at which the queue was
    found empty), ``longest_ray`` (the most evaluations one ray took: no
    schedule ends sooner) and ``live_rows`` (rows of slots that held a ray,
    summed over evaluations): evaluated - live_rows is what free slots cost
    once the queue is empty, live_rows - used what rows cost that waited
    for no value."""
    lead = mask_intersect.shape
    o, d, mi, tn, tf = _flat_rays(org, dirs, mask_intersect, t_near, t_far)
    R, dev = mi.numel(), tn.device
    thr, clip = tcfg.sdf_threshold, tcfg.dist_clip
    iters, line_iters = tcfg.sphere_tracing_iters, tcfg.line_step_iters
    scale = 1 - tcfg.line_search_step
    sign = torch.tensor([[1.0], [-1.0]], dtype=tn.dtype, device=dev)
    meets = mi.cpu().numpy()
    slot_ray = np.full((blocks, slots), -1, np.int64)   # -1: a free slot
    cursor = 0
    # a ray's state while it holds a slot, at its own index
    t = torch.zeros((2, R), dtype=tn.dtype, device=dev)
    nxt, curr = torch.zeros_like(t), torch.zeros_like(t)
    unfin = torch.zeros((2, R), dtype=torch.bool, device=dev)
    waits = torch.zeros_like(unfin)         # the row waits for a value
    back = torch.zeros((2, R), dtype=torch.int32, device=dev)
    it = torch.zeros(R, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    rounds = live_rows = 0
    drained = None
    evals = torch.zeros(R, dtype=torch.int32, device=dev)   # of each ray

    while True:
        claimed = []
        for b in range(blocks):
            free = np.flatnonzero(slot_ray[b] < 0)
            while free.size and cursor < R:
                idx = np.arange(cursor, min(cursor + free.size, R))
                cursor += free.size
                hits = idx[meets[idx]]
                slot_ray[b, free[:hits.size]] = hits
                free = free[hits.size:]
                claimed.append(hits)
        if claimed:
            new = torch.from_numpy(np.concatenate(claimed)).to(dev)
            t[:, new] = torch.stack([tn[new], tf[new]])
            unfin[:, new] = True
            waits[:, new] = True
            it[new] = -1        # the evaluation before the first iteration
        live = slot_ray >= 0
        if drained is None and cursor >= R:
            drained = rounds
        if not live.any():
            break
        rounds += 1
        live_rows += 2 * int(live.sum())
        a = torch.from_numpy(slot_ray[live]).to(dev)
        evals[a] += 1
        ta, wa, ia = t[:, a], waits[:, a], it[a]
        v = sdf_mlp_xyz_reference(
            packed, multires, (o[a] + ta[..., None] * d[a]).reshape(-1, 3))
        counts[0] += 2 * slots * int(live.any(1).sum())
        counts[1] += wa.sum()
        na = torch.where(wa, v.reshape(ta.shape).clamp(-clip, clip),
                         nxt[:, a])
        # line search: a row that overshot steps back
        ja, ca = back[:, a], curr[:, a]
        wa = (ia >= 0) & (na < 0) & (ja < line_iters)
        step = torch.ldexp(torch.full_like(ca, scale), -ja) * ca
        ta = torch.where(wa, ta - sign * step, ta)
        ja = ja + wa
        # a ray with no row stepping back is through the iteration
        over = ~wa.any(0)
        ua = unfin[:, a]
        ua = torch.where(over, ua & ((ta[0] < ta[1]) | (ia < 0)), ua)
        u2, c2 = _mask_update(ua, na, thr)
        done = over & ((ia + 1 >= iters) | ~u2.any(0))
        go = over & ~done
        # the next iteration's step
        ta = torch.where(go & u2, ta + sign * c2, ta)
        t[:, a] = ta
        nxt[:, a] = torch.where(go & ~u2, torch.zeros_like(na), na)
        curr[:, a] = torch.where(go, c2, ca)
        unfin[:, a] = torch.where(over, u2, ua)
        waits[:, a] = torch.where(go, u2, wa)
        back[:, a] = torch.where(go, torch.zeros_like(ja), ja)
        it[a] = torch.where(over, ia + 1, ia)
        ended = np.zeros(live.shape, bool)
        ended[live] = done.cpu().numpy()
        slot_ray[ended] = -1
    if rows is not None:
        rows += counts
    if detail is not None:
        detail.update(rounds=rounds, live_rows=live_rows, drained=drained,
                      longest_ray=int(evals.max()) if R else 0)
    return unfin[0].reshape(lead), t[0].reshape(lead), t[1].reshape(lead)


def _launch(tcfg, packed, multires, org, dirs, mi, t_near, t_far, rows):
    dev = org.device
    check_tensors(dev, org=org, dirs=dirs, t_near=t_near, t_far=t_far)
    check_tensors(dev, torch.bool, mask_intersect=mi)
    if rows is not None:
        check_tensors(dev, torch.int64, rows=rows)
        if rows.shape != (2,):
            raise ValueError("rows must be an int64 pair")
    wargs = tc_weight_args(packed, dev)
    n = org.shape[0]
    t_s = torch.empty(n, dtype=torch.float32, device=dev)
    t_e = torch.empty(n, dtype=torch.float32, device=dev)
    unfin = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return unfin, t_s, t_e
    # the queue's cursor over ray indices, zeroed on the stream
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.function(
        "march_forward", (PTR,) * 5 + (INT,) * 4 + (ctypes.c_float,) * 3 +
        TC_WEIGHT_ARGTYPES + (PTR,) * 6)
    raise_on_error(fn(
        org.data_ptr(), dirs.data_ptr(), mi.data_ptr(), t_near.data_ptr(),
        t_far.data_ptr(), n, multires, tcfg.sphere_tracing_iters,
        tcfg.line_step_iters, 1.0 - tcfg.line_search_step,
        tcfg.sdf_threshold, tcfg.dist_clip, *wargs, t_s.data_ptr(),
        t_e.data_ptr(), unfin.data_ptr(),
        None if rows is None else rows.data_ptr(), queue.data_ptr(),
        stream(dev)), "sphere_march")
    return unfin, t_s, t_e


def sphere_march(tcfg: TracerConfig, packed: PackedSDF, multires: int,
                 org: torch.Tensor, dirs: torch.Tensor,
                 mask_intersect: torch.Tensor, t_near: torch.Tensor,
                 t_far: torch.Tensor, rows: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional sphere tracing of the packed SDF-MLP.

    org, dirs (L..., 3) f32; mask_intersect (L...) bool; t_near, t_far
    (L...) f32. Returns (unfinished_start, t_start, t_end), each (L...).
    A CPU tensor goes through ``sphere_march_reference``; a CUDA tensor
    through the kernel (raising if it cannot run). Each kernel launch adds
    one to ``sphere_march.launches``."""
    lead = mask_intersect.shape
    if org.shape != lead + (3,) or dirs.shape != lead + (3,) or \
            t_near.shape != lead or t_far.shape != lead:
        raise ValueError("sphere_march takes org, dirs (L..., 3) and "
                         "mask_intersect, t_near, t_far (L...)")
    if any(t.dtype != torch.float32 for t in (org, dirs, t_near, t_far)) \
            or mask_intersect.dtype != torch.bool:
        raise ValueError("sphere_march takes f32 tensors and a bool mask")
    check_multires(packed, multires)
    if on_cpu(org, "sphere_march"):
        return sphere_march_reference(tcfg, packed, multires, org, dirs,
                                      mask_intersect, t_near, t_far, rows)
    flat = [a.contiguous() for a in _flat_rays(org, dirs, mask_intersect,
                                               t_near, t_far)]
    unfin, t_s, t_e = _launch(tcfg, packed, multires, *flat, rows)
    sphere_march.launches += flat[2].numel() > 0
    return unfin.reshape(lead), t_s.reshape(lead), t_e.reshape(lead)


sphere_march.launches = 0
