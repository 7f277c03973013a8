"""Fused bidirectional sphere-trace march: plain version and CUDA wrapper.

Replaces the TPU kernel ``mvsdf_tpu/tracing/pallas/march_kernel.py``
(``pallas_sphere_trace``, ``pl.pallas_call`` at line 258). The kernel is
``csrc/march.cu``: the whole march of 16 rays per block in one launch,
their start and end points the 32 rows of one SDF-MLP tile, the state in
shared memory, every gate a block-wide vote, so the march needs no gather
and no host sync. Its header says what bounds it and what its design does
about it. ``sphere_march`` is a drop-in for ``sphere_trace._sphere_trace``
(whose ``march_compact_schedule`` does not apply here, as in the JAX
package).

- ``sphere_march_reference`` is the plain version: every row of every
  block evaluated at each of a fixed number of trips, the results kept
  only on the rows the march uses. A block's gate in the kernel is whether
  any of its rows is used, so the reference counts rows as the kernel
  does.
- ``sphere_march`` runs the plain version for tensors on the CPU, and for
  CUDA tensors launches the kernel or raises. ``sphere_march.launches``
  counts kernel launches.

Both add to ``rows``, when given (an int64 pair on the inputs' device),
[rows evaluated, rows used]: the kernel evaluates all 32 rows of a block
whose gate passes; the rows used are those whose value the march keeps.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..sphere_trace import TracerConfig, _mask_update
from . import build
from .sdf_mlp import (INT, PTR, WEIGHT_ARGTYPES, PackedSDF,
                      check_multires, check_tensors, on_cpu, raise_on_error,
                      sdf_mlp_xyz_reference, stream, weight_args)

RAYS = 16          # rays per block of the kernel
ROWS = 2 * RAYS    # MLP rows per block: start and end points


def sphere_march_reference(tcfg: TracerConfig, packed: PackedSDF,
                           multires: int, org, dirs, mask_intersect, t_near,
                           t_far, rows: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel; arguments as ``sphere_march``."""
    lead = mask_intersect.shape
    R = mask_intersect.numel()
    nb = -(-R // RAYS)
    pad = nb * RAYS - R

    def blocks(a, inner=()):
        """(L..., *inner) -> (nb, RAYS, *inner), zero/False padded."""
        a = a.reshape(R, *inner)
        a = torch.cat([a, a.new_zeros((pad, *inner))])
        return a.reshape(nb, RAYS, *inner)

    o = blocks(org, (3,))[:, None]          # (nb, 1, RAYS, 3)
    d = blocks(dirs, (3,))[:, None]
    mi = blocks(mask_intersect)
    unfin = torch.stack([mi, mi], 1)        # (nb, 2, RAYS): start, end
    zero = torch.zeros((), dtype=t_near.dtype, device=t_near.device)
    t = torch.where(unfin, torch.stack([blocks(t_near), blocks(t_far)], 1),
                    zero)
    sign = torch.tensor([1.0, -1.0], dtype=t.dtype,
                        device=t.device).view(1, 2, 1)
    counts = torch.zeros(2, dtype=torch.int64, device=t.device)
    clip, thr = tcfg.dist_clip, tcfg.sdf_threshold

    def evaluate(t, sel, base):
        """``base`` with rows ``sel`` replaced by the clipped SDF at t."""
        counts[0] += ROWS * sel.flatten(1).any(1).sum()
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
        unfin = unfin & (t[:, 0] < t[:, 1])[:, None]
    unfin, _ = _mask_update(unfin, nxt, thr)
    if rows is not None:
        rows += counts

    def out(a):
        return a.reshape(nb * RAYS)[:R].reshape(lead)

    return out(unfin[:, 0]), out(t[:, 0]), out(t[:, 1])


def _launch(tcfg, packed, multires, org, dirs, mi, t_near, t_far, rows):
    dev = org.device
    check_tensors(dev, org=org, dirs=dirs, t_near=t_near, t_far=t_far)
    check_tensors(dev, torch.bool, mask_intersect=mi)
    if rows is not None:
        check_tensors(dev, torch.int64, rows=rows)
        if rows.shape != (2,):
            raise ValueError("rows must be an int64 pair")
    wargs = weight_args(packed, dev)
    n = org.shape[0]
    t_s = torch.empty(n, dtype=torch.float32, device=dev)
    t_e = torch.empty(n, dtype=torch.float32, device=dev)
    unfin = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return unfin, t_s, t_e
    fn = build.function(
        "march_forward", (PTR,) * 5 + (INT,) * 4 + (ctypes.c_float,) * 3 +
        WEIGHT_ARGTYPES + (PTR,) * 5)
    raise_on_error(fn(
        org.data_ptr(), dirs.data_ptr(), mi.data_ptr(), t_near.data_ptr(),
        t_far.data_ptr(), n, multires, tcfg.sphere_tracing_iters,
        tcfg.line_step_iters, 1.0 - tcfg.line_search_step,
        tcfg.sdf_threshold, tcfg.dist_clip, *wargs, t_s.data_ptr(),
        t_e.data_ptr(), unfin.data_ptr(),
        None if rows is None else rows.data_ptr(), stream(dev)),
        "sphere_march")
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
    R = mask_intersect.numel()
    flat = [a.reshape(R, *a.shape[len(lead):]).contiguous()
            for a in (org, dirs, mask_intersect, t_near, t_far)]
    unfin, t_s, t_e = _launch(tcfg, packed, multires, *flat, rows)
    sphere_march.launches += R > 0
    return unfin.reshape(lead), t_s.reshape(lead), t_e.reshape(lead)


sphere_march.launches = 0
