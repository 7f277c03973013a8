"""Fused bracketed secant for the no-grad trace: plain version and CUDA
wrapper.

Replaces the TPU kernel ``mvsdf_tpu/tracing/pallas/secant_kernel.py``
(``pallas_secant``, ``pl.pallas_call`` at line 137). The kernel is
``csrc/secant.cu``: all ``n_steps`` secant steps of 64 rays a block in one
launch, the brackets in shared memory, the tensor-core SDF-MLP tile (with
the positional encoding computed in the kernel) inside the loop. Its
header says what bounds it and what its design does about it.

- ``secant_reference`` is the plain version: the trace's own ``_secant``
  on the plain xyz MLP.
- ``secant`` runs the plain version for tensors on the CPU, and for CUDA
  tensors launches the kernel or raises. ``secant.launches`` counts kernel
  launches.
- ``secant_count`` is the kernel's count entry: a fixed capacity of rays,
  of which the kernel refines the first ``count`` (a 0-d int32 on the
  device that it reads itself) and leaves the rest 0, for the
  graph-replayed training step; ``secant_count_reference`` is its plain
  version.
"""
from __future__ import annotations

import torch

from ..sphere_trace import _secant
from . import build, stamp
from .sdf_mlp import (INT, PTR, TC_WEIGHT_ARGTYPES, PackedSDF, _count_arg,
                      check_multires, check_tensors, first_rows, on_cpu,
                      raise_on_error, sdf_mlp_xyz_reference, stream,
                      tc_weight_args)


def secant_reference(packed: PackedSDF, multires: int, n_steps: int, org,
                     dirs, z_lo, z_hi, s_lo, s_hi) -> torch.Tensor:
    """Plain PyTorch version of the kernel; arguments as ``secant``."""
    return _secant(n_steps,
                   lambda x: sdf_mlp_xyz_reference(packed, multires, x),
                   org, dirs, z_lo, z_hi, s_lo, s_hi)


def _launch(packed, multires, n_steps, org, dirs, z_lo, z_hi, s_lo, s_hi,
            count=None):
    dev = org.device
    check_tensors(dev, org=org, dirs=dirs, z_lo=z_lo, z_hi=z_hi, s_lo=s_lo,
                  s_hi=s_hi)
    cptr = None if count is None else _count_arg(count, dev)
    wargs = tc_weight_args(packed, dev)
    n = org.shape[0]
    out = (torch.empty if count is None else torch.zeros)(
        n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = build.function("secant_count_forward",
                        (PTR,) * 6 + (INT, PTR) + (INT,) * 2 +
                        TC_WEIGHT_ARGTYPES + (PTR, PTR))
    raise_on_error(fn(org.data_ptr(), dirs.data_ptr(), z_lo.data_ptr(),
                      z_hi.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(), n,
                      cptr, multires, n_steps, *wargs, out.data_ptr(),
                      stream(dev)), "secant")
    return out


def _check(packed, multires, org, dirs, z_lo, z_hi, s_lo, s_hi):
    n = org.shape[0]
    if org.shape != (n, 3) or dirs.shape != (n, 3) or any(
            t.shape != (n,) for t in (z_lo, z_hi, s_lo, s_hi)):
        raise ValueError("secant takes org, dirs (N, 3) and brackets (N,)")
    if any(t.dtype != torch.float32
           for t in (org, dirs, z_lo, z_hi, s_lo, s_hi)):
        raise ValueError("secant takes f32 tensors")
    check_multires(packed, multires)


def secant(packed: PackedSDF, multires: int, n_steps: int,
           org: torch.Tensor, dirs: torch.Tensor, z_lo: torch.Tensor,
           z_hi: torch.Tensor, s_lo: torch.Tensor,
           s_hi: torch.Tensor) -> torch.Tensor:
    """``n_steps`` bracketed secant steps on N rays -> z_pred (N,).

    org, dirs (N, 3) f32; the brackets z_lo, z_hi (N,) f32 with their SDF
    values s_lo, s_hi. A CPU tensor goes through ``secant_reference``; a
    CUDA tensor through the kernel (raising if it cannot run). Each kernel
    launch adds one to ``secant.launches``."""
    args = (org, dirs, z_lo, z_hi, s_lo, s_hi)
    _check(packed, multires, *args)
    if on_cpu(org, "secant"):
        return secant_reference(packed, multires, n_steps, *args)
    out = _launch(packed, multires, n_steps,
                  *(t.contiguous() for t in args))
    secant.launches += org.shape[0] > 0
    return out


secant.launches = 0


def secant_count_reference(packed: PackedSDF, multires: int, n_steps: int,
                           org, dirs, z_lo, z_hi, s_lo, s_hi,
                           count) -> torch.Tensor:
    """Plain version of the count entry: the first ``count`` rays as
    ``secant_reference`` refines them, the rest 0."""
    out = torch.zeros(org.shape[0], dtype=torch.float32, device=org.device)
    k = first_rows(count, org.shape[0])
    out[:k] = secant_reference(packed, multires, n_steps,
                               *(t[:k] for t in (org, dirs, z_lo, z_hi, s_lo,
                                                 s_hi)))
    return out


def secant_count(packed: PackedSDF, multires: int, n_steps: int,
                 org: torch.Tensor, dirs: torch.Tensor, z_lo: torch.Tensor,
                 z_hi: torch.Tensor, s_lo: torch.Tensor, s_hi: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """``secant`` on the first ``count`` of N rays, the rest of the (N,)
    result 0; ``count`` is a 0-d int32 on the rays' device, read by the
    kernel (no host sync; a CUDA graph replays the launch for any count).

    A CPU tensor goes through ``secant_count_reference``; a CUDA tensor
    through the kernel (raising if it cannot run). Each kernel launch adds
    one to ``secant_count.launches``. Under a ``stamp.StepProbe`` its
    SDF rows, count x n_steps, go to the probe's row counters."""
    args = (org, dirs, z_lo, z_hi, s_lo, s_hi)
    _check(packed, multires, *args)
    stamp.count_rows(count, org.shape[0], n_steps)
    if on_cpu(org, "secant_count"):
        return secant_count_reference(packed, multires, n_steps, *args,
                                      count)
    out = _launch(packed, multires, n_steps,
                  *(t.contiguous() for t in args), count=count)
    secant_count.launches += org.shape[0] > 0
    return out


secant_count.launches = 0
