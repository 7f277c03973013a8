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
"""
from __future__ import annotations

import torch

from ..sphere_trace import _secant
from . import build
from .sdf_mlp import (INT, PTR, TC_WEIGHT_ARGTYPES, PackedSDF,
                      check_multires, check_tensors, on_cpu, raise_on_error,
                      sdf_mlp_xyz_reference, stream, tc_weight_args)


def secant_reference(packed: PackedSDF, multires: int, n_steps: int, org,
                     dirs, z_lo, z_hi, s_lo, s_hi) -> torch.Tensor:
    """Plain PyTorch version of the kernel; arguments as ``secant``."""
    return _secant(n_steps,
                   lambda x: sdf_mlp_xyz_reference(packed, multires, x),
                   org, dirs, z_lo, z_hi, s_lo, s_hi)


def _launch(packed, multires, n_steps, org, dirs, z_lo, z_hi, s_lo, s_hi):
    dev = org.device
    check_tensors(dev, org=org, dirs=dirs, z_lo=z_lo, z_hi=z_hi, s_lo=s_lo,
                  s_hi=s_hi)
    wargs = tc_weight_args(packed, dev)
    n = org.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = build.function("secant_forward",
                        (PTR,) * 6 + (INT,) * 3 + TC_WEIGHT_ARGTYPES +
                        (PTR, PTR))
    raise_on_error(fn(org.data_ptr(), dirs.data_ptr(), z_lo.data_ptr(),
                      z_hi.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(), n,
                      multires, n_steps, *wargs, out.data_ptr(),
                      stream(dev)), "secant")
    return out


def secant(packed: PackedSDF, multires: int, n_steps: int,
           org: torch.Tensor, dirs: torch.Tensor, z_lo: torch.Tensor,
           z_hi: torch.Tensor, s_lo: torch.Tensor,
           s_hi: torch.Tensor) -> torch.Tensor:
    """``n_steps`` bracketed secant steps on N rays -> z_pred (N,).

    org, dirs (N, 3) f32; the brackets z_lo, z_hi (N,) f32 with their SDF
    values s_lo, s_hi. A CPU tensor goes through ``secant_reference``; a
    CUDA tensor through the kernel (raising if it cannot run). Each kernel
    launch adds one to ``secant.launches``."""
    n = org.shape[0]
    if org.shape != (n, 3) or dirs.shape != (n, 3) or any(
            t.shape != (n,) for t in (z_lo, z_hi, s_lo, s_hi)):
        raise ValueError("secant takes org, dirs (N, 3) and brackets (N,)")
    if any(t.dtype != torch.float32
           for t in (org, dirs, z_lo, z_hi, s_lo, s_hi)):
        raise ValueError("secant takes f32 tensors")
    check_multires(packed, multires)
    args = (org, dirs, z_lo, z_hi, s_lo, s_hi)
    if on_cpu(org, "secant"):
        return secant_reference(packed, multires, n_steps, *args)
    out = _launch(packed, multires, n_steps,
                  *(t.contiguous() for t in args))
    secant.launches += n > 0
    return out


secant.launches = 0
