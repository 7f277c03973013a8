"""Fused SDF-MLP for the no-grad trace: packing, plain version, CUDA wrapper.

Replaces the TPU kernel ``mvsdf_tpu/tracing/pallas/sdf_kernel.py``
(``pallas_sdf_apply``, ``pl.pallas_call`` at line 205). The kernel is
``csrc/sdf_mlp.cu``; its header says what bounds it (operations: ~3.67
MFLOP per point for the full-size net) and what its design does about it.

- ``pack_sdf_weights`` folds weight norm into effective weights once per
  step and zero-pads every hidden layer to the width H.
- ``sdf_mlp_reference`` is the plain PyTorch version of the kernel's
  arithmetic. The tests use it, and the chip smoke run holds the kernel
  against it.
- ``sdf_mlp`` runs the plain version for a tensor on the CPU, and for a
  CUDA tensor launches the kernel or raises. ``sdf_mlp.launches`` counts
  kernel launches.

The kernel is built from the source at first use with ``nvcc`` into
``_build/`` beside this file (a shared library with a plain C interface,
loaded with ctypes).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ...fields.sdf import ImplicitConfig, ImplicitNetwork, softplus100

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "sdf_mlp.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
MAX_H = 512      # two columns per thread, 256 threads
MAX_HIDDEN = 32  # skip layers are a 32-bit mask


class PackedSDF(NamedTuple):
    """Effective SDF-MLP weights in the kernel's layout (all f32,
    contiguous, one device): w_in (d_pe, H); b_in (H,); w_hid (n_hid, H, H);
    b_hid (n_hid, H); w_skip_pe (n_skip, d_pe, H) in hidden-layer order;
    w_out (H,) the SDF column; b_out (1,). ``skip`` marks each hidden
    layer that adds ``pe @ w_skip_pe`` and scales by 1/sqrt(2)."""
    w_in: torch.Tensor
    b_in: torch.Tensor
    w_hid: torch.Tensor
    b_hid: torch.Tensor
    w_skip_pe: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    skip: Tuple[bool, ...]

    @property
    def d_pe(self) -> int:
        return self.w_in.shape[0]

    @property
    def H(self) -> int:
        return self.w_in.shape[1]


def _round_up(x, m):
    return -(-x // m) * m


@torch.no_grad()
def pack_sdf_weights(net: ImplicitNetwork) -> PackedSDF:
    """Fold weight norm and zero-pad every hidden width to H (a multiple
    of 32). The zero bias and the zero rows of the next matrix keep the
    padded lanes (softplus(0) = log(2)/100) out of the result."""
    cfg = net.cfg
    dims = cfg.layer_dims
    n_layers = len(dims)
    d_pe = dims[0]
    if n_layers < 3 or 0 in cfg.skip_in:
        raise ValueError("the SDF kernel needs at least one hidden layer "
                         "and no skip into the first layer")
    H = _round_up(max(dims[1:-1]), 32)
    if H > MAX_H or n_layers - 3 > MAX_HIDDEN:
        raise ValueError(f"the SDF kernel takes hidden widths <= {MAX_H} "
                         f"and <= {MAX_HIDDEN} hidden layers")
    dev = net.layers[0].b.device
    f32 = dict(dtype=torch.float32, device=dev)
    layers = net.layers
    n_hid = n_layers - 3

    W0 = layers[0].effective_weight()
    w_in = torch.zeros(d_pe, H, **f32)
    w_in[:, :W0.shape[1]] = W0
    b_in = torch.zeros(H, **f32)
    b_in[:W0.shape[1]] = layers[0].b

    w_hid = torch.zeros(n_hid, H, H, **f32)
    b_hid = torch.zeros(n_hid, H, **f32)
    skip_pe = []
    skip = []
    for j in range(n_hid):
        l = j + 1
        W = layers[l].effective_weight()
        in_dim, out_dim = W.shape
        b_hid[j, :out_dim] = layers[l].b
        if l in cfg.skip_in:
            h_dim = in_dim - d_pe
            w_hid[j, :h_dim, :out_dim] = W[:h_dim]
            wpe = torch.zeros(d_pe, H, **f32)
            wpe[:, :out_dim] = W[h_dim:]
            skip_pe.append(wpe)
            skip.append(True)
        else:
            w_hid[j, :in_dim, :out_dim] = W
            skip.append(False)
    w_skip_pe = torch.stack(skip_pe) if skip_pe else \
        torch.zeros(0, d_pe, H, **f32)

    Wl = layers[n_layers - 2].effective_weight()
    w_out = torch.zeros(H, **f32)
    w_out[:Wl.shape[0]] = Wl[:, 0]
    b_out = layers[n_layers - 2].b[:1].detach().clone().float()
    return PackedSDF(w_in, b_in, w_hid, b_hid, w_skip_pe.contiguous(),
                     w_out, b_out.contiguous(), tuple(skip))


def sdf_mlp_reference(packed: PackedSDF, pe: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: pe (N, d_pe) f32 -> sdf (N,)."""
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    h = softplus100(pe @ packed.w_in + packed.b_in)
    k = 0
    for j, is_skip in enumerate(packed.skip):
        z = h @ packed.w_hid[j]
        if is_skip:
            z = (z + pe @ packed.w_skip_pe[k]) * inv_sqrt2
            k += 1
        h = softplus100(z + packed.b_hid[j])
    return h @ packed.w_out + packed.b_out


# --- build and load ---------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the SDF kernel is built from "
                       f"{SOURCE} with the CUDA toolkit")


def library_path() -> str:
    """Path of the built library, named by a hash of the source so an
    edited source is rebuilt."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsdf_mlp_{digest}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/sdf_mlp.cu for sm_90a (no-op when already built);
    returns the library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, path)
    return path


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            fn = lib.sdf_mlp_forward
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, i, i, p, p, p, p, i, ctypes.c_uint, p, p, p,
                           i, p, p]
            fn.restype = i
            _LIB = lib
        return _LIB


def _launch(packed: PackedSDF, pe: torch.Tensor) -> torch.Tensor:
    n, d_pe = pe.shape
    if d_pe != packed.d_pe:
        raise ValueError(f"pe has {d_pe} lanes, the weights {packed.d_pe}")
    for name, t in zip(PackedSDF._fields, packed):
        if isinstance(t, torch.Tensor) and (
                t.device != pe.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"packed.{name} must be contiguous f32 on "
                             f"{pe.device}")
    out = torch.empty(n, dtype=torch.float32, device=pe.device)
    if n == 0:
        return out
    mask = sum(1 << j for j, s in enumerate(packed.skip) if s)
    stream = torch.cuda.current_stream(pe.device).cuda_stream
    rc = _library().sdf_mlp_forward(
        pe.data_ptr(), n, d_pe, packed.w_in.data_ptr(),
        packed.b_in.data_ptr(), packed.w_hid.data_ptr(),
        packed.b_hid.data_ptr(), len(packed.skip), mask,
        packed.w_skip_pe.data_ptr(), packed.w_out.data_ptr(),
        packed.b_out.data_ptr(), packed.H, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sdf_mlp kernel launch failed: CUDA error {rc}")
    return out


def sdf_mlp(packed: PackedSDF, pe: torch.Tensor) -> torch.Tensor:
    """SDF column of the packed MLP at pe (N, d_pe) f32 -> (N,).

    A CPU tensor goes through ``sdf_mlp_reference``; a CUDA tensor through
    the kernel (raising if it cannot run). Each kernel launch adds one to
    ``sdf_mlp.launches``."""
    if pe.dim() != 2 or pe.dtype != torch.float32:
        raise ValueError("pe must be a 2-D f32 tensor")
    if pe.device.type == "cpu":
        return sdf_mlp_reference(packed, pe)
    if pe.device.type != "cuda":
        raise ValueError(f"sdf_mlp runs on cpu or cuda, not {pe.device}")
    out = _launch(packed, pe.contiguous())
    sdf_mlp.launches += 1
    return out


sdf_mlp.launches = 0


def flops_per_point(cfg: ImplicitConfig) -> int:
    """Operations (2 per multiply-add) of one SDF evaluation at the net's
    true widths: every layer's matrix, the SDF column of the last."""
    shapes = cfg.layer_shapes()
    macs = sum(i * o for i, o in shapes[:-1]) + shapes[-1][0]
    return 2 * macs
