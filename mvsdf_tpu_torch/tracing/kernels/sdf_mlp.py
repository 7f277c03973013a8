"""Fused SDF-MLP for the no-grad trace: packing, plain versions, CUDA
wrappers.

Two kernels, both in ``csrc/sdf_mlp.cu`` on the tensor-core MLP tile of
``csrc/mlp_tile_tc.cuh`` (which the fused secant and march kernels loop
over too):

- ``sdf_mlp`` takes the positional encoding pe (N, d_pe). It replaces the
  TPU kernel ``mvsdf_tpu/tracing/pallas/sdf_kernel.py`` (``pallas_sdf_apply``,
  ``pl.pallas_call`` at line 205).
- ``sdf_mlp_xyz`` takes the points x (N, 3) and computes the encoding in
  the kernel. It replaces the same call with ``in_kernel_pe=True``
  (``_make_pe_kernel``, lines 137-157).

The kernel sources say what bounds them (operations: ~3.67 MFLOP per point
for the full-size net) and what their design does about it: every product
runs on the tensor cores as three bf16 products of operands split into
hi = bf16(v) and lo = bf16(v - hi), summed in f32.

- ``pack_sdf_weights`` folds weight norm into effective weights once per
  step and zero-pads every hidden layer to the width H (the f32 fields;
  the plain versions read them), then splits and tiles them for the
  tensor-core tile (``w_tc``, ``v_tc``; every kernel takes these).
- ``sdf_mlp_reference`` and ``sdf_mlp_xyz_reference`` are the plain f32
  PyTorch versions of the kernels' function: the yardstick the kernels are
  held to. ``sdf_mlp_split_reference`` is the plain version of the kernels'
  arithmetic, split products and all, with f32 sums or, with
  ``accumulation="tensor_core"``, the sums as the card's tensor cores take
  them (``tc_k_step``: each k-step's terms aligned and cut toward zero,
  which is where the kernels' one-sided error from f32 comes from). The
  tests use them, and the chip smoke run holds the kernels against them.
- ``sdf_mlp`` and ``sdf_mlp_xyz`` run the plain version for a tensor on the
  CPU, and for a CUDA tensor launch the kernel or raise. Their
  ``.launches`` count kernel launches.
- ``sdf_mlp_count`` and ``sdf_mlp_xyz_count`` are the kernels' count
  entries: a fixed capacity of rows, of which the kernel computes the first
  ``count`` (a 0-d int32 on the device that it reads itself) and leaves the
  rest 0. The graph-replayed training step evaluates its compacted blocks
  through them (``compaction.bounded_call_into``); their plain versions are
  ``sdf_mlp_count_reference`` and ``sdf_mlp_xyz_count_reference``.

The kernels are built at first use (``build.py``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...fields.embedder import embed_dim, positional_encoding
from ...fields.sdf import ImplicitConfig, ImplicitNetwork
from . import build, stamp
from .softplus100 import softplus100
from .launch import INT, PTR, on_cpu, raise_on_error, stream

MAX_H = 512      # two warpgroups, each a 256-column wgmma
MAX_HIDDEN = 32  # skip layers are a 32-bit mask
TC_WIDTHS = (64, 128, 256, 512)  # padded widths the tile is built for
TC_K = 16        # wgmma's K: a k-step's rows of a weight matrix


class PackedSDF(NamedTuple):
    """Effective SDF-MLP weights in the kernel's layout (all f32,
    contiguous, one device): w_in (d_pe, H); b_in (H,); w_hid (n_hid, H, H);
    b_hid (n_hid, H); w_skip_pe (n_skip, d_pe, H) in hidden-layer order;
    w_out (H,) the SDF column; b_out (1,). ``skip`` marks each hidden
    layer that adds ``pe @ w_skip_pe`` and scales by 1/sqrt(2).

    For the tensor-core tile, at the padded width ``tc_width(H)``: ``w_tc``
    (bf16) is the stream of weight tiles ``tile_split_weights`` lays out;
    ``v_tc`` (n_hid + 2, HP) f32 holds b_in, b_hid and w_out, zero-padded."""
    w_in: torch.Tensor
    b_in: torch.Tensor
    w_hid: torch.Tensor
    b_hid: torch.Tensor
    w_skip_pe: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    skip: Tuple[bool, ...]
    w_tc: torch.Tensor
    v_tc: torch.Tensor

    @property
    def d_pe(self) -> int:
        return self.w_in.shape[0]

    @property
    def H(self) -> int:
        return self.w_in.shape[1]


def _round_up(x, m):
    return -(-x // m) * m


def tc_width(H: int) -> int:
    """The padded width the tensor-core tile runs a net of width H at."""
    for hp in TC_WIDTHS:
        if H <= hp:
            return hp
    raise ValueError(f"the SDF kernel takes hidden widths <= {MAX_H}")


def split_bf16(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """v (f32) -> (hi, lo) in bf16 with hi = bf16(v), lo = bf16(v - hi),
    both rounded to nearest even: hi + lo keeps 16 bits of v's mantissa
    (|v - hi - lo| <= 2^-17 |v|)."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def layer_matrices(w_in, w_hid, w_skip_pe, skip) -> list:
    """The f32 matrices of the weight stream in the order the tile consumes
    them, each (K, HP) with K a multiple of 16: the input layer's (KP, HP);
    then each hidden layer's (HP, HP), followed by its (KP, HP) from the PE
    if it is a skip layer. Rows above d_pe or H and columns above H are
    zero. The arguments are PackedSDF's fields of those names."""
    d_pe, H = w_in.shape
    HP, KP = tc_width(H), _round_up(d_pe, TC_K)

    def pad(w, rows):
        out = w.new_zeros(rows, HP)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    mats = [pad(w_in, KP)]
    k = 0
    for j, is_skip in enumerate(skip):
        mats.append(pad(w_hid[j], HP))
        if is_skip:
            mats.append(pad(w_skip_pe[k], KP))
            k += 1
    return mats


def tile_split_weights(mats) -> torch.Tensor:
    """The bf16 weight stream of the tensor-core tile: for every k-step (16
    rows) of every matrix in ``mats``, the hi tile then the lo tile of
    ``split_bf16``, each (16, HP) tile stored as wgmma's K-major core
    matrices: W[k][n] at element ((k // 8) * (HP // 8) + n // 8) * 64 +
    (n % 8) * 8 + k % 8."""
    tiles = []
    for w in mats:
        K, HP = w.shape
        both = torch.stack(split_bf16(w))             # (2, K, HP)
        t = both.reshape(2, K // TC_K, 2, 8, HP // 8, 8)
        # (hi/lo, k-step, kg, k8, ng, n8) -> (k-step, hi/lo, kg, ng, n8, k8)
        tiles.append(t.permute(1, 0, 2, 4, 5, 3).reshape(-1))
    return torch.cat(tiles).contiguous()


@torch.no_grad()
def pack_sdf_weights(net: ImplicitNetwork) -> PackedSDF:
    """Fold weight norm and zero-pad every hidden width to H (a multiple
    of 32). The zero bias and the zero rows of the next matrix keep the
    padded lanes (softplus(0) = log(2)/100) out of the result. The same
    matrices, split into bf16 hi/lo and tiled at the width tc_width(H), are
    the tensor-core tile's ``w_tc``."""
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
    w_skip_pe = w_skip_pe.contiguous()
    v_tc = torch.zeros(n_hid + 2, tc_width(H), **f32)
    v_tc[0, :H] = b_in
    v_tc[1:n_hid + 1, :H] = b_hid
    v_tc[n_hid + 1, :H] = w_out
    w_tc = tile_split_weights(layer_matrices(w_in, w_hid, w_skip_pe, skip))
    return PackedSDF(w_in, b_in, w_hid, b_hid, w_skip_pe, w_out,
                     b_out.contiguous(), tuple(skip), w_tc, v_tc)


def mlp_chain(packed: PackedSDF, pe: torch.Tensor, matmul) -> torch.Tensor:
    """pe (N, d_pe) f32 -> sdf (N,) with every layer's product taken by
    ``matmul(a, w, acc)`` (acc + a @ w, acc None for zero); bias, the
    skip's 1/sqrt(2), softplus100 and the SDF column's dot product in f32.
    A skip layer's product from the encoding is accumulated onto the one
    from h, as the tile does."""
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    h = softplus100(matmul(pe, packed.w_in, None) + packed.b_in)
    k = 0
    for j, is_skip in enumerate(packed.skip):
        z = matmul(h, packed.w_hid[j], None)
        if is_skip:
            z = matmul(pe, packed.w_skip_pe[k], z) * inv_sqrt2
            k += 1
        h = softplus100(z + packed.b_hid[j])
    return h @ packed.w_out + packed.b_out


def f32_matmul(a: torch.Tensor, w: torch.Tensor,
               acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    return a @ w if acc is None else acc + a @ w


def sdf_mlp_reference(packed: PackedSDF, pe: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: pe (N, d_pe) f32 -> sdf (N,)."""
    return mlp_chain(packed, pe, f32_matmul)


def sdf_mlp_xyz_reference(packed: PackedSDF, multires: int,
                          x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the in-kernel-PE kernel: x (N, 3) f32 ->
    sdf (N,)."""
    return sdf_mlp_reference(packed, positional_encoding(x, multires))


def split_matmul(a: torch.Tensor, w: torch.Tensor,
                 acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc + a @ w as the tensor-core tile computes it: both operands split
    by ``split_bf16``, a_hi w_hi + a_lo w_hi + a_hi w_lo with every product
    exact and the sums in f32."""
    a_hi, a_lo = (t.float() for t in split_bf16(a))
    w_hi, w_lo = (t.float() for t in split_bf16(w))
    out = a_hi @ w_hi + a_lo @ w_hi + a_hi @ w_lo
    return out if acc is None else acc + out


# --- the tensor cores' accumulation ----------------------------------------

# One `wgmma` k-step on the H100 (test_wgmma_k_step_rounding in
# tests/test_torch_cuda.py holds this model to the card): the 16 bf16
# products are exact; each of them and the f32 accumulator is aligned to E,
# the largest exponent among them (a product's being the sum of its
# operands' exponents, its significand in [1, 4)), and cut toward zero to a
# multiple of 2^(E - TC_ALIGN_BITS); the cut terms are summed exactly and
# the sum cut toward zero to f32.
TC_ALIGN_BITS = 25
TC_MODEL_ROWS = 1024   # rows ``tc_matmul`` models at a time (f64 memory)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32, rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def binary_exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) of f64 values, exactly; -2000 for 0."""
    e = torch.frexp(x).exponent.double() - 1
    return torch.where(x == 0, torch.full_like(e, -2000.0), e)


def tc_k_step(acc: torch.Tensor, a: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """acc (N, H) f32 + a (N, k) @ w (k, H) as one `wgmma` k-step of the H100
    adds them (a and w hold bf16 values, k <= 16; see TC_ALIGN_BITS)."""
    A, W, C = a.double(), w.double(), acc.double()
    P = A[:, :, None] * W[None]                      # (N, k, H), exact
    Ep = binary_exponent(A)[:, :, None] + binary_exponent(W)[None]
    Ep = torch.where(P == 0, torch.full_like(Ep, -2000.0), Ep)
    E = torch.maximum(Ep.amax(1), binary_exponent(C))
    q = torch.exp2(torch.clamp(E, min=-1000.0) - TC_ALIGN_BITS)
    s = (torch.trunc(P / q[:, None]) * q[:, None]).sum(1) + \
        torch.trunc(C / q) * q
    return round_toward_zero(s)


def tc_matmul(a: torch.Tensor, w: torch.Tensor,
              acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc + a @ w as the tile computes it: ``split_matmul``'s three bf16
    passes, every 16-row k-step of w taking hi x hi, lo x hi, hi x lo in
    turn into one accumulator by ``tc_k_step``."""
    a_hi, a_lo = (t.float() for t in split_bf16(a))
    w_hi, w_lo = (t.float() for t in split_bf16(w))
    out = (torch.zeros(a.shape[0], w.shape[1], device=a.device)
           if acc is None else acc.clone())
    for r in range(0, a.shape[0], TC_MODEL_ROWS):
        o = out[r:r + TC_MODEL_ROWS]
        for k in range(0, w.shape[0], TC_K):
            for x, y in ((a_hi, w_hi), (a_lo, w_hi), (a_hi, w_lo)):
                o = tc_k_step(o, x[r:r + TC_MODEL_ROWS, k:k + TC_K],
                              y[k:k + TC_K])
        out[r:r + TC_MODEL_ROWS] = o
    return out


def sdf_mlp_split_reference(packed: PackedSDF, pe: torch.Tensor,
                            accumulation: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of the kernels' arithmetic, step by step: pe
    (N, d_pe) f32 -> sdf (N,), every product split into three bf16 passes.
    ``accumulation="f32"`` sums them in f32 (``split_matmul``);
    ``"tensor_core"`` as the card's tensor cores do (``tc_matmul``, which
    cuts where f32 would round: the kernels' one-sided error; slow, f64 on
    the host's or card's vector units). The kernel still differs from the
    latter in its epilogue's f32 roundings and the SDF column's sum."""
    if accumulation == "f32":
        return mlp_chain(packed, pe, split_matmul)
    if accumulation != "tensor_core":
        raise ValueError(f"accumulation {accumulation!r}")
    return mlp_chain(packed, pe, tc_matmul)


# --- launching ------------------------------------------------------------

# the packed split weights as every kernel's C entry point takes them
TC_WEIGHT_ARGTYPES = (INT, INT, INT, ctypes.c_uint, PTR, PTR, PTR)


def check_tensors(device: torch.device, dtype=torch.float32, **tensors):
    """Raises unless every tensor is contiguous, of ``dtype``, on
    ``device``: the kernels take raw pointers."""
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {device}")


def check_multires(packed: PackedSDF, multires: int):
    if embed_dim(multires) != packed.d_pe:
        raise ValueError(f"multires {multires} encodes {embed_dim(multires)}"
                         f" lanes, the weights take {packed.d_pe}")


def _skip_mask(packed: PackedSDF) -> int:
    return sum(1 << j for j, s in enumerate(packed.skip) if s)


def tc_weight_args(packed: PackedSDF, device: torch.device) -> list:
    """The packed split weights as the C entry points take them
    (TC_WEIGHT_ARGTYPES), after checking their types, sizes and device."""
    HP, KP = tc_width(packed.H), _round_up(packed.d_pe, TC_K)
    n_hid = len(packed.skip)
    check_tensors(device, torch.bfloat16, **{"packed.w_tc": packed.w_tc})
    check_tensors(device, **{"packed.v_tc": packed.v_tc,
                             "packed.b_out": packed.b_out})
    rows = KP + n_hid * HP + sum(packed.skip) * KP
    if packed.w_tc.numel() != 2 * rows * HP or \
            packed.v_tc.shape != (n_hid + 2, HP):
        raise ValueError("packed.w_tc / v_tc do not match the net's shape")
    return [packed.d_pe, HP, n_hid, _skip_mask(packed),
            packed.w_tc.data_ptr(), packed.v_tc.data_ptr(),
            packed.b_out.data_ptr()]


def _launch(packed: PackedSDF, pe: torch.Tensor) -> torch.Tensor:
    n, d_pe = pe.shape
    if d_pe != packed.d_pe:
        raise ValueError(f"pe has {d_pe} lanes, the weights {packed.d_pe}")
    wargs = tc_weight_args(packed, pe.device)
    out = torch.empty(n, dtype=torch.float32, device=pe.device)
    if n == 0:
        return out
    fn = build.function("sdf_mlp_forward",
                        (PTR, INT, *TC_WEIGHT_ARGTYPES, PTR, PTR))
    raise_on_error(fn(pe.data_ptr(), n, *wargs, out.data_ptr(),
                      stream(pe.device)), "sdf_mlp")
    return out


def _launch_xyz(packed: PackedSDF, multires: int,
                x: torch.Tensor) -> torch.Tensor:
    wargs = tc_weight_args(packed, x.device)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    fn = build.function("sdf_mlp_xyz_forward",
                        (PTR, INT, INT, *TC_WEIGHT_ARGTYPES, PTR, PTR))
    raise_on_error(fn(x.data_ptr(), n, multires, *wargs, out.data_ptr(),
                      stream(x.device)), "sdf_mlp_xyz")
    return out


def sdf_mlp(packed: PackedSDF, pe: torch.Tensor) -> torch.Tensor:
    """SDF column of the packed MLP at pe (N, d_pe) f32 -> (N,).

    A CPU tensor goes through ``sdf_mlp_reference``; a CUDA tensor through
    the kernel (raising if it cannot run). Each kernel launch adds one to
    ``sdf_mlp.launches``."""
    if pe.dim() != 2 or pe.dtype != torch.float32:
        raise ValueError("pe must be a 2-D f32 tensor")
    if on_cpu(pe, "sdf_mlp"):
        return sdf_mlp_reference(packed, pe)
    out = _launch(packed, pe.contiguous())
    sdf_mlp.launches += pe.shape[0] > 0
    return out


sdf_mlp.launches = 0


def sdf_mlp_xyz(packed: PackedSDF, multires: int,
                x: torch.Tensor) -> torch.Tensor:
    """SDF column of the packed MLP at the points x (N, 3) f32 -> (N,),
    the positional encoding (``multires`` frequencies) computed in the
    kernel.

    A CPU tensor goes through ``sdf_mlp_xyz_reference``; a CUDA tensor
    through the kernel (raising if it cannot run). Each kernel launch adds
    one to ``sdf_mlp_xyz.launches``."""
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError("x must be an (N, 3) f32 tensor")
    check_multires(packed, multires)
    if on_cpu(x, "sdf_mlp_xyz"):
        return sdf_mlp_xyz_reference(packed, multires, x)
    out = _launch_xyz(packed, multires, x.contiguous())
    sdf_mlp_xyz.launches += x.shape[0] > 0
    return out


sdf_mlp_xyz.launches = 0


def _count_arg(count: torch.Tensor, device: torch.device) -> int:
    """The device pointer of a count entry's row count: a 0-d int32 on the
    rows' device."""
    check_tensors(device, torch.int32, count=count)
    if count.dim() != 0:
        raise ValueError("count must be a 0-d int32 tensor")
    return count.data_ptr()


def first_rows(count: torch.Tensor, n: int) -> int:
    """A CPU count as the plain versions read it: the rows below it, at
    most n."""
    return max(0, min(int(count), n))


def sdf_mlp_count_reference(packed: PackedSDF, pe: torch.Tensor,
                            count: torch.Tensor) -> torch.Tensor:
    """Plain version of the count entry: the first ``count`` rows of pe as
    ``sdf_mlp_reference`` computes them, the rest 0."""
    out = torch.zeros(pe.shape[0], dtype=torch.float32, device=pe.device)
    k = first_rows(count, pe.shape[0])
    out[:k] = sdf_mlp_reference(packed, pe[:k])
    return out


def sdf_mlp_xyz_count_reference(packed: PackedSDF, multires: int,
                                x: torch.Tensor,
                                count: torch.Tensor) -> torch.Tensor:
    """Plain version of the in-kernel-PE count entry: the first ``count``
    rows of x as ``sdf_mlp_xyz_reference`` computes them, the rest 0."""
    out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    k = first_rows(count, x.shape[0])
    out[:k] = sdf_mlp_xyz_reference(packed, multires, x[:k])
    return out


def sdf_mlp_count(packed: PackedSDF, pe: torch.Tensor,
                  count: torch.Tensor) -> torch.Tensor:
    """``sdf_mlp`` on the first ``count`` rows of pe (N, d_pe), the rest of
    the (N,) result 0; ``count`` is a 0-d int32 on pe's device, read by the
    kernel, so the launch never waits on the host and a CUDA graph can
    replay it for any count. The grid covers all N rows; blocks past the
    count exit at once.

    A CPU tensor goes through ``sdf_mlp_count_reference``; a CUDA tensor
    through the kernel (raising if it cannot run). Each kernel launch adds
    one to ``sdf_mlp_count.launches``. Under a ``stamp.StepProbe`` the
    rows it computes go to the probe's row counters."""
    if pe.dim() != 2 or pe.dtype != torch.float32:
        raise ValueError("pe must be a 2-D f32 tensor")
    stamp.count_rows(count, pe.shape[0])
    if on_cpu(pe, "sdf_mlp_count"):
        return sdf_mlp_count_reference(packed, pe, count)
    pe = pe.contiguous()
    n, d_pe = pe.shape
    if d_pe != packed.d_pe:
        raise ValueError(f"pe has {d_pe} lanes, the weights {packed.d_pe}")
    cptr = _count_arg(count, pe.device)
    wargs = tc_weight_args(packed, pe.device)
    out = torch.zeros(n, dtype=torch.float32, device=pe.device)
    if n == 0:
        return out
    fn = build.function("sdf_mlp_count_forward",
                        (PTR, INT, PTR, *TC_WEIGHT_ARGTYPES, PTR, PTR))
    raise_on_error(fn(pe.data_ptr(), n, cptr, *wargs, out.data_ptr(),
                      stream(pe.device)), "sdf_mlp_count")
    sdf_mlp_count.launches += 1
    return out


sdf_mlp_count.launches = 0


def sdf_mlp_xyz_count(packed: PackedSDF, multires: int, x: torch.Tensor,
                      count: torch.Tensor) -> torch.Tensor:
    """``sdf_mlp_xyz`` on the first ``count`` rows of x (N, 3), the rest of
    the (N,) result 0; ``count`` as ``sdf_mlp_count`` takes it.

    A CPU tensor goes through ``sdf_mlp_xyz_count_reference``; a CUDA
    tensor through the kernel (raising if it cannot run). Each kernel
    launch adds one to ``sdf_mlp_xyz_count.launches``; under a
    ``stamp.StepProbe`` its rows are counted as ``sdf_mlp_count``'s."""
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError("x must be an (N, 3) f32 tensor")
    check_multires(packed, multires)
    stamp.count_rows(count, x.shape[0])
    if on_cpu(x, "sdf_mlp_xyz_count"):
        return sdf_mlp_xyz_count_reference(packed, multires, x, count)
    x = x.contiguous()
    n = x.shape[0]
    cptr = _count_arg(count, x.device)
    wargs = tc_weight_args(packed, x.device)
    out = torch.zeros(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    fn = build.function("sdf_mlp_xyz_count_forward",
                        (PTR, INT, PTR, INT, *TC_WEIGHT_ARGTYPES, PTR, PTR))
    raise_on_error(fn(x.data_ptr(), n, cptr, multires, *wargs,
                      out.data_ptr(), stream(x.device)), "sdf_mlp_xyz_count")
    sdf_mlp_xyz_count.launches += 1
    return out


sdf_mlp_xyz_count.launches = 0


def flops_per_point(cfg: ImplicitConfig) -> int:
    """Operations (2 per multiply-add) of one SDF evaluation at the net's
    true widths: every layer's matrix, the SDF column of the last."""
    shapes = cfg.layer_shapes()
    macs = sum(i * o for i, o in shapes[:-1]) + shapes[-1][0]
    return 2 * macs
