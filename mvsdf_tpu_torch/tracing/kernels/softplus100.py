"""Bias + Softplus(beta=100) of the SDF network's hidden layers and its two
derivatives, as PyTorch operators (``torch.ops.mvsdf.*``) whose CUDA
kernels are hand-written (``csrc/softplus100.cu``).

With s(z) = sigmoid(100 z):

- ``softplus100_bias(y, b, keep_z)`` -> (z, h): z = y + b and h =
  logaddexp(0, 100 z) / 100, the layer's activation, for the bias b
  broadcast to y's shape (``b.expand_as(y)``); z is empty without
  ``keep_z``;
- ``softplus100_grad(g, z, a)`` -> g s(z) (+ a), the activation's VJP
  (plus the gradient that reached z itself, where one did);
- ``softplus100_grad_grad(gg, g, z, want_g, want_z)`` -> (gg s(z),
  gg g 100 s(z) (1 - s(z))), the VJP of ``softplus100_grad`` with respect
  to g and z, each empty where its ``want_*`` is False.

With the SDF network's bf16 activations (``fields/sdf.py``) the hidden
activation h is stored in bf16, and its cotangent is bf16: with
``h_bf16`` ``softplus100_bias`` writes h in bf16, and the other two take
the dtype of g, f32 or bf16, from their operand (g's cotangent in g's
dtype): the f32 arithmetic with the casts to and from bf16 that the
plain chain (``softplus100(y + b).to(bfloat16)``) takes, inside the
launch.

Each operator runs its plain version (``*_reference``: PyTorch's ops in
the order the field's plain chain takes them) on any device but the card,
and on the card launches its kernel (``forward``, ``grad``, ``grad_grad``
here), or raises: f32 only (but for the bf16 operands named above), on
(..., cols) operands whose last dimension is contiguous. Each launch adds
one to the wrapper's ``.launches`` (a bf16 launch to its
``.bf16.launches``), which ``counts`` carries through CUDA graph replays.
The first two operators are differentiable: ``softplus100_bias``'s
backward is ``softplus100_grad``, which is y's gradient and the broadcast
bias's (the expand's own backward sums it over the rows, and only where
the bias's gradient is taken: not in the spatial gradient's backward),
and ``softplus100_grad``'s is ``softplus100_grad_grad``, which is not (no
loss takes a third derivative). Being operators, they are what ``torch.export`` records, so
an exported program launches the kernel on the card too.
``fields/sdf.bias_softplus100`` and the export's value + gradient
(``fields/fused_grad.value_and_grad``) call them.

``softplus100`` and the ``*_reference`` functions are the activation's
one plain form. The field's plain activation (``fields/sdf.softplus100``)
and the trace kernels' plain versions (``sdf_mlp.mlp_chain``) take it
from here.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .counts import HostCount
from .launch import raise_on_error, stream

PTR, I64, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
F32, BF16 = torch.float32, torch.bfloat16


def softplus100(z: torch.Tensor) -> torch.Tensor:
    """Softplus(beta=100) in the stable ``logaddexp(0, 100 z) / 100``
    form: the activation's one plain expression."""
    t = 100.0 * z
    return torch.logaddexp(torch.zeros_like(t), t) * 0.01


def forward_reference(y: torch.Tensor, b: torch.Tensor,
                      h_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, h), h cast to ``h_dtype`` where one is given."""
    z = y + b
    h = softplus100(z)
    return z, h if h_dtype is None else h.to(h_dtype)


def grad_reference(g: torch.Tensor, z: torch.Tensor,
                   a: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = g.to(z.dtype) * torch.sigmoid(100.0 * z)
    return out if a is None else out + a


def grad_grad_reference(gg: torch.Tensor, g: torch.Tensor, z: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g's cotangent in g's dtype, z's)"""
    s = torch.sigmoid(100.0 * z)
    return (gg * s).to(g.dtype), (gg * g.to(z.dtype)) * (1 - s) * s * 100.0


def _rows(name: str, t: torch.Tensor, shape, device,
          dtype=torch.float32) -> torch.Tensor:
    """``t``, ``dtype`` of ``shape`` on ``device``, as (rows, cols) with
    unit inner stride, or raise."""
    if t.device != device or t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{name} must be {dtype} on {device} of shape "
                         f"{tuple(shape)}, not {t.dtype} on {t.device} "
                         f"{tuple(t.shape)}")
    cols = t.shape[-1]
    t2 = t.reshape(-1, cols)
    if cols > 1 and t2.stride(1) != 1:
        raise ValueError(f"{name}'s last dimension must be contiguous")
    return t2


def _on_the_card(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name} launches on cuda, not {t.device}")


def _bias_row(b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The bias as the kernel reads it, one (cols,) row: ``b`` itself, or
    the row that ``b`` of y's shape broadcasts (stride 0 along every
    leading dimension longer than 1, as ``expand_as`` makes it)."""
    if b.dim() > 1:
        if b.shape != y.shape or any(
                st for st, n in zip(b.stride()[:-1], b.shape[:-1]) if n > 1):
            raise ValueError("b must be (cols,) or one row broadcast over "
                             "y's rows")
        b = b[(0,) * (b.dim() - 1)]
    return _rows("b", b, y.shape[-1:], y.device)


def _narrow(dtype: torch.dtype, name: str) -> int:
    """1 where an operand of ``dtype`` is bf16, 0 where f32, or raise."""
    if dtype not in (F32, BF16):
        raise ValueError(f"{name} must be float32 or bfloat16, not {dtype}")
    return int(dtype == BF16)


def _launched(entry, bf16: int) -> None:
    (entry.bf16 if bf16 else entry).launches += 1


def forward(y: torch.Tensor, b: torch.Tensor, keep_z: bool = True,
            h_dtype: torch.dtype = F32
            ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One launch: (z, h) of ``y`` (..., C) and the bias ``b``, (C,) or
    broadcast to y's shape, on the card, h in ``h_dtype`` (f32 or bf16);
    z is None without ``keep_z`` (then not written)."""
    _on_the_card(y, "softplus100_forward")
    bf16 = _narrow(h_dtype, "h")
    cols = y.shape[-1]
    y2 = _rows("y", y, y.shape, y.device)
    h = torch.empty(y.shape, dtype=h_dtype, device=y.device)
    z = torch.empty(y.shape, dtype=F32, device=y.device) if keep_z else None
    if y2.shape[0]:
        b2 = _bias_row(b, y)
        fn = build.function("softplus100_forward",
                            (PTR, I64, PTR, PTR, PTR, INT, I64, INT, PTR))
        raise_on_error(fn(y2.data_ptr(), y2.stride(0), b2.data_ptr(),
                          z.data_ptr() if keep_z else None, h.data_ptr(),
                          bf16, y2.shape[0], cols, stream(y.device)),
                       "softplus100_forward")
        _launched(forward, bf16)
    return z, h


def grad(g: torch.Tensor, z: torch.Tensor,
         a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch: g s(z), plus ``a`` where given; all of z's shape, on
    the card, g f32 or bf16, the rest f32."""
    _on_the_card(z, "softplus100_grad")
    bf16 = _narrow(g.dtype, "g")
    cols = z.shape[-1]
    g2 = _rows("g", g, z.shape, z.device, g.dtype)
    z2 = _rows("z", z, z.shape, z.device)
    a2 = None if a is None else _rows("a", a, z.shape, z.device)
    out = torch.empty(z.shape, dtype=F32, device=z.device)
    if z2.shape[0]:
        fn = build.function("softplus100_grad",
                            (PTR, I64, PTR, I64, PTR, I64, PTR, INT, I64,
                             INT, PTR))
        raise_on_error(fn(g2.data_ptr(), g2.stride(0), z2.data_ptr(),
                          z2.stride(0), None if a2 is None else a2.data_ptr(),
                          0 if a2 is None else a2.stride(0), out.data_ptr(),
                          bf16, z2.shape[0], cols, stream(z.device)),
                       "softplus100_grad")
        _launched(grad, bf16)
    return out


def grad_grad(gg: torch.Tensor, g: torch.Tensor, z: torch.Tensor,
              want: Tuple[bool, bool] = (True, True)
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One launch: (gg s(z) in g's dtype, gg g 100 s(z) (1 - s(z))) on the
    card, each None where ``want`` says so (then not written); g f32 or
    bf16, the rest f32."""
    _on_the_card(z, "softplus100_grad_grad")
    bf16 = _narrow(g.dtype, "g")
    cols = z.shape[-1]
    gg2, z2 = (_rows(k, t, z.shape, z.device) for k, t in (("gg", gg),
                                                             ("z", z)))
    g2 = _rows("g", g, z.shape, z.device, g.dtype)
    outs = [torch.empty(z.shape, dtype=dt, device=z.device) if w else None
            for w, dt in zip(want, (g.dtype, F32))]
    if z2.shape[0] and any(want):
        fn = build.function("softplus100_grad_grad",
                            (PTR, I64, PTR, I64, PTR, I64, PTR, PTR, INT,
                             I64, INT, PTR))
        raise_on_error(fn(gg2.data_ptr(), gg2.stride(0), g2.data_ptr(),
                          g2.stride(0), z2.data_ptr(), z2.stride(0),
                          *[None if o is None else o.data_ptr()
                            for o in outs],
                          bf16, z2.shape[0], cols, stream(z.device)),
                       "softplus100_grad_grad")
        _launched(grad_grad, bf16)
    return outs[0], outs[1]


for _entry in (forward, grad, grad_grad):
    _entry.launches = 0
    _entry.bf16 = HostCount()


# --- the operators ----------------------------------------------------------

def _empty(t: torch.Tensor) -> torch.Tensor:
    """What an operator returns for an output it was told not to write."""
    return t.new_empty(0)


@torch.library.custom_op("mvsdf::softplus100_bias", mutates_args=(),
                         schema="(Tensor y, Tensor b, bool keep_z, "
                                "bool h_bf16=False) -> (Tensor, Tensor)")
def softplus100_bias(y, b, keep_z, h_bf16=False):
    z, h = forward_reference(y, b, BF16 if h_bf16 else None)
    return (z if keep_z else _empty(y)), h


@softplus100_bias.register_kernel("cuda")
def _(y, b, keep_z, h_bf16=False):
    z, h = forward(y, b, keep_z, BF16 if h_bf16 else F32)
    return (z if keep_z else _empty(y)), h


@softplus100_bias.register_fake
def _(y, b, keep_z, h_bf16=False):
    return (torch.empty_like(y) if keep_z else _empty(y)), \
        torch.empty_like(y, dtype=BF16 if h_bf16 else F32)


@torch.library.custom_op("mvsdf::softplus100_grad", mutates_args=(),
                         schema="(Tensor g, Tensor z, Tensor? a) -> Tensor")
def softplus100_grad(g, z, a):
    return grad_reference(g, z, a)


@softplus100_grad.register_kernel("cuda")
def _(g, z, a):
    return grad(g, z, a)


@softplus100_grad.register_fake
def _(g, z, a):
    return torch.empty_like(z)


@torch.library.custom_op("mvsdf::softplus100_grad_grad", mutates_args=(),
                         schema="(Tensor gg, Tensor g, Tensor z, "
                                "bool want_g, bool want_z) -> "
                                "(Tensor, Tensor)")
def softplus100_grad_grad(gg, g, z, want_g, want_z):
    dg, dz = grad_grad_reference(gg, g, z)
    return (dg if want_g else _empty(g)), (dz if want_z else _empty(z))


@softplus100_grad_grad.register_kernel("cuda")
def _(gg, g, z, want_g, want_z):
    dg, dz = grad_grad(gg, g, z, (want_g, want_z))
    return (_empty(g) if dg is None else dg), (_empty(z) if dz is None
                                               else dz)


@softplus100_grad_grad.register_fake
def _(gg, g, z, want_g, want_z):
    return (torch.empty_like(z, dtype=g.dtype) if want_g else _empty(g)), \
        (torch.empty_like(z) if want_z else _empty(z))


def _bias_setup(ctx, inputs, output):
    if not inputs[2]:
        raise ValueError("softplus100_bias: a gradient needs z (keep_z); "
                         "was this call traced without a gradient?")
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(output[0])


def _bias_backward(ctx, gz, gh):
    """The gradient of y and of the broadcast b: h's through the
    activation's VJP, plus z's own (the spatial gradient's nodes send
    one)."""
    (z,) = ctx.saved_tensors
    dy = gz if gh is None else softplus100_grad(gh, z, gz)
    if dy is None:
        return None, None, None, None
    return tuple(dy if w else None for w in ctx.needs_input_grad[:2]) + \
        (None, None)


def _grad_setup(ctx, inputs, output):
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(inputs[0], inputs[1])


def _grad_backward(ctx, gg):
    if gg is None:
        return None, None, None
    g, z = ctx.saved_tensors
    want_g, want_z, want_a = ctx.needs_input_grad
    dg, dz = softplus100_grad_grad(gg, g, z, want_g, want_z)
    return (dg if want_g else None), (dz if want_z else None), \
        (gg if want_a else None)


softplus100_bias.register_autograd(_bias_backward, setup_context=_bias_setup)
softplus100_grad.register_autograd(_grad_backward, setup_context=_grad_setup)
