"""Value + spatial gradient of the implicit MLP with no autograd involved
(port of the forward of ``mvsdf_tpu/fields/fused_grad.py``).

``sdf.full_value_and_grad`` takes the spatial gradient with
``torch.autograd.grad``, which ``torch.export`` cannot record. The
export's static render calls ``value_and_grad`` instead: the forward,
keeping each hidden layer's pre-activation z, then one reverse pass seeded
on the SDF column, by hand.

The activation and its derivative are the kernels layer's operators
(``torch.ops.mvsdf.softplus100_bias`` and ``softplus100_grad``,
``tracing/kernels/softplus100.py``): the exported program records them,
so on the card it launches their kernels, and off the card they run the
plain chain's ops in its order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tracing.kernels import softplus100 as SP

ISQRT2 = 1.0 / np.sqrt(2.0)


def _pe(x, multires):
    """Positional encoding and its elementwise first derivative factors:
    (pe (N, D), dpe (N, D))."""
    if multires <= 0:
        return x, torch.ones_like(x)
    parts, dparts = [x], [torch.ones_like(x)]
    for i in range(multires):
        f = 2.0 ** i
        xf = x * f
        s, c = torch.sin(xf), torch.cos(xf)
        parts += [s, c]
        dparts += [f * c, -f * s]
    return torch.cat(parts, -1), torch.cat(dparts, -1)


def _mm(a, w, bf16):
    """a (M, K) @ w (K, N) in f32; ``bf16`` rounds both operands to bf16
    first (a product of two bf16 values is exact in f32, the sums stay
    f32), as JAX's ``dot_general`` with ``preferred_element_type=float32``
    and the port's ``mlp.linear_apply``."""
    if bf16:
        return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    return a @ w


def _pe_pullback(weighted, d):
    """(N, K*d) -> (N, d): the sum of the d-wide PE blocks."""
    n, width = weighted.shape
    return weighted.reshape(n, width // d, d).sum(1)


def _forward(multires, skip_in, bf16, x, Ws, bs):
    """(out (N, 2+F), g (N, d)): the forward storing the hidden layers'
    pre-activations, then one reverse pass seeded on the SDF column."""
    L = len(Ws)
    inp, dpe = _pe(x, multires)
    zs = []
    h = inp
    for l in range(L):
        ht = torch.cat([h, inp], -1) * ISQRT2 if l in skip_in else h
        y = _mm(ht, Ws[l], bf16)
        if l < L - 1:
            z, h = SP.softplus100_bias(y, bs[l], True)
            zs.append(z)
        else:
            h = y + bs[l]
    out = h

    d0 = inp.shape[-1]
    zb = torch.zeros_like(out)
    zb[:, 0] = 1.0
    inpbar = torch.zeros_like(inp)
    for l in range(L - 1, -1, -1):
        hb = _mm(zb, Ws[l].T, bf16)
        if l in skip_in:
            inpbar = inpbar + hb[:, -d0:] * ISQRT2
            hb = hb[:, :-d0] * ISQRT2
        if l > 0:
            zb = SP.softplus100_grad(hb, zs[l - 1], None)
        else:
            inpbar = inpbar + hb
    g = _pe_pullback(inpbar * dpe, x.shape[-1])
    return out, g


@torch.no_grad()
def value_and_grad(net, x: torch.Tensor):
    """``sdf.full_value_and_grad``'s results with no autograd involved:
    x (..., d) -> (out (..., 2+F), g (..., d)), detached. The export's
    static render uses it, since ``torch.export`` cannot capture
    ``torch.autograd.grad``."""
    cfg = net.cfg
    Ws = [layer.effective_weight() for layer in net.layers]
    bs = [layer.b for layer in net.layers]
    lead = x.shape[:-1]
    out, g = _forward(cfg.multires, tuple(cfg.skip_in),
                      cfg.bf16_activations, x.reshape(-1, x.shape[-1]),
                      Ws, bs)
    return out.reshape(*lead, out.shape[-1]), g.reshape(*lead, x.shape[-1])
