"""Fused value + spatial gradient of the implicit MLP with a hand-derived
backward (port of ``mvsdf_tpu/fields/fused_grad.py``).

``sdf.full_value_and_grad`` takes the spatial gradient with
``torch.autograd.grad(create_graph=True)``, and a loss on that gradient is
then differentiated by a double backward through autograd's graph. This
module derives that backward by hand from the mixed-derivative identity

    d/dp  <gbar, grad_x f>  =  d/dp  jvp(f; x, gbar)

so the gradient-output cotangent costs ONE forward tangent pass plus a
combined reverse pass in which the primal-chain and tangent-chain
cotangents are stacked along the point axis (one matmul per layer and
direction, twice the rows), and the only stored residuals are the per-layer
pre-activations z_l: activations and the positional encoding are recomputed
elementwise.

Softplus(beta=100):
    sigma(z)   = logaddexp(0, 100 z) / 100
    sigma'(z)  = sigmoid(100 z)
    sigma''(z) = 100 sigmoid(100 z) (1 - sigmoid(100 z))

The weight-norm reparameterisation stays outside the Function: the wrapper
passes each layer's effective weight, and autograd carries its cotangent on
to ``v`` and ``g``. Off by default (``ImplicitConfig.fused_value_grad``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

ISQRT2 = 1.0 / np.sqrt(2.0)


def _sigma(z):
    return torch.logaddexp(torch.zeros_like(z), 100.0 * z) * 0.01


def _sigma_p(z):
    return torch.sigmoid(100.0 * z)


def _sigma_pp(z):
    s = torch.sigmoid(100.0 * z)
    return 100.0 * s * (1.0 - s)


def _pe(x, multires):
    """Positional encoding and its elementwise first and second derivative
    factors: (pe (N, D), dpe (N, D), d2pe (N, D), coord (D,) int64 mapping
    each channel to its source coordinate)."""
    d = x.shape[-1]
    ar = torch.arange(d, device=x.device)
    if multires <= 0:
        return x, torch.ones_like(x), torch.zeros_like(x), ar
    parts, dparts, d2parts = [x], [torch.ones_like(x)], [torch.zeros_like(x)]
    for i in range(multires):
        f = 2.0 ** i
        xf = x * f
        s, c = torch.sin(xf), torch.cos(xf)
        parts += [s, c]
        dparts += [f * c, -f * s]
        d2parts += [-f * f * s, -f * f * c]
    return (torch.cat(parts, -1), torch.cat(dparts, -1),
            torch.cat(d2parts, -1), ar.repeat(1 + 2 * multires))


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
    """(out (N, 2+F), g (N, d), zs): the forward storing the
    pre-activations, then one reverse pass seeded on the SDF column."""
    L = len(Ws)
    inp, dpe, _, _ = _pe(x, multires)
    zs = []
    h = inp
    for l in range(L):
        ht = torch.cat([h, inp], -1) * ISQRT2 if l in skip_in else h
        z = _mm(ht, Ws[l], bf16) + bs[l]
        zs.append(z)
        h = _sigma(z) if l < L - 1 else z
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
            zb = hb * _sigma_p(zs[l - 1])
        else:
            inpbar = inpbar + hb
    g = _pe_pullback(inpbar * dpe, x.shape[-1])
    return out, g, zs


def _backward(multires, skip_in, bf16, x, Ws, zs, outbar, gbar, want_x):
    """(Wbars, bbars, xbar or None) for the cotangents (outbar, gbar); a
    ``gbar`` of None (no loss reads g) skips the tangent chain, whose
    every contribution is then zero."""
    L = len(Ws)
    n = x.shape[0]
    inp, dpe, d2pe, coord = _pe(x, multires)
    d0 = inp.shape[-1]
    tangent = gbar is not None

    # tangent pass in the direction gbar: <gbar, grad_x f> is the
    # derivative of f(x + eps gbar); the last layer's tangent is not read
    if tangent:
        gsel = gbar[:, coord]
        t_inp = dpe * gsel
        zetas = []
        u = t_inp
        for l in range(L - 1):
            ut = torch.cat([u, t_inp], -1) * ISQRT2 if l in skip_in else u
            zeta = _mm(ut, Ws[l], bf16)
            zetas.append(zeta)
            u = _sigma_p(zs[l]) * zeta

    # combined reverse pass: the primal chain's cotangent zb (seeded with
    # outbar) and the tangent chain's tb (seeded e_sdf, the coefficient of
    # <gbar, g> in the loss), stacked into one matmul a step
    zb = outbar
    inpbar = torch.zeros_like(inp)
    if tangent:
        tb = torch.zeros_like(outbar)
        tb[:, 0] = 1.0
        tinpbar = torch.zeros_like(inp)
    Wbars, bbars = [None] * L, [None] * L
    for l in range(L - 1, -1, -1):
        if l == 0:
            h_in = inp
            u_in = t_inp if tangent else None
        else:
            h_in = _sigma(zs[l - 1])
            u_in = _sigma_p(zs[l - 1]) * zetas[l - 1] if tangent else None
        if l in skip_in:
            h_in = torch.cat([h_in, inp], -1) * ISQRT2
            if tangent:
                u_in = torch.cat([u_in, t_inp], -1) * ISQRT2
        if tangent:
            ct = torch.cat([zb, tb], 0)                     # (2N, out)
            rows_in = torch.cat([h_in, u_in], 0)            # (2N, in)
        else:
            ct, rows_in = zb, h_in
        Wbars[l] = _mm(rows_in.T, ct, bf16)                 # (in, out)
        bbars[l] = zb.sum(0)
        back = _mm(ct, Ws[l].T, bf16)                       # (2N|N, in)
        hb, ub = (back[:n], back[n:]) if tangent else (back, None)
        if l in skip_in:
            inpbar = inpbar + hb[:, -d0:] * ISQRT2
            hb = hb[:, :-d0] * ISQRT2
            if tangent:
                tinpbar = tinpbar + ub[:, -d0:] * ISQRT2
                ub = ub[:, :-d0] * ISQRT2
        if l > 0:
            sp = _sigma_p(zs[l - 1])
            if tangent:
                zb = hb * sp + ub * zetas[l - 1] * _sigma_pp(zs[l - 1])
                tb = ub * sp
            else:
                zb = hb * sp
        else:
            inpbar = inpbar + hb
            if tangent:
                tinpbar = tinpbar + ub

    # x's cotangent through the PE:
    # J_PE^T inpbar + (d/dx [J_PE(x) gbar])^T tinpbar
    xbar = None
    if want_x:
        w = inpbar * dpe
        if tangent:
            w = w + tinpbar * d2pe * gsel
        xbar = _pe_pullback(w, x.shape[-1])
    return Wbars, bbars, xbar


class FusedValueGrad(torch.autograd.Function):
    """apply(multires, skip_in, bf16, x (N, d), *Ws, *bs) -> (out (N, 2+F),
    g (N, d)); Ws[l] (in, out) are the effective weights, bs[l] the
    biases. Saves x, the weights and the pre-activations only."""

    @staticmethod
    def forward(ctx, multires, skip_in, bf16, x, *params):
        L = len(params) // 2
        Ws, bs = params[:L], params[L:]
        out, g, zs = _forward(multires, skip_in, bf16, x, Ws, bs)
        ctx.cfg = (multires, skip_in, bf16, L)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, *Ws, *zs)
        return out, g

    @staticmethod
    @once_differentiable
    def backward(ctx, outbar, gbar):
        multires, skip_in, bf16, L = ctx.cfg
        x, *saved = ctx.saved_tensors
        Ws, zs = saved[:L], saved[L:]
        if outbar is None:
            outbar = torch.zeros_like(zs[-1])
        Wbars, bbars, xbar = _backward(multires, skip_in, bf16, x, Ws, zs,
                                       outbar, gbar,
                                       ctx.needs_input_grad[3])
        return (None, None, None, xbar, *Wbars, *bbars)


def fused_full_value_and_grad(net, x: torch.Tensor):
    """``sdf.full_value_and_grad`` through ``FusedValueGrad``: x (..., d)
    -> (out (..., 2+F), g (..., d)), with the same contract (under
    ``torch.no_grad()`` both come back detached)."""
    cfg = net.cfg
    Ws = [layer.effective_weight() for layer in net.layers]
    bs = [layer.b for layer in net.layers]
    lead = x.shape[:-1]
    out, g = FusedValueGrad.apply(cfg.multires, tuple(cfg.skip_in),
                                  cfg.bf16_activations,
                                  x.reshape(-1, x.shape[-1]), *Ws, *bs)
    return out.reshape(*lead, out.shape[-1]), g.reshape(*lead, x.shape[-1])


@torch.no_grad()
def value_and_grad(net, x: torch.Tensor):
    """``sdf.full_value_and_grad``'s results with no autograd involved:
    the forward and the hand-derived reverse pass seeded on the SDF column
    (``_forward``), detached. The export's static render uses it, since
    ``torch.export`` cannot capture ``torch.autograd.grad``."""
    cfg = net.cfg
    Ws = [layer.effective_weight() for layer in net.layers]
    bs = [layer.b for layer in net.layers]
    lead = x.shape[:-1]
    out, g, _ = _forward(cfg.multires, tuple(cfg.skip_in),
                         cfg.bf16_activations, x.reshape(-1, x.shape[-1]),
                         Ws, bs)
    return out.reshape(*lead, out.shape[-1]), g.reshape(*lead, x.shape[-1])
