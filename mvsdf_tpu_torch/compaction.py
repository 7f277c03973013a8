"""Mask-compacted computation (port of ``mvsdf_tpu/compaction.py``).

Runs a per-row function only on the rows a mask selects, gathered by index,
and scatters its outputs into full-size targets. Four forms, one result per
row:

- ``compact_call_into`` gathers exactly the active rows (``nonzero``: a
  host sync, and a shape that depends on the data). The per-epoch training
  path and eval use it. The JAX package needs fixed-capacity blocks,
  capacity cascades and a dense overflow branch to give XLA static shapes;
  here the capacity fields of ``TracerConfig`` / ``ModelConfig`` carry over
  from the JAX configs but do not change results.
- ``bounded_call_into`` orders the rows on the device (active rows first,
  stably) and hands ``fn`` the whole fixed-size block with the active count
  as a 0-d device tensor: no host sync and no shape that depends on the
  data, so a CUDA graph can capture it. The block holds every row, so it
  needs no overflow branch; the kernels' count entries compute only the
  rows below the count, and ``bounded_rows`` runs a torch function on the
  tiles of the block that hold active rows, each tile a conditional node
  of the graph (``run_if``). The graph-replayed training step's trace
  uses it.
- ``bounded_cascade_call_into`` is the JAX package's capacity cascade
  with no host sync, for differentiated ``fn``: the ordered block split at
  the capacities, the first segment always run with plain autograd, each
  later one a conditional node that runs when the count reaches into it,
  in its forward and again (recomputed) in its backward. The rows computed
  are those of the tier JAX takes, every row on overflow. The
  graph-replayed training step's supervised path and shading use it.
- ``masked_call_into`` runs ``fn`` on every row with no gather, for
  ``torch.export`` (the static trace).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from .tracing.kernels import stamp


def compact_call_into(fn, mask, per_row_inputs: Sequence, targets: Sequence,
                      out_masks: Optional[Sequence] = None) -> Tuple:
    """Run ``fn`` (per-row input arrays -> tuple of per-row outputs) on the
    rows where ``mask`` (R,) is set, and return the targets with those rows
    replaced. With ``out_masks`` (one (R,) bool mask per output, each a
    subset of ``mask``), output k only replaces the rows of out_masks[k].
    Rows outside the mask always keep their target value. Differentiable:
    the scatter is an out-of-place ``index_put``."""
    if out_masks is not None and len(out_masks) != len(targets):
        raise ValueError("out_masks must match targets 1:1")
    idx = mask.nonzero().squeeze(-1)
    if idx.numel() == 0:
        return tuple(targets)
    outs = fn(*[a[idx] for a in per_row_inputs])
    merged = []
    for k, (t, o) in enumerate(zip(targets, outs)):
        rows = idx
        if out_masks is not None:
            keep = out_masks[k][idx]
            rows, o = idx[keep], o[keep]
        merged.append(t.index_put((rows,), o.to(t.dtype)))
    return tuple(merged)


def masked_call_into(fn, mask, per_row_inputs: Sequence, targets: Sequence,
                     out_masks: Optional[Sequence] = None) -> Tuple:
    """``compact_call_into``'s results with no gather: ``fn`` runs on every
    row, and its outputs replace the targets where the masks say. No shape
    depends on the data, so ``torch.export`` can capture it; a row's
    result is what the gathered call gives it, as long as ``fn`` treats
    rows independently."""
    if out_masks is not None and len(out_masks) != len(targets):
        raise ValueError("out_masks must match targets 1:1")
    outs = fn(*per_row_inputs)
    return tuple(_where_rows(mask if out_masks is None else out_masks[k],
                             o.to(t.dtype), t)
                 for k, (t, o) in enumerate(zip(targets, outs)))


def bounded_order(mask):
    """Device-side stable compaction order of the rows of ``mask`` (any
    shape, flattened): (perm, pos, count). ``perm`` (R,) lists the active
    rows in order, then the others in order; ``pos`` (R,) is its inverse
    (row r sits at block row pos[r]); ``count`` is the number of active
    rows, a 0-d int32 tensor. A cumsum and one scatter of a permutation:
    no host sync, no repeated index."""
    m = mask.reshape(-1)
    act = torch.cumsum(m, 0)
    count = act[-1:].reshape(()) if m.numel() else act.sum()
    rows = torch.arange(m.numel(), device=m.device)
    pos = torch.where(m, act - 1, count + rows - act)
    perm = torch.empty_like(pos).scatter_(0, pos, rows)
    return perm, pos, count.to(torch.int32)


def bounded_call_into(fn, mask, per_row_inputs: Sequence, targets: Sequence,
                      out_masks: Optional[Sequence] = None) -> Tuple:
    """``compact_call_into``'s results with no host sync: ``fn(count,
    *block_inputs)`` gets every row, the ``count`` active rows first
    (``bounded_order``), and must treat rows independently; only its
    outputs on the active rows are kept (rows past ``count`` may hold
    anything). With ``out_masks`` (each a subset of ``mask``), output k
    replaces the rows of out_masks[k] only. Differentiable (gathers and
    ``torch.where``)."""
    if out_masks is not None and len(out_masks) != len(targets):
        raise ValueError("out_masks must match targets 1:1")
    perm, pos, count = bounded_order(mask)
    outs = fn(count, *[a[perm] for a in per_row_inputs])
    return tuple(_where_rows(mask if out_masks is None else out_masks[k],
                             o[pos].to(t.dtype), t)
                 for k, (t, o) in enumerate(zip(targets, outs)))


@contextlib.contextmanager
def parameters_as(module, tensors):
    """Inside, ``module`` reads ``tensors`` (in ``module.parameters()``
    order) in place of its parameters."""
    slots = [(m, k) for m in module.modules()
             for k, p in m._parameters.items() if p is not None]
    old = [m._parameters[k] for m, k in slots]
    for (m, k), t in zip(slots, tensors):
        m._parameters[k] = t
    try:
        yield
    finally:
        for (m, k), t in zip(slots, old):
            m._parameters[k] = t


class _Segment(torch.autograd.Function):
    """``fn`` on one later segment of a cascade's block, run when ``pred``
    (a 0-d device bool) holds: its forward writes ``fn``'s outputs into
    zeros made before the conditional node, and its backward zeroes the
    gradients of the inputs and of ``module``'s parameters and then, under
    a node with the same predicate, recomputes ``fn`` and writes its VJP
    into them. Nothing the node computes is kept past it, so a skipped
    segment leaves zeros and contributes zero gradient. The recompute
    reads fresh leaves in place of the inputs and the parameters: under
    capture, autograd's nodes for the parameters themselves belong to the
    graph's stream, and the VJP must not wait on it from inside a node.
    The backward is first order: the loss is differentiated once, though
    ``fn`` may differentiate inside."""

    @staticmethod
    def forward(ctx, fn, module, pred, specs, n_in, *args):
        xs = args[:n_in]
        outs = [xs[0].new_zeros((xs[0].shape[0], *tail), dtype=dtype)
                for tail, dtype in specs]

        def body():
            for o, v in zip(outs, fn(*xs)):
                o.copy_(v)
        run_if(pred, body)
        ctx.fn, ctx.module, ctx.n_in = fn, module, n_in
        ctx.save_for_backward(pred, *args)
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *g_outs):
        pred, *args = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]
        grads = [torch.zeros_like(a) if n else None
                 for a, n in zip(args, need)]

        def body():
            leaves = [a.detach().requires_grad_(n)
                      for a, n in zip(args, need)]
            with torch.enable_grad(), parameters_as(ctx.module,
                                                    leaves[ctx.n_in:]):
                outs = ctx.fn(*leaves[:ctx.n_in])
            wrt = [a for a, n in zip(leaves, need) if n]
            live = [(o, g) for o, g in zip(outs, g_outs) if o.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in live], wrt,
                                           [g for _, g in live],
                                           allow_unused=True))
            for buf in grads:
                if buf is not None:
                    v = next(got)
                    if v is not None:
                        buf.copy_(v)
        run_if(pred, body)
        return (None, None, None, None, None, *grads)


def bounded_cascade_call_into(fn, mask, caps, per_row_inputs: Sequence,
                              targets: Sequence,
                              out_masks: Optional[Sequence] = None,
                              module: Optional[torch.nn.Module] = None
                              ) -> Tuple:
    """The JAX package's ``compact_call_into(..., capacity=caps,
    remat=True)`` with no host sync: ``fn`` (per-row inputs -> tuple of
    per-row outputs, rows independent) on the rows of the tier the active
    count takes, the exact dense computation past the top capacity, and
    differentiable with respect to the inputs and the parameters of
    ``module``, the one module ``fn`` reads parameters from (every tensor
    it reads that needs a gradient, other than its inputs).

    The rows are ordered active first, stably (``bounded_order``: JAX's
    ``argsort(~mask, stable=True)``), and the block is split at the
    capacities (ascending, those of ``mask.numel()`` or more dropped; none
    left: ``fn`` on every row, JAX's dense call). Segment 0, [0, c1), runs
    with plain autograd; segment j, [c_j, c_j+1) (the last ending at the
    row count), runs when the count exceeds c_j, as a ``_Segment``: a
    conditional node of a CUDA graph under capture (``run_if``), read on
    the host otherwise. So the rows computed are JAX's ``order[:cap]`` for
    the tier it takes, padding rows included, and every row on overflow;
    recomputing a later segment in the backward is JAX's remat, whose
    gradients equal the stored forward's.

    ``targets`` are full-size; without ``out_masks`` every computed row is
    written (JAX's unpredicated write), with them output k replaces the
    rows of out_masks[k] (each a subset of ``mask``) only. The other rows
    keep their target."""
    if out_masks is not None and len(out_masks) != len(targets):
        raise ValueError("out_masks must match targets 1:1")
    n = mask.numel()
    # JAX's _normalize_caps
    caps = tuple(sorted(c for c in caps if c < n))
    if not caps:
        outs = fn(*per_row_inputs)
        if out_masks is None:
            return tuple(o.to(t.dtype) for o, t in zip(outs, targets))
        return tuple(_where_rows(m, o.to(t.dtype), t)
                     for m, o, t in zip(out_masks, outs, targets))
    perm, pos, count = bounded_order(mask)
    block = [a[perm] for a in per_row_inputs]
    first = fn(*[b[:caps[0]] for b in block])
    specs = [(o.shape[1:], o.dtype) for o in first]
    params = tuple(module.parameters()) if module is not None else ()
    segments = [first]
    ran = [mask.new_ones(caps[0], dtype=torch.bool)]
    for s, e in zip(caps, caps[1:] + (n,)):
        pred = count > s
        segments.append(_Segment.apply(fn, module, pred, specs, len(block),
                                       *[b[s:e] for b in block], *params))
        ran.append(pred.expand(e - s))
    written = torch.cat(ran)[pos] if out_masks is None else None
    return tuple(_where_rows(written if out_masks is None else out_masks[k],
                             torch.cat([seg[k] for seg in segments])[pos]
                             .to(t.dtype), t)
                 for k, t in enumerate(targets))


def _where_rows(m, o, t):
    """Row-masked merge of (R,) ``m`` over (R, ...) ``o`` / ``t``."""
    return torch.where(m.reshape(m.shape + (1,) * (t.dim() - m.dim())), o, t)


def run_if(pred, body) -> None:
    """``body()`` when the 0-d bool tensor ``pred`` holds. While a CUDA
    graph is being captured, ``body`` is captured into a conditional node
    that each replay runs or skips by ``pred``'s value on the device (no
    host read; ``tracing/kernels/graph_cond``, inside its
    ``ConditionalBodies``); otherwise ``pred`` is read on the host.
    ``body`` writes its results into tensors made before the call: what it
    allocates is not there after a replay that skipped it."""
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        from .tracing.kernels.graph_cond import if_node
        with if_node(pred):
            body()
    elif bool(pred):
        body()


# rows a tile of ``bounded_rows`` holds at least, and tiles a block at most
TILE_ROWS = 1 << 12
MAX_TILES = 64


def tile_rows(n: int) -> int:
    """The tile of a block of ``n`` rows: at least TILE_ROWS rows, at most
    MAX_TILES tiles."""
    return max(TILE_ROWS, -(-n // MAX_TILES))


def bounded_rows(fn, x, count, out, tile: Optional[int] = None,
                 sdf_rows: bool = False):
    """``out[s:e] = fn(x[s:e], n)`` for each tile [s, e) of the rows of
    ``x`` that starts below ``count`` (a 0-d int tensor), ``n`` being the
    tile's rows below the count; the other tiles of ``out`` keep what they
    hold. No host read under CUDA-graph capture (``run_if``), so the work
    follows the count to within a tile. ``fn`` must treat rows
    independently. With ``sdf_rows`` (``fn`` an SDF evaluation) each tile
    that runs adds ``n`` and its e - s rows to the row counters of the
    step's ``stamp.StepProbe``, where one is entered. Returns ``out``."""
    m = x.shape[0]
    tile = tile or tile_rows(m)
    for s in range(0, m, tile):
        e = min(s + tile, m)

        def body(s=s, e=e):
            n = (count - s).clamp(0, e - s)
            if sdf_rows:
                stamp.count_rows(n, e - s, computed=e - s)
            out[s:e] = fn(x[s:e], n)
        run_if(count > s, body)
    return out
