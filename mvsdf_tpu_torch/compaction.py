"""Mask-compacted computation (port of ``mvsdf_tpu/compaction.py``).

Runs a per-row function only on the rows a mask selects, gathered by index,
and scatters its outputs into full-size targets. Three forms, one result per
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
  of the graph (``run_if``). The graph-replayed training step uses it.
- ``masked_call_into`` runs ``fn`` on every row with no gather, for
  ``torch.export`` (the static trace).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


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
    merged = []
    for k, (t, o) in enumerate(zip(targets, outs)):
        m = mask if out_masks is None else out_masks[k]
        m = m.reshape(m.shape + (1,) * (t.dim() - m.dim()))
        merged.append(torch.where(m, o.to(t.dtype), t))
    return tuple(merged)


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
    merged = []
    for k, (t, o) in enumerate(zip(targets, outs)):
        m = mask if out_masks is None else out_masks[k]
        m = m.reshape(m.shape + (1,) * (t.dim() - m.dim()))
        merged.append(torch.where(m, o[pos].to(t.dtype), t))
    return tuple(merged)


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


def bounded_rows(fn, x, count, out, tile: Optional[int] = None):
    """``out[s:e] = fn(x[s:e], n)`` for each tile [s, e) of the rows of
    ``x`` that starts below ``count`` (a 0-d int tensor), ``n`` being the
    tile's rows below the count; the other tiles of ``out`` keep what they
    hold. No host read under CUDA-graph capture (``run_if``), so the work
    follows the count to within a tile. ``fn`` must treat rows
    independently. Returns ``out``."""
    m = x.shape[0]
    tile = tile or tile_rows(m)
    for s in range(0, m, tile):
        e = min(s + tile, m)

        def body(s=s, e=e):
            out[s:e] = fn(x[s:e], (count - s).clamp(0, e - s))
        run_if(count > s, body)
    return out
