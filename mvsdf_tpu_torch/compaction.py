"""Mask-compacted computation (port of ``mvsdf_tpu/compaction.py``).

Runs a per-row function only on the rows a mask selects, gathered by index,
and scatters its outputs into full-size targets. The JAX package needs
fixed-capacity blocks, capacity cascades and a dense overflow branch to give
XLA static shapes; eager PyTorch gathers exactly the active rows, so the
capacity fields of ``TracerConfig`` / ``ModelConfig`` carry over from the
JAX configs but do not change results (nor, here, what is computed beyond
choosing where to compact). ``masked_call_into`` gives the same results
with no gather, for ``torch.export`` (the static trace).
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
