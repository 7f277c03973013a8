"""Operation and byte counts of the bf16 configuration's supervised work
(``drivers/train_bf16.py`` times it): the SDF network's bf16 products and
the activation's bf16 entries, each input byte read once and each output
byte written once; peaks and the bound as ``flops.py`` has them.
"""
from __future__ import annotations

from .flops import bound_s

# elementwise operations an element of each bf16 entry, as the kernel
# computes it (csrc/softplus100.cu); far below the bytes' bound
ACT_OPS = {"forward": 7, "grad": 6, "grad_a": 7, "grad_grad": 10}


def act_bf16_cost(entry: str, rows: int, cols: int):
    """(operations, bytes) of one launch of an activation bf16 entry on
    (rows, cols): forward reads y (f32) and the bias row, writes z (f32)
    and h (bf16); grad reads g (bf16) and z (f32), with ``grad_a`` a
    (f32), and writes f32; grad_grad reads gg (f32), g (bf16), z (f32) and
    writes g's cotangent (bf16) and z's (f32)."""
    per = {"forward": 4 + 4 + 2, "grad": 2 + 4 + 4, "grad_a": 2 + 4 + 4 + 4,
           "grad_grad": 4 + 2 + 4 + 2 + 4}[entry]
    extra = 4 * cols if entry == "forward" else 0
    return ACT_OPS[entry] * rows * cols, per * rows * cols + extra


def bf16_gemm_cost(rows: int, K: int, N: int):
    """(operations, bytes) of one bf16 product (rows, K) @ (K, N) with an
    f32 result: 2 rows K N operations; x and the weight in bf16 read, the
    result in f32 written."""
    return 2 * rows * K * N, 2 * rows * K + 2 * K * N + 4 * rows * N


def share(costs, ms) -> float:
    """The roofline share (%) of work of these (operations, bytes) that
    took these milliseconds in all: the sum of the bounds over the sum of
    the times."""
    return sum(bound_s(*c) for c in costs) * 1e3 / sum(ms) * 100
