"""Operation and byte counts from shapes, the H100's peaks, and the
roofline bound.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 989 TFLOP/s
on the bf16 tensor cores, 3.35 TB/s of HBM. Operations count 2 per
multiply-add.
"""
from __future__ import annotations

from .weights import embed_dim, implicit_shapes, render_shapes

PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12


def sdf_column_macs(icfg: dict) -> int:
    """Multiply-adds of one SDF value: every hidden layer, and the SDF
    column of the last."""
    shapes = implicit_shapes(icfg)
    return sum(i * o for i, o in shapes[:-1]) + shapes[-1][0]


def implicit_macs(icfg: dict) -> int:
    """Multiply-adds of the SDF network's whole output at one point."""
    return sum(i * o for i, o in implicit_shapes(icfg))


def render_macs(rcfg: dict) -> int:
    return sum(i * o for i, o in render_shapes(rcfg))


def sdf_mlp_cost(icfg: dict, rows: int):
    """(operations, bytes) of ``sdf_mlp`` on ``rows`` encoded points: the
    SDF column at every row; each input read once (the encoded points in
    f32, every weight and bias of the column's layers in f32) and each
    output written once."""
    shapes = implicit_shapes(icfg)
    weights = sum(i * o + o for i, o in shapes[:-1]) + shapes[-1][0] + 1
    nbytes = 4 * (rows * embed_dim(icfg["multires"]) + rows + weights)
    return 2 * sdf_column_macs(icfg) * rows, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds one H100 needs: operations at the bf16 peak or
    bytes at the HBM rate, the larger."""
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_S)


def step_flops(icfg: dict, rcfg: dict, B: int, P: int, trace_rows: int,
               hits: int, dsurf: bool, detach_geometry: bool) -> int:
    """Model operations of one training step of B x P rays, each matrix
    product counted once:
    - the trace: ``trace_rows`` SDF values (the SDF column, forward);
    - the sample groups (the ``hits`` surface points, B*P/2 eikonal points
      and, with ``dsurf``, B*P more on the depth surfaces): the whole
      output forward, the spatial gradient, and the backward of both
      (weights and inputs): 2 + 2 + 4 + 4 = 12 operations per
      multiply-add;
    - the shading at the ``hits`` points: the SDF network's forward,
      spatial gradient and the backward of its forward (12 with the
      backward of the gradient too, where the geometry is not detached,
      else 8), and the radiance network forward and backward (6)."""
    full = implicit_macs(icfg)
    groups = hits + B * P // 2 + (B * P if dsurf else 0)
    shade = (8 if detach_geometry else 12) * full + 6 * render_macs(rcfg)
    return (2 * sdf_column_macs(icfg) * trace_rows + 12 * full * groups +
            shade * hits)
