"""Launch counts of the training step's kernel wrappers, by name: the
trace's kernels, the SDF network's activation kernel (``softplus100.py``:
its three entries, and the three of its bf16 activations) and the stage
stamps and row counters (``stamp.py``); and
the data-parallel step's all-reduces and their bytes
(``parallel/sharding``: ``allreduce``, ``allreduce_bytes``); the rows the
camera projections contract (``geometry/projections``:
``projected_rows``) and the SDF network's bf16 products contract
(``fields/mlp``: ``bf16_gemm_rows``).

Each wrapper adds one to its ``.launches`` where it launches its kernel.
Under CUDA-graph replay the wrappers run once, at capture, and every replay
launches the kernels again without them: the graph's owner takes
``since(before)`` around the capture and ``add``s it once per replay, so
the counts still mean launches.
"""
from __future__ import annotations

from typing import Dict


class HostCount:
    """A count the host keeps where the work is asked for, in the form
    ``wrappers`` carries: a ``.launches`` integer."""
    launches = 0


# the activation kernel's entries in ``wrappers``
ACT_KERNEL = ("softplus100_forward", "softplus100_grad",
              "softplus100_grad_grad")
# its launches with bf16 operands (the SDF network's bf16 activations)
ACT_KERNEL_BF16 = ("softplus100_bf16_forward", "softplus100_bf16_grad",
                   "softplus100_bf16_grad_grad")
# the entries of ``wrappers`` that count rows of work, not launches
ROWS = ("projected_rows", "bf16_gemm_rows")


def wrappers() -> Dict[str, object]:
    """name -> wrapper function, for every kernel of the trace, the
    activation kernel's entries and the stage stamps and counters; name ->
    counter, for the all-reduces, the projected rows and the bf16
    products' rows."""
    from ...fields import mlp as L
    from ...geometry import projections as G
    from ...parallel import sharding as D
    from . import march_kernel as M
    from . import sdf_mlp as K
    from . import secant_kernel as S
    from . import softplus100 as A
    from . import stamp as T
    return {"sdf_mlp": K.sdf_mlp, "sdf_mlp_xyz": K.sdf_mlp_xyz,
            "secant": S.secant, "sphere_march": M.sphere_march,
            "sdf_mlp_count": K.sdf_mlp_count,
            "sdf_mlp_xyz_count": K.sdf_mlp_xyz_count,
            "secant_count": S.secant_count,
            "softplus100_forward": A.forward, "softplus100_grad": A.grad,
            "softplus100_grad_grad": A.grad_grad,
            "softplus100_bf16_forward": A.forward.bf16,
            "softplus100_bf16_grad": A.grad.bf16,
            "softplus100_bf16_grad_grad": A.grad_grad.bf16,
            "stage_stamp": T.stamp, "stage_count": T.count,
            "allreduce": D.ALLREDUCES, "allreduce_bytes": D.ALLREDUCE_BYTES,
            "projected_rows": G.PROJECTED_ROWS,
            "bf16_gemm_rows": L.BF16_GEMM_ROWS}


def snapshot() -> Dict[str, int]:
    return {k: f.launches for k, f in wrappers().items()}


def since(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each kernel since ``before`` (a ``snapshot``)."""
    return {k: v - before[k] for k, v in snapshot().items()}


def add(launches: Dict[str, int]) -> None:
    for k, f in wrappers().items():
        f.launches += launches.get(k, 0)


def zero() -> None:
    for f in wrappers().values():
        f.launches = 0
