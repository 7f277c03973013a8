"""ctypes binding of the native max-flow (port of
``mvsdf_tpu/meshcut/native.py``): ``csrc/maxflow.cpp``, a Dinic max-flow
built as a host library by ``tracing/kernels/build.py`` at first use. A
failed build raises; there is no Python stand-in."""
from __future__ import annotations

import ctypes

from ..tracing.kernels import build

SOURCE = "maxflow.cpp"


def load() -> ctypes.CDLL:
    lib = build.host_library(SOURCE)
    lib.mesh_maxflow_cut.restype = ctypes.c_int64
    lib.mesh_maxflow_cut.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib
