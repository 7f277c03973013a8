"""ctypes binding of the native marching-tetrahedra triangulator (port of
``mvsdf_tpu/eval/marching_native.py``): ``csrc/marching_tets.cpp``, built
as a host library by ``tracing/kernels/build.py`` at first use."""
from __future__ import annotations

import ctypes

import numpy as np

from ..tracing.kernels import build

SOURCE = "marching_tets.cpp"
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


def load() -> ctypes.CDLL:
    lib = build.host_library(SOURCE)
    lib.marching_tets.restype = ctypes.c_int64
    lib.marching_tets.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(_F32P), ctypes.POINTER(_I64P), _I64P]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_tets_native(volume: np.ndarray, level: float = 0.0):
    """volume (nx, ny, nz) float32 -> (verts (V, 3) in grid units, faces
    (F, 3) int64), equal to the numpy path of ``marching.py``: vertices in
    ``np.unique`` order of their edge keys, to the bit."""
    lib = load()
    vol = np.ascontiguousarray(volume, np.float32)
    nx, ny, nz = vol.shape
    verts_p, faces_p = _F32P(), _I64P()
    n_faces = ctypes.c_int64()
    nv = lib.marching_tets(vol.ctypes.data_as(_F32P), nx, ny, nz,
                           np.float32(level), ctypes.byref(verts_p),
                           ctypes.byref(faces_p), ctypes.byref(n_faces))
    try:
        verts = (np.ctypeslib.as_array(verts_p, shape=(nv, 3)).copy() if nv
                 else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(faces_p,
                                       shape=(n_faces.value, 3)).copy()
                 if n_faces.value else np.zeros((0, 3), np.int64))
    finally:
        lib.mt_free(verts_p)
        lib.mt_free(faces_p)
    return verts, faces
