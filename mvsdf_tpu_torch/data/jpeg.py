"""JPEG reading: ``tracing/kernels/csrc/jpeg.cpp``, a baseline decoder in
host C++ built by ``tracing/kernels/build.py`` at first use and bound with
ctypes. The port depends on no image library.

It reads sequential Huffman-coded 8-bit files with 1 or 3 components and
sampling factors up to 2x2 (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart
intervals, several scans, and skips APPn and COM segments; its output
equals libjpeg-turbo's with default settings (the ISLOW integer IDCT,
fancy upsampling, its YCbCr -> RGB tables), so ``cv2.imread``'s after
BGR -> RGB. Progressive, arithmetic-coded, lossless and 12-bit files,
CMYK/YCCK and an EXIF orientation other than 1 raise a ``ValueError`` that
names the file. A failed build raises; there is no Python stand-in.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..tracing.kernels import build

SOURCE = "jpeg.cpp"
SIGNATURE = b"\xff\xd8\xff"
ERR_LEN = 256


def _lib() -> ctypes.CDLL:
    lib = build.host_library(SOURCE)
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_header.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_int]
    return lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The image in the JPEG bytes ``data``: (H, W, 3) RGB or (H, W, 1)
    grey, uint8. ``name`` heads the message of a ValueError."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(ERR_LEN)
    hwc = (ctypes.c_int32 * 3)()
    if lib.jpeg_header(buf.ctypes.data, buf.size, hwc, err, ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty(tuple(hwc), np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, out.size,
                       err, ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """The image stored in the JPEG file ``path``: (H, W, 3|1) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a JPEG file")
    return decode_jpeg(data, path)
