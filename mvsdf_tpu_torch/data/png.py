"""PNG reading and writing on ``zlib`` and numpy: the port depends on no
image library.

Read: 8- and 16-bit gray, gray + alpha, RGB and RGBA, non-interlaced, every
row filter (None, Sub, Up, Average, Paeth). The array comes back as an
image library gives it: (H, W) for gray, (H, W, C) otherwise, uint8 or
uint16. Palette or interlaced files, other bit depths and other formats
raise a ``ValueError`` that names the file (``formats.read_image`` picks
this reader or the JPEG one by the file's signature).

Undoing the row filters is sequential along a row for Average and Paeth
(each byte adds a predictor from the decoded byte to its left), and
encoders that pick filters adaptively (libpng, so ``cv2.imwrite``) use
Paeth on most rows of a photograph. ``unfilter`` therefore runs a small
host C function (``tracing/kernels/csrc/png_unfilter.cu``, built with the
trace's kernels) when asked to (``native=True``: scene loading for the
card), and ``unfilter_reference``, its plain numpy version, otherwise.

Write: the same colour types and depths, every row with one given filter or
each row with the filter that minimises its sum of absolute bytes (libpng's
heuristic).
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}           # colour type -> channels
COLOR_TYPE = {c: t for t, c in CHANNELS.items()}
FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def read_png(path: str, native: bool = False) -> np.ndarray:
    """The image stored in the PNG file ``path``; ``native`` undoes the row
    filters with the host C function (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (only PNG is read)")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not "
                         f"read")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not read")
    ch = CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (w * bpp + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=h * (w * bpp + 1)).reshape(
        h, w * bpp + 1)
    try:
        out = unfilter(rows, bpp, native)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def unfilter_reference(rows: np.ndarray, bpp: int) -> np.ndarray:
    """rows (H, 1 + stride) uint8, each a filter byte and its filtered
    bytes -> the decoded bytes (H, stride). Plain numpy: Sub, Up and None
    rows at once, Average and Paeth rows one pixel at a time."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    kinds = rows[:, 0]
    if h and kinds.max() > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} does not exist")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line, kind = rows[y, 1:], kinds[y]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:   # uint8 sums wrap mod 256, as the filter does
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        else:
            cur = np.empty(stride, np.uint8)
            b_all = prev.astype(np.int32)
            a = np.zeros(bpp, np.int32)
            c = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                b = b_all[x:x + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pa, pb, pc = np.abs(b - c), np.abs(a - c), \
                        np.abs(a + b - 2 * c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                a = (line[x:x + bpp] + pred) & 255
                cur[x:x + bpp] = a
                c = b
        out[y] = cur
        prev = cur
    return out


def unfilter(rows: np.ndarray, bpp: int, native: bool = False
             ) -> np.ndarray:
    """``unfilter_reference``'s function; ``native`` runs the host C
    function instead (built at first use; a failed build raises)."""
    if not native:
        return unfilter_reference(rows, bpp)
    from ..tracing.kernels import build
    fn = build.function("png_unfilter", (ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p))
    rows = np.ascontiguousarray(rows, np.uint8)
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    bad = fn(rows.ctypes.data, h, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row filter {bad - 1} does not exist")
    return out


def _paeth(a, b, c):
    a, b, c = (v.astype(np.int16) for v in (a, b, c))
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def filter_rows(raw: np.ndarray, bpp: int,
                filter_type: Optional[int] = None) -> np.ndarray:
    """raw (H, stride) uint8 -> (H, 1 + stride): each row's filter byte and
    filtered bytes. ``filter_type`` 0-4 filters every row so; None picks
    for each row the filter of least sum of |bytes as int8|."""
    a = np.zeros_like(raw)
    a[:, bpp:] = raw[:, :-bpp]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    c = np.zeros_like(raw)
    c[1:, bpp:] = raw[:-1, :-bpp]
    avg = ((a.astype(np.uint16) + b) >> 1).astype(np.uint8)
    cands = np.stack([raw, raw - a, raw - b, raw - avg,
                      raw - _paeth(a, b, c)])          # (5, H, stride)
    if filter_type is None:
        cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)
        kinds = np.argmin(cost, axis=0)
    else:
        if filter_type not in range(5):
            raise ValueError(f"PNG row filter {filter_type} does not exist")
        kinds = np.full(raw.shape[0], filter_type)
    rows = cands[kinds, np.arange(raw.shape[0])]
    return np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, filter_type: Optional[int] = None,
              level: int = 6):
    """Writes ``img`` (H, W) or (H, W, C) with C in 1-4, uint8 or uint16,
    as a PNG file; ``filter_type`` as in ``filter_rows``."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: PNG pixels are uint8 or uint16, not "
                         f"{img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in COLOR_TYPE:
        raise ValueError(f"{path}: a PNG image is (H, W) or (H, W, 1-4), "
                         f"not {img.shape}")
    h, w, ch = img.shape
    depth = 8 * img.dtype.itemsize
    data = img.astype(">u2") if depth == 16 else img
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    body = zlib.compress(
        filter_rows(raw, ch * depth // 8, filter_type).tobytes(), level)
    header = struct.pack(">IIBBBBB", w, h, depth, COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", body) +
                _chunk(b"IEND", b""))
