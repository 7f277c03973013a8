"""MVS dataset file formats (port of ``mvsdf_tpu/data/formats.py``): PFM
depth maps, MVS camera txt, pair.txt view graphs, and RGB / mask images
read by the port's own PNG and JPEG decoders (``data/png.py``,
``data/jpeg.py``), picked by the file's signature. Host-side.

Format parity targets:
  - PFM read/write:       ``code/utils/my_utils.py:438-496``
  - camera txt (2x4x4):   ``code/utils/my_utils.py:365-409`` (load_cam)
  - pair.txt view graph:  ``code/utils/my_utils.py:334-362``
  - RGB/mask image load:  ``code/utils/rend_util.py:8-23``
"""
from __future__ import annotations

import re
import sys
from typing import Optional

import numpy as np

from . import png
from .jpeg import SIGNATURE as JPEG_SIGNATURE, read_jpeg


def load_pfm(path: str) -> np.ndarray:
    """Portable float map -> (h, w) or (h, w, 3) float32, bottom-up flipped
    to row-major top-down (like the reference)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dim = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not dim:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dim.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.ascontiguousarray(data.reshape(shape)[::-1]).astype(np.float32)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("PFM image must be float32")
    color = image.ndim == 3 and image.shape[2] == 3
    if not color and not (image.ndim == 2 or
                          (image.ndim == 3 and image.shape[2] == 1)):
        raise ValueError("image must be HxW, HxWx1 or HxWx3")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(b"%f\n" % scale)
        np.flipud(image).tofile(f)


def load_cam(path: str, max_d: int = 256, interval_scale: float = 1.0,
             override: bool = False) -> np.ndarray:
    """MVS camera txt -> (2, 4, 4): [0]=world-to-cam extrinsic,
    [1][:3,:3]=K, [1][3]=(depth_min, interval, n_depths, depth_max)."""
    cam = np.zeros((2, 4, 4))
    with open(path) as f:
        words = f.read().split()
    for i in range(4):
        for j in range(4):
            cam[0][i][j] = float(words[4 * i + j + 1])
    for i in range(3):
        for j in range(3):
            cam[1][i][j] = float(words[3 * i + j + 18])
    n = len(words)
    if n == 29:
        cam[1][3][0] = float(words[27])
        cam[1][3][1] = float(words[28]) * interval_scale
        cam[1][3][2] = max_d
        cam[1][3][3] = cam[1][3][0] + cam[1][3][1] * (max_d - 1)
    elif n == 30:
        cam[1][3][0] = float(words[27])
        cam[1][3][1] = float(words[28]) * interval_scale
        cam[1][3][2] = float(words[29])
        cam[1][3][3] = cam[1][3][0] + cam[1][3][1] * (cam[1][3][2] - 1)
    elif n == 31:
        if override:
            cam[1][3][0] = float(words[27])
            cam[1][3][1] = (float(words[30]) - float(words[27])) / (max_d - 1)
            cam[1][3][2] = max_d
            cam[1][3][3] = float(words[30])
        else:
            cam[1][3][0] = float(words[27])
            cam[1][3][1] = float(words[28]) * interval_scale
            cam[1][3][2] = float(words[29])
            cam[1][3][3] = float(words[30])
    return cam


def write_cam(path: str, cam: np.ndarray):
    c = np.asarray(cam)
    lines = ["extrinsic"]
    for i in range(4):
        lines.append(" ".join(str(c[0][i][j]) for j in range(4)))
    lines += ["", "intrinsic"]
    for i in range(3):
        lines.append(" ".join(str(c[1][i][j]) for j in range(3)))
    lines += ["", " ".join(str(c[1][3][j]) for j in range(4)), ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def load_pair(path: str, min_views: Optional[int] = None) -> dict:
    """pair.txt -> {'id_list': [...], id: {'id', 'index', 'pair', 'score'}}"""
    with open(path) as f:
        lines = f.readlines()
    n_cam = int(lines[0])
    pairs = {}
    ids = []
    for i in range(1, 1 + 2 * n_cam, 2):
        img_id = lines[i].strip()
        toks = lines[i + 1].strip().split(" ")
        n_pair = int(toks[0])
        if min_views is not None and n_pair < min_views:
            continue
        pair = [toks[j] for j in range(1, 1 + 2 * n_pair, 2)]
        score = [float(toks[j + 1]) for j in range(1, 1 + 2 * n_pair, 2)]
        ids.append(img_id)
        pairs[img_id] = {"id": img_id, "index": i // 2, "pair": pair,
                         "score": score}
    pairs["id_list"] = ids
    return pairs


def write_pair(path: str, pair: dict):
    out = [str(len(pair["id_list"]))]
    for idx in pair["id_list"]:
        out.append(str(idx))
        entry = pair[idx]
        out.append(f"{len(entry['pair'])} " + " ".join(
            f"{p} {s}" for p, s in zip(entry["pair"], entry["score"])))
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def read_image(path: str, native: bool = False) -> np.ndarray:
    """The PNG or JPEG image in ``path``, by the file's signature, as an
    image library gives it: (H, W) for grey, (H, W, C) otherwise; ``native``
    as in ``png.read_png``. Any other format raises a ValueError naming the
    file."""
    with open(path, "rb") as f:
        head = f.read(len(png.SIGNATURE))
    if head == png.SIGNATURE:
        return png.read_png(path, native)
    if head.startswith(JPEG_SIGNATURE):
        img = read_jpeg(path)
        return img[..., 0] if img.shape[2] == 1 else img
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def load_rgb(path: str, native: bool = False) -> np.ndarray:
    """Image -> (3, h, w) float32 in [-1, 1] (ref rend_util.py:8-16);
    ``native`` as in ``png.read_png``."""
    img = read_image(path, native)
    img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[..., :3]
    return ((img - 0.5) * 2.0).transpose(2, 0, 1)


def load_mask(path: str, native: bool = False) -> np.ndarray:
    """Mask image -> (h, w) bool (threshold 0.5; ref rend_util.py:18-23)."""
    img = np.asarray(read_image(path, native))
    if img.ndim == 3:
        img = img[..., :3].mean(-1)
    if img.max() > 1.5:
        return img > 127.5
    return img > 0.5
