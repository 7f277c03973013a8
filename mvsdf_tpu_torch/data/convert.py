"""Vis-MVSNet output -> scene directory converter (port of
``mvsdf_tpu/data/convert.py``).

Reads a Vis-MVSNet output directory (``%08d.jpg`` or ``.png`` images,
``%08d_flow3.pfm`` depths, ``%08d_flow{1,2,3}_prob.pfm`` probabilities,
``cam_%08d_flow3.txt``, ``pair.txt``, optionally ``cut.ply``) and writes the
reference layout: probability-thresholded depth maps, ``image_hd/`` at twice
the depth maps' size, all-255 ``mask_hd/``, and ``cameras_hd.npz`` with
``world_mat = K(2x) E`` and ``scale_mat`` from the bounding box of
``cut.ply`` (or of the cameras' frusta); ``pair.txt`` and the cam files go
to the output's parent. Images are read by the port's own decoders
(``formats.read_image``) as ``cv2.imread(IMREAD_COLOR)`` gives them, and
resized with ``scene.resize_bilinear`` on the chosen device (``cuda``
unless the caller names another).

    python -m mvsdf_tpu_torch.data.convert --data_dir VIS --out_dir SCENE \
        [--pthresh 0.8,0.7,0.8] [--platform cpu]

The eval CLI also reads a DTU scan's ground-truth cloud with
``load_ply_points``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import formats
from .png import write_png
from .scene import resize_bilinear
from ..device import resolve_device

PLY_TYPES = {"float": "f4", "float32": "f4", "double": "f8", "uchar": "u1",
             "uint8": "u1", "int": "i4", "uint": "u4", "short": "i2",
             "ushort": "u2"}


def load_ply_points(path: str) -> np.ndarray:
    """Minimal PLY reader (ascii or binary_little_endian, x/y/z floats)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header if l.startswith("format")).split()[1]
        n = int(next(l for l in header if l.startswith("element vertex"))
                .split()[-1])
        props = [l.split() for l in header if l.startswith("property")
                 and not l.startswith("property list")]
        names = [p[2] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            xyz = data[:, [names.index("x"), names.index("y"),
                           names.index("z")]]
        else:
            dt = np.dtype([(nm, "<" + PLY_TYPES[p[1]])
                           for nm, p in zip(names, props)])
            data = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            xyz = np.stack([data["x"], data["y"], data["z"]], -1)
    return np.asarray(xyz, np.float64)


def write_ply_points(path: str, pts: np.ndarray, binary: bool = True):
    """Writes points (N, 3) as a PLY of float x/y/z vertices,
    binary_little_endian or ascii (6 decimals)."""
    pts = np.asarray(pts, np.float32)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")


def scene_bbox_from_points(pts: np.ndarray, perc: float = 1.0):
    lo = np.percentile(pts, 100 - 100 * perc, axis=0)
    hi = np.percentile(pts, 100 * perc, axis=0)
    center = (lo + hi) / 2
    size = float((hi - lo).max())
    return center, size


def scene_bbox_from_cams(cams, depth_range=(0.3, 0.9)):
    """Fallback bbox from camera frusta mid-depth points."""
    pts = []
    for cam in cams:
        E = cam[0]
        R = E[:3, :3]
        t = E[:3, 3]
        c = -R.T @ t
        z = R.T @ np.array([0, 0, 1.0])
        d0, d1 = cam[1][3][0], cam[1][3][3]
        if d1 <= 0:
            d0, d1 = 0.5, 2.0
        for a in depth_range:
            pts.append(c + z * (d0 + a * (d1 - d0)))
    return scene_bbox_from_points(np.asarray(pts))


def imread_color(path: str, native: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 RGB as ``cv2.imread(IMREAD_COLOR)`` gives it (after
    BGR -> RGB): grey becomes 3 channels, alpha is dropped, 16 bits become
    8 by ``>> 8``; ``native`` as in ``png.read_png``."""
    img = formats.read_image(path, native)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    img = img[..., :1] if img.shape[2] in (1, 2) else img[..., :3]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


def _resize(arr: np.ndarray, size, device) -> torch.Tensor:
    """(h, w) or (h, w, c) float32 -> (*size[, c]) on ``device``, the
    samples of ``cv2.resize(INTER_LINEAR)``."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device).float()
    t = t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]
    out = resize_bilinear(t, size)[0]
    return out[0] if arr.ndim == 2 else out.permute(1, 2, 0)


def convert(data_dir: str, out_dir: str, pthresh=(0.8, 0.7, 0.8),
            max_d: int = 256, device=None) -> dict:
    """data_dir: Vis-MVSNet output with {%08d.jpg|png images, cam_%08d_flow3
    .txt, %08d_flow3.pfm depths, %08d_flow{1,2,3}_prob.pfm, pair.txt,
    optionally cut.ply}. Returns the seconds spent decoding, resizing and
    writing, and in all."""
    dev = resolve_device(device)
    native = dev.type == "cuda"   # PNG rows unfiltered by the host C code
    t_start = time.perf_counter()
    times = {"decode_s": 0.0, "resize_s": 0.0, "write_s": 0.0}
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_hd"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask_hd"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)

    pair = formats.load_pair(os.path.join(data_dir, "pair.txt"))
    ids = pair["id_list"]

    cams = [formats.load_cam(
        os.path.join(data_dir, f"cam_{i.zfill(8)}_flow3.txt"), max_d)
        for i in ids]

    cut_ply = os.path.join(data_dir, "cut.ply")
    if os.path.exists(cut_ply):
        center, size = scene_bbox_from_points(load_ply_points(cut_ply),
                                              perc=0.99)
    else:
        center, size = scene_bbox_from_cams(cams)

    cam_dict = {}
    for k, img_id in enumerate(ids):
        stem = img_id.zfill(8)
        img_path = None
        for ext in (".jpg", ".png"):
            p = os.path.join(data_dir, stem + ext)
            if os.path.exists(p):
                img_path = p
                break
        if img_path is None:
            raise FileNotFoundError(f"image for id {img_id}")
        t0 = time.perf_counter()
        img = imread_color(img_path, native)
        times["decode_s"] += time.perf_counter() - t0

        depth = formats.load_pfm(
            os.path.join(data_dir, f"{stem}_flow3.pfm"))
        h, w = depth.shape
        H, W = h * 2, w * 2
        t0 = time.perf_counter()
        # probability-threshold masks at 3 scales (ref :51-57)
        mask = np.ones_like(depth, bool)
        for scale_i, th in enumerate(pthresh):
            pp = os.path.join(data_dir, f"{stem}_flow{scale_i + 1}_prob.pfm")
            if os.path.exists(pp):
                prob = formats.load_pfm(pp)
                if prob.shape != depth.shape:
                    mask &= (_resize(prob, (h, w), dev) > th).cpu().numpy()
                else:
                    mask &= prob > th
        depth_masked = depth * mask
        img_hd = _resize(img, (H, W), dev)
        img_hd = torch.floor(img_hd + 0.5).clamp_(0, 255).to(
            torch.uint8).cpu().numpy()
        times["resize_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        write_png(os.path.join(out_dir, "image_hd", f"{k:03}.png"), img_hd)
        write_png(os.path.join(out_dir, "mask_hd", f"{k:03}.png"),
                  np.full((H, W), 255, np.uint8))
        formats.write_pfm(os.path.join(out_dir, "depth", f"{k:03}.pfm"),
                          depth_masked.astype(np.float32))
        times["write_s"] += time.perf_counter() - t0

        cam = cams[k]
        # world_mat at image_hd resolution: scale intrinsics to 2x depth res
        K = cam[1][:3, :3].copy() * 1.0
        K[:2] *= 2
        P = np.zeros((4, 4))
        P[:3] = K @ cam[0][:3]
        P[3, 3] = 1
        scale_mat = np.eye(4)
        scale_mat[0, 0] = scale_mat[1, 1] = scale_mat[2, 2] = size / 2
        scale_mat[:3, 3] = center
        cam_dict[f"world_mat_{k}"] = P.astype(np.float32)
        cam_dict[f"scale_mat_{k}"] = scale_mat.astype(np.float32)

    np.savez(os.path.join(out_dir, "cameras_hd.npz"), **cam_dict)
    # pair + cams are consumed from the parent dir (ref scene_dataset layout)
    parent = os.path.dirname(os.path.abspath(out_dir))
    formats.write_pair(os.path.join(parent, "pair.txt"), pair)
    for img_id, cam in zip(ids, cams):
        formats.write_cam(
            os.path.join(parent, f"cam_{img_id.zfill(8)}_flow3.txt"), cam)
    times["total_s"] = time.perf_counter() - t_start
    times["views"] = len(ids)
    print(f"timings: decode {times['decode_s']:.3f} s, resize "
          f"{times['resize_s']:.3f} s, write {times['write_s']:.3f} s, all "
          f"{times['total_s']:.3f} s for {len(ids)} views on {dev.type}")
    print(f"converted {len(ids)} views -> {out_dir} "
          f"(center={center}, size={size:.3f})")
    return times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--pthresh", default="0.8,0.7,0.8")
    ap.add_argument("--platform", default="", choices=["", "cpu", "cuda",
                                                       "gpu"],
                    help="'cpu' resizes on the CPU; the default is the GPU")
    args = ap.parse_args(argv)
    if args.platform != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --platform "
                           "cpu to run on the CPU")
    return convert(args.data_dir, args.out_dir,
                   tuple(float(x) for x in args.pthresh.split(",")),
                   device="cpu" if args.platform == "cpu" else "cuda")


if __name__ == "__main__":
    main()
