"""The training cells' scene: a synthetic sphere seen by cameras on a ring,
at the sizes a configuration's ``scene`` entry gives, written once per
checkout in the reference's scene-directory layout, which the program's
loader reads.

A copy of the ring-scene writer of the program's synthetic data (the same
cameras, renders and files), on numpy and ``zlib`` alone. Beside the
program's files it writes what the plain reference reads: the images and
masks as ``.npy`` arrays (the same bytes the PNG files hold) and the
random FeatExt weights as ``featext.pt``, which the program loads as its
pretrained checkpoint (``MVSDF_VISMVSNET_PT``).

The cache directory is keyed by the configuration's name, never by a seed:
``.cache/scenes/<config>/`` beside this file; it keeps the ``scene`` entry
it was written from, and another entry writes it anew. A writer that is
cut off leaves a ``.partial`` directory, which the next run removes.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import zlib

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
DONE = "complete"


def scene_dir(config_name: str, cache: str = CACHE) -> str:
    """The cache directory of a configuration's scene (its root: the
    program's data directory is ``<root>/scene``)."""
    return os.path.join(cache, "scenes", config_name)


def ensure_scene(config_name: str, spec: dict, cache: str = CACHE) -> str:
    """The root of the configuration's scene, written first where it is
    not complete or was written from another ``spec`` (the configuration's
    ``scene`` entry, which the directory keeps in ``complete``)."""
    root = scene_dir(config_name, cache)
    done = os.path.join(root, DONE)
    if os.path.exists(done):
        with open(done) as f:
            if json.load(f) == spec:
                return root
    part = root + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    write_scene(part, spec)
    with open(os.path.join(part, DONE), "w") as f:
        json.dump(spec, f)
    os.replace(part, root)
    return root


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit grey (H, W) or RGB (H, W, 3) PNG, every row unfiltered."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * ch)], 1)
    head = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2}[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", head) +
                _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) +
                _png_chunk(b"IEND", b""))


def write_pfm(path: str, z: np.ndarray) -> None:
    """A grey little-endian PFM, rows bottom-up."""
    z = np.asarray(z, "<f4")
    with open(path, "wb") as f:
        f.write(b"Pf\n%d %d\n-1.000000\n" % (z.shape[1], z.shape[0]))
        np.flipud(z).tofile(f)


def look_at(cam_pos, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World-to-camera 4x4 extrinsic of a camera at cam_pos facing the
    origin."""
    c = np.asarray(cam_pos, np.float64)
    z = -c / np.linalg.norm(c)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    E = np.eye(4)
    E[:3, :3] = np.stack([x, y, z])
    E[:3, 3] = -E[:3, :3] @ c
    return E


def render_view(extr, K, hw, cam_pos, radius):
    """(rgb (H, W, 3) uint8, silhouette (H, W) bool, z-depth (H, W) f32, 0
    off the sphere) of the sphere of ``radius`` at the origin."""
    H, W = hw
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1).reshape(-1, 3)
    dirs_cam = pix @ np.linalg.inv(K).T.astype(np.float32)
    dirs_w = dirs_cam @ extr[:3, :3].astype(np.float32)
    dirs_w /= np.linalg.norm(dirs_w, axis=-1, keepdims=True)
    o = np.asarray(cam_pos, np.float32)
    b = dirs_w @ o
    disc = b ** 2 - (o @ o - radius ** 2)
    hit = disc > 0
    tq = -b - np.sqrt(np.maximum(disc, 0))
    z = np.where(hit, tq * dirs_cam[:, 2] / np.linalg.norm(dirs_cam, axis=-1),
                 0)
    n = (o + tq[:, None] * dirs_w) / radius
    albedo = np.stack([0.55 + 0.4 * np.sin(6 * n[:, 0]),
                       0.5 + 0.4 * np.sin(6 * n[:, 1] + 1),
                       0.5 + 0.4 * np.cos(5 * n[:, 2])], -1)
    light = np.array([0.3, 0.8, 0.5], np.float32)
    shade = 0.3 + 0.7 * np.clip(n @ (light / np.linalg.norm(light)), 0, None)
    u, v = pix[:, 0] / W, pix[:, 1] / H
    bg = np.stack([0.2 + 0.3 * u, 0.25 + 0.2 * v, 0.35 + 0.1 * u * v], -1)
    rgb = np.where(hit[:, None], albedo * shade[:, None], bg)
    rgb = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return (rgb.reshape(H, W, 3), hit.reshape(H, W),
            z.astype(np.float32).reshape(H, W))


def _cam_text(cam) -> str:
    lines = ["extrinsic"]
    lines += [" ".join(str(cam[0][i][j]) for j in range(4)) for i in range(4)]
    lines += ["", "intrinsic"]
    lines += [" ".join(str(cam[1][i][j]) for j in range(3)) for i in range(3)]
    lines += ["", " ".join(str(cam[1][3][j]) for j in range(4)), ""]
    return "\n".join(lines)


def featext_weights(seed: int) -> dict:
    """Random FeatExt weights (Vis-MVSNet's feature extractor, the
    reference's key names) from ``np.random.default_rng(seed)``: uniform
    convolutions at 1/sqrt(fan-in), batch norms with unit scale and
    variance and small random means."""
    import torch
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        b = np.sqrt(1.0 / (cin * k * k))
        sd[name] = rng.uniform(-b, b, (cout, cin, k, k))

    def bn(name, c):
        sd.update({name + ".weight": np.ones(c), name + ".bias": np.zeros(c),
                   name + ".running_mean": rng.normal(0, 0.1, c),
                   name + ".running_var": np.ones(c),
                   name + ".num_batches_tracked": np.zeros((), np.int64)})

    def block(p, cin, cout, stride):
        conv(p + ".conv1.weight", cout, cin, 3)
        bn(p + ".bn1", cout)
        conv(p + ".conv2.weight", cout, cout, 3)
        bn(p + ".bn2", cout)
        if stride != 1 or cin != cout:
            conv(p + ".downsample.0.weight", cout, cin, 1)
            bn(p + ".downsample.1", cout)

    conv("init_conv.0.weight", 16, 3, 5)
    bn("init_conv.1", 16)
    prev = 16
    for i, (name, f) in enumerate(zip(ENC, FILTERS)):
        p = f"unet.enc_blocks.{name}"
        block(p + ".0", prev, f, 1 if i == 0 else 2)
        block(p + ".1", f, f, 1)
        prev = f
    for name, f in zip(DEC, FILTERS[-2::-1]):
        p = f"unet.dec_blocks.{name}"
        sd[p + ".0.weight"] = rng.uniform(-0.05, 0.05, (prev, f, 3, 3))
        conv(p + ".1.weight", f, 2 * f, 3)
        block(p + ".2.0", f, f, 1)
        prev = f
    conv("final_conv_1.weight", 32, 128, 3)
    conv("final_conv_2.weight", 32, 64, 3)
    conv("final_conv_3.weight", 32, 32, 3)
    return {k: torch.from_numpy(np.asarray(
        v, np.int64 if k.endswith("num_batches_tracked") else np.float32))
        for k, v in sd.items()}


FILTERS = (32, 64, 128)
ENC = ("2d2_0", "2d4_1", "2d8_2")
DEC = ("2d16_3", "2d8_4")


def write_scene(root: str, spec: dict) -> str:
    """Writes the scene of ``spec`` (views, img_hw, depth_hw,
    sphere_radius, ring_distance, ring_height, featext_seed) under
    ``root`` and returns its data directory, ``root/scene``: images,
    masks, depth maps, ``cameras_hd.npz``, ``pair.txt`` and the MVS cameras
    as the program's loader reads them; ``images.npy``, ``masks.npy`` and
    ``featext.pt`` for the reference. Each view's two source views are its
    ring neighbours."""
    import torch
    n = spec["views"]
    H, W = spec["img_hw"]
    h, w = spec["depth_hw"]
    radius = spec["sphere_radius"]
    data_dir = os.path.join(root, "scene")
    for sub in ("image_hd", "mask_hd", "depth"):
        os.makedirs(os.path.join(data_dir, sub))
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    dist, height = spec["ring_distance"], spec["ring_height"]
    cam_pos = np.stack([dist * np.sin(angles), height * np.ones_like(angles),
                        dist * np.cos(angles)], -1)
    f = 30.0 * W / 32
    K_hd = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    K_d = K_hd.copy()
    K_d[0] *= w / W
    K_d[1] *= h / H
    images = np.lib.format.open_memmap(os.path.join(root, "images.npy"), "w+",
                                       np.uint8, (n, H, W, 3))
    masks = np.lib.format.open_memmap(os.path.join(root, "masks.npy"), "w+",
                                      np.bool_, (n, H, W))
    cams = {}
    ring = lambda i, j: min((j - i) % n, (i - j) % n)
    pair = [str(n)]
    for i in range(n):
        extr = look_at(cam_pos[i])
        rgb, mask, _ = render_view(extr, K_hd, (H, W), cam_pos[i], radius)
        images[i], masks[i] = rgb, mask
        write_png(os.path.join(data_dir, "image_hd", f"{i:03}.png"), rgb)
        write_png(os.path.join(data_dir, "mask_hd", f"{i:03}.png"),
                  mask.astype(np.uint8) * 255)
        _, _, z = render_view(extr, K_d, (h, w), cam_pos[i], radius)
        write_pfm(os.path.join(data_dir, "depth", f"{i:03}.pfm"), z)
        P = np.zeros((4, 4), np.float32)
        P[:3] = K_hd @ extr[:3]
        P[3, 3] = 1
        cams[f"world_mat_{i}"] = P
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        cam = np.zeros((2, 4, 4))
        cam[0] = extr
        cam[1][:3, :3] = K_d
        cam[1][3] = [0.5, 0.01, 256, 0.5 + 0.01 * 255]
        with open(os.path.join(root, f"cam_{i:08}_flow3.txt"), "w") as fh:
            fh.write(_cam_text(cam))
        others = sorted((j for j in range(n) if j != i),
                        key=lambda j: ring(i, j))[:2]
        pair += [str(i), "2 " + " ".join(f"{j} {10.0 - k}"
                                         for k, j in enumerate(others))]
    images.flush()
    masks.flush()
    del images, masks
    np.savez(os.path.join(data_dir, "cameras_hd.npz"), **cams)
    with open(os.path.join(root, "pair.txt"), "w") as fh:
        fh.write("\n".join(pair) + "\n")
    torch.save(featext_weights(spec["featext_seed"]),
               os.path.join(root, "featext.pt"))
    return data_dir
