"""Writes the JPEG decoder's fixtures under ``tests/fixtures/jpeg/``: small
files written by OpenCV (``cv2.imwrite``, libjpeg-turbo) and, beside each,
OpenCV's decode of it (``cv2.imread(IMREAD_COLOR)``, BGR -> RGB) as an
(H, W, 3) uint8 ``.npy``. Needs ``cv2``, which the port does not:

    python scripts/make_jpeg_fixtures.py [--out tests/fixtures/jpeg]

Covers 4:4:4, 4:2:2, 4:2:0 and 4:4:0 sampling, grey, a restart interval,
sizes with partial MCUs (97x61), a row of chroma 2 samples wide (the box
upsampling path), and one progressive file (which the decoder must refuse;
no decode is stored for it).

One more file is at a DTU image's size, 1600x1200: view 0 of
``data/synthetic.write_scene_dir``'s ring scene at that size, 4:2:0 at
quality 90, so the decoder is timed at the size the converter reads. A
decode of it would take 5.8 MB, so beside it lies a JSON with the shape
and the SHA-256 of OpenCV's decode (RGB, C order) instead of a ``.npy``.
"""
import argparse
import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
OUT = os.path.join(os.path.dirname(HERE), "tests", "fixtures", "jpeg")
SF = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
      "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
      "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
      "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
FULL = "view_1600x1200"
FULL_HW = (1200, 1600)
FULL_QUALITY = 90


def picture(h, w, seed):
    """A smooth colour field with edges and noise (BGR uint8), so blocks
    carry many AC coefficients."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xs / 7 + ys / 11),
                    128 + 90 * np.cos(ys / 5 - xs / 13),
                    60 + 1.5 * xs + ys], -1)
    img[(xs - w / 2) ** 2 + (ys - h / 2) ** 2 < (min(h, w) / 3) ** 2] = (
        30, 220, 90)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cases():
    """name -> (image, imwrite parameters)."""
    out = {}
    for sf, code in SF.items():
        out[f"rgb_{sf}_97x61"] = (picture(61, 97, 1), [
            cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, code])
    out["grey_97x61"] = (cv2.cvtColor(picture(61, 97, 2),
                                      cv2.COLOR_BGR2GRAY),
                         [cv2.IMWRITE_JPEG_QUALITY, 85])
    out["rgb_420_restart_64x48"] = (picture(48, 64, 3), [
        cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["420"]])
    out["rgb_420_3x5"] = (picture(5, 3, 4), [
        cv2.IMWRITE_JPEG_QUALITY, 95,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["420"]])
    out["progressive_32x24"] = (picture(24, 32, 5), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    return out


def full_view():
    """View 0 of the ring scene at 1600x1200 (BGR uint8), as
    ``write_scene_dir(root, n, img_hw=(1200, 1600))`` renders it."""
    from mvsdf_tpu_torch.data.synthetic import (look_at_extrinsic,
                                                render_ring_view)
    h, w = FULL_HW
    pos = np.array([0.0, 0.3, 2.2])
    f = 30.0 * w / 32
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    rgb, _, _ = render_ring_view(look_at_extrinsic(pos), K, (h, w), pos,
                                 0.5)
    return np.ascontiguousarray(rgb[..., ::-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    total = 0
    for name, (img, params) in cases().items():
        path = os.path.join(args.out, f"{name}.jpg")
        if not cv2.imwrite(path, img, params):
            raise RuntimeError(f"cv2.imwrite {path} failed")
        total += os.path.getsize(path)
        if name.startswith("progressive"):
            continue
        dec = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
        np.save(os.path.join(args.out, f"{name}.npy"),
                np.ascontiguousarray(dec))
        total += os.path.getsize(os.path.join(args.out, f"{name}.npy"))
    path = os.path.join(args.out, f"{FULL}.jpg")
    if not cv2.imwrite(path, full_view(), [
            cv2.IMWRITE_JPEG_QUALITY, FULL_QUALITY,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["420"]]):
        raise RuntimeError(f"cv2.imwrite {path} failed")
    dec = np.ascontiguousarray(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    with open(os.path.join(args.out, f"{FULL}.json"), "w") as f:
        json.dump({"shape": list(dec.shape),
                   "sha256": hashlib.sha256(dec.tobytes()).hexdigest(),
                   "decoder": f"cv2 {cv2.__version__}"}, f, indent=1)
        f.write("\n")
    total += os.path.getsize(path) + os.path.getsize(
        os.path.join(args.out, f"{FULL}.json"))
    print(f"wrote {len(cases()) + 1} JPEG fixtures to {args.out}: {total} bytes "
          f"(cv2 {cv2.__version__})")


if __name__ == "__main__":
    main()
