"""The port's Vis-MVSNet converter (``data/convert.py``, its CLI) and JPEG
decoder (``data/jpeg.py`` on ``csrc/jpeg.cpp``) on the CPU.

- One Vis-MVSNet directory (``data/synthetic.write_vismvsnet_dir``: 3
  views, depth 16x16, images 64x64 written by ``cv2`` as JPEG, and again
  by the port as PNG; probability maps at 1/4, 1/2 and 1x the depth size)
  goes through the JAX package's ``convert`` (``cv2.imread`` and
  ``cv2.resize``) and through the port's CLI with ``--platform cpu``, each
  from its own folder so the two print the same paths. Equal: the depth
  PFM bytes, the ``cameras_hd.npz`` arrays, the pair and cam files' bytes,
  ``mask_hd``, and the printed line (the port prints its timings on the
  line before). ``image_hd`` (a 2x downscale: OpenCV's area path with
  rounding half up, the port's bilinear samples rounded half up) may
  differ by 1; 0 values differ, measured. The probability maps are 0.95
  and 0.05, so no bilinear sample of them lies near a threshold: at an
  exact tie the two float resizes could round apart (0 flips here, as the
  equal depth maps show). The converted scene loads in the port's
  ``SceneData`` equal to the JAX package's.
- The decoder equals ``cv2.imread`` on every committed fixture
  (``tests/fixtures/jpeg/``, made by ``scripts/make_jpeg_fixtures.py``;
  the 1600x1200 view also to the committed SHA-256 of OpenCV's decode)
  and on 120 random files of every sampling, grey, restart intervals and
  sizes from 1x1; a JPEG scene image loads in ``formats.load_rgb`` and
  ``load_mask`` as in the JAX package (imageio). Progressive, 4:1:1,
  arithmetic-coded, lossless and 12-bit files and an EXIF orientation of 6
  raise a ValueError naming the file.
- ``imread_color`` gives ``cv2.imread(IMREAD_COLOR)``'s pixels for grey,
  grey + alpha, RGBA and 16-bit PNGs.
"""
import contextlib
import glob
import hashlib
import io
import json
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest

from mvsdf_tpu.data import formats as j_formats
from mvsdf_tpu.data.convert import convert as j_convert
from mvsdf_tpu.data.scene import SceneData as JScene
from mvsdf_tpu_torch.data import formats, png
from mvsdf_tpu_torch.data.convert import imread_color
from mvsdf_tpu_torch.data.jpeg import decode_jpeg, read_jpeg
from mvsdf_tpu_torch.data.scene import SceneData
from mvsdf_tpu_torch.data.synthetic import write_vismvsnet_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
FULL_VIEW = os.path.join(FIXTURES, "view_1600x1200")
OUT = os.path.join("scan", "imfunc4")
N_VIEWS, HW = 3, 16


def _cv2_jpeg(path, rgb):
    assert cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])


@pytest.fixture(scope="module", params=[".jpg", ".png"])
def converted(request, tmp_path_factory):
    ext = request.param
    root = tmp_path_factory.mktemp("convert" + ext[1:])
    vis = str(root / "vis")
    write_vismvsnet_dir(vis, N_VIEWS, HW, image_ext=ext,
                        write_image=_cv2_jpeg if ext == ".jpg" else None)
    for side in ("jax", "port"):
        os.makedirs(root / side / "scan")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root / "jax")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            j_convert(vis, OUT)
    res = subprocess.run(
        [sys.executable, "-m", "mvsdf_tpu_torch.data.convert", "--data_dir",
         vis, "--out_dir", OUT, "--platform", "cpu"], cwd=str(root / "port"),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return {"ext": ext, "vis": vis,
            "jax": str(root / "jax" / OUT), "port": str(root / "port" / OUT),
            "jax_out": buf.getvalue(), "port_out": res.stdout}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_converter_files_equal_jax(converted):
    j, t = converted["jax"], converted["port"]
    for k in range(N_VIEWS):
        name = os.path.join("depth", f"{k:03}.pfm")
        assert _bytes(os.path.join(t, name)) == _bytes(os.path.join(j, name))
    d0 = formats.load_pfm(os.path.join(t, "depth", "000.pfm"))
    assert (d0[:, :HW // 2] == 0).all() and (d0[:, HW // 2:] > 0).all()
    d1 = formats.load_pfm(os.path.join(t, "depth", "001.pfm"))
    assert 0 < (d1 == 0).mean() < 0.5    # flow1's low corner, upsampled 4x
    a, b = np.load(os.path.join(t, "cameras_hd.npz")), np.load(
        os.path.join(j, "cameras_hd.npz"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 2 * N_VIEWS
    for key in b.files:
        assert a[key].dtype == b[key].dtype == np.float32
        np.testing.assert_array_equal(a[key], b[key])
    tp, jp = os.path.dirname(t), os.path.dirname(j)
    names = ["pair.txt"] + [f"cam_{k:08}_flow3.txt" for k in range(N_VIEWS)]
    for name in names:
        assert _bytes(os.path.join(tp, name)) == _bytes(os.path.join(jp,
                                                                     name))
    for k in range(N_VIEWS):
        mine = png.read_png(os.path.join(t, "mask_hd", f"{k:03}.png"))
        theirs = cv2.imread(os.path.join(j, "mask_hd", f"{k:03}.png"),
                            cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(mine, theirs)
        assert mine.shape == (2 * HW, 2 * HW) and (mine == 255).all()
    port_lines = converted["port_out"].strip().splitlines()
    assert port_lines[-1] == converted["jax_out"].strip()
    assert port_lines[-2].startswith("timings: decode ")


def test_converter_image_hd_within_one_of_jax(converted):
    j, t = converted["jax"], converted["port"]
    differing = 0
    for k in range(N_VIEWS):
        mine = png.read_png(os.path.join(t, "image_hd", f"{k:03}.png"))
        theirs = cv2.imread(os.path.join(j, "image_hd", f"{k:03}.png"),
                            cv2.IMREAD_COLOR)[..., ::-1]
        assert mine.shape == theirs.shape == (2 * HW, 2 * HW, 3)
        d = np.abs(mine.astype(int) - theirs)
        assert d.max() <= 1
        differing += int((d > 0).sum())
    assert differing == 0, differing


def test_converted_scene_loads_as_in_jax(converted):
    t = converted["port"]
    ours = SceneData(t, load_features=False, device="cpu")
    theirs = JScene(t, load_features=False)
    for k in ("n_images", "img_res", "total_pixels", "size", "pair"):
        assert getattr(ours, k) == getattr(theirs, k), k
    for k in ("intrinsics", "poses", "rgb", "masks", "depths", "depth_cams",
              "cams_hd", "center"):
        a, b = getattr(ours, k), getattr(theirs, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, k)
    assert ours.n_images == N_VIEWS
    assert (ours.depths[0, 0][:, :HW // 2] == 0).all()


def test_converter_names_a_missing_image(tmp_path):
    vis = str(tmp_path / "vis")
    write_vismvsnet_dir(vis, 2, 8)
    os.remove(os.path.join(vis, "00000001.png"))
    from mvsdf_tpu_torch.data import convert
    with pytest.raises(FileNotFoundError, match="image for id 1"):
        convert.main(["--data_dir", vis, "--out_dir",
                      str(tmp_path / "s" / "x"), "--platform", "cpu"])


# --- the decoder ---------------------------------------------------------------

def _fixtures():
    """The small fixtures, each with its OpenCV decode beside it."""
    return sorted(p for p in glob.glob(os.path.join(FIXTURES, "*.jpg"))
                  if os.path.exists(p[:-4] + ".npy"))


def test_fixtures_are_all_there():
    names = {os.path.basename(p)[:-4] for p in _fixtures()}
    assert {"rgb_444_97x61", "rgb_422_97x61", "rgb_420_97x61",
            "rgb_440_97x61", "grey_97x61", "rgb_420_restart_64x48",
            "rgb_420_3x5"} <= names
    assert os.path.exists(os.path.join(FIXTURES, "progressive_32x24.jpg"))
    assert os.path.exists(FULL_VIEW + ".jpg")
    data = _bytes(os.path.join(FIXTURES, "rgb_420_restart_64x48.jpg"))
    assert b"\xff\xdd" in data and b"\xff\xd0" in data   # DRI and RST0
    total = sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(FIXTURES, "*")))
    assert total < 200_000


@pytest.mark.parametrize("path", _fixtures(), ids=os.path.basename)
def test_decoder_equals_cv2_on_the_fixture(path):
    want = np.load(path[:-4] + ".npy")
    np.testing.assert_array_equal(imread_color(path), want)
    np.testing.assert_array_equal(
        imread_color(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    raw = read_jpeg(path)
    assert raw.shape == want.shape[:2] + (1 if "grey" in path else 3,)


def test_decoder_equals_cv2_on_the_full_size_view():
    """The DTU-sized fixture: equal to OpenCV's decode, whose SHA-256 is
    what the card's checks hold the decoder to."""
    want = json.load(open(FULL_VIEW + ".json"))
    got = imread_color(FULL_VIEW + ".jpg")
    assert list(got.shape) == want["shape"] == [1200, 1600, 3]
    np.testing.assert_array_equal(
        got, cv2.imread(FULL_VIEW + ".jpg", cv2.IMREAD_COLOR)[..., ::-1])
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() \
        == want["sha256"]


def test_decoder_equals_cv2_on_random_files():
    rng = np.random.default_rng(0)
    sfs = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]
    for trial in range(120):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        grey = trial % 6 == 0
        img = rng.normal(128, 60, (h, w) if grey else (h, w, 3))
        img = cv2.GaussianBlur(np.clip(img, 0, 255).astype(np.uint8), (3, 3),
                               0)
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(20, 101)),
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sfs[trial % 4]]
        if trial % 5 == 0:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL,
                       int(rng.integers(1, 4))]
        ok, enc = cv2.imencode(".jpg", img, params)
        assert ok
        want = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
        want = want[..., None] if grey else want[..., ::-1]
        np.testing.assert_array_equal(decode_jpeg(enc.tobytes()), want,
                                      err_msg=f"trial {trial} {h}x{w}")


def test_jpeg_scene_images_load_as_in_jax():
    for path in _fixtures():
        for f in ("load_rgb", "load_mask"):
            a, b = getattr(formats, f)(path), getattr(j_formats, f)(path)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _patched(tmp_path, name, fn):
    data = bytearray(_bytes(os.path.join(FIXTURES, "rgb_444_97x61.jpg")))
    path = str(tmp_path / f"{name}.jpg")
    with open(path, "wb") as f:
        f.write(bytes(fn(data)))
    return path


def _sof(data):
    return data.index(b"\xff\xc0")


def _with_exif_orientation(data, value):
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1) +
            struct.pack("<HHIHH", 0x0112, 3, 1, value, 0) +
            struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body \
        + data[2:]


def _set(data, at, value):
    data[at] = value
    return data


@pytest.mark.parametrize("case", ["progressive", "411", "arithmetic",
                                  "lossless", "12bit", "exif6"])
def test_decoder_refuses_what_it_does_not_read(tmp_path, case):
    if case == "progressive":
        path = os.path.join(FIXTURES, "progressive_32x24.jpg")
        match = "progressive"
    elif case == "411":
        path = str(tmp_path / "x411.jpg")
        cv2.imwrite(path, np.full((16, 32, 3), 90, np.uint8),
                    [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
        match = "sampling factors"
    elif case == "arithmetic":
        path = _patched(tmp_path, case,
                        lambda d: _set(d, _sof(d) + 1, 0xC9))
        match = "arithmetic"
    elif case == "lossless":
        path = _patched(tmp_path, case,
                        lambda d: _set(d, _sof(d) + 1, 0xC3))
        match = "lossless"
    elif case == "12bit":
        path = _patched(tmp_path, case, lambda d: _set(d, _sof(d) + 4, 12))
        match = "12-bit"
    else:
        path = _patched(tmp_path, case,
                        lambda d: _with_exif_orientation(d, 6))
        match = "EXIF orientation 6"
    with pytest.raises(ValueError, match=match) as info:
        read_jpeg(path)
    assert path in str(info.value)
    with pytest.raises(ValueError, match=os.path.basename(path)):
        formats.load_rgb(path)


def test_exif_orientation_1_is_read(tmp_path):
    path = _patched(tmp_path, "exif1", lambda d: _with_exif_orientation(d,
                                                                        1))
    np.testing.assert_array_equal(
        imread_color(path), np.load(os.path.join(FIXTURES,
                                                 "rgb_444_97x61.npy")))
    np.testing.assert_array_equal(imread_color(path),
                                  cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("kind", ["grey", "grey_alpha", "rgba", "rgb16",
                                  "grey16"])
def test_imread_color_matches_cv2_on_pngs(tmp_path, kind):
    rng = np.random.default_rng(3)
    shape = {"grey": (9, 7), "grey_alpha": (9, 7, 2), "rgba": (9, 7, 4),
             "rgb16": (9, 7, 3), "grey16": (9, 7)}[kind]
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / f"{kind}.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(imread_color(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR)[
                                      ..., ::-1])
