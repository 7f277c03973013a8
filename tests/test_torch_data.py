"""The port's data slice against the JAX package on the CPU: the PNG codec
(against imageio and OpenCV), the MVS file formats, the camera
decomposition, HOCON configs, the FeatExt CNN and its weight loading, the
bilinear resize, ``SceneData`` and the device-resident batch gather.

Tolerances: everything exact but
- ``decompose_projection`` / ``scale_camera``: 1e-6 (float64 QR, f32 out);
- the bilinear resize against ``cv2.resize(INTER_LINEAR)``: 1e-5;
- FeatExt features: max |port - JAX| <= 1e-5 of the largest |feature|
  (measured 7e-7 relative: cuDNN-free f32 convolutions summed in another
  order on both sides).
"""
import dataclasses
import os
import struct
import zlib

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu import config as jc
from mvsdf_tpu.data import featext as j_featext
from mvsdf_tpu.data import formats as j_formats
from mvsdf_tpu.data.scene import SceneData as JScene
from mvsdf_tpu.geometry import cameras as j_cameras
from mvsdf_tpu.geometry import projections as j_proj
from mvsdf_tpu.hocon import config_from_hocon as j_config_from_hocon
from mvsdf_tpu_torch.convert import featext_params_from_jax
from mvsdf_tpu_torch.data import featext as t_featext
from mvsdf_tpu_torch.data import formats as t_formats
from mvsdf_tpu_torch.data import png
from mvsdf_tpu_torch.data.scene import SceneData, resize_bilinear
from mvsdf_tpu_torch.data.synthetic import write_scene_dir
from mvsdf_tpu_torch.geometry import cameras as t_cameras
from mvsdf_tpu_torch.geometry import projections as t_proj
from mvsdf_tpu_torch.hocon import config_from_hocon
from mvsdf_tpu_torch.train.device_data import DeviceSceneCache

FEAT_TOL = 1e-5
# (bit depth, channels) of every PNG colour type the codec reads
KINDS = [(8, 1), (8, 2), (8, 3), (8, 4), (16, 1), (16, 2), (16, 3), (16, 4)]
KIND_IDS = [f"{d}bit_{c}ch" for d, c in KINDS]

SMALL_CONF = """
train{
    learning_rate = 3.0e-4
    num_pixels = 64
    sched_milestones = [4/6, 5/6]
    sched_factor = 0.1
    plot_freq = 1/2
}
model{
    feature_vector_size = 16
    implicit_network {
        dims = [64, 64, 64, 64]
        geometric_init = True
        bias = 0.6
        skip_in = [2]
        weight_norm = True
        multires = 6
    }
    rendering_network {
        mode = idr
        dims = [64, 64]
        weight_norm = True
        multires_view = 4
    }
    ray_tracer {
        sphere_tracing_iters = 7
        n_steps = 64
        n_secant_steps = 6
    }
}
schedule{
    feat_weight = [0.0, 0.2, 0.02]
    far_thresh = 0.3
}
"""


def _image(depth, ch, seed=0, hw=(13, 21)):
    """A smooth ramp plus noise: every row filter has something to do."""
    rng = np.random.default_rng(seed)
    top = 255 if depth == 8 else 65535
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    base = (x * 7 + y * 3)[..., None] * (np.arange(ch) + 1)
    img = (base * top // 400 + rng.integers(0, top // 16, hw + (ch,))) % top
    img = img.astype(np.uint8 if depth == 8 else np.uint16)
    return img[..., 0] if ch == 1 else img


def _library_write(path, img):
    """imageio where it can (8-bit, 16-bit gray), else OpenCV (16-bit
    colour, channels in BGR order)."""
    if img.dtype == np.uint8 or img.ndim == 2:
        imageio.imwrite(path, img)
    else:
        cv2.imwrite(path, img[..., [2, 1, 0, 3][:img.shape[2]]])


def _library_read(path, like):
    if like.dtype == np.uint8 or like.ndim == 2:
        return imageio.imread(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, None],
                         ids=list(png.FILTERS) + ["adaptive"])
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_png_writer_is_read_back_exactly(tmp_path, kind, filter_type):
    """Written by the port with one filter on every row (or the adaptive
    choice), read by the port and, where it can, by imageio / OpenCV."""
    img = _image(*kind)
    path = str(tmp_path / "x.png")
    png.write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(png.read_png(path), img)
    if kind != (16, 2):   # no library here writes or reads 16-bit gray+alpha
        np.testing.assert_array_equal(_library_read(path, img), img)


@pytest.mark.parametrize("kind", [k for k in KINDS if k != (16, 2)],
                         ids=[i for k, i in zip(KINDS, KIND_IDS)
                              if k != (16, 2)])
def test_png_reader_reads_library_files_exactly(tmp_path, kind):
    img = _image(*kind, seed=1, hw=(40, 57))
    path = str(tmp_path / "x.png")
    _library_write(path, img)
    got = png.read_png(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _library_read(path, img))


def test_png_adaptive_rows_mix_filters(tmp_path):
    """OpenCV picks Paeth on most rows of an image; the port's writer picks
    per row too, and both decode to the same bytes."""
    y, x = np.mgrid[0:64, 0:64]
    img = np.stack([(x * 4) % 256, (y * 4) % 256, ((x * y) // 16) % 256],
                   -1).astype(np.uint8)
    img[::7] = np.random.default_rng(0).integers(0, 256, img[::7].shape)
    raw = img.reshape(64, -1)
    kinds = png.filter_rows(raw, 3)[:, 0]
    assert len(set(kinds.tolist())) >= 3, kinds
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img[..., ::-1])
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(png.unfilter_reference(
        png.filter_rows(raw, 3), 3), raw)


def _patch_header(path, **field):
    """Rewrites one IHDR field (colour type or interlace) and its CRC."""
    data = bytearray(open(path, "rb").read())
    at = {"color": 25, "interlace": 28}
    for k, v in field.items():
        data[at[k]] = v
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("case", ["palette", "interlaced", "jpeg"])
def test_png_reader_names_the_file_it_cannot_read(tmp_path, case):
    path = str(tmp_path / f"bad_{case}.png")
    if case == "jpeg":
        cv2.imwrite(str(tmp_path / "x.jpg"), _image(8, 3))
        os.replace(str(tmp_path / "x.jpg"), path)
    else:
        png.write_png(path, _image(8, 1))
        _patch_header(path, **({"color": 3} if case == "palette"
                               else {"interlace": 1}))
    with pytest.raises(ValueError, match="bad_" + case):
        png.read_png(path)


def test_rgb_and_mask_loaders_match_the_jax_package(tmp_path):
    rgb = _image(8, 3, hw=(20, 30))
    mask = (_image(8, 1, hw=(20, 30)) > 100).astype(np.uint8) * 255
    png.write_png(str(tmp_path / "i.png"), rgb)
    png.write_png(str(tmp_path / "m.png"), mask)
    for f in ("load_rgb", "load_mask"):
        p = str(tmp_path / ("i.png" if f == "load_rgb" else "m.png"))
        a, b = getattr(t_formats, f)(p), getattr(j_formats, f)(p)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pfm_cam_and_pair_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((7, 9), (7, 9, 3)):
        d = rng.normal(size=shape).astype(np.float32)
        t_formats.write_pfm(str(tmp_path / "a.pfm"), d)
        j_formats.write_pfm(str(tmp_path / "b.pfm"), d)
        for p in ("a.pfm", "b.pfm"):
            for mod in (t_formats, j_formats):
                np.testing.assert_array_equal(
                    mod.load_pfm(str(tmp_path / p)), d)
    cam = np.zeros((2, 4, 4))
    cam[0] = np.eye(4) + rng.normal(size=(4, 4))
    cam[1][:3, :3] = rng.normal(size=(3, 3))
    cam[1][3] = [0.5, 0.01, 192, 0.5 + 0.01 * 191]
    t_formats.write_cam(str(tmp_path / "c.txt"), cam)
    for kw in ({}, {"max_d": 128, "interval_scale": 2.0},
               {"override": True}):
        np.testing.assert_array_equal(
            t_formats.load_cam(str(tmp_path / "c.txt"), **kw),
            j_formats.load_cam(str(tmp_path / "c.txt"), **kw))
    pair = {"id_list": ["0", "1", "2"]}
    for i in range(3):
        pair[str(i)] = {"id": str(i), "index": i,
                        "pair": [str((i + 1) % 3), str((i + 2) % 3)],
                        "score": [3.5, 1.25]}
    t_formats.write_pair(str(tmp_path / "pair.txt"), pair)
    assert t_formats.load_pair(str(tmp_path / "pair.txt")) == pair
    assert j_formats.load_pair(str(tmp_path / "pair.txt")) == pair
    assert t_formats.load_pair(str(tmp_path / "pair.txt"), min_views=3) == \
        j_formats.load_pair(str(tmp_path / "pair.txt"), min_views=3)


def test_decompose_projection_and_scale_camera_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(10):
        K = np.array([[rng.uniform(40, 900), rng.uniform(-2, 2),
                       rng.uniform(10, 800)],
                      [0, rng.uniform(40, 900), rng.uniform(10, 600)],
                      [0, 0, 1.0]])
        q = rng.normal(size=4)
        R = t_cameras.quat_to_rot(torch.tensor(q / np.linalg.norm(q))
                                  ).numpy()
        t = rng.normal(size=3)
        P = K @ np.concatenate([R, t[:, None]], 1) * rng.uniform(0.5, 3)
        for a, b in zip(t_cameras.decompose_projection(P),
                        j_cameras.decompose_projection(P)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        cam = rng.normal(size=(3, 2, 4, 4)).astype(np.float32)
        for s in (2, 0.5, (2.0, 3.0)):
            ours = t_proj.scale_camera(cam, s)
            np.testing.assert_allclose(ours, j_proj.scale_camera(cam, s),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(
                t_proj.scale_camera(torch.from_numpy(cam), s).numpy(), ours,
                rtol=1e-6, atol=1e-6)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_shared_fields_equal(a, b, path="cfg"):
    fa, fb = _fields(a), _fields(b)
    shared = fa.keys() & fb.keys()
    assert len(shared) >= min(len(fa), len(fb)) - 12, (path, fa.keys() ^
                                                       fb.keys())
    for k in sorted(shared):
        if dataclasses.is_dataclass(fa[k]):
            _assert_shared_fields_equal(fa[k], fb[k], f"{path}.{k}")
        else:
            assert fa[k] == fb[k], (f"{path}.{k}", fa[k], fb[k])


def test_config_from_hocon_matches_jax(tmp_path):
    conf = tmp_path / "small.conf"
    conf.write_text(SMALL_CONF)
    ours, theirs = config_from_hocon(str(conf)), j_config_from_hocon(
        str(conf))
    _assert_shared_fields_equal(ours, theirs)
    assert ours.schedule.feat_weight == (0.0, 0.2, 0.02)
    assert ours.model.implicit.dims == (64,) * 4
    assert ours.train.plot_freq == 0.5


# ---------------------------------------------------------------------------
# FeatExt
# ---------------------------------------------------------------------------

def _jax_feat_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, j_featext.init_feat_ext(np.random.default_rng(seed)))


def _feat_close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    err = np.abs(ours - theirs).max()
    assert err <= FEAT_TOL * np.abs(theirs).max(), err


def test_featext_matches_jax_on_the_same_weights():
    params = _jax_feat_params(0)
    sd = featext_params_from_jax(params)
    mine = t_featext.init_feat_ext(np.random.default_rng(0))
    assert sd.keys() == mine.keys()
    for k in sd:   # the port draws the same random weights from one seed
        assert torch.equal(sd[k], mine[k]), k
    net = t_featext.make_feat_ext(sd, "cpu")
    x = np.random.default_rng(1).normal(size=(2, 3, 48, 64)).astype(
        np.float32)
    with torch.no_grad():
        ours = net(torch.from_numpy(x))
    theirs = j_featext.feat_ext_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    for o, t in zip(ours, theirs):
        _feat_close(o.numpy(), t)


def test_featext_loads_a_reference_layout_checkpoint(tmp_path):
    """vismvsnet.pt holds the whole VisMVSNet under module.*; its
    module.feat_ext.* part loads into the port's module (strict) and gives
    the JAX package's features from the same file."""
    rng = np.random.default_rng(7)
    ref = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
        np.float32)) if v.dtype == torch.float32 else v
        for k, v in t_featext.FeatExt().state_dict().items()}
    for k in ref:
        if k.endswith("running_var"):
            ref[k] = ref[k].abs() + 0.5
    blob = {"module.feat_ext." + k: v for k, v in ref.items()}
    blob["module.cost_reg.0.weight"] = torch.zeros(3)   # another submodule
    path = str(tmp_path / "vismvsnet.pt")
    torch.save({"state_dict": blob, "epoch": 3}, path)
    sd = t_featext.load_torch_checkpoint(path)
    assert sd.keys() == ref.keys()
    net = t_featext.make_feat_ext(sd, "cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(v, ref[k]), k
    x = np.random.default_rng(2).normal(size=(1, 3, 32, 48)).astype(
        np.float32)
    with torch.no_grad():
        ours = net(torch.from_numpy(x))[2].numpy()
    theirs = j_featext.feat_ext_apply(j_featext.load_torch_checkpoint(path),
                                      jnp.asarray(x))[2]
    _feat_close(ours, theirs)


@pytest.mark.parametrize("src,dst", [((40, 48), (32, 40)), ((32, 40),
                                                            (40, 48)),
                                     ((37, 53), (18, 26)), ((24, 32),
                                                            (48, 64))])
def test_bilinear_resize_matches_cv2(src, dst):
    """F.interpolate(bilinear, align_corners=False, no antialias) samples
    at half-pixel centres, as cv2.resize(INTER_LINEAR) does."""
    img = np.random.default_rng(0).uniform(-1, 1, src + (3,)).astype(
        np.float32)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    ours = resize_bilinear(torch.from_numpy(img.transpose(2, 0, 1))[None],
                           dst)[0].numpy().transpose(1, 2, 0)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# SceneData and the device-resident cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """One directory (non-square images whose feature input needs a
    resize), loaded by both packages with their random FeatExt weights."""
    root = str(tmp_path_factory.mktemp("scene"))
    data_dir = write_scene_dir(root, n_images=4, img_hw=(40, 48),
                               depth_hw=(16, 20))
    ours = SceneData(data_dir, allow_random_features=True, device="cpu")
    theirs = JScene(data_dir, allow_random_features=True)
    return ours, theirs


def test_scene_data_matches_jax(scenes):
    ours, theirs = scenes
    for k in ("n_images", "img_res", "total_pixels", "size", "pair"):
        assert getattr(ours, k) == getattr(theirs, k), k
    for k in ("intrinsics", "poses", "pose_init", "rgb", "masks", "depths",
              "depth_cams", "cams_hd", "center", "uv"):
        a, b = getattr(ours, k), getattr(theirs, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, k)
    assert 0.05 < ours.masks.mean() < 0.6   # a silhouette, not a full mask
    assert ours.feats.shape == (4, 32, 16, 20)
    _feat_close(ours.feats.numpy(), theirs.feats)


def test_get_batch_and_device_gather_match_jax(scenes):
    ours, theirs = scenes
    for n in (37, -1):
        ours.change_sampling_idx(n, np.random.default_rng(5))
        theirs.change_sampling_idx(n, np.random.default_rng(5))
        idx = [2, 0, 3]
        a, b = ours.get_batch(idx), theirs.get_batch(idx)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k.startswith("feat"):
                _feat_close(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k], k)
        # the on-device gather equals the host batch element for element
        cache = DeviceSceneCache(ours, "cpu")
        sel = np.arange(ours.total_pixels) if ours.sampling_idx is None \
            else ours.sampling_idx
        g = cache.gather(torch.tensor(idx), torch.from_numpy(sel))
        assert g.keys() == a.keys()
        for k in a:
            assert tuple(g[k].shape) == a[k].shape, k
            np.testing.assert_array_equal(g[k].numpy(), a[k], k)
    assert cache.nbytes() > ours.rgb.nbytes + ours.feats.numel() * 4


def test_features_come_from_the_pretrained_file_when_it_is_set(
        scenes, tmp_path, monkeypatch):
    ours, _ = scenes
    sd = t_featext.init_feat_ext(np.random.default_rng(11))
    path = str(tmp_path / "vismvsnet.pt")
    torch.save({"module.feat_ext." + k: v for k, v in sd.items()}, path)
    monkeypatch.setenv("MVSDF_VISMVSNET_PT", path)
    scene = SceneData(ours.data_dir, device="cpu")
    direct = SceneData(ours.data_dir, feat_params=sd, device="cpu")
    assert torch.equal(scene.feats, direct.feats)
    assert not torch.equal(scene.feats, ours.feats)
    monkeypatch.delenv("MVSDF_VISMVSNET_PT")
    with pytest.raises(FileNotFoundError, match="MVSDF_VISMVSNET_PT"):
        SceneData(ours.data_dir, device="cpu")
