"""The scene writer's copy writes what the program's loader reads, once
per configuration, whatever the seed."""
import os

import numpy as np
import torch

from portbench import scene
from portbench.tests import tiny


def test_loader_reads_what_the_writer_wrote(tmp_path, monkeypatch):
    from mvsdf_tpu_torch.data.scene import SceneData
    spec = tiny.config("mvsdf_dtu_kernels")["scene"]
    root = scene.ensure_scene("tiny", spec, str(tmp_path))
    monkeypatch.setenv("MVSDF_VISMVSNET_PT", os.path.join(root,
                                                          "featext.pt"))
    sd = SceneData(os.path.join(root, "scene"), device="cpu")
    n, (H, W), (h, w) = spec["views"], spec["img_hw"], spec["depth_hw"]
    assert sd.n_images == n and tuple(sd.img_res) == (H, W)
    images = np.load(os.path.join(root, "images.npy"))
    masks = np.load(os.path.join(root, "masks.npy"))
    rgb = (images.reshape(n, H * W, 3).astype(np.float32) / 255.0 - 0.5) * 2
    np.testing.assert_array_equal(sd.rgb, rgb)
    np.testing.assert_array_equal(sd.masks, masks.reshape(n, H * W))
    assert sd.depths.shape == (n, 1, h, w) and (sd.depths > 0).any()
    assert tuple(sd.feats.shape) == (n, 32, h, w)
    # each view's sources are its ring neighbours
    assert sorted(sd.src_indices(0)) == [1, n - 1]


def test_cache_is_keyed_by_the_configuration_not_the_seed(tmp_path):
    spec = tiny.config("mvsdf_dtu_kernels")["scene"]
    root = scene.ensure_scene("cfg", spec, str(tmp_path))
    assert root == scene.scene_dir("cfg", str(tmp_path))
    assert os.path.basename(root) == "cfg"
    stamp = os.path.getmtime(os.path.join(root, "images.npy"))
    assert scene.ensure_scene("cfg", spec, str(tmp_path)) == root
    assert os.path.getmtime(os.path.join(root, "images.npy")) == stamp
    other = dict(spec, views=5)
    scene.ensure_scene("cfg", other, str(tmp_path))
    assert np.load(os.path.join(root, "images.npy")).shape[0] == 5


def test_a_cut_writer_is_written_again(tmp_path):
    spec = tiny.config("mvsdf_dtu_kernels")["scene"]
    part = scene.scene_dir("cfg", str(tmp_path)) + ".partial"
    os.makedirs(os.path.join(part, "scene"))
    root = scene.ensure_scene("cfg", spec, str(tmp_path))
    assert not os.path.exists(part) and os.path.exists(
        os.path.join(root, scene.DONE))


def test_featext_weights_load_into_the_programs_network():
    from mvsdf_tpu_torch.data.featext import make_feat_ext
    sd = scene.featext_weights(0)
    net = make_feat_ext(sd, "cpu")
    out = net(torch.zeros(1, 3, 16, 16))
    assert out[2].shape == (1, 32, 8, 8)
