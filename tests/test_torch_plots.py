"""The port's figures (``mvsdf_tpu_torch/eval/plots.py``) against
matplotlib, which only this test imports (the GPU machine has none).

- ``scene_projection``: the snapshot's projected vertices and camera
  centres within 0.5 px of ``mpl_toolkits.mplot3d.proj3d.proj_transform``
  with ``get_proj()`` of an Axes3D set up as the JAX package's
  ``plot_scene_snapshot`` sets it up (the same cube limits, box aspect
  (1, 1, 1), ``view_init(elev, azim)``), both mapped to pixels by the
  snapshot's own window; measured 0 px (the same float64 matrix).
- ``plot_depth_maps``: every pixel within 1/255 of matplotlib's
  ``viridis(Normalize(vmin, vmax)(d))`` with vmin the map's smallest
  positive depth and vmax its largest (the port keeps viridis as uint8:
  0.5/255 at most).
- ``plot_scene_snapshot``: a (900, 900) RGB PNG that is not blank; a
  nearer triangle hides a farther one; the face subset for more than
  ``max_faces`` faces is ``default_rng(0)``'s, as in the JAX package;
  ``face_colors`` take viridis. ``Trainer.plot`` writes
  ``scene_{epoch}.png`` beside the OBJ and the HTML.
"""
import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import colormaps  # noqa: E402
from matplotlib.colors import Normalize  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402

from mvsdf_tpu_torch.data.png import read_png  # noqa: E402
from mvsdf_tpu_torch.data.synthetic import make_scene  # noqa: E402
from mvsdf_tpu_torch.eval import plots  # noqa: E402
from mvsdf_tpu_torch.eval.marching import extract_mesh  # noqa: E402


@pytest.fixture(scope="module")
def scene():
    verts, faces = extract_mesh(lambda x: x.norm(dim=-1) - 0.5,
                                resolution=32, device="cpu")
    poses = make_scene(n_images=5, n_pix=8, feat_ch=4, img_hw=40,
                       depth_hw=20)["pose"]
    return verts, faces, poses


def _mpl_proj(lo, hi, elev, azim):
    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_box_aspect((1, 1, 1))
    ax.view_init(elev=elev, azim=azim)
    M = ax.get_proj()
    plt.close(fig)
    return M


@pytest.mark.parametrize("elev,azim", [(25, -60), (60, 30), (-20, 135),
                                       (100, -10)])
def test_the_snapshot_projects_as_mplot3d(scene, elev, azim):
    verts, _, poses = scene
    lo, hi = plots.scene_box(verts, poses)
    M = plots.scene_projection(lo, hi, elev, azim)
    pts = np.concatenate([verts, poses[:, :3, 3]]).astype(np.float64)
    px, py, depth = plots.project(M, pts)
    tx, ty, tz = proj3d.proj_transform(pts[:, 0], pts[:, 1], pts[:, 2],
                                       _mpl_proj(lo, hi, elev, azim))
    qx, qy = plots.window_to_pixels(np.asarray(tx), np.asarray(ty))
    assert np.abs(px - qx).max() <= 0.5 and np.abs(py - qy).max() <= 0.5
    np.testing.assert_allclose(depth, tz, rtol=1e-9, atol=1e-12)
    # the scene lands inside the image
    assert px.min() > 0 and px.max() < plots.SNAPSHOT_PX
    assert py.min() > 0 and py.max() < plots.SNAPSHOT_PX


@pytest.mark.parametrize("kind", ["holes", "no_depth", "constant"])
def test_depth_maps_match_matplotlib_viridis(tmp_path, kind):
    rng = np.random.default_rng(0)
    H, W, B = 12, 16, 3
    d = rng.uniform(0.5, 3.0, (B, H * W)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.3] = 0.0
    d[1, :5] = 3.0          # a map whose largest depth repeats
    if kind == "no_depth":
        d[2] = 0.0
    elif kind == "constant":
        d[2] = 1.25
    path = str(tmp_path / "depth.png")
    plots.plot_depth_maps(path, d, (H, W))
    img = read_png(path)
    assert img.shape == (H, B * W, 3)
    cmap = colormaps["viridis"]
    for b in range(B):
        m = d[b] > 0
        vmin = d[b][m].min() if m.any() else np.float32(0)
        want = cmap(Normalize(vmin=vmin, vmax=d[b].max())(
            d[b].reshape(H, W)))[..., :3]
        got = img[:, b * W:(b + 1) * W] / 255.0
        assert np.abs(got - want).max() <= 1 / 255, b


def test_the_snapshot_is_drawn(scene, tmp_path):
    verts, faces, poses = scene
    path = str(tmp_path / "scene.png")
    plots.plot_scene_snapshot(path, verts, faces, poses=poses,
                              points=verts[::5])
    img = read_png(path)
    assert img.shape == (plots.SNAPSHOT_PX, plots.SNAPSHOT_PX, 3)
    drawn = (img != 255).any(-1)
    assert 0.005 < drawn.mean() < 0.5
    crimson = (img == plots._CRIMSON).all(-1).sum()
    red = (img == (255, 0, 0)).all(-1).sum()
    assert crimson > 5 * 8 * 10 and red > 50
    # the mesh alone: its pixels are the lum shades (blue the largest)
    plots.plot_scene_snapshot(path, verts, faces)
    img = read_png(path).reshape(-1, 3).astype(int)
    img = img[(img != 255).any(-1)]
    assert len(img) and (img[:, 2] >= img[:, 1]).all() and \
        (img[:, 1] >= img[:, 0]).all()


def test_a_nearer_triangle_hides_a_farther_one(tmp_path):
    # a triangle and a half-size copy moved towards mplot3d's eye at azim
    # -60, elev 25, whose projection lies inside the first one's: with
    # the depth test right, both show, whatever the drawing order
    tri = np.array([[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [0.0, 0.0, 0.5]])
    eye = np.array([np.cos(np.deg2rad(-60)), np.sin(np.deg2rad(-60)), 0.45])
    verts = np.concatenate([tri, 0.5 * tri + 0.3 * eye])
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    path = str(tmp_path / "two.png")
    colors = np.array([0.0, 1.0])
    images = []
    for order in (faces, faces[::-1]):
        fc = colors if order is faces else colors[::-1]
        plots.plot_scene_snapshot(path, verts, order, face_colors=fc)
        images.append(read_png(path))
        img = images[-1].reshape(-1, 3)
        far = (img == plots.VIRIDIS[0]).all(-1).sum()
        near = (img == plots.VIRIDIS[255]).all(-1).sum()
        assert near > 1000 and far > 1000, (near, far)
    np.testing.assert_array_equal(images[0], images[1])


def test_the_face_subset_is_the_jax_packages(scene, tmp_path):
    verts, faces, _ = scene
    n = 500
    sel = np.random.default_rng(0).choice(len(faces), size=n, replace=False)
    colors = np.linspace(0, 1, len(faces))
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    plots.plot_scene_snapshot(a, verts, faces, face_colors=colors,
                              max_faces=n)
    plots.plot_scene_snapshot(b, verts, faces[sel], face_colors=colors[sel],
                              max_faces=n)
    np.testing.assert_array_equal(read_png(a), read_png(b))
    # and the face colours are viridis entries
    img = read_png(a).reshape(-1, 3)
    img = img[(img != 255).any(-1)]
    table = {tuple(c) for c in plots.VIRIDIS}
    assert len(img) > n and all(tuple(c) in table
                                for c in np.unique(img, axis=0))


def test_the_trainer_writes_the_scene_snapshot(tmp_path):
    import torch
    from mvsdf_tpu_torch import config as tc
    from mvsdf_tpu_torch.data.scene import SceneData
    from mvsdf_tpu_torch.data.synthetic import write_scene_dir
    from mvsdf_tpu_torch.fields.radiance import RenderConfig
    from mvsdf_tpu_torch.fields.sdf import ImplicitConfig
    from mvsdf_tpu_torch.train.loop import Trainer
    data = write_scene_dir(str(tmp_path), n_images=3, img_hw=32,
                           depth_hw=16)
    cfg = tc.MVSDFConfig(
        model=tc.ModelConfig(
            implicit=ImplicitConfig(feature_vector_size=16, dims=(64,) * 4,
                                    skip_in=(2,)),
            render=RenderConfig(feature_vector_size=16, dims=(64,) * 2)),
        train=tc.TrainConfig(batch_size=3, num_pixels=64, nepochs=2))
    scene = SceneData(data, allow_random_features=True, device="cpu")
    trainer = Trainer(cfg, scene, str(tmp_path / "exp"), device="cpu",
                      log_fn=lambda *_: None)
    with torch.no_grad():
        trainer.plot(1, resolution=24)
    names = sorted(os.listdir(trainer.plots_dir))
    assert names == ["scene_1.html", "scene_1.png", "surface_1.obj"], names
    img = read_png(os.path.join(trainer.plots_dir, "scene_1.png"))
    assert img.shape == (plots.SNAPSHOT_PX, plots.SNAPSHOT_PX, 3)
    assert (img != 255).any()
