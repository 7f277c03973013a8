"""The port's evaluation CLI and the modules it brings, against the JAX
package on the CPU, at a small width (SDF 4 x 64, radiance 2 x 64) on a
3-view ``write_scene_dir`` scene. Each CLI restores its own checkpoint of
the same weights (seeded noise on the JAX package's init, carried by
``convert.params_from_jax``).

Tolerances, from measurement on this scene:
- mesh: the same vertex count and faces; vertices within 1e-4 (1.5e-5
  measured: the grids' f32 sums in another order move the edge
  interpolation), colours within 2e-4 (the OBJ keeps 4 decimals; 1e-4
  measured);
- rendering: PSNR lines within 0.01 dB (equal measured), PNGs within one
  level of 255 (equal measured); the DTU line equal to its 4 decimals.
Under ``--pallas`` the JAX package runs its Pallas kernels in interpret
mode and the port its kernels' plain versions (CPU tensors).

The native triangulator is built here with the system C++ compiler and
held to the port's numpy path and to the JAX package's C++ path.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from mvsdf_tpu.data.convert import load_ply_points as j_load_ply
from mvsdf_tpu.eval import chamfer as j_chamfer
from mvsdf_tpu.eval import cli as j_cli
from mvsdf_tpu.eval import dtu_eval as j_dtu
from mvsdf_tpu.eval import marching as j_march
from mvsdf_tpu.eval import mesh as j_mesh
from mvsdf_tpu.eval import psnr as j_psnr
from mvsdf_tpu.eval.marching_native import marching_tets_native as j_native
from mvsdf_tpu.hocon import config_from_hocon as j_hocon
from mvsdf_tpu.train import checkpoints as j_ckpt
from mvsdf_tpu.train.step import init_train_state as j_init_train_state
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.convert import load_ply_points
from mvsdf_tpu_torch.data.png import read_png
from mvsdf_tpu_torch.data.synthetic import write_scene_dir
from mvsdf_tpu_torch.eval import chamfer, dtu_eval, marching, psnr
from mvsdf_tpu_torch.eval import cli
from mvsdf_tpu_torch.eval.marching_native import marching_tets_native
from mvsdf_tpu_torch.eval.mesh import load_obj, save_obj
from mvsdf_tpu_torch.hocon import config_from_hocon
from mvsdf_tpu_torch.train import checkpoints as t_ckpt
from mvsdf_tpu_torch.train.step import init_train_state

CONF = """
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
}
"""
EPOCH = 3
VERT_TOL, COLOR_TOL, PSNR_TOL = 1e-4, 2e-4, 0.01


def _sphere_points(n, radius, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    return radius * p / np.linalg.norm(p, axis=1, keepdims=True) + \
        0.005 * rng.standard_normal((n, 3))


def _write_ply(path, pts, binary):
    """x/y/z floats and a uchar red, in one of the two formats the reader
    takes."""
    red = np.arange(len(pts)) % 256
    head = (f"ply\nformat {'binary_little_endian' if binary else 'ascii'} "
            f"1.0\nelement vertex {len(pts)}\nproperty float x\nproperty "
            f"float y\nproperty float z\nproperty uchar red\nelement face 0"
            f"\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        if binary:
            rec = np.zeros(len(pts), [("x", "<f4"), ("y", "<f4"),
                                      ("z", "<f4"), ("red", "u1")])
            rec["x"], rec["y"], rec["z"] = pts.T
            rec["red"] = red
            f.write(rec.tobytes())
        else:
            for p, r in zip(pts.astype(np.float32), red):
                f.write(f"{p[0]} {p[1]} {p[2]} {r}\n".encode())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A 3-view scene, a checkpoint of the same weights for each package,
    a DTU-style STL cloud (binary PLY), ObsMask and Plane files."""
    root = tmp_path_factory.mktemp("evalcli")
    conf = str(root / "small.conf")
    with open(conf, "w") as f:
        f.write(CONF)
    scene = write_scene_dir(str(root), n_images=3, img_hw=(24, 32),
                            depth_hw=(12, 16))
    state = j_init_train_state(j_hocon(conf), seed=0)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * np.abs(np.asarray(a)).mean() *
        rng.standard_normal(a.shape).astype(np.float32), state.params)
    j_ckpt.save_checkpoint(
        str(root / "jexps" / "e" / "stamp" / "checkpoints"), EPOCH,
        state._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                       epoch=jnp.asarray(EPOCH, jnp.int32)))
    ts = init_train_state(config_from_hocon(conf), device="cpu")
    ts.net.load_state_dict(params_from_jax(params))
    t_ckpt.save_checkpoint(
        str(root / "texps" / "e" / "stamp" / "checkpoints"), EPOCH, ts,
        EPOCH)
    stl = str(root / "stl.ply")
    _write_ply(stl, _sphere_points(3000, 0.55, 2), binary=True)
    obs = str(root / "obs.mat")
    mask = np.random.default_rng(3).uniform(size=(21, 21, 21)) < 0.9
    scipy.io.savemat(obs, {"ObsMask": mask, "BB": np.array(
        [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]), "Res": np.array([[0.1]])})
    plane = str(root / "plane.mat")
    scipy.io.savemat(plane, {"P": np.array([[0.0], [1.0], [0.0], [0.3]])})
    return {"root": root, "scene": scene, "conf": conf, "stl": stl,
            "obs": obs, "plane": plane}


def _run_both(env, tag, *extra):
    """Runs the JAX CLI and the port's, each on its checkpoint, into
    evals folders of their own; returns (JAX's, the port's) eval dirs and
    the port's result."""
    root = env["root"]
    common = ["--data_dir", env["scene"], "--conf", env["conf"],
              "--expname", "e", "--platform", "cpu", *extra]
    j_cli.main(common + ["--exps_folder", str(root / "jexps"),
                         "--evals_folder", str(root / f"jev_{tag}")])
    result = cli.main(common + ["--exps_folder", str(root / "texps"),
                                "--evals_folder", str(root / f"tev_{tag}")])
    return (str(root / f"jev_{tag}" / "e"), str(root / f"tev_{tag}" / "e"),
            result)


def _psnr_line(path):
    words = open(path).read().split()
    return float(words[words.index("mean") + 2]), \
        float(words[words.index("std") + 2])


def _same_pngs(jdir, tdir, n):
    names = [f"eval_{i:03d}.png" for i in range(n)]
    assert sorted(f for f in os.listdir(tdir) if f.endswith(".png")) == names
    for name in names:
        a = read_png(os.path.join(jdir, name)).astype(int)
        b = read_png(os.path.join(tdir, name)).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
def test_eval_cli_matches_jax(env, pallas):
    """Mesh (vertices, faces, indicator colours), HTML scene, rendering
    PNGs and PSNR, and the DTU-protocol line from an STL cloud with an
    ObsMask and a ground plane."""
    extra = ["--resolution", "40", "--eval_rendering", "--dtu_stl",
             env["stl"], "--dtu_obsmask", env["obs"], "--dtu_plane",
             env["plane"], "--dtu_downsample", "0.05", "--dtu_max_dist",
             "0.5"] + (["--pallas"] if pallas else [])
    jdir, tdir, result = _run_both(env, f"mesh{int(pallas)}", *extra)
    obj = f"surface_world_coordinates_{EPOCH}.obj"
    jv, jf, jc = load_obj(os.path.join(jdir, obj))
    tv, tf, tc = load_obj(os.path.join(tdir, obj))
    assert len(tf) > 1000 and result.epoch == EPOCH
    assert tv.shape == jv.shape
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=VERT_TOL)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=COLOR_TOL)
    np.testing.assert_allclose(result.verts, tv, rtol=0, atol=1e-6)
    assert os.path.getsize(os.path.join(tdir, f"scene_{EPOCH}.html")) > 0
    for a, b in zip(_psnr_line(os.path.join(jdir, "psnr.txt")),
                    _psnr_line(os.path.join(tdir, "psnr.txt"))):
        assert abs(a - b) <= PSNR_TOL
    assert np.isfinite(result.psnrs).all() and len(result.psnrs) == 3
    _same_pngs(os.path.join(jdir, "rendering"),
               os.path.join(tdir, "rendering"), 3)
    line = open(os.path.join(tdir, "chamfer.txt")).read()
    assert line == open(os.path.join(jdir, "chamfer.txt")).read()
    assert line.startswith("DTU EVALUATION e: accuracy = ")


def test_render_mode_and_only_cam_match_jax(env):
    """--render_mode renders (dist clip 0.05, 40 iterations) and writes no
    mesh; --only_cam renders free viewpoints at --only_cam_size."""
    jdir, tdir, _ = _run_both(env, "render", "--render_mode",
                              "--eval_rendering", "--pallas")
    assert not any(f.endswith(".obj") for f in os.listdir(tdir))
    for a, b in zip(_psnr_line(os.path.join(jdir, "psnr.txt")),
                    _psnr_line(os.path.join(tdir, "psnr.txt"))):
        assert abs(a - b) <= PSNR_TOL
    _same_pngs(os.path.join(jdir, "rendering"),
               os.path.join(tdir, "rendering"), 3)
    jdir, tdir, _ = _run_both(
        env, "cam", "--only_cam", os.path.join(env["scene"],
                                               "cameras_hd.npz"),
        "--only_cam_size", "16,20")
    _same_pngs(os.path.join(jdir, "rendering2"),
               os.path.join(tdir, "rendering2"), 3)
    assert read_png(os.path.join(tdir, "rendering2",
                                 "eval_000.png")).shape == (16, 20, 3)


def _volume(kind, n):
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.standard_normal((n, n + 1, n + 2)).astype(np.float32)
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(xs, xs, xs, indexing="ij")
    vol = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.63
    if kind == "near_zero":
        # values of 1e-7 about the surface: vertices a hair from the grid
        # points, faces near degenerate, their orientation rounding
        vol = np.where(np.abs(vol) < 0.1, 1e-7 * rng.standard_normal(
            vol.shape), vol).astype(np.float32)
    return vol


def _oriented(faces):
    """Each face rotated to start at its least vertex (which keeps its
    orientation), the faces sorted: the faces as a set."""
    k = np.argmin(faces, 1)[:, None]
    rolled = np.take_along_axis(faces, (k + np.arange(3)) % 3, 1)
    return rolled[np.lexsort(rolled.T[::-1])]


@pytest.mark.parametrize("kind", ["sphere", "random", "near_zero"])
@pytest.mark.parametrize("n", [9, 24, 41])
def test_native_triangulator_matches_numpy_and_jax(kind, n):
    """The C++ triangulator built by the port: the same vertices as the
    numpy path to the bit, the same oriented faces (in another order), and
    the JAX package's C++ output exactly. Both paths orient a face in grid
    units, so near-degenerate faces and unequal spacings agree too."""
    vol = _volume(kind, n)
    kw = dict(spacing=(0.05, 0.04, 0.03), origin=(-1.0, 0.5, 2.0))
    nv, nf = marching.marching_tetrahedra(vol, 0.0, **kw)
    cv, cf = marching.marching_tetrahedra(vol, 0.0, native=True, **kw)
    assert len(nf) > 10
    np.testing.assert_array_equal(cv, nv)
    np.testing.assert_array_equal(_oriented(cf), _oriented(nf))
    gv, gf = marching_tets_native(vol, 0.0)
    jv, jf = j_native(vol, 0.0)
    np.testing.assert_array_equal(gv, jv)
    np.testing.assert_array_equal(gf, jf)
    np.testing.assert_array_equal(
        cv, j_march.marching_tetrahedra(vol, 0.0, native=True, **kw)[0])


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_load_ply_points_matches_jax(tmp_path, binary):
    pts = _sphere_points(500, 2.0, 4)
    path = str(tmp_path / "p.ply")
    _write_ply(path, pts, binary)
    ours = load_ply_points(path)
    np.testing.assert_array_equal(ours, j_load_ply(path))
    assert ours.shape == (500, 3) and ours.dtype == np.float64
    np.testing.assert_allclose(ours, pts, rtol=1e-6, atol=1e-6)


def test_load_obj_matches_jax(tmp_path):
    verts, faces = j_march.extract_mesh(
        lambda x: jnp.sqrt((x ** 2).sum(-1)) - 0.5, 20)
    colors = np.random.default_rng(5).uniform(size=verts.shape)
    for c in (None, colors):
        path = str(tmp_path / "m.obj")
        save_obj(path, verts, faces, c)
        ours, theirs = load_obj(path), j_mesh.load_obj(path)
        for a, b in zip(ours, theirs):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours[1], faces)


def test_masked_psnr_and_chamfer_points_match_jax():
    rng = np.random.default_rng(6)
    mask = rng.uniform(size=(12, 10, 1)) < 0.6
    a, b = rng.uniform(size=(2, 12, 10, 3)).astype(np.float32)
    assert psnr.masked_psnr(a * mask, b * mask, mask) == \
        j_psnr.masked_psnr(a * mask, b * mask, mask)
    assert psnr.masked_psnr(a * mask, a * mask, mask) == float("inf")
    p, q = rng.standard_normal((2, 300, 3))
    assert psnr.chamfer_points(p, q) == j_psnr.chamfer_points(p, q)


def test_dtu_evaluations_match_jax():
    """dtu_style_eval (surface samples, bbox crop) and
    dtu_official_eval_mesh (densify, downsample, ObsMask, plane), and the
    .mat loaders, on a sphere mesh against a noisy sphere cloud."""
    verts, faces = j_march.extract_mesh(
        lambda x: jnp.sqrt((x ** 2).sum(-1)) - 0.5, 24)
    gt = _sphere_points(4000, 0.52, 7)
    kw = dict(n_samples=5000, max_dist=0.2, seed=3)
    for bbox in (None, np.array([[-1, -0.2, -1], [1, 1, 1]])):
        ours = chamfer.dtu_style_eval(verts, faces, gt, bbox=bbox, **kw)
        assert ours == j_chamfer.dtu_style_eval(verts, faces, gt, bbox=bbox,
                                                **kw)
        assert 0 < ours["overall"] < 0.1
    np.testing.assert_array_equal(chamfer.sample_surface(verts, faces, 99),
                                  j_chamfer.sample_surface(verts, faces, 99))
    mask = np.random.default_rng(8).uniform(size=(11, 11, 11)) < 0.8
    mkw = dict(obs_mask=mask, bb=np.array([[-1.0] * 3, [1.0] * 3]), res=0.2,
               ground_plane=np.array([0.0, 1.0, 0.0, 0.2]), max_dist=0.3,
               thresh=0.04)
    ours = dtu_eval.dtu_official_eval_mesh(verts, faces, gt, **mkw)
    assert ours == j_dtu.dtu_official_eval_mesh(verts, faces, gt, **mkw)
    assert ours["n_rec_obs"] > 100 and np.isfinite(ours["overall"])


def test_mat_loaders_match_jax(env):
    for a, b in zip(dtu_eval.load_obs_mask(env["obs"]),
                    j_dtu.load_obs_mask(env["obs"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dtu_eval.load_ground_plane(env["plane"]),
                                  j_dtu.load_ground_plane(env["plane"]))


def test_eval_cli_refusals(env):
    """--eval_cameras on a checkpoint trained without cameras raises a
    ValueError naming --train_cameras (before camera optimisation was
    ported it raised NotImplementedError); without --platform cpu the CLI
    needs a GPU."""
    args = ["--data_dir", env["scene"], "--conf", env["conf"], "--expname",
            "e", "--exps_folder", str(env["root"] / "texps"),
            "--evals_folder", str(env["root"] / "tev_refuse")]
    with pytest.raises(ValueError, match="train_cameras"):
        cli.main(args + ["--platform", "cpu", "--eval_cameras"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
