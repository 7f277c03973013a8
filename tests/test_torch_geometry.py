"""Parity of the port's geometry with the JAX package on the CPU: ray
generation (4x4 and quaternion poses, with skew), ray/sphere intersection,
the MVS projection chain, grid sampling, and the carving built on them.
Same numpy inputs on both sides; f32 tolerances as stated per check."""
import jax.numpy as jnp
import numpy as np
import torch

from mvsdf_tpu.geometry import cameras as j_cam
from mvsdf_tpu.geometry import projections as j_proj
from mvsdf_tpu.supervision.carving import carving as j_carving
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.geometry import cameras as t_cam
from mvsdf_tpu_torch.geometry import projections as t_proj
from mvsdf_tpu_torch.supervision.carving import carving as t_carving

T = torch.from_numpy
J = jnp.asarray


def _scene():
    return make_scene(n_images=3, n_pix=200, feat_ch=4, img_hw=48,
                      depth_hw=24)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def test_rays_and_sphere_intersection():
    sc = _scene()
    K = sc["intrinsics"].copy()
    K[:, 0, 1] = 0.3  # skew exercises the full lift formula
    dirs, loc = t_cam.get_camera_params(T(sc["uv"]), T(sc["pose"]), T(K))
    jd, jl = j_cam.get_camera_params(J(sc["uv"]), J(sc["pose"]), J(K))
    _close(dirs, jd, 1e-6)
    _close(loc, jl, 1e-6)
    for r in (1.0, 2.3):
        t, m = t_cam.get_sphere_intersection(loc, dirs, r)
        jt, jm = j_cam.get_sphere_intersection(jl, jd, r)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        _close(t, jt, 1e-5)  # sqrt of a difference of squares, |t| ~ 3
        if r == 1.0:  # cameras sit at radius 2.2: some rays miss
            assert m.any() and not m.all()


def test_quaternion_poses():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 4))
    vec = np.concatenate([q, rng.normal(size=(3, 3)) * 2], 1).astype(
        np.float32)
    _close(t_cam.quat_to_rot(T(vec[:, :4])), j_cam.quat_to_rot(J(vec[:, :4])),
           1e-6)
    sc = _scene()
    dirs, loc = t_cam.get_camera_params(T(sc["uv"]), T(vec),
                                        T(sc["intrinsics"]))
    jd, jl = j_cam.get_camera_params(J(sc["uv"]), J(vec),
                                     J(sc["intrinsics"]))
    _close(dirs, jd, 1e-6)
    _close(loc, jl, 1e-6)


def test_projection_chain():
    sc = _scene()
    cam = sc["depth_cams"][0, 0]
    pts = np.random.default_rng(1).uniform(-0.8, 0.8, (100, 3)).astype(
        np.float32)
    hom = t_proj.to_hom(T(pts))
    jhom = j_proj.to_hom(J(pts))
    _close(hom, jhom, 0)
    pc = t_proj.world_to_cam(hom, T(cam))
    jpc = j_proj.world_to_cam(jhom, J(cam))
    _close(pc, jpc, 1e-5)
    xy = t_proj.cam_to_img(pc, T(cam))
    jxy = j_proj.cam_to_img(jpc, J(cam))
    _close(xy, jxy, 1e-4)
    back = t_proj.img_to_cam(xy, pc[:, 2], T(cam))
    _close(back, j_proj.img_to_cam(jxy, jpc[:, 2], J(cam)), 1e-5)
    world = t_proj.cam_to_world(back, T(cam))
    _close(world, j_proj.cam_to_world(j_proj.img_to_cam(
        jxy, jpc[:, 2], J(cam)), J(cam)), 1e-5)
    _close(world[:, :3], pts, 1e-4)  # the chain closes
    _close(t_proj.pixel_grid(5, 7), j_proj.pixel_grid(5, 7), 0)


def test_grid_sampling():
    rng = np.random.default_rng(2)
    img = rng.normal(size=(4, 9, 11)).astype(np.float32)
    xy = rng.uniform(-3, 14, (60, 2)).astype(np.float32)
    g = t_proj.normalize_pixel_coords(T(xy), 9, 11)
    jg = j_proj.normalize_pixel_coords(J(xy), 9, 11)
    _close(g, jg, 1e-6)
    inr = t_proj.in_range_mask(g)
    np.testing.assert_array_equal(inr.numpy(), np.asarray(
        j_proj.in_range_mask(jg)))
    assert inr.any() and not inr.all()
    _close(t_proj.grid_sample_nearest(T(img), g),
           j_proj.grid_sample_nearest(J(img), jg), 1e-6)
    _close(t_proj.grid_sample_bilinear(T(img), g),
           j_proj.grid_sample_bilinear(J(img), jg), 1e-5)
    # batched form: one image per leading index
    imgs = np.stack([img, -img])
    gs = torch.stack([g, g.flip(0)])
    got = t_proj.grid_sample_bilinear(T(imgs), gs)
    _close(got[1], j_proj.grid_sample_bilinear(J(-img), jg[::-1]), 1e-5)


def test_carving_parity():
    sc = _scene()
    depths = sc["depths"].reshape(3, 1, 24, 24)
    cams = sc["depth_cams"].reshape(3, 2, 4, 4)
    pts = np.random.default_rng(3).uniform(-0.9, 0.9, (400, 3)).astype(
        np.float32)
    for use_invalid in (False, True):
        d, ins, sup = t_carving(T(pts), T(depths), T(cams), 0.125,
                                use_invalid)
        jd, jins, jsup = j_carving(J(pts), J(depths), J(cams), 0.125,
                                   use_invalid)
        np.testing.assert_array_equal(ins.numpy(), np.asarray(jins))
        np.testing.assert_array_equal(sup.numpy(), np.asarray(jsup))
        assert ins.any() and (~ins & sup).any()
        _close(d, jd, 2e-5)
