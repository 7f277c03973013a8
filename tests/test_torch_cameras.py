"""Camera optimisation in the port against the JAX package on the CPU.

- Unit level: ``pose_vecs_from_matrices`` on every branch of Shepperd's
  method (within 1e-6), ``sparse_adam_step`` over several steps (within
  1e-6 relative), ``camera_accuracy`` in float64 (equal), and
  ``SceneData.get_gt_pose`` (equal).
- One phase-B step with ``train_cameras`` at the size of
  ``tests/unit/test_camera_opt.py`` (SDF 2 x 32, radiance 1 x 32), 2
  images x 512 rays (1,024 rays: 128 would drop every compaction tier),
  from the same weights, poses and random draws, with the plain trace and
  with the kernel-path trace and the supervised compaction: loss terms within 1e-4
  relative, field gradients within 2e-3 of each tensor's largest entry,
  the pose gradient within 1e-3 of its largest entry (2.0e-5 measured;
  its f32 sums run in another order through the quaternion, the ray
  directions and the implicit-diff points).
- Two training steps (the port's in a subprocess: a torch optimizer step
  changes XLA:CPU results for the rest of its process): the poses within
  1e-6 (7.5e-9 measured) and the SparseAdam moments within 1e-3 of their
  largest entry (7.6e-5 measured: the second step's gradients follow the
  field's first Adam step) of the JAX package's; rows the batch did not
  touch keep their pose and zero moments. A step with a non-finite loss leaves the field as it was and
  still moves the touched poses (to NaN) in both packages.
- The training CLI with ``--train_cameras`` in both packages for epochs
  0-2 on a 5-view scene with perturbed initial cameras
  (``write_scene_dir(pose_noise=...)``): the same host plan (the host RNG
  after the run, the SparseAdam step count, the rows touched), and poses
  that moved alike. The packages draw their per-step noise from different
  generators, so the gradients part from the first step on: each pose
  coordinate lies within 2.5e-4 (2.5 x learning_rate_cam; 1.5e-4
  measured) of the JAX package's, and the displacements from the
  initial cameras have a cosine of at least 0.8 (0.96 measured). A resume
  from epoch 1 gives the straight run's epoch-2 state to the bits.
- The eval CLI with ``--eval_cameras`` in both packages on one camera
  checkpoint (carried across by ``convert.cam_state_from_jax``): equal
  ``CAMERAS EVALUATION`` lines, the same mesh in the ground-truth frame
  (equal faces; vertices within 1e-4 as the eval CLI test holds them,
  1.2e-5 measured; colours within 2e-4), PSNR lines within 0.01 dB. A
  checkpoint without cameras makes the port's eval CLI and a
  ``--train_cameras`` resume raise a ValueError naming the flag.
"""
import dataclasses
import functools
import glob
import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvsdf_tpu.train.step as j_step_mod
from mvsdf_tpu import config as jc
from mvsdf_tpu.data.scene import SceneData as JScene
from mvsdf_tpu.eval import cameras as j_cams
from mvsdf_tpu.eval import cli as j_eval_cli
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.fields.sdf import ImplicitConfig as JImplicit
from mvsdf_tpu.geometry.cameras import get_camera_params as j_rays
from mvsdf_tpu.hocon import config_from_hocon as j_hocon
from mvsdf_tpu.rendering.renderer import render_forward as j_render
from mvsdf_tpu.supervision.losses import total_loss as j_total
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu.train import checkpoints as j_ckpt
from mvsdf_tpu.train import cameras_opt as j_opt
from mvsdf_tpu.train import cli as j_train_cli
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.convert import cam_state_from_jax, params_from_jax
from mvsdf_tpu_torch.data.scene import SceneData
from mvsdf_tpu_torch.data.synthetic import make_scene, write_scene_dir
from mvsdf_tpu_torch.eval import cameras
from mvsdf_tpu_torch.eval import cli as eval_cli
from mvsdf_tpu_torch.eval.mesh import load_obj
from mvsdf_tpu_torch.fields.network import MVSDFNetwork
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig as TImplicit
from mvsdf_tpu_torch.geometry.cameras import get_camera_params, quat_to_rot
from mvsdf_tpu_torch.hocon import config_from_hocon
from mvsdf_tpu_torch.rendering.renderer import render_forward as t_render
from mvsdf_tpu_torch.supervision.losses import total_loss as t_total
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer
from mvsdf_tpu_torch.train import cameras_opt
from mvsdf_tpu_torch.train import checkpoints as t_ckpt
from mvsdf_tpu_torch.train.step import init_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, FEAT = 2, 512, 16
ICFG = dict(feature_vector_size=FEAT, dims=(32,) * 2, skip_in=(),
            multires=4)
RCFG = dict(feature_vector_size=FEAT, dims=(32,), multires_view=2)
TRACER = dict(sphere_tracing_iters=4, n_steps=16, n_secant_steps=3,
              sample_chunk=0)
N_POSES = 4                    # rows of the pose table; the batch uses 2
INDICES = np.array([2, 1])
LR_CAM = 1e-4
CONF = """
train{
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
}
"""


def _rot(axis, deg):
    a = np.asarray(axis, np.float64)
    a /= np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    t = np.radians(deg)
    return np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k


def test_pose_vecs_from_matrices_match_jax_on_every_branch():
    """Trace > 0, and trace <= 0 with each diagonal entry the largest
    (turns near 180 degrees about x, y and z), and random rotations."""
    rng = np.random.default_rng(0)
    rots = [_rot([1, 2, 3], 20), _rot([1, 0, 0], 180), _rot([0, 1, 0], 180),
            _rot([0, 0, 1], 180), _rot([1, 0.1, -0.1], 170),
            _rot([0.1, 1, 0.2], 175), _rot([-0.1, 0.2, 1], 165)]
    rots += [_rot(rng.normal(size=3), d) for d in rng.uniform(0, 180, 20)]
    poses = np.tile(np.eye(4), (len(rots), 1, 1))
    poses[:, :3, :3] = rots
    poses[:, :3, 3] = rng.normal(size=(len(rots), 3))
    branches = {-1 if np.trace(R) > 0 else int(np.argmax(np.diag(R)))
                for R in rots}
    assert branches == {-1, 0, 1, 2}
    poses = poses.astype(np.float32)
    got = cameras_opt.pose_vecs_from_matrices(poses)
    want = j_opt.pose_vecs_from_matrices(poses)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    R = quat_to_rot(torch.from_numpy(got[:, :4])).numpy()
    np.testing.assert_allclose(R, poses[:, :3, :3], rtol=0, atol=1e-5)
    # the 7-d rows generate the matrix path's rays, in both packages
    sc = make_scene(n_images=2, n_pix=16, feat_ch=FEAT)
    pv = cameras_opt.pose_vecs_from_matrices(sc["pose"])
    uv, K = torch.from_numpy(sc["uv"]), torch.from_numpy(sc["intrinsics"])
    d_q, c_q = get_camera_params(uv, torch.from_numpy(pv), K)
    d_m, _ = get_camera_params(uv, torch.from_numpy(sc["pose"]), K)
    jd, jcl = j_rays(jnp.asarray(sc["uv"]), jnp.asarray(pv),
                     jnp.asarray(sc["intrinsics"]))
    np.testing.assert_allclose(d_q.numpy(), d_m.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d_q.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(c_q.numpy(), np.asarray(jcl))


def test_sparse_adam_steps_match_jax():
    """Six steps on 6 rows, random gradients and touched rows (one touched
    row with a zero gradient, whose moments still decay)."""
    rng = np.random.default_rng(1)
    pv0 = rng.normal(size=(6, 7)).astype(np.float32)
    t_pv = torch.from_numpy(pv0)
    t_st = cameras_opt.init_sparse_adam(t_pv)
    j_pv = jnp.asarray(pv0)
    j_st = j_opt.init_sparse_adam(j_pv)
    for k in range(6):
        g = rng.normal(size=(6, 7)).astype(np.float32)
        touched = rng.uniform(size=6) < 0.6
        touched[k % 6] = True
        g[~touched] = 0
        if k == 3:
            g[k % 6] = 0
        t_st, t_pv = cameras_opt.sparse_adam_step(
            t_st, t_pv, torch.from_numpy(g), torch.from_numpy(touched),
            LR_CAM)
        j_st, j_pv = j_opt.sparse_adam_step(j_st, j_pv, jnp.asarray(g),
                                            jnp.asarray(touched), LR_CAM)
        np.testing.assert_allclose(t_pv.numpy(), np.asarray(j_pv),
                                   rtol=1e-6, atol=0)
        for a, b in ((t_st.m, j_st.m), (t_st.v, j_st.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
        assert int(t_st.step) == int(j_st.step) == k + 1
        assert t_st.step.dtype == torch.int32
    untouched = np.asarray(j_st.m == 0).all(1)
    np.testing.assert_array_equal(t_pv.numpy()[untouched], pv0[untouched])


def _camera_set(rng, n):
    Rs = np.stack([_rot(rng.normal(size=3), rng.uniform(0, 90))
                   for _ in range(n)])
    ts = rng.normal(size=(n, 3)) * 2
    return Rs, ts


@pytest.mark.parametrize("case", ["aligned", "perturbed", "similarity"])
def test_camera_accuracy_matches_jax(case):
    rng = np.random.default_rng(2)
    gt_R, gt_t = _camera_set(rng, 12)
    if case == "aligned":
        R, t = gt_R, gt_t
    else:
        R = np.stack([_rot(rng.normal(size=3), 3) @ r for r in gt_R])
        t = gt_t + 0.05 * rng.normal(size=gt_t.shape)
    if case == "similarity":
        G = _rot([0.3, -1, 0.5], 40)
        R = np.einsum("ij,njk->nik", G.T, R)
        t = 0.5 * t @ G + np.array([0.2, -0.1, 0.4])
    got = cameras.camera_accuracy(R.astype(np.float32), t, gt_R, gt_t)
    want = j_cams.camera_accuracy(R.astype(np.float32), t, gt_R, gt_t)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if case == "aligned":
        assert got["R_errors_deg"].max() < 0.05 and \
            got["t_errors"].max() < 1e-6
    elif case == "similarity":
        assert abs(got["scale"] - 2.0) < 0.1
    c, R_u, t_u = cameras.umeyama(t, gt_t)
    for a, b in zip((c, R_u, t_u), j_cams.umeyama(t, gt_t)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """A 5-view scene with initial cameras 2 degrees and 1% off, and a
    scale matrix that is not the identity (so the ground-truth world frame
    and the training frame differ)."""
    root = tmp_path_factory.mktemp("camscene")
    data = write_scene_dir(str(root), n_images=5, img_hw=(24, 32),
                           depth_hw=(12, 16), pose_noise=(2.0, 0.01))
    conf = root / "small.conf"
    conf.write_text(CONF)
    return {"root": root, "data": data, "conf": str(conf)}


def test_get_gt_pose_matches_jax(tmp_path, scene_dir):
    data = str(tmp_path / "scene")
    shutil.copytree(scene_dir["data"], data)
    for txt in glob.glob(os.path.join(scene_dir["root"], "*.txt")):
        shutil.copy(txt, tmp_path)      # pair.txt and the MVS cameras
    cams = dict(np.load(os.path.join(data, "cameras_hd.npz")))
    S = np.diag([1.2, 1.2, 1.2, 1.0]).astype(np.float32)
    S[:3, 3] = [0.1, -0.2, 0.3]
    cams.update({k: S for k in cams if k.startswith("scale_mat_")})
    np.savez(os.path.join(data, "cameras_hd.npz"), **cams)
    ours = SceneData(data, load_features=False, device="cpu")
    theirs = JScene(data, load_features=False)
    for scaled in (False, True):
        np.testing.assert_array_equal(ours.get_gt_pose(scaled),
                                      theirs.get_gt_pose(scaled))
    np.testing.assert_array_equal(ours.get_gt_pose(True), ours.poses)
    assert np.abs(ours.get_gt_pose() - ours.poses).max() > 0.1
    np.testing.assert_array_equal(ours.pose_init, theirs.pose_init)


# --- one training step -----------------------------------------------------

# case -> (model kw for both sides, port-only model kw): the plain trace,
# and the trace through sdf_mlp (its plain version here) with the
# supervised groups compacted to the surface hits
STEP_CASES = {"plain": ({}, {}),
              "compact": (dict(supervised_compact_frac=(0.375,)),
                          dict(use_pallas_trace=True))}


def _configs(case="plain"):
    common, port_only = STEP_CASES[case]
    common = dict(implicit_diff_min_dot=0.0, **common)
    jcfg = jc.MVSDFConfig(
        model=jc.ModelConfig(implicit=JImplicit(**ICFG),
                             render=JRender(**RCFG),
                             tracer=JTracer(**TRACER), **common),
        train=jc.TrainConfig(batch_size=B, num_pixels=P,
                             train_cameras=True))
    tcfg = tc.MVSDFConfig(
        model=tc.ModelConfig(implicit=TImplicit(**ICFG),
                             render=TRender(**RCFG),
                             tracer=TTracer(**TRACER), **common,
                             **port_only),
        train=tc.TrainConfig(batch_size=B, num_pixels=P,
                             train_cameras=True))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def step_data():
    """Weights (perturbed), the scene with the batch's indices into a
    4-row pose table (2 rows untouched), the table's initial 7-d rows (the
    batch's true poses, perturbed), and the random draws."""
    jcfg, _ = _configs()
    params = jax.tree_util.tree_map(
        np.asarray, j_step_mod.init_params(jcfg, seed=0))
    rng = np.random.default_rng(1)
    params["implicit"] = [
        {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in p.items()} for p in params["implicit"]]
    sc = make_scene(n_images=B, n_pix=P, feat_ch=FEAT, seed=3)
    sc["indices"] = INDICES
    table = np.concatenate([sc["pose"][::-1], sc["pose"][::-1]])
    pv0 = cameras_opt.pose_vecs_from_matrices(table)
    pv0 += (0.01 * rng.normal(size=pv0.shape)).astype(np.float32)
    noise = {"minimal_steps": rng.uniform(size=16).astype(np.float32),
             "eik_points": rng.uniform(-1, 1, (B * P // 2, 3)
                                       ).astype(np.float32)}
    return params, sc, pv0, noise


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_camera_step_loss_and_gradients_match_jax(step_data, case):
    params, sc, pv0, noise = step_data
    jcfg, tcfg = _configs(case)
    gates = jcfg.schedule.gates_for_phase(1)
    weights = jcfg.schedule.weights(0.3)
    jbatch, jnoise = _jnp(sc), _jnp(noise)

    @jax.jit
    def j_loss(p, pv):
        inputs = dict(jbatch, pose=pv[jbatch["indices"]])
        out = j_render(jcfg.model, p, inputs, training=True, gates=gates,
                       noise=jnoise)
        lt = j_total(out, jbatch, gates, jcfg.schedule, weights)
        return lt.loss, (lt, out.network_object_mask)

    (_, (j_lt, j_hit)), (j_grads, j_pose_grad) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(pv0))

    net = MVSDFNetwork(tcfg.model.implicit, tcfg.model.render)
    net.load_state_dict(params_from_jax(params))
    tbatch = _torch(sc)
    pv = torch.from_numpy(pv0).requires_grad_(True)
    out = t_render(tcfg.model, net, dict(tbatch, pose=pv[tbatch["indices"]]),
                   training=True, gates=tcfg.schedule.gates_for_phase(1),
                   noise=_torch(noise))
    t_lt = t_total(out, tbatch, tcfg.schedule.gates_for_phase(1),
                   tcfg.schedule, tcfg.schedule.weights(0.3))
    grads = torch.autograd.grad(t_lt.loss, list(net.parameters()) + [pv])

    np.testing.assert_array_equal(out.network_object_mask.numpy(),
                                  np.asarray(j_hit))
    assert 0.05 < out.network_object_mask.float().mean().item() < 0.95
    for name in t_lt._fields:
        want = float(getattr(j_lt, name))
        got = float(torch.as_tensor(getattr(t_lt, name)).detach())
        assert abs(got - want) <= 1e-4 * abs(want) + 1e-7, (name, got, want)
    for (name, _), g in zip(net.named_parameters(), grads[:-1]):
        net_name, _, l, k = name.split(".")
        want = np.asarray(j_grads[net_name][int(l)][k])
        assert np.abs(g.numpy() - want).max() <= 2e-3 * max(
            np.abs(want).max(), 1e-12), name
    want = np.asarray(j_pose_grad)
    got = grads[-1].numpy()
    touched = np.zeros(N_POSES, bool)
    touched[INDICES] = True
    assert (got[~touched] == 0).all() and (want[~touched] == 0).all()
    assert (np.abs(want[touched]).max(1) > 1e-3).all()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


PORT_ARM = r"""
import pickle, sys
import numpy as np, torch
from mvsdf_tpu_torch.config import Weights
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.train.step import init_train_state, make_train_step

cfg, params, scene, pv0, noise = pickle.load(open(sys.argv[1], "rb"))
t = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
out = {}
for tag, n, weights in (
        ("ok", 2, cfg.schedule.weights(0.3)),
        ("nan", 1, Weights(**dict(vars(cfg.schedule.weights(0.3)),
                                  rgb=float("nan"))))):
    state = init_train_state(cfg, seed=0, device="cpu", pose_init=pv0)
    state.net.load_state_dict(params_from_jax(params))
    step = make_train_step(cfg, phase_idx=1)
    losses = []
    for _ in range(n):
        m = step(state, t(scene), weights, noise=t(noise))
        losses.append([float(m["loss"]), float(m["grad_norm"])])
    out[tag + "_losses"] = np.asarray(losses)
    out[tag + "_pose_vecs"] = state.pose_vecs.numpy()
    out[tag + "_m"] = state.cam_opt.m.numpy()
    out[tag + "_v"] = state.cam_opt.v.numpy()
    out[tag + "_step"] = state.cam_opt.step.numpy()
    for k, v in state.net.state_dict().items():
        out[tag + ":" + k] = v.numpy()
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def steps(step_data, tmp_path_factory):
    """The port's two camera steps and its non-finite step (in a
    subprocess), and the JAX package's, through each make_train_step with
    the same random draws."""
    params, sc, pv0, noise = step_data
    jcfg, tcfg = _configs()
    tmp = tmp_path_factory.mktemp("camsteps")
    inp, outp = tmp / "in.pkl", tmp / "out.npz"
    with open(inp, "wb") as f:
        pickle.dump((tcfg, params, sc, pv0, noise), f)
    res = subprocess.run([sys.executable, "-c", PORT_ARM, str(inp),
                          str(outp)], env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    port = dict(np.load(outp))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    adam, _ = j_step_mod.make_optimizer(jcfg)
    theirs = {}
    w = jcfg.schedule.weights(0.3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_step_mod, "render_forward", functools.partial(
            j_step_mod.render_forward, noise=_jnp(noise)))
        step = j_step_mod.make_train_step(jcfg, phase_idx=1, donate=False)
        for tag, n, weights in (("ok", 2, w),
                                ("nan", 1, dataclasses.replace(
                                    w, rgb=float("nan")))):
            state = j_step_mod.init_train_state(jcfg, seed=0,
                                                pose_init=pv0)
            state = state._replace(params=jp, opt_state=adam.init(jp))
            losses = []
            for _ in range(n):
                state, m = step(state, _jnp(sc),
                                j_step_mod.weights_to_array(weights),
                                jax.random.PRNGKey(0))
                losses.append([float(m["loss"]), float(m["grad_norm"])])
            theirs[tag] = (state, np.asarray(losses))
    return port, theirs, pv0, params


def test_camera_train_steps_match_jax(steps):
    port, theirs, pv0, _ = steps
    state, losses = theirs["ok"]
    np.testing.assert_allclose(port["ok_losses"], losses, rtol=1e-4)
    want = np.asarray(state.pose_vecs)
    np.testing.assert_allclose(port["ok_pose_vecs"], want, rtol=0,
                               atol=1e-6)
    for k in ("m", "v"):
        a, b = port[f"ok_{k}"], np.asarray(getattr(state.cam_opt, k))
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), k
    assert int(port["ok_step"]) == int(state.cam_opt.step) == 2
    touched = np.zeros(N_POSES, bool)
    touched[INDICES] = True
    # two Adam steps move each touched coordinate by ~2 x lr_cam
    moved = np.abs(port["ok_pose_vecs"] - pv0)
    assert (moved[touched] > 0.5 * LR_CAM).all()
    np.testing.assert_array_equal(port["ok_pose_vecs"][~touched],
                                  pv0[~touched])
    assert (port["ok_m"][~touched] == 0).all()


def test_a_non_finite_step_moves_the_poses_as_in_jax(steps):
    """A NaN loss (here from a NaN rgb weight): the skip zeroes the field's
    update, so the field keeps its weights; the poses take the SparseAdam
    step of a NaN gradient and become NaN on the touched rows, as the JAX
    package's do (ROADMAP queue 3)."""
    port, theirs, pv0, params = steps
    state, losses = theirs["nan"]
    assert np.isnan(port["nan_losses"]).all() and np.isnan(losses).all()
    touched = np.zeros(N_POSES, bool)
    touched[INDICES] = True
    for pv in (port["nan_pose_vecs"], np.asarray(state.pose_vecs)):
        assert np.isnan(pv[touched]).all()
        np.testing.assert_array_equal(pv[~touched], pv0[~touched])
    for net_name in ("implicit", "render"):
        for l, layer in enumerate(params[net_name]):
            for k, v in layer.items():
                np.testing.assert_array_equal(
                    port[f"nan:{net_name}.layers.{l}.{k}"], v)
                np.testing.assert_array_equal(
                    np.asarray(state.params[net_name][l][k]), v)


# --- the training CLI ------------------------------------------------------

def _train_args(scene_dir, exps, *extra):
    return ["--data_dir", scene_dir["data"], "--pallas",
            "--allow_random_features", "--platform", "cpu", "--conf",
            scene_dir["conf"], "--batch_size", "2", "--nepoch", "2",
            "--num_pixels", "64", "--expname", "c", "--exps_folder",
            str(exps), "--train_cameras", *extra]


def _run_port_cli(args):
    res = subprocess.run(
        [sys.executable, "-m", "mvsdf_tpu_torch.train.cli", *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def _ckpt_dir(exps):
    (path,) = glob.glob(os.path.join(str(exps), "c", "*", "checkpoints"))
    return path


@pytest.fixture(scope="module")
def cli_runs(scene_dir):
    """Epochs 0-2 through each package's training CLI (the port's in a
    subprocess), 2 images a step of 5: 6 SparseAdam steps."""
    root = scene_dir["root"]
    j_train_cli.main(_train_args(scene_dir, root / "jexps", "--no_mesh"))
    _run_port_cli(_train_args(scene_dir, root / "texps"))
    jcfg = j_hocon(scene_dir["conf"])
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, train_cameras=True, batch_size=2))
    like = j_step_mod.init_train_state(
        jcfg, 0, pose_init=JScene(scene_dir["data"],
                                  load_features=False).pose_init)
    j_state, j_rng = j_ckpt.restore_checkpoint(_ckpt_dir(root / "jexps"),
                                               None, like)
    tree, t_rng = t_ckpt.load_checkpoint(_ckpt_dir(root / "texps"), None)
    return {"jax": (j_state, j_rng, np.asarray(like.pose_vecs)),
            "port": (tree, t_rng)}


def test_camera_cli_matches_jax(scene_dir, cli_runs):
    j_state, j_rng, pv0 = cli_runs["jax"]
    tree, t_rng = cli_runs["port"]
    assert tree["epoch"] == int(j_state.epoch) == 2
    # the same host plan: the RNG after it, the steps, the rows drawn
    assert t_rng["np_rng"] == j_rng["np_rng"]
    opt = tree["cam_opt"]
    assert int(opt["step"]) == int(j_state.cam_opt.step) == 6
    np.testing.assert_array_equal(
        (opt["m"] != 0).any(1).numpy(),
        (np.asarray(j_state.cam_opt.m) != 0).any(1))
    # the initial cameras are the scene's perturbed ones in both
    np.testing.assert_allclose(pv0, cameras_opt.pose_vecs_from_matrices(
        SceneData(scene_dir["data"], load_features=False,
                  device="cpu").pose_init), rtol=0, atol=1e-6)
    got, want = tree["pose_vecs"].numpy(), np.asarray(j_state.pose_vecs)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2.5 * LR_CAM
    d_got, d_want = (got - pv0).ravel(), (want - pv0).ravel()
    cos = d_got @ d_want / np.linalg.norm(d_got) / np.linalg.norm(d_want)
    assert cos >= 0.8, cos


def test_camera_cli_resume_is_bit_exact(scene_dir, cli_runs):
    """The port's epoch-1 checkpoint resumed with --is_continue trains
    epoch 2 to the straight run's bits: the field, Adam, the poses, their
    moments and step, and both RNGs."""
    root = scene_dir["root"]
    straight = _ckpt_dir(root / "texps")
    exps = root / "texps_resumed"
    ck = os.path.join(str(exps), "c", os.path.basename(
        os.path.dirname(straight)), "checkpoints")
    os.makedirs(ck)
    shutil.copytree(os.path.join(straight, "step_1"),
                    os.path.join(ck, "step_1"))
    with open(os.path.join(ck, "latest.txt"), "w") as f:
        f.write("1")
    out = _run_port_cli(_train_args(scene_dir, exps, "--is_continue"))
    assert "resumed from epoch 1" in out
    a = torch.load(os.path.join(straight, "step_2", "state.pt"),
                   weights_only=False)
    b = torch.load(os.path.join(ck, "step_2", "state.pt"),
                   weights_only=False)
    assert torch.equal(a["pose_vecs"], b["pose_vecs"])
    for k in ("m", "v", "step"):
        assert torch.equal(a["cam_opt"][k], b["cam_opt"][k]), k
    for k, v in a["net"].items():
        assert torch.equal(v, b["net"][k]), k
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert open(os.path.join(straight, "step_2", "rng.json")).read() == \
        open(os.path.join(ck, "step_2", "rng.json")).read()


# --- the eval CLI ----------------------------------------------------------

@pytest.fixture(scope="module")
def eval_env(scene_dir):
    """One set of weights and one set of optimised cameras (the scene's
    initial cameras under a similarity: 30 degrees, scale 1.3, a shift)
    saved by each package: orbax for JAX, torch.save for the port (through
    convert.params_from_jax and cam_state_from_jax); and a camera-less
    checkpoint of the port."""
    root = scene_dir["root"]
    jcfg = j_hocon(scene_dir["conf"])
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, train_cameras=True))
    scene = SceneData(scene_dir["data"], load_features=False, device="cpu")
    G = _rot([0.2, 1.0, -0.4], 30)
    poses = scene.pose_init.astype(np.float64).copy()
    poses[:, :3, :3] = np.einsum("ij,njk->nik", G, poses[:, :3, :3])
    poses[:, :3, 3] = 1.3 * poses[:, :3, 3] @ G.T + [0.1, 0.2, -0.3]
    pv = cameras_opt.pose_vecs_from_matrices(poses)
    state = j_step_mod.init_train_state(jcfg, seed=0, pose_init=pv)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * np.abs(np.asarray(a)).mean() *
        rng.standard_normal(a.shape).astype(np.float32), state.params)
    cam_opt = j_opt.SparseAdamState(
        m=jnp.asarray(rng.normal(size=pv.shape), jnp.float32),
        v=jnp.asarray(rng.uniform(size=pv.shape), jnp.float32),
        step=jnp.asarray(7, jnp.int32))
    j_ckpt.save_checkpoint(
        str(root / "ej" / "e" / "stamp" / "checkpoints"), 3,
        state._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                       epoch=jnp.asarray(3, jnp.int32), cam_opt=cam_opt))
    tcfg = config_from_hocon(scene_dir["conf"])
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, train_cameras=True))
    ts = init_train_state(tcfg, device="cpu", pose_init=pv)
    ts.net.load_state_dict(params_from_jax(params))
    ts.pose_vecs, ts.cam_opt = cam_state_from_jax(
        state.pose_vecs, jax.tree_util.tree_map(np.asarray, cam_opt))
    t_ckpt.save_checkpoint(str(root / "et" / "e" / "stamp" / "checkpoints"),
                           3, ts, 3)
    ts.pose_vecs = ts.cam_opt = None
    t_ckpt.save_checkpoint(str(root / "en" / "e" / "stamp" / "checkpoints"),
                           3, ts, 3)
    return root, cam_opt


def test_cam_state_carries_across(eval_env):
    root, cam_opt = eval_env
    tree, _ = t_ckpt.load_checkpoint(
        str(root / "et" / "e" / "stamp" / "checkpoints"), None)
    for k in ("m", "v", "step"):
        np.testing.assert_array_equal(tree["cam_opt"][k].numpy(),
                                      np.asarray(getattr(cam_opt, k)))
    assert tree["cam_opt"]["step"].dtype == torch.int32


def test_eval_cameras_matches_jax(scene_dir, eval_env):
    root, _ = eval_env
    common = ["--data_dir", scene_dir["data"], "--conf", scene_dir["conf"],
              "--expname", "e", "--platform", "cpu", "--eval_cameras",
              "--resolution", "40", "--eval_rendering", "--pallas"]
    j_eval_cli.main(common + ["--exps_folder", str(root / "ej"),
                              "--evals_folder", str(root / "jev")])
    result = eval_cli.main(common + ["--exps_folder", str(root / "et"),
                                     "--evals_folder", str(root / "tev")])
    jdir, tdir = root / "jev" / "e", root / "tev" / "e"
    line = (tdir / "cameras.txt").read_text()
    assert line == (jdir / "cameras.txt").read_text()
    assert line.startswith("CAMERAS EVALUATION: R error mean = ")
    # the initial cameras were 2 degrees and 1% off before the similarity
    acc = result.cameras
    assert 1.0 < acc["R_errors_deg"].mean() < 3.0
    assert abs(acc["scale"] - 1 / 1.3) < 0.05
    obj = "surface_world_coordinates_3.obj"
    jv, jf, jcol = load_obj(str(jdir / obj))
    tv, tf, tcol = load_obj(str(tdir / obj))
    assert len(tf) > 1000
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcol, jcol, rtol=0, atol=2e-4)
    assert (tdir / "scene_3.html").stat().st_size > 0
    words = [(jdir / "psnr.txt").read_text().split(),
             (tdir / "psnr.txt").read_text().split()]
    for key in ("mean", "std"):
        a, b = (float(w[w.index(key) + 2]) for w in words)
        assert abs(a - b) <= 0.01
    assert np.isfinite(result.psnrs).all() and len(result.psnrs) == 5


def test_eval_cameras_without_camera_state_raises(scene_dir, eval_env):
    root, _ = eval_env
    with pytest.raises(ValueError, match="train_cameras"):
        eval_cli.main(["--data_dir", scene_dir["data"], "--conf",
                       scene_dir["conf"], "--expname", "e", "--platform",
                       "cpu", "--eval_cameras", "--exps_folder",
                       str(root / "en"), "--evals_folder",
                       str(root / "nev")])
    assert not (root / "nev" / "e" / "cameras.txt").exists()


def test_camera_training_refuses_a_checkpoint_without_cameras(scene_dir,
                                                              eval_env):
    """A --train_cameras run resumed from a checkpoint trained without
    cameras raises a ValueError naming the flag, instead of stepping
    poses that are not there."""
    from mvsdf_tpu_torch.train.loop import Trainer
    root, _ = eval_env
    cfg = config_from_hocon(scene_dir["conf"])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, train_cameras=True, batch_size=2))
    trainer = Trainer(cfg, SceneData(scene_dir["data"], load_features=False,
                                     device="cpu"),
                      str(root / "en" / "e" / "stamp"), device="cpu",
                      log_fn=lambda *a: 0)
    assert trainer.state.pose_vecs is not None
    with pytest.raises(ValueError, match="--train_cameras"):
        trainer.maybe_resume()
