"""Data-parallel training of the port (``mvsdf_tpu_torch/parallel/``) on
the CPU: two processes in a gloo group, each with half of the per-image
ray axis, against the port's one-process step and the JAX package's step
on a 2-device mesh (``make_mesh(2)`` of the simulated CPU devices).

- One training step in phases A, B (the bench configuration: the
  kernel-path trace, the supervised compaction) and C, each without and
  with ``train_cameras``, 2 images x 256 rays (2 x 128 a rank), small
  width, from the same weights (``convert.params_from_jax``) and the same
  global random draws (the ``noise=`` replay, which each rank slices as it
  slices its own draws). The port's arms run in subprocesses (a torch
  optimizer step changes XLA:CPU results for the rest of its process).
  - The two ranks end with equal parameters, gradients and poses, to the
    bit.
  - Two ranks against one process, JAX's own sharded-step tolerances
    (``tests/multihost/test_sharded_step.py``): the loss within 2e-5
    relative, the gradient norm within 2e-4, every parameter within 1e-4
    relative + 1e-5 absolute; besides, each loss term within 2e-5
    relative, equal hit fractions, each gradient tensor within 1e-4 of its
    largest entry and the SparseAdam moments (0.1 x the pose gradient)
    within 1e-4 of theirs.
  - Two ranks against the JAX package's 2-device mesh step: the port's
    step tolerances (``tests/test_torch_step.py``): loss terms within 1e-4
    relative, the gradient norm within 1e-4 relative, equal hit fractions.
    Adam's first step moves an entry by ~lr x sign(gradient), and the two
    packages' gradients part by up to 2e-3 of a tensor's largest entry, so
    an entry whose gradient lies below that may take the other sign: each
    parameter within lr / 2 where its gradient is above 2e-3 of its
    tensor's largest, within 2 lr elsewhere, and the median entry within
    1e-6; poses within 1e-6.
- The divisibility error, in both packages.
- The training CLI under ``python -m torch.distributed.run
  --nproc_per_node 2`` (gloo on the CPU): one experiment folder, rank 0's
  ``metrics.jsonl`` and checkpoints only; a 2-rank resume restores on
  every rank the state rank 0 saved, exactly.
"""
import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvsdf_tpu.train.step as j_step_mod
from mvsdf_tpu import config as jc
from mvsdf_tpu.fields.radiance import RenderConfig as JRender
from mvsdf_tpu.fields.sdf import ImplicitConfig as JImplicit
from mvsdf_tpu.parallel import device_put_batch, make_mesh
from mvsdf_tpu.parallel.sharding import \
    validate_ray_divisibility as j_validate
from mvsdf_tpu.tracing.sphere_trace import TracerConfig as JTracer
from mvsdf_tpu.train.cameras_opt import pose_vecs_from_matrices
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.data.synthetic import make_scene, write_scene_dir
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig as TImplicit
from mvsdf_tpu_torch.parallel import validate_ray_divisibility
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P = 2, 256
ICFG = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
RCFG = dict(feature_vector_size=16, dims=(64,) * 2)
BENCH_TRACER = dict(
    fill_misses=False, sampler_capacity_frac=0.25, fill_capacity_frac=0.5,
    fallback_capacity_frac=(0.0625, 0.09375, 0.375),
    march_compact_schedule=((0, (0.375, 0.5)), (1, (0.1875, 0.25)),
                            (5, (0.0625, 0.125, 0.25))))
# phase -> (phase_idx, tp, tracer kw, model kw for both, port-only kw)
PHASES = {
    "A": (0, 0.05, {}, {}, {}),
    "B": (1, 0.3, BENCH_TRACER, dict(supervised_compact_frac=(0.375,)),
          dict(use_pallas_trace=True)),
    "C": (2, 0.8, {}, {}, {}),
}
CASES = [f"{ph}{cams}" for ph in PHASES for cams in ("", "_cameras")]
N_POSES = 4
INDICES = np.array([2, 0])
LOSSES = ("loss", "rgb_loss", "eikonal_loss", "depth_loss", "feat_loss",
          "surf_loss")


def _configs(case):
    phase, tp, tr, model, port_only = PHASES[case[0]]
    cams = case.endswith("_cameras")
    common = dict(implicit_diff_min_dot=0.0, **model)
    jcfg = jc.MVSDFConfig(
        model=jc.ModelConfig(implicit=JImplicit(**ICFG),
                             render=JRender(**RCFG), tracer=JTracer(**tr),
                             **common),
        train=jc.TrainConfig(batch_size=B, num_pixels=P,
                             train_cameras=cams))
    tcfg = tc.MVSDFConfig(
        model=tc.ModelConfig(implicit=TImplicit(**ICFG),
                             render=TRender(**RCFG), tracer=TTracer(**tr),
                             **common, **port_only),
        train=tc.TrainConfig(batch_size=B, num_pixels=P,
                             train_cameras=cams))
    return phase, tp, jcfg, tcfg


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def data():
    """Weights (perturbed so the field has surface hits and unfinished
    rays), the scene with the batch's indices into a 4-row pose table, the
    table's initial rows and every global random draw, as numpy."""
    jcfg = _configs("A")[2]
    params = jax.tree_util.tree_map(
        np.asarray, j_step_mod.init_params(jcfg, seed=0))
    rng = np.random.default_rng(1)
    params["implicit"] = [
        {k: (v + 0.5 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in p.items()} for p in params["implicit"]]
    sc = make_scene(n_images=B, n_pix=P, feat_ch=8, img_hw=96, depth_hw=24)
    sc["object_mask"] = rng.uniform(size=(B, P)) < 0.7
    sc["indices"] = INDICES
    table = np.concatenate([sc["pose"][::-1], sc["pose"][::-1]])
    pv0 = np.asarray(pose_vecs_from_matrices(table), np.float32)
    pv0 += (0.01 * rng.normal(size=pv0.shape)).astype(np.float32)
    n = B * P // 2
    depth_ok = np.flatnonzero(sc["depths"].reshape(-1) > 0)
    noise = {
        "minimal_steps": rng.uniform(size=100).astype(np.float32),
        "eik_points": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "dsurf_jitter_noise": rng.uniform(
            -0.1, 0.1, (sc["depths"].size, 3)).astype(np.float32),
        "dsurf_on_idx": rng.choice(depth_ok, n),
        "dsurf_jitter_idx": rng.choice(depth_ok, n),
    }
    return params, sc, pv0, noise


PORT_ARM = r"""
import os, pickle, sys
import numpy as np, torch
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.parallel import host_ray_slice, init_distributed
from mvsdf_tpu_torch.train.step import init_train_state, make_train_step

inp, out_dir = sys.argv[1], sys.argv[2]
init_distributed(device="cpu")
rank = int(os.environ.get("RANK", "0"))
cases, params, scene, pv0, noise = pickle.load(open(inp, "rb"))
t = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
batch = t(scene)
sl = host_ray_slice(batch["uv"].shape[1])
for k in ("uv", "object_mask", "rgb"):
    batch[k] = batch[k][:, sl].contiguous()
for case, (cfg, phase, tp) in cases.items():
    cams = cfg.train.train_cameras
    state = init_train_state(cfg, seed=0, device="cpu",
                             pose_init=pv0 if cams else None)
    state.net.load_state_dict(params_from_jax(params))
    step = make_train_step(cfg, phase)
    m = step(state, batch, cfg.schedule.weights(tp), noise=t(noise))
    out = {"m:" + k: float(v) for k, v in m.items()}
    for k, p in state.net.named_parameters():
        out["p:" + k] = p.detach().numpy()
        out["g:" + k] = p.grad.numpy()
    if cams:
        out["pose_vecs"] = state.pose_vecs.numpy()
        out["cam_m"] = state.cam_opt.m.numpy()
    np.savez(os.path.join(out_dir, f"{case}_{rank}.npz"), **out)
"""


def _launch(code, args, world, env=None, timeout=600):
    """Run ``code`` in ``world`` processes of one gloo group (one process:
    no group), each with RANK / WORLD_SIZE set as torchrun sets them."""
    port = free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                 **(env or {}))
        if world > 1:
            e.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:]
    return [so for so, _ in outs]


@pytest.fixture(scope="module")
def port_runs(data, tmp_path_factory):
    """Every case's step in one process and in two ranks: {(case, world,
    rank): outputs}."""
    params, sc, pv0, noise = data
    tmp = tmp_path_factory.mktemp("parallel")
    cases = {}
    for case in CASES:
        phase, tp, _, tcfg = _configs(case)
        cases[case] = (tcfg, phase, tp)
    inp = tmp / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump((cases, params, sc, pv0, noise), f)
    runs = {}
    for world in (1, 2):
        out = tmp / f"world{world}"
        out.mkdir()
        _launch(PORT_ARM, [str(inp), str(out)], world)
        for case in CASES:
            for r in range(world):
                runs[case, world, r] = dict(np.load(out / f"{case}_{r}.npz"))
    return runs


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _jax_mesh_step(data, case):
    """The JAX package's make_train_step on a 2-device mesh, replaying the
    same draws: (state, metrics)."""
    params, sc, pv0, noise = data
    phase, tp, jcfg, _ = _configs(case)
    mesh = make_mesh(2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    adam, _ = j_step_mod.make_optimizer(jcfg)
    cams = jcfg.train.train_cameras
    state = j_step_mod.init_train_state(jcfg, seed=0,
                                        pose_init=pv0 if cams else None)
    state = state._replace(params=jp, opt_state=adam.init(jp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_step_mod, "render_forward", functools.partial(
            j_step_mod.render_forward, noise=_jnp(noise)))
        step = j_step_mod.make_train_step(jcfg, phase, mesh=mesh,
                                          donate=False)
        batch = device_put_batch(mesh, _jnp(sc))
        state, m = step(state, batch, j_step_mod.weights_to_array(
            jcfg.schedule.weights(tp)), jax.random.PRNGKey(0))
    return state, {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_keep_equal_replicas(port_runs, case):
    a, b = port_runs[case, 2, 0], port_runs[case, 2, 1]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process(port_runs, case):
    two, one = port_runs[case, 2, 0], port_runs[case, 1, 0]
    assert 0.05 < one["m:hit_frac"] < 0.95
    assert two["m:hit_frac"] == one["m:hit_frac"]
    for k in LOSSES:
        assert abs(two["m:" + k] - one["m:" + k]) <= \
            2e-5 * abs(one["m:" + k]) + 1e-7, k
    np.testing.assert_allclose(two["m:grad_norm"], one["m:grad_norm"],
                               rtol=2e-4, atol=1e-6)
    for k in one:
        if k.startswith("p:"):
            np.testing.assert_allclose(two[k], one[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        elif k.startswith("g:") or k == "cam_m":
            scale = max(np.abs(one[k]).max(), 1e-12)
            assert np.abs(two[k] - one[k]).max() <= 1e-4 * scale, k


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_the_jax_mesh_step(data, port_runs, case):
    params, _, pv0, _ = data
    _, _, jcfg, _ = _configs(case)
    state, m = _jax_mesh_step(data, case)
    port = port_runs[case, 2, 0]
    assert port["m:hit_frac"] == pytest.approx(m["hit_frac"], abs=1e-7)
    for k in LOSSES + ("grad_norm",):
        assert abs(port["m:" + k] - m[k]) <= 1e-4 * abs(m[k]) + 1e-7, k
    lr = jcfg.train.learning_rate * B
    moved = 0
    for net_name in ("implicit", "render"):
        for l, layer in enumerate(state.params[net_name]):
            for k, v in layer.items():
                want = np.asarray(v)
                name = f"{net_name}.layers.{l}.{k}"
                diff = np.abs(port["p:" + name] - want)
                g = np.abs(port["g:" + name])
                clear = g > 2e-3 * g.max()
                assert diff[clear].max() <= lr / 2, (name, diff.max())
                assert diff.max() <= 2 * lr * (1 + 1e-3), name
                assert np.median(diff) <= 1e-6, name
                moved += np.abs(want - params[net_name][l][k]).max() > lr
    assert moved > 0
    if jcfg.train.train_cameras:
        np.testing.assert_allclose(port["pose_vecs"],
                                   np.asarray(state.pose_vecs), rtol=0,
                                   atol=1e-6)
        assert np.abs(port["pose_vecs"] - pv0).max() > 0


def test_the_ray_axis_must_divide_over_the_ranks():
    validate_ray_divisibility(256, world=2)
    with pytest.raises(ValueError, match="not divisible"):
        validate_ray_divisibility(255, world=2)
    j_validate(256, make_mesh(2))
    with pytest.raises(ValueError, match="not divisible"):
        j_validate(255, make_mesh(2))


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
        skip_in = [2]
        multires = 6
    }
    rendering_network {
        mode = idr
        dims = [64, 64]
        multires_view = 4
    }
}
"""
RESUME_ARM = r"""
import os, sys
import numpy as np, torch
from mvsdf_tpu_torch.train import checkpoints as ckpt, cli

trainer, _ = cli.setup(sys.argv[2:])
trainer.maybe_resume()
tree, rng = ckpt.load_checkpoint(trainer.ckpt_dir, None)
st = trainer.state
same = all(torch.equal(v, tree["net"][k])
           for k, v in st.net.state_dict().items())
saved, live = tree["optimizer"]["state"], st.optimizer.state_dict()["state"]
same &= all(torch.equal(live[i][k], v) for i, s in saved.items()
            for k, v in s.items())
same &= trainer.rng.bit_generator.state == rng["np_rng"]
same &= torch.equal(trainer.generator.get_state(),
                    torch.from_numpy(rng["torch_generator"]))
trainer.run(resume=False)
out = {k: v.numpy() for k, v in st.net.state_dict().items()}
np.savez(os.path.join(sys.argv[1], f"resumed_{os.environ['RANK']}.npz"),
         same=same, start=trainer.start_epoch, **out)
"""


def test_a_two_rank_cli_run_saves_once_and_resumes_on_every_rank(tmp_path):
    data = write_scene_dir(str(tmp_path), n_images=3, img_hw=32,
                           depth_hw=16)
    conf = tmp_path / "small.conf"
    conf.write_text(CONF)
    exps = tmp_path / "exps"
    args = ["--data_dir", data, "--platform", "cpu", "--conf", str(conf),
            "--batch_size", "3", "--num_pixels", "64", "--exps_folder",
            str(exps), "--allow_random_features", "--pallas"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "mvsdf_tpu_torch.train.cli",
         *args, "--nepoch", "2"], env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    # rank 0 alone printed the epochs
    assert res.stdout.count("[1/2] loss=") == 1, res.stdout
    stamps = os.listdir(exps / "mvsdf")
    assert len(stamps) == 1
    exp = exps / "mvsdf" / stamps[0]
    rows = [json.loads(x) for x in open(exp / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert sorted(os.listdir(exp / "checkpoints")) == [
        "latest.txt", "step_1", "step_2"]
    assert "scene_1.png" in os.listdir(exp / "plots")

    _launch(RESUME_ARM, [str(tmp_path), *args, "--nepoch", "3",
                         "--is_continue"], world=2)
    r0, r1 = (dict(np.load(tmp_path / f"resumed_{r}.npz")) for r in (0, 1))
    assert bool(r0["same"]) and bool(r1["same"])
    assert int(r0["start"]) == int(r1["start"]) == 3
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], k)
    rows = [json.loads(x) for x in open(exp / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
