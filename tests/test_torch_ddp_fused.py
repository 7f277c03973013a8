"""The fused chunk path (``train/loop.py``'s ``_train_chunk``: on the CPU
the captured step's plain version, run eagerly) under a process group:
two gloo ranks in subprocesses, each with half of every image's rays, on
a 4-view scene at B=2 x P=512 rays a step (1,024: enough that the bounded
trace's capacity tiers and tiles stay on), over one chunk of three epochs
(epochs 0-2, two steps each) from the JAX package's initial parameters.

- Against the one-process chunk path, both replaying the same global
  draws at every step (each side's ``render_forward`` given one fixed
  noise dict, which each rank slices as it slices its own draws): every
  epoch's metrics within 2e-5 relative (``tests/test_torch_parallel.py``'s
  bound for two ranks against one process), ``hit_frac`` equal, and every
  parameter within Adam's bound after six steps (each entry lr / 2, the
  median entry 1e-6: an entry whose gradient is near 0 may take either
  sign, as ``tests/test_torch_fused_dispatch.py`` bounds the JAX
  comparison).
- Against the JAX package's fused ``Trainer`` on a two-device CPU mesh
  (``--xla_force_host_platform_device_count=2`` in a process of its own),
  with the same draws: ``tests/test_torch_fused_dispatch.py``'s bounds
  (metrics within 1e-4 relative, ``hit_frac`` equal, lr within 1e-6,
  parameters within lr / 2 and the median within 1e-6).
- The two ranks end with equal parameters and Adam moments, to the bit.
- With each epoch's pixel subset ordered so that rank 0's share holds the
  silhouette and rank 1's none of it, the ranks' bounded tiles run
  differently (a recorder on ``compaction.run_if``), and every rank makes
  the same all-reduces, of the same sizes, in the same order (a recorder
  on ``dist.all_reduce``): in phase A three a step (the eikonal and
  depth losses' counts, then the gradients), none inside a tile.
- The benchmark's data-parallel driver (``portbench/drivers/
  train_ddp.py``) at its tests' CPU size, two ranks: rank 0's steps
  against the plain reference (``portbench/reference/``) within 1e-4, as
  ``portbench/tests/test_portbench_correct.py`` holds the one-process
  cells, and the ranks' weights equal after its window.
- ``loop.fuses``: a gloo group takes the chunk path on the CPU, not on a
  GPU (a graph cannot capture gloo's collectives).
- On two cards (skips with fewer): the same chunk over NCCL, each rank
  replaying its captured graph, ends with bit-equal replicas.

Every arm runs in a subprocess (a torch optimizer step changes XLA:CPU
results for the rest of its process, and each rank is a process); the
test process imports no JAX.
"""
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.data.synthetic import write_scene_dir
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig as TImplicit
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig as TTracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, EPOCHS = 2, 512, 3
METRICS = ("loss", "rgb_loss", "eikonal_loss", "depth_loss", "feat_loss",
           "surf_loss", "grad_norm", "lr", "hit_frac")
# the bench configuration's trace: the capacity cascade and the march's
# compaction schedule (tests/test_torch_parallel.py's BENCH_TRACER)
TRACER = dict(
    sphere_tracing_iters=3, n_steps=12, n_secant_steps=2, sample_chunk=0,
    fill_misses=False, sampler_capacity_frac=0.25, fill_capacity_frac=0.5,
    fallback_capacity_frac=(0.0625, 0.09375, 0.375),
    march_compact_schedule=((0, (0.375, 0.5)), (1, (0.1875, 0.25)),
                            (2, (0.0625, 0.125, 0.25))))
NET = dict(implicit=dict(feature_vector_size=32, dims=(32,) * 2, skip_in=(),
                         multires=4),
           render=dict(feature_vector_size=32, dims=(32,), multires_view=2))
TRAIN = dict(batch_size=B, num_pixels=P, nepochs=24, epochs_per_dispatch=3,
             plot_freq=0.5)


def _cfg(pallas=True):
    """The port's configuration: the JAX run's, with the trace through
    the kernels' plain versions (their count entries and bounded tiles)
    where ``pallas``."""
    return tc.MVSDFConfig(
        model=tc.ModelConfig(
            implicit=TImplicit(**NET["implicit"]),
            render=TRender(**NET["render"]), tracer=TTracer(**TRACER),
            use_pallas_trace=pallas),
        train=tc.TrainConfig(**TRAIN))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(code, args, world, env=None, timeout=600):
    """``code`` in ``world`` processes of one group (gloo; one process: no
    group), RANK / WORLD_SIZE set as torchrun sets them."""
    port = _free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                 **(env or {}))
        if world > 1:
            e.update(RANK=str(r), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args], env=e, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, so[-3000:] + se[-3000:]
    return [so for so, _ in outs]


JAX_MESH_RUN = r"""
import functools, json, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
import mvsdf_tpu.train.step as j_step
from mvsdf_tpu import config as jc
from mvsdf_tpu.data.scene import SceneData
from mvsdf_tpu.fields.radiance import RenderConfig
from mvsdf_tpu.fields.sdf import ImplicitConfig
from mvsdf_tpu.tracing.sphere_trace import TracerConfig
from mvsdf_tpu.train.loop import Trainer

scene_dir, out = sys.argv[1], sys.argv[2]
net, tracer, train, noise = pickle.load(open(os.path.join(out, "jax.pkl"),
                                             "rb"))
assert len(jax.devices()) == 2, jax.devices()
cfg = jc.MVSDFConfig(
    model=jc.ModelConfig(implicit=ImplicitConfig(**net["implicit"]),
                         render=RenderConfig(**net["render"]),
                         tracer=TracerConfig(**tracer)),
    schedule=jc.Schedule(), train=jc.TrainConfig(**train))
params0 = jax.tree_util.tree_map(
    np.asarray, j_step.init_params(cfg, seed=cfg.train.seed))
j_step.render_forward = functools.partial(
    j_step.render_forward,
    noise={k: jnp.asarray(v) for k, v in noise.items()})
t = Trainer(cfg, SceneData(scene_dir, allow_random_features=True),
            os.path.join(out, "jax"), log_fn=lambda *a: 0)
assert t.mesh is not None and t.mesh.size == 2
t.state = t.state._replace(
    params=jax.tree_util.tree_map(jnp.asarray, params0))
t._train_chunk(0, 2)
t._flush_metrics()
flat = lambda p: {f"{n}.layers.{i}.{k}": np.asarray(v)
                  for n in ("implicit", "render")
                  for i, layer in enumerate(p[n]) for k, v in layer.items()}
np.savez(os.path.join(out, "jax.npz"), **flat(t.state.params))
with open(os.path.join(out, "params0.pkl"), "wb") as f:
    pickle.dump(params0, f)
"""

PORT_RUN = r"""
import json, os, pickle, sys
import numpy as np, torch
import torch.distributed as dist
import mvsdf_tpu_torch.train.step as ts
from mvsdf_tpu_torch import compaction
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.scene import SceneData
from mvsdf_tpu_torch.parallel import init_distributed, rank, world_size
from mvsdf_tpu_torch.train.loop import Trainer, fuses

scene_dir, out, mode, device = sys.argv[1:5]
dev = init_distributed(device=device)
torch.set_num_threads(2)
cfg, params0, noise = pickle.load(open(os.path.join(out, "port.pkl"), "rb"))
fixed = {k: torch.from_numpy(np.asarray(v)).to(dev)
         for k, v in noise.items()}
render_forward = ts.render_forward


def replay(*args, **kw):   # every step's draws: the fixed noise
    kw["noise"] = fixed
    return render_forward(*args, **kw)


ts.render_forward = replay
calls, preds = [], []
if mode == "record":
    all_reduce, run_if = dist.all_reduce, compaction.run_if

    def recorded(t, *a, **kw):
        calls.append([t.numel(), str(t.dtype)])
        return all_reduce(t, *a, **kw)

    def recorded_if(pred, body):
        preds.append(bool(pred))
        return run_if(pred, body)

    dist.all_reduce, compaction.run_if = recorded, recorded_if
    draw = SceneData.draw_sampling_idx

    def silhouette_first(self, n, rng):   # rank 0's share: the silhouette
        sel = draw(self, n, rng)
        inside = self.masks.any(0)[sel]
        return sel[np.argsort(~inside, kind="stable")]

    SceneData.draw_sampling_idx = silhouette_first
sd = SceneData(scene_dir, allow_random_features=True, device=dev)
t = Trainer(cfg, sd, os.path.join(out, f"{mode}{world_size()}"), device=dev,
            log_fn=lambda *a: None)
if params0 is not None:   # else the trainer's own, from the seed
    t.state.net.load_state_dict(params_from_jax(params0))
t._train_chunk(0, 2)
t._flush_metrics()
if dev.type == "cuda":
    torch.cuda.synchronize()
res = {"p:" + k: v.detach().cpu().numpy()
       for k, v in t.state.net.named_parameters()}
for i, (m, v, _) in enumerate(ts.adam_state(t.state.optimizer)):
    res[f"m:{i}"], res[f"v:{i}"] = m.cpu().numpy(), v.cpu().numpy()
res["calls"], res["preds"] = json.dumps(calls), json.dumps(preds)
res["fuses"] = [fuses(cfg, dev), fuses(cfg, "cuda")]
graphs = [s.graph is not None for s in t.fused_steps.values()]
res["replayed"] = bool(graphs) and all(graphs)
np.savez(os.path.join(out, f"{mode}_{world_size()}_{rank()}.npz"), **res)
"""


def _noise(seed):
    """Every global draw of a step (``render_forward``'s ``noise=``)."""
    rng = np.random.default_rng(seed)
    n, depth_rows = B * P // 2, B * 16 * 16   # the scene's 16x16 depths
    return {
        "minimal_steps": rng.uniform(size=12).astype(np.float32),
        "eik_points": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "dsurf_jitter_noise": rng.uniform(
            -0.1, 0.1, (depth_rows, 3)).astype(np.float32),
        "dsurf_on_idx": rng.integers(0, depth_rows, n),
        "dsurf_jitter_idx": rng.integers(0, depth_rows, n)}


def _rows(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh run, then the port's: one process and two ranks
    replaying the same draws, and two ranks recording their all-reduces
    and tiles. {name: (outputs, metrics rows)}, the scene and the
    folder."""
    out = tmp_path_factory.mktemp("ddp_fused")
    scene_dir = write_scene_dir(str(out / "data"), n_images=4)
    noise = _noise(1)
    with open(out / "jax.pkl", "wb") as f:
        pickle.dump((NET, TRACER, TRAIN, noise), f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = subprocess.run([sys.executable, "-c", JAX_MESH_RUN, scene_dir,
                          str(out)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    with open(out / "params0.pkl", "rb") as f:
        params0 = pickle.load(f)
    with open(out / "port.pkl", "wb") as f:
        pickle.dump((_cfg(), params0, noise), f)
    got = {"jax": (dict(np.load(out / "jax.npz")), _rows(out / "jax"))}
    for mode, world in (("noise", 1), ("noise", 2), ("record", 2)):
        _launch(PORT_RUN, [scene_dir, str(out), mode, "cpu"], world)
        for r in range(world):
            got[mode, world, r] = (
                dict(np.load(out / f"{mode}_{world}_{r}.npz")),
                _rows(out / f"{mode}{world}") if r == 0 else None)
    return got, scene_dir, out


def _params(d):
    return {k[2:]: v for k, v in d.items() if k.startswith("p:")}


def _close_to(got, want, lr):
    """Every entry within lr / 2, the median within 1e-6 (module
    docstring)."""
    assert got.keys() == want.keys()
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= lr / 2, (k, diff.max())
        assert np.median(diff) <= 1e-6, (k, np.median(diff))


@pytest.mark.parametrize("mode", ["noise", "record"])
def test_two_ranks_keep_bit_equal_replicas(runs, mode):
    got, _, _ = runs
    a, b = got[mode, 2, 0][0], got[mode, 2, 1][0]
    keys = [k for k in a if k[:2] in ("p:", "m:", "v:")]
    assert keys and sorted(keys) == sorted(k for k in b if k[:2] in
                                           ("p:", "m:", "v:"))
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_two_rank_chunk_equals_one_process(runs):
    got, _, _ = runs
    (two, rows2), (one, rows1) = got["noise", 2, 0], got["noise", 1, 0]
    assert [r["step"] for r in rows2] == [r["step"] for r in rows1] == \
        list(range(EPOCHS))
    for r2, r1 in zip(rows2, rows1):
        assert 0.05 < r1["hit_frac"] < 0.95
        for k in METRICS:
            if k == "hit_frac":
                assert r2[k] == r1[k], (r1["step"], k)
            else:
                assert abs(r2[k] - r1[k]) <= 2e-5 * abs(r1[k]) + 1e-7, \
                    (r1["step"], k, r2[k], r1[k])
    _close_to(_params(two), _params(one), _cfg().train.learning_rate * B)


def test_two_rank_chunk_equals_the_jax_mesh_trainer(runs):
    from mvsdf_tpu_torch.convert import params_from_jax
    got, _, out = runs
    (two, rows), (jax_p, jrows) = got["noise", 2, 0], got["jax"]
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == \
        list(range(EPOCHS))
    for r, jr in zip(rows, jrows):
        for k in METRICS:
            if k == "hit_frac":
                assert r[k] == jr[k], (r["step"], k)
            elif k == "lr":
                np.testing.assert_allclose(r[k], jr[k], rtol=1e-6)
            else:
                assert abs(r[k] - jr[k]) <= 1e-4 * abs(jr[k]) + 1e-7, \
                    (r["step"], k, r[k], jr[k])
    lr = _cfg().train.learning_rate * B
    _close_to(_params(two), jax_p, lr)
    with open(out / "params0.pkl", "rb") as f:
        start = {k: v.numpy() for k, v in
                 params_from_jax(pickle.load(f)).items()}
    assert max(np.abs(jax_p[k] - start[k]).max() for k in start) > lr


def test_ranks_make_the_same_all_reduces_when_their_tiles_differ(runs):
    got, _, _ = runs
    (a, rows), (b, _) = got["record", 2, 0], got["record", 2, 1]
    calls = [json.loads(str(d["calls"])) for d in (a, b)]
    preds = [json.loads(str(d["preds"])) for d in (a, b)]
    assert preds[0] != preds[1]
    assert sum(preds[0]) > sum(preds[1])
    steps = EPOCHS * 2
    assert len(calls[0]) == 3 * steps
    assert calls[0] == calls[1]
    grads = [c for c in calls[0] if c[0] > 1]
    assert len(grads) == steps and len({c[0] for c in grads}) == 1
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_a_gloo_group_fuses_on_the_cpu_only(runs):
    """The chunk path under a gloo group on the CPU, and not on a GPU,
    where a graph cannot capture gloo's collectives; one process fuses."""
    got, _, _ = runs
    assert list(got["noise", 2, 0][0]["fuses"]) == [True, False]
    assert list(got["noise", 1, 0][0]["fuses"]) == [True, True]


DRIVER_RUN = r"""
import json, sys, torch
from portbench import run
from portbench.common import Cell, load_benchmark
from portbench.tests import tiny
real = Cell(load_benchmark(), "ddp4_dtu_kernels.train_c")
cell = tiny.cell(real.name, real.config_name)
cell.config["ranks"] = 2
cell.config["train"]["num_pixels"] = 512
cell.end_to_end = real.end_to_end
res, checks = run.measure(cell, 2 ** 31 + 29, 0.5, False,
                          torch.device("cpu"), cache=sys.argv[1])
print(json.dumps({"correct": res["correct"], "attempted": res["attempted"],
                  "checks": {k: v for k, v, _ in checks}}))
"""


def test_the_benchmark_driver_against_the_plain_reference(runs, tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", DRIVER_RUN, str(tmp_path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["attempted"] > 0, got
    checks = got["checks"]
    assert checks["replica_gap"] == 0
    for k in ("loss_gap", "grad_gap", "update_gap"):
        assert checks[k] <= 1e-4, (k, checks[k])


@pytest.mark.cuda
def test_two_cards_replay_the_chunk_with_equal_replicas(tmp_path):
    """The port's own initial parameters and the noise of a seed: this
    runs where JAX is not installed."""
    import torch
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    out = tmp_path
    scene_dir = write_scene_dir(str(out / "data"), n_images=4)
    with open(out / "port.pkl", "wb") as f:
        pickle.dump((_cfg(), None, _noise(2)), f)
    _launch(PORT_RUN, [scene_dir, str(out), "cards", "cuda"], 2)
    a, b = (dict(np.load(out / f"cards_2_{r}.npz")) for r in (0, 1))
    assert bool(a["replayed"]) and bool(b["replayed"])
    for k in a:
        if k[:2] in ("p:", "m:", "v:"):
            np.testing.assert_array_equal(a[k], b[k], k)
