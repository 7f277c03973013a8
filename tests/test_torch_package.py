"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package nor an image library (the GPU machine it targets has none), its
entry points refuse to fall back to the CPU silently, and its parameter
conversion and synthetic scene match the JAX package's."""
import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mvsdf_tpu.train.step import init_params as j_init_params
from mvsdf_tpu import config as jc
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.convert import params_from_jax, params_to_jax
from mvsdf_tpu_torch.data.convert import convert as convert_images
from mvsdf_tpu_torch.data.convert import main as convert_main
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.eval import marching_native
from mvsdf_tpu_torch.eval.marching import eval_sdf_grid, extract_mesh
from mvsdf_tpu_torch.fields.network import MVSDFNetwork
from mvsdf_tpu_torch.tracing.kernels import build
from mvsdf_tpu_torch.train.step import init_params, init_train_state
from tests.golden.scene_fixtures import make_scene as golden_make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_LIBRARIES = ("imageio", "cv2", "PIL", "matplotlib", "mpl_toolkits",
                   "orbax", "skimage")
PORT = os.path.join(REPO, "mvsdf_tpu_torch")


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = list(_port_files())
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mvsdf_tpu", "optax", "flax"),\
                (path, mod)


def test_no_file_of_the_port_imports_an_image_library():
    files = list(_port_files())
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in IMAGE_LIBRARIES, (path, mod)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, mvsdf_tpu_torch\n"
            "for m in pkgutil.walk_packages(mvsdf_tpu_torch.__path__, "
            "'mvsdf_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{('jax', 'mvsdf_tpu') + IMAGE_LIBRARIES!r}]\n"
            "print(len([m for m in sys.modules if m.startswith("
            "'mvsdf_tpu_torch.')]), bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) > 20 and bad.strip() == "[]", res.stdout


def test_entry_points_default_to_cuda_and_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = tc.MVSDFConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, device="cuda")
    sphere = lambda x: x.norm(dim=-1) - 0.5
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_sdf_grid(sphere, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_mesh(sphere, 8)
    assert extract_mesh(sphere, 8, device="cpu")[1].shape[1] == 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_main(["--data_dir", "vis", "--out_dir", "scene"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_images("vis", "scene")
    from mvsdf_tpu_torch import bench, graft_entry
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.main([])


def test_the_eval_modules_are_scanned_and_build_from_the_port():
    """The scans above cover the eval slice, and the host C++ the port
    compiles is its own copy under its csrc/, never a source of the JAX
    package."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("eval/cli.py", "eval/psnr.py", "eval/chamfer.py",
                "eval/dtu_eval.py", "eval/marching_native.py",
                "eval/mesh.py", "data/convert.py", "data/jpeg.py",
                "fields/fused_grad.py"):
        assert os.path.join("mvsdf_tpu_torch", mod) in files, mod
    src = os.path.join(build.CSRC, marching_native.SOURCE)
    assert os.path.exists(src)
    assert os.path.commonpath([src, PORT]) == PORT


def test_params_from_jax_round_trip_is_exact():
    params = jax.tree_util.tree_map(
        np.asarray, j_init_params(jc.MVSDFConfig(), seed=5))
    state = params_from_jax(params)
    back = params_to_jax(state)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    cfg = tc.MVSDFConfig()
    net = MVSDFNetwork(cfg.model.implicit, cfg.model.render)
    net.load_state_dict(state)  # strict: every key and shape matches
    # and the port's own init from the same seed draws the same weights
    mine = init_params(cfg, seed=5, device="cpu").state_dict()
    for k, v in state.items():
        np.testing.assert_array_equal(mine[k].numpy(), v.numpy())


def test_synthetic_scene_matches_the_jax_fixture():
    kw = dict(n_images=3, n_pix=100, feat_ch=4, img_hw=40, depth_hw=20)
    ours, theirs = make_scene(**kw), golden_make_scene(**kw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], k)


def test_the_data_parallel_export_and_figure_modules_are_scanned():
    """The scans above cover the data-parallel, export and figure modules
    of the port, and importing them alone loads no JAX, no JAX package and
    no matplotlib."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    mods = ("parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharding.py", "eval/export.py", "eval/plots.py")
    for mod in mods:
        assert os.path.join("mvsdf_tpu_torch", mod) in files, mod
    names = ["mvsdf_tpu_torch." + m[:-3].replace("/", ".").replace(
        ".__init__", "") for m in mods]
    code = ("import sys, importlib\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "from mvsdf_tpu_torch.eval.plots import (plot_depth_maps, "
            "plot_scene_snapshot)\n"
            "from mvsdf_tpu_torch.eval.export import (export_renderer, "
            "load_renderer, make_render_fn, main)\n"
            "from mvsdf_tpu_torch.parallel import (init_distributed, "
            "world_size, rank, DATA_AXIS, host_ray_slice, "
            "validate_ray_divisibility, sum_counts, sum_)\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{('jax', 'mvsdf_tpu') + IMAGE_LIBRARIES!r}])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_the_validation_modules_are_scanned_and_need_a_gpu(tmp_path):
    """The scans above cover the validation entry points and the shaded
    scene; importing them alone loads no JAX, no JAX package and no image
    library; and they run on the GPU unless asked for the CPU."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    mods = ("validation/__init__.py", "validation/full_training.py",
            "validation/quality_pin.py", "validation/dtu_suite.py",
            "data/synthetic.py")
    for mod in mods:
        assert os.path.join("mvsdf_tpu_torch", mod) in files, mod
    names = ["mvsdf_tpu_torch." + m[:-3].replace("/", ".").replace(
        ".__init__", "") for m in mods]
    code = ("import sys, importlib\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "from mvsdf_tpu_torch.validation.full_training import (train, "
            "evaluate, run, main)\n"
            "from mvsdf_tpu_torch.validation.quality_pin import gate\n"
            "from mvsdf_tpu_torch.data.synthetic import (make_scene_shaded, "
            "write_shaded_scene_dir)\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{('jax', 'mvsdf_tpu', 'tests') + IMAGE_LIBRARIES!r}])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from mvsdf_tpu_torch.data.synthetic import make_scene_shaded
    from mvsdf_tpu_torch.validation import full_training
    with pytest.raises(RuntimeError, match="no CUDA device"):
        full_training.main(["--epochs", "1", "--out", str(tmp_path / "v")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_scene_shaded(n=2, img_hw=8, depth_hw=4, n_pix=8)
    assert not os.path.exists(tmp_path / "v")


def test_the_bench_and_entry_modules_are_scanned_and_import_no_driver_file():
    """The scans above cover the bench and the driver entry points; neither they nor any other file of the port or
    chip_smoke.py imports the JAX package's ``bench`` or
    ``__graft_entry__``, or the tests; importing them alone loads none of
    these, no JAX and no image library."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    mods = ("bench.py", "graft_entry.py")
    for mod in mods:
        assert os.path.join("mvsdf_tpu_torch", mod) in files, mod
    for path in _port_files():
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("bench", "__graft_entry__",
                                             "tests"), (path, mod)
    names = ["mvsdf_tpu_torch." + m[:-3] for m in mods]
    code = ("import sys, importlib\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "from mvsdf_tpu_torch.bench import (bench_config, fused_config, "
            "run_bench, main)\n"
            "from mvsdf_tpu_torch.graft_entry import entry, dryrun_multichip\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            f"{('jax', 'mvsdf_tpu', 'tests', 'bench', '__graft_entry__') + IMAGE_LIBRARIES!r}])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
