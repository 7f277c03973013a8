"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU silently, and its
parameter conversion and synthetic scene match the JAX package's."""
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
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.fields.network import MVSDFNetwork
from mvsdf_tpu_torch.train.step import init_params, init_train_state
from tests.golden.scene_fixtures import make_scene as golden_make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, mvsdf_tpu_torch\n"
            "for m in pkgutil.walk_packages(mvsdf_tpu_torch.__path__, "
            "'mvsdf_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'mvsdf_tpu')]\n"
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
