"""The port's mesh trimming (``mvsdf_tpu_torch/meshcut/``) against the JAX
package's ``mvsdf_tpu/meshcut/`` on the CPU, exactly: face adjacency, the
Otsu threshold and the mode gap, the max-flow cut (and its plain version
through ``scipy.sparse.csgraph.maximum_flow``), ``trim_mesh`` and the CLI,
on random meshes and graphs and on the in-repo trained mesh
``tests/fixtures/capstone_trained_mesh_r48.obj``.

Both packages build their own copy of ``maxflow.cpp`` with the system C++
compiler; the port's lands in ``tracing/kernels/_build/``.
"""
import os
import shutil

import numpy as np
import pytest

from mvsdf_tpu.meshcut import cli as j_cli
from mvsdf_tpu.meshcut import cut as j_cut
from mvsdf_tpu_torch.eval.mesh import load_obj
from mvsdf_tpu_torch.meshcut import cli, cut, native
from mvsdf_tpu_torch.tracing.kernels import build

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "capstone_trained_mesh_r48.obj")


def _grid_mesh(n, rng, drop):
    """An n x n grid of quads split into triangles, a share ``drop`` of
    them removed (holes, boundaries, islands), random vertex colours."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    vid = lambda a, b: a * (n + 1) + b
    tri = np.concatenate([
        np.stack([vid(i, j), vid(i + 1, j), vid(i, j + 1)], -1),
        np.stack([vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)], -1)
    ]).reshape(-1, 3)
    faces = tri[rng.uniform(size=len(tri)) >= drop]
    verts = rng.uniform(-1, 1, ((n + 1) ** 2, 3)).astype(np.float32)
    # two confidence modes, as a trained indicator gives
    red = np.where(rng.uniform(size=len(verts)) < 0.3,
                   rng.uniform(0.8, 1.0, len(verts)),
                   rng.uniform(0.0, 0.3, len(verts)))
    colors = np.stack([red, 1 - red, np.zeros_like(red)], -1)
    return verts, faces, colors.astype(np.float32)


def _soup(rng):
    """A triangle soup on few vertices: edges shared by many faces, and
    degenerate faces with a repeated vertex."""
    faces = rng.integers(0, 12, (200, 3))
    colors = rng.uniform(size=(12, 3)).astype(np.float32)
    return rng.uniform(size=(12, 3)).astype(np.float32), faces, colors


@pytest.fixture(scope="module")
def meshes():
    rng = np.random.default_rng(0)
    return {"fixture": load_obj(FIXTURE),
            "grid": _grid_mesh(40, rng, 0.1),
            "grid_holes": _grid_mesh(25, rng, 0.4),
            "soup": _soup(rng)}


MESHES = ["fixture", "grid", "grid_holes", "soup"]


@pytest.mark.parametrize("name", MESHES)
def test_adjacency_threshold_and_separation_match_jax(meshes, name):
    verts, faces, colors = meshes[name]
    adj = cut.face_adjacency_edges(faces)
    np.testing.assert_array_equal(adj, j_cut.face_adjacency_edges(faces))
    assert len(adj) > 0
    conf = colors[faces, 0].mean(axis=1)
    assert cut.auto_threshold(conf) == j_cut.auto_threshold(conf)
    assert cut.indicator_separation(conf) == \
        j_cut.indicator_separation(conf)
    # the degenerate cases: one bin, no faces
    flat = np.full(50, 0.4, np.float32)
    assert cut.auto_threshold(flat) == j_cut.auto_threshold(flat)
    assert cut.auto_threshold(flat[:0]) == j_cut.auto_threshold(flat[:0])
    assert cut.indicator_separation(flat) == 0.0


def _random_graph(rng):
    n = int(rng.integers(1, 300))
    labels = rng.uniform(size=n) < rng.uniform(0.1, 0.9)
    m = int(rng.integers(0, 4 * n))
    uv = rng.integers(0, n, (m, 2))        # with self-loops and repeats
    cap = rng.integers(0, 12, (m, 1))      # with capacity 0
    return labels, np.concatenate([uv, cap], 1).astype(np.uint32)


@pytest.mark.parametrize("seed", range(6))
def test_maxflow_matches_jax_and_scipy(seed):
    """On random graphs: the native cut's flow value and source side equal
    the plain version's (scipy) and the JAX package's source side,
    exactly. The source side (reachable in the residual graph) is the same
    for every maximum flow."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        labels, edges = _random_graph(rng)
        flow, side = cut.maxflow_cut(labels, edges)
        ref_flow, ref_side = cut.maxflow_cut_reference(labels, edges)
        assert flow == ref_flow
        np.testing.assert_array_equal(side, ref_side)
        np.testing.assert_array_equal(side, j_cut.mesh_cut(labels, edges))
        np.testing.assert_array_equal(cut.mesh_cut(labels, edges), side)


@pytest.mark.parametrize("name", MESHES)
def test_maxflow_on_mesh_graphs_matches_scipy(meshes, name):
    verts, faces, colors = meshes[name]
    conf = colors[faces, 0].mean(axis=1)
    labels = conf > cut.auto_threshold(conf) / 255.0
    adj = cut.face_adjacency_edges(faces)
    for smooth in (1, 10):
        edges = np.concatenate([adj, np.full((len(adj), 1), smooth)], 1)
        flow, side = cut.maxflow_cut(labels, edges)
        ref_flow, ref_side = cut.maxflow_cut_reference(labels, edges)
        assert flow == ref_flow and flow > 0
        np.testing.assert_array_equal(side, ref_side)


def test_maxflow_refuses_an_edge_beyond_the_faces():
    with pytest.raises(ValueError, match="beyond the 3 labels"):
        cut.maxflow_cut(np.ones(3, bool), np.array([[0, 3, 1]]))


@pytest.mark.parametrize("thresh", [15.0, "auto", 200.0])
@pytest.mark.parametrize("smooth", [1, 10])
def test_trim_mesh_matches_jax(meshes, thresh, smooth):
    """The trained fixture at 15 (which removes every face of a mesh whose
    indicator is calibrated below the reference's 0.94), the Otsu split,
    and 200: vertices, faces and colours equal."""
    verts, faces, colors = meshes["fixture"]
    got = cut.trim_mesh(verts, faces, colors, thresh=thresh, smooth=smooth)
    want = j_cut.trim_mesh(verts, faces, colors, thresh=thresh,
                           smooth=smooth)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if thresh == "auto":
        assert 0 < len(got[1]) < len(faces)
    with pytest.raises(ValueError, match="'auto'"):
        cut.trim_mesh(verts, faces, colors, thresh="otsu")


@pytest.mark.parametrize("args", [["--thresh", "auto"],
                                  ["--thresh", "15", "--smooth", "3"],
                                  ["--thresh", "120"]],
                         ids=["auto", "15", "120"])
def test_cli_matches_jax(tmp_path, capsys, args):
    """Both CLIs on the fixture: the same printed lines (with the output
    path swapped) and the same OBJ, byte for byte."""
    out = {}
    for tag, main in (("jax", j_cli.main), ("port", cli.main)):
        path = str(tmp_path / f"{tag}.obj")
        main([FIXTURE, path, *args])
        out[tag] = (capsys.readouterr().out.replace(path, "OUT"),
                    open(path).read())
    assert out["port"] == out["jax"]
    assert "trimmed " in out["port"][0]
    if args[1] == "auto":
        assert out["port"][0].startswith("auto threshold: ")


def test_cli_refuses_an_obj_without_colours(tmp_path):
    from mvsdf_tpu_torch.eval.mesh import save_obj
    verts, faces, _ = load_obj(FIXTURE)
    path = str(tmp_path / "plain.obj")
    save_obj(path, verts, faces)
    with pytest.raises(SystemExit, match="no vertex colors"):
        cli.main([path, str(tmp_path / "out.obj")])


def test_native_library_is_built_from_the_port_and_a_failed_build_raises(
        tmp_path):
    """``maxflow.cpp`` is a copy of the JAX package's, byte for byte, built
    from ``tracing/kernels/csrc/`` into ``_build/``; a source that does not
    compile raises (there is no Python stand-in)."""
    src = os.path.join(build.CSRC, native.SOURCE)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(src, "rb") as a, open(os.path.join(
            repo, "mvsdf_tpu", "meshcut", "maxflow.cpp"), "rb") as b:
        assert a.read() == b.read()
    lib = native.load()
    assert lib._name == build.host_library_path(native.SOURCE)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(src, csrc / native.SOURCE)
    with open(csrc / native.SOURCE, "a") as f:
        f.write("\nthis is not C++\n")
    with pytest.raises(RuntimeError, match="maxflow.cpp failed"):
        build.build_host(native.SOURCE, str(csrc), str(tmp_path / "out"))
