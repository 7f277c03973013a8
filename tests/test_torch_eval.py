"""The training loop's mesh snapshot and render writer against the JAX
package on the CPU: the SDF grid through the plain field, marching
tetrahedra, the largest component, OBJ and HTML output, and the
rendered-vs-ground-truth PNG.

Tolerances: meshes of an analytic SDF exact on the same grid (the same
numpy arithmetic), its grid 1e-6 (one f32 ulp from another sqrt and sin);
the small field's grid 2e-5 absolute (f32 sums in another order on
each side, as in ``tests/test_torch_fields.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu.eval import html_viewer as j_html
from mvsdf_tpu.eval import marching as j_march
from mvsdf_tpu.eval import mesh as j_mesh
from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.png import read_png
from mvsdf_tpu_torch.eval import html_viewer as t_html
from mvsdf_tpu_torch.eval import marching as t_march
from mvsdf_tpu_torch.eval import mesh as t_mesh
from mvsdf_tpu_torch.eval.plots import plot_image_grid
from mvsdf_tpu_torch.fields import sdf as t_sdf

ICFG = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))


def _two_blobs(lib):
    """Two spheres of radius 0.35 and 0.2 (two components), with a bump."""
    def f(x):
        a = lib.sqrt(((x - lib.asarray([0.3, 0.0, 0.0])) ** 2).sum(-1))
        b = lib.sqrt(((x + lib.asarray([0.5, 0.1, 0.0])) ** 2).sum(-1))
        return lib.minimum(a - 0.35, b - 0.2) + 0.02 * lib.sin(9 * x[..., 1])
    return f


def _oriented_triangles(verts, faces):
    """Each face as its three vertices, rotated to start at the least one
    (which keeps its orientation), the faces sorted: the mesh's triangle
    set, whatever order the vertices and faces are numbered in."""
    out = []
    for t in verts[faces]:
        k = tuple(map(tuple, t.tolist()))
        i = min(range(3), key=k.__getitem__)
        out.append(k[i:] + k[:i])
    return sorted(out)


@pytest.mark.parametrize("resolution,slab", [(29, 8), (32, 5)])
def test_extract_mesh_matches_jax(resolution, slab):
    """Ragged and whole slabs: the grid, the numpy triangulation and the
    largest component are the JAX package's; ``extract_mesh`` triangulates
    with the C++ code as the JAX package's does by default, giving its
    vertices and faces exactly, and the numpy path's vertices with the same
    oriented triangles, numbered in another order."""
    vol = t_march.eval_sdf_grid(_two_blobs(torch), resolution, slab=slab,
                                device="cpu")
    np.testing.assert_allclose(   # torch's and XLA's sqrt / sin: 1 ulp
        vol, j_march.eval_sdf_grid(_two_blobs(jnp), resolution, slab=slab),
        rtol=0, atol=1e-6)
    step = 2.0 / (resolution - 1)
    kw = dict(spacing=(step,) * 3, origin=(-1.0,) * 3)
    tv, tf = t_march.marching_tetrahedra(vol, 0.0, **kw)
    jv, jf = j_march.marching_tetrahedra(vol, 0.0, native=False, **kw)
    assert len(tf) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    nv, nf = t_march.extract_mesh(_two_blobs(torch), resolution, slab=slab,
                                  device="cpu")
    gv, gf = j_march.marching_tetrahedra(vol, 0.0, **kw)
    np.testing.assert_array_equal(nv, gv)
    np.testing.assert_array_equal(nf, gf)
    assert _oriented_triangles(tv, tf) == _oriented_triangles(nv, nf)
    for by in ("area", "faces"):
        a, b = (t_mesh.biggest_component(tv, tf, by=by),
                j_mesh.biggest_component(jv, jf, by=by))
        assert 0 < len(a[1]) < len(tf)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_snapshot_grid_of_the_field_matches_jax():
    """``Trainer.plot``'s grid: the plain field under no_grad against
    ``sdf_apply`` with the same weights."""
    jcfg = j_sdf.ImplicitConfig(**ICFG)
    params = jax.tree_util.tree_map(
        np.asarray, j_sdf.init_implicit(jcfg, np.random.default_rng(0)))
    net = t_sdf.ImplicitNetwork(t_sdf.ImplicitConfig(**ICFG))
    state = params_from_jax({"implicit": params, "render": []})
    net.load_state_dict({k[len("implicit."):]: v for k, v in state.items()})
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ours = t_march.eval_sdf_grid(lambda x: t_sdf.sdf_apply(net, x), 20,
                                 slab=6, device="cpu")
    theirs = j_march.eval_sdf_grid(
        lambda x: j_sdf.sdf_apply(jcfg, jp, x), 20, slab=6)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-5)
    assert ours.min() < 0 < ours.max()


def test_obj_and_html_files_match_jax(tmp_path):
    verts, faces = j_march.extract_mesh(_two_blobs(jnp), 24)
    colors = np.random.default_rng(0).uniform(size=verts.shape)
    for c in (None, colors):
        t_mesh.save_obj(str(tmp_path / "t.obj"), verts, faces, c)
        j_mesh.save_obj(str(tmp_path / "j.obj"), verts, faces, c)
        assert (tmp_path / "t.obj").read_text() == \
            (tmp_path / "j.obj").read_text()
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = [[0, 0, 2], [2, 0, 0], [0, 2, 0]]
    t_html.write_scene_html(str(tmp_path / "t.html"), verts, faces,
                            poses=poses, title="epoch 2")
    j_html.write_scene_html(str(tmp_path / "j.html"), verts, faces,
                            poses=poses, title="epoch 2")
    assert (tmp_path / "t.html").read_text() == \
        (tmp_path / "j.html").read_text()


def test_render_grid_png_holds_rendered_and_ground_truth(tmp_path):
    """The rendered | ground-truth pair of ``Trainer.plot``, one row a
    view, [-1, 1] mapped to 0..255."""
    rng = np.random.default_rng(0)
    hw = (7, 9)
    pred = rng.uniform(-1.2, 1.2, (2, 63, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (2, 63, 3)).astype(np.float32)
    plot_image_grid(str(tmp_path / "r.png"), pred, gt, hw)
    img = read_png(str(tmp_path / "r.png"))
    assert img.shape == (2 * 7, 2 * 9, 3) and img.dtype == np.uint8
    u8 = lambda a: np.round(np.clip((a + 1) / 2, 0, 1) * 255).reshape(
        2, 7, 9, 3)
    np.testing.assert_array_equal(img[:7, :9], u8(pred)[0])
    np.testing.assert_array_equal(img[7:, 9:], u8(gt)[1])
