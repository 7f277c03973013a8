"""The camera projections' contraction (``geometry/projections._apply``):
a broadcast multiply-add over M's columns, at the broadcast shapes its
callers use (carving, the feature warp, the depth-map unprojection),
against ``torch.matmul`` in value and in both gradients; no library
contraction or copy of M in its profile; and the rows its counter
(``projections.PROJECTED_ROWS``) adds over a training step's losses,
against the rows the shapes give, and what the trace's summary makes of
them. CPU only; no JAX."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.fields.network import MVSDFNetwork
from mvsdf_tpu_torch.fields.radiance import RenderConfig
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig
from mvsdf_tpu_torch.geometry import projections as proj
from mvsdf_tpu_torch.rendering.renderer import render_forward
from mvsdf_tpu_torch.supervision.losses import total_loss
from mvsdf_tpu_torch.train.metrics import Tracer

# caller -> (M's shape, p's shape), as each caller broadcasts them at a
# small size: carving's V views over M points, the feature warp's B
# images' 1 + S views over P points, the unprojection's N depth maps of
# h x w pixels (the pixel grid shared by the maps, then one point a pixel)
FAMILIES = {
    "carving": ((5, 1, 4, 4), (37, 4)),
    "feature_warp": ((2, 3, 1, 4, 4), (2, 1, 29, 4)),
    "unproject_intrinsics": ((3, 1, 1, 3, 3), (6, 8, 3)),
    "unproject_extrinsics": ((3, 1, 1, 4, 4), (3, 6, 8, 4)),
}
CASES = pytest.mark.parametrize("family", list(FAMILIES))


def _operands(family, requires_grad=False):
    gen = torch.Generator().manual_seed(sorted(FAMILIES).index(family))
    m_shape, p_shape = FAMILIES[family]
    M = torch.randn(m_shape, generator=gen)
    p = torch.randn(p_shape, generator=gen) * 3
    return M.requires_grad_(requires_grad), p.requires_grad_(requires_grad)


def _matmul(M, p):
    return torch.matmul(M, p.unsqueeze(-1)).squeeze(-1)


@CASES
def test_apply_equals_matmul(family):
    """Within 1e-6 of the largest entry's magnitude, in matmul's
    broadcast shape."""
    M, p = _operands(family)
    got, want = proj._apply(M, p), _matmul(M, p)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@CASES
def test_apply_gradients_match_matmul(family):
    """The gradients to p and to M (M requiring grad as the cameras do
    under --train_cameras; autograd sums M's over the broadcast) within
    1e-5 of the largest entry's magnitude."""
    M, p = _operands(family, requires_grad=True)
    g = torch.randn(_matmul(M, p).shape,
                    generator=torch.Generator().manual_seed(7))
    got = torch.autograd.grad(proj._apply(M, p), (M, p), g)
    want = torch.autograd.grad(_matmul(M, p), (M, p), g)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert (a - w).abs().max() <= 1e-5 * w.abs().max()


@CASES
def test_apply_runs_no_library_contraction(family):
    """Neither a batched product nor a copy of M: its profile records no
    aten::bmm, aten::matmul or aten::clone."""
    M, p = _operands(family)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        proj._apply(M, p)
    names = {e.name for e in prof.events()}
    assert "aten::mul" in names
    assert not names & {"aten::bmm", "aten::matmul", "aten::clone"}


B, P = 2, 64
DEPTH_HW = 16


@pytest.mark.parametrize("phase", [0, 2], ids=["phaseA", "phaseC"])
def test_projected_rows_count_the_shapes(phase):
    """One training render (in phase A with its depth-surface samples,
    which unproject every depth map) and its losses, capture-free:
    the counter adds, for each depth map of h x w pixels, 2 h w rows (the
    unprojection: intrinsics, then extrinsics); for each carved group of
    n points, 2 n rows a depth map (world to camera, camera to image); and
    with the feature loss 2 B (1 + S) P rows (each image's ray points into
    its own and its S source views, the same two products)."""
    cfg = tc.MVSDFConfig(
        model=tc.ModelConfig(
            implicit=ImplicitConfig(feature_vector_size=16, dims=(64,) * 4,
                                    skip_in=(2,)),
            render=RenderConfig(feature_vector_size=16, dims=(64,) * 2)),
        train=tc.TrainConfig(batch_size=B, num_pixels=P))
    sc = make_scene(n_images=B, n_pix=P, feat_ch=8, img_hw=32,
                    depth_hw=DEPTH_HW)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in sc.items()}
    torch.manual_seed(0)
    net = MVSDFNetwork(cfg.model.implicit, cfg.model.render)
    gates = cfg.schedule.gates_for_phase(phase)
    before = proj.PROJECTED_ROWS.launches
    out = render_forward(cfg.model, net, batch, training=True, gates=gates,
                         generator=torch.Generator().manual_seed(0))
    total_loss(out, batch, gates, cfg.schedule,
               cfg.schedule.weights([0.05, 0.3, 0.7][phase]))
    rows = proj.PROJECTED_ROWS.launches - before

    maps = batch["depths"].shape[0] * batch["depths"].shape[1]
    S = batch["src_cams"].shape[1]
    half = B * P // 2
    groups = {"rt_surf": B * P, "eik": half, "dsurf_on": half,
              "dsurf_jitter": half}
    carved = sum(n for name, n in groups.items()
                 if getattr(gates, "d_use_" + name))
    want = 2 * maps * carved
    if gates.use_dsurf:
        want += 2 * maps * DEPTH_HW * DEPTH_HW
    if gates.enable_feat:
        want += 2 * B * (1 + S) * P
    # the cells' step (B = 8, P = 4,096, 8 maps of 600 x 800, S = 2) by
    # the same formula: 8,990,720 rows in phase A, 983,040 in phase C
    assert rows == want


def test_tracer_reports_the_projected_rows_a_replay():
    """``Tracer.summary`` gives the projected rows over the replays of the
    chunks that counted them (the capture's warm-up takes no part), None
    where none did."""
    tr = Tracer(on=True)
    ms = 10 ** 6
    row = lambda t0: [v * ms for v in (t0, t0 + 1, t0 + 2, t0 + 3, t0 + 4,
                                       t0 + 5)] + [0, 0]
    tr.add_chunk(0, np.array([row(0), row(10), row(20)]),
                 [False, True, True], 10.0, 2, projected=2 * 983_040)
    tr.add_chunk(1, np.array([row(30), row(40)]), [True, True], 10.0, 2,
                 projected=2 * 983_040)
    assert tr.summary()["projected_rows_per_step"] == 983_040
    bare = Tracer(on=True)
    bare.add_chunk(0, np.array([row(0)]), [True], 1.0, 1)
    assert bare.summary()["projected_rows_per_step"] is None
