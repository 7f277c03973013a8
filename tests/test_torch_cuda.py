"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: they skip without a GPU. This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.embedder import positional_encoding
from mvsdf_tpu_torch.tracing.kernels import march_kernel as M
from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
from mvsdf_tpu_torch.tracing.kernels import secant_kernel as S
from mvsdf_tpu_torch.tracing.sphere_trace import (TracerConfig, _secant,
                                                  _sphere_trace)

SMALL = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
WIDTHS = pytest.mark.parametrize("kw", [SMALL, {}],
                                 ids=["small_padded", "full"])
# one net for each width the tensor-core tile is instantiated at
TC_WIDTHS = pytest.mark.parametrize(
    "kw", [SMALL, dict(feature_vector_size=16, dims=(96,) * 3, skip_in=()),
           dict(feature_vector_size=16, dims=(200,) * 3, skip_in=(1,)), {}],
    ids=["small_padded", "h96_at_128", "h200_at_256", "full"])
ROWS = (1, 63, 64, 65, 4097, 8449)   # across the 64-row tile's edges


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@TC_WIDTHS
def test_sdf_mlp_kernel_matches_plain_version(cuda, kw):
    """Max |kernel - f32 plain| <= 1e-4 on SDF values of order 1 (three
    bf16 tensor-core passes on split operands: ~2e-5); row counts across
    tile edges, one launch counted per call."""
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**kw),
                              np.random.default_rng(0)).to(cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn_like(p))
        packed = K.pack_sdf_weights(net)
        for n in ROWS:
            x = torch.rand((n, 3), device=cuda) * 2 - 1
            pe = positional_encoding(x, 6)
            before = K.sdf_mlp.launches
            got = K.sdf_mlp(packed, pe)
            torch.cuda.synchronize()
            assert K.sdf_mlp.launches == before + 1
            ref = K.sdf_mlp_reference(packed, pe)
            assert got.shape == (n,)
            assert torch.isfinite(got).all()
            assert (got - ref).abs().max().item() <= 1e-4


def _packed(kw, device, noise):
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**kw),
                              np.random.default_rng(0)).to(device)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(noise * torch.randn_like(p))
        return K.pack_sdf_weights(net)


def _rays(n, device, spread):
    """n rays from one camera towards points in a cube, with their
    intersection with the unit sphere (as trace_rays computes it)."""
    org = torch.tensor([[0.1, 0.2, 2.2]], device=device).expand(n, 3)
    dirs = (torch.rand((n, 3), device=device) * 2 - 1) * spread - org
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    org = org.contiguous()
    d_dot_o = (dirs * org).sum(-1)
    under = d_dot_o ** 2 - ((org ** 2).sum(-1) - 1.0)
    mi = under > 0
    sq = torch.sqrt(torch.where(mi, under, torch.zeros_like(under)))
    t_near = torch.where(mi, -d_dot_o - sq, torch.zeros_like(sq)).clamp_min(0)
    t_far = torch.where(mi, -d_dot_o + sq, torch.zeros_like(sq)).clamp_min(0)
    return org, dirs, mi, t_near, t_far


@pytest.mark.cuda
@TC_WIDTHS
def test_sdf_mlp_xyz_kernel_matches_plain_version(cuda, kw):
    """Max |kernel - f32 plain| <= 1e-4 (three bf16 tensor-core passes on
    split operands, sinf/cosf against torch's), row counts across tile
    edges, one launch counted per call."""
    packed = _packed(kw, cuda, 0.05)
    for n in ROWS:
        x = torch.rand((n, 3), device=cuda) * 2 - 1
        before = K.sdf_mlp_xyz.launches
        got = K.sdf_mlp_xyz(packed, 6, x)
        torch.cuda.synchronize()
        assert K.sdf_mlp_xyz.launches == before + 1
        ref = K.sdf_mlp_xyz_reference(packed, 6, x)
        assert got.shape == (n,)
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 1e-4


def _brackets(packed, device, count):
    """Secant arguments of at least ``count`` rays: brackets at each ray's
    first sign crossing of 64 plain samples."""
    org, dirs, mi, t_near, t_far = _rays(40000, device, 0.5)
    ts = t_near[:, None] + torch.linspace(0, 1, 64, device=device) * (
        t_far - t_near)[:, None]
    with torch.no_grad():
        v = K.sdf_mlp_xyz_reference(packed, 6, (
            org[:, None] + ts[..., None] * dirs[:, None]).reshape(-1, 3)
        ).reshape(-1, 64)
    first = torch.argmax((v < 0).int(), 1)
    r = torch.nonzero(mi & (v < 0).any(1) & (first > 0))[:, 0]
    assert r.numel() >= count
    i = first[r]
    return (org[r], dirs[r], ts[r, i - 1], ts[r, i], v[r, i - 1], v[r, i])


@pytest.mark.cuda
@WIDTHS
def test_secant_kernel_matches_plain_version(cuda, kw):
    """|kernel - plain| <= 1e-4 + 1e-4 |z| (the secant divides by an SDF
    difference); ray counts across the 64-ray block's edges; and against
    the trace's own _secant through the sdf_mlp_xyz kernel, the same
    arithmetic on the same points: 1e-6 + 1e-6 |z|."""
    torch.manual_seed(0)
    packed = _packed(kw, cuda, 0.0)   # the geometric init's sphere
    rays = _brackets(packed, cuda, 4097)
    for n in (1, 63, 64, 65, 4097):
        args = tuple(a[:n].contiguous() for a in rays)
        before = S.secant.launches
        got = S.secant(packed, 6, 8, *args)
        torch.cuda.synchronize()
        assert S.secant.launches == before + 1
        ref = S.secant_reference(packed, 6, 8, *args)
        assert got.shape == (n,)
        assert ((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()
        host = _secant(8, lambda x: K.sdf_mlp_xyz(packed, 6, x), *args)
        assert ((got - host).abs() <= 1e-6 + 1e-6 * host.abs()).all()


def _check_march(got, ref, rows, rows_ref, n):
    agree = got[0] == ref[0]
    assert agree.float().mean().item() >= 0.999
    for a, b in zip(got[1:], ref[1:]):
        assert a.shape == (n,) and torch.isfinite(a).all()
        assert (a - b)[agree].abs().max().item() <= 1e-4
    evaluated, used = rows.tolist()
    assert abs(used - int(rows_ref[1])) <= 0.01 * int(rows_ref[1])
    assert evaluated >= used and evaluated % 64 == 0


@pytest.mark.cuda
@WIDTHS
@pytest.mark.parametrize("n", [1, 31, 63, 65, 4097])
def test_sphere_march_kernel_matches_plain_version(cuda, kw, n):
    """Unfinished masks agree on >= 99.9% of rays, t_s and t_e within 1e-4
    where they agree (the tile's SDF is within ~2e-5 of f32, so a ray may
    stop an iteration apart); the rows the kernel uses within 1% of the
    plain version's, the rows it evaluates whole 64-row tiles."""
    torch.manual_seed(0)
    packed = _packed(kw, cuda, 0.02)
    tcfg = TracerConfig()
    rays = _rays(n, cuda, 0.9)
    rows = torch.zeros(2, dtype=torch.int64, device=cuda)
    rows_ref = torch.zeros_like(rows)
    before = M.sphere_march.launches
    got = M.sphere_march(tcfg, packed, 6, *rays, rows=rows)
    torch.cuda.synchronize()
    assert M.sphere_march.launches == before + 1
    ref = M.sphere_march_reference(tcfg, packed, 6, *rays, rows=rows_ref)
    _check_march(got, ref, rows, rows_ref, n)


@pytest.mark.cuda
@WIDTHS
def test_sphere_march_is_the_same_for_shuffled_rays(cuda, kw):
    """Which block and slot a ray lands in, and beside which rays, must not
    reach its values: a shuffled copy gives every ray the same bits. And
    against the trace's own host-driven march through the sdf_mlp_xyz
    kernel (the same arithmetic on the same points): equal masks, |dt| <=
    1e-6."""
    torch.manual_seed(0)
    packed = _packed(kw, cuda, 0.02)
    tcfg = TracerConfig()
    rays = _rays(4097, cuda, 0.9)
    got = M.sphere_march(tcfg, packed, 6, *rays)
    perm = torch.randperm(4097, device=cuda)
    shuffled = M.sphere_march(tcfg, packed, 6,
                              *(a[perm].contiguous() for a in rays))
    for a, b in zip(got, shuffled):
        assert torch.equal(a[perm], b)
    host = _sphere_trace(tcfg, lambda x: K.sdf_mlp_xyz(packed, 6, x), *rays)
    assert torch.equal(got[0], host[0])
    for a, b in zip(got[1:], host[1:]):
        assert (a - b).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_sphere_march_with_no_ray_to_march(cuda):
    """Rays none of which meets the sphere cost no tile row and get t = 0;
    no ray at all launches nothing."""
    packed = _packed(SMALL, cuda, 0.02)
    tcfg = TracerConfig()
    org, dirs, mi, t_near, t_far = _rays(1000, cuda, 0.9)
    away = (org, -dirs, torch.zeros_like(mi), t_near, t_far)
    rows = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = M.sphere_march(tcfg, packed, 6, *away, rows=rows)
    torch.cuda.synchronize()
    assert not got[0].any() and not got[1].any() and not got[2].any()
    assert rows.tolist() == [0, 0]
    before = M.sphere_march.launches
    none = M.sphere_march(tcfg, packed, 6, *(a[:0] for a in away))
    assert M.sphere_march.launches == before
    assert all(a.shape == (0,) for a in none)


@pytest.mark.cuda
def test_png_native_unfilter_matches_plain_version(cuda):
    """The host C function that undoes PNG row filters (built with the
    kernels) against its numpy plain version: every filter, 1-8 bytes a
    pixel; a filter type that does not exist raises."""
    from mvsdf_tpu_torch.data import png
    rng = np.random.default_rng(0)
    for bpp, w in ((1, 37), (2, 17), (3, 29), (4, 13), (6, 11), (8, 5)):
        raw = rng.integers(0, 256, (23, w * bpp)).astype(np.uint8)
        for ft in (0, 1, 2, 3, 4, None):
            rows = png.filter_rows(raw, bpp, ft)
            got = png.unfilter(rows, bpp, native=True)
            assert np.array_equal(got, png.unfilter_reference(rows, bpp))
            assert np.array_equal(got, raw)
    rows[5, 0] = 7
    with pytest.raises(ValueError, match="filter 7"):
        png.unfilter(rows, 8, native=True)


def wgmma_k_step_fn(build_dir):
    """The probe ``wgmma_probe`` of tests/csrc/wgmma_probe.cu, built alone
    beside a copy of the tile's header into ``build_dir`` (it is no part of
    the port's kernel library): (a, b, c) -> c + a @ b by one m64n32k16
    `wgmma`, a (64, 16) and b (16, 32) bf16, c (64, 32) f32 on the card."""
    import ctypes
    import shutil
    from mvsdf_tpu_torch.tracing.kernels import build
    src = os.path.join(build_dir, "csrc")
    os.makedirs(src)
    shutil.copy(os.path.join(os.path.dirname(__file__), "csrc",
                             "wgmma_probe.cu"), src)
    shutil.copy(os.path.join(build.CSRC, "mlp_tile_tc.cuh"), src)
    fn = ctypes.CDLL(build.build(csrc=src, build_dir=build_dir)).wgmma_probe
    fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int

    def k_step(a, b, c):
        d = torch.empty_like(c)
        K.raise_on_error(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            d.data_ptr(), K.stream(c.device)), "wgmma_probe")
        return d
    return k_step


def k_step_inputs(kind, gen):
    """(a (64, 16) bf16, b (16, 32) bf16, c (64, 32) f32): operand exponents
    2^-6..2^6 ("wide") or 2^-1..2^1 ("narrow") of random signs, c uniform
    in +-4 (those two), 0 ("zero_c"), or near minus the products' sum
    ("cancel")."""
    def bf16(shape, lo, hi):
        m = torch.rand(shape, generator=gen, dtype=torch.float64) + 1
        e = torch.randint(lo, hi + 1, shape, generator=gen).double()
        s = torch.randint(0, 2, shape, generator=gen).double() * 2 - 1
        return (s * m * 2 ** e).bfloat16()

    lo, hi = (-1, 1) if kind == "narrow" else (-6, 6)
    a, b = bf16((64, 16), lo, hi), bf16((16, 32), lo, hi)
    if kind == "zero_c":
        c = torch.zeros(64, 32)
    elif kind == "cancel":
        c = -(a.double() @ b.double()).float() * (
            1 + 1e-3 * torch.rand((64, 32), generator=gen))
    else:
        c = (torch.rand((64, 32), generator=gen, dtype=torch.float64) * 8
             - 4).float()
    return a, b, c


@pytest.mark.cuda
def test_wgmma_k_step_rounding(cuda, tmp_path):
    """One m64n32k16 k-step of the tile's `wgmma` (tests/csrc/
    wgmma_probe.cu) on 4 kinds x 4 seeds x 2,048 = 32,768 sums of an f32 c
    and 16 bf16 products, whose exact value needs more than f32's 24 bits:
    the card does not round the sum to nearest (more than 10,000 of them
    differ from that), it gives ``tc_k_step``'s model of its accumulation to
    the bit (terms aligned to the largest operand exponent sum, cut toward
    zero at 25 bits, the sum cut toward zero)."""
    k_step = wgmma_k_step_fn(str(tmp_path))
    off_nearest = 0
    for kind in ("wide", "narrow", "zero_c", "cancel"):
        for seed in range(4):
            a, b, c = k_step_inputs(kind, torch.Generator().manual_seed(seed))
            got = k_step(a.to(cuda), b.to(cuda), c.to(cuda)).cpu()
            nearest = (c.double() + a.double() @ b.double()).float()
            off_nearest += int((got != nearest).sum())
            assert torch.equal(got, K.tc_k_step(c, a.float(), b.float())), \
                (kind, seed)
    assert off_nearest > 10000


CLI_CONF = """
train{ plot_freq = 1/2 }
model{
    feature_vector_size = 16
    implicit_network {
        dims = [64, 64, 64, 64]
        skip_in = [2]
        bias = 0.6
    }
    rendering_network { dims = [64, 64] }
}
"""


@pytest.mark.cuda
def test_training_cli_on_the_card(cuda, tmp_path, monkeypatch):
    """The training CLI on a 3-view on-disk scene, epochs 0..4 (phases A,
    B, C, C, C) through --pallas on the card, on its fused default: finite
    losses, the SDF-MLP kernel's count entry launched in every chunk (the
    chunks close at the phase changes and the save epochs 2 and 4),
    checkpoints and meshes."""
    import json
    from mvsdf_tpu_torch.data.synthetic import write_scene_dir
    from mvsdf_tpu_torch.train import cli
    data = write_scene_dir(str(tmp_path), n_images=3, img_hw=(48, 64),
                           depth_hw=(24, 32))
    conf = tmp_path / "small.conf"
    conf.write_text(CLI_CONF)
    launches = []
    from mvsdf_tpu_torch.train import loop
    train_chunk = loop.Trainer._train_chunk

    def counted(self, e0, e1):
        before = K.sdf_mlp_count.launches
        out = train_chunk(self, e0, e1)
        launches.append(K.sdf_mlp_count.launches - before)
        return out

    monkeypatch.setattr(loop.Trainer, "_train_chunk", counted)
    trainer = cli.main(["--data_dir", data, "--pallas",
                        "--allow_random_features", "--conf", str(conf),
                        "--batch_size", "3", "--nepoch", "4",
                        "--num_pixels", "256", "--exps_folder",
                        str(tmp_path / "exps")])
    assert trainer.device.type == "cuda"
    rows = [json.loads(line) for line in
            open(os.path.join(trainer.exp_dir, "metrics.jsonl"))]
    assert [r["phase"] for r in rows] == [0, 1, 2, 2, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert len(launches) == 4 and min(launches) > 0, launches
    assert open(os.path.join(trainer.ckpt_dir, "latest.txt")).read() == "4"
    for e in (2, 4):
        assert os.path.exists(os.path.join(trainer.plots_dir,
                                           f"surface_{e}.obj"))


@pytest.mark.cuda
def test_eval_cli_on_the_card(cuda, tmp_path):
    """The eval CLI (--pallas --resolution 128 --eval_rendering) on the
    epoch-2 checkpoint of a training CLI run on a 3-view scene: the mesh,
    HTML scene, PNGs and a finite PSNR; sdf_mlp launched (16 slabs of the
    grid and the traces) and no other kernel."""
    from mvsdf_tpu_torch.data.synthetic import write_scene_dir
    from mvsdf_tpu_torch.eval import cli as eval_cli
    from mvsdf_tpu_torch.train import cli
    data = write_scene_dir(str(tmp_path), n_images=3, img_hw=(48, 64),
                           depth_hw=(24, 32))
    conf = tmp_path / "small.conf"
    conf.write_text(CLI_CONF)
    common = ["--data_dir", data, "--conf", str(conf), "--exps_folder",
              str(tmp_path / "exps"), "--pallas"]
    cli.main(common + ["--allow_random_features", "--batch_size", "3",
                       "--nepoch", "2", "--num_pixels", "256"])
    counted = (K.sdf_mlp, K.sdf_mlp_xyz, S.secant, M.sphere_march)
    before = [f.launches for f in counted]
    result = eval_cli.main(common + ["--resolution", "128",
                                     "--eval_rendering", "--evals_folder",
                                     str(tmp_path / "evals")])
    launches = [f.launches - b for f, b in zip(counted, before)]
    evaldir = tmp_path / "evals" / "mvsdf"
    assert result.epoch == 2 and len(result.faces) > 0
    for name in ("surface_world_coordinates_2.obj", "scene_2.html",
                 "psnr.txt"):
        assert (evaldir / name).is_file(), name
    assert sorted(os.listdir(evaldir / "rendering")) == [
        f"eval_{i:03d}.png" for i in range(3)]
    assert len(result.psnrs) == 3 and np.isfinite(result.psnrs).all()
    assert launches[0] > 128 // 8 and launches[1:] == [0, 0, 0], launches


@pytest.mark.cuda
def test_maxflow_builds_and_cuts_on_the_card_machine(cuda, tmp_path):
    """The mesh trimming's max-flow (host C++) builds through
    build.build_host on the card's machine, and its cut of a mesh's face
    graph equals the plain version's (scipy): flow value and faces."""
    from mvsdf_tpu_torch.meshcut import cut, native
    from mvsdf_tpu_torch.tracing.kernels import build
    assert build.build_host(native.SOURCE) == build.host_library_path(
        native.SOURCE)
    rng = np.random.default_rng(0)
    n = 60
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    vid = lambda a, b: a * (n + 1) + b
    faces = np.concatenate([
        np.stack([vid(i, j), vid(i + 1, j), vid(i, j + 1)], -1),
        np.stack([vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)], -1)
    ]).reshape(-1, 3)
    labels = rng.uniform(size=len(faces)) < 0.5
    adj = cut.face_adjacency_edges(faces)
    edges = np.concatenate([adj, np.full((len(adj), 1), 1)], 1)
    flow, side = cut.maxflow_cut(labels, edges)
    ref_flow, ref_side = cut.maxflow_cut_reference(labels, edges)
    assert flow == ref_flow > 0
    np.testing.assert_array_equal(side, ref_side)


@pytest.mark.cuda
def test_camera_training_step_on_the_card(cuda):
    """One phase-B step with train_cameras on the card, the trace through
    sdf_mlp: the touched poses move and stay finite, the others keep
    theirs, and the kernel was launched."""
    from mvsdf_tpu_torch.config import (ModelConfig, MVSDFConfig,
                                        TrainConfig)
    from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
    from mvsdf_tpu_torch.fields.radiance import RenderConfig
    from mvsdf_tpu_torch.train.cameras_opt import pose_vecs_from_matrices
    from mvsdf_tpu_torch.train.step import init_train_state, make_train_step
    cfg = MVSDFConfig(
        model=ModelConfig(implicit=t_sdf.ImplicitConfig(**SMALL),
                          render=RenderConfig(feature_vector_size=16,
                                              dims=(64, 64)),
                          use_pallas_trace=True),
        train=TrainConfig(batch_size=2, num_pixels=512, train_cameras=True))
    sc = make_scene(n_images=2, n_pix=512, feat_ch=16)
    table = np.concatenate([sc["pose"], sc["pose"]])   # rows 2, 3 unused
    pv0 = pose_vecs_from_matrices(table)
    state = init_train_state(cfg, seed=0, device=cuda, pose_init=pv0)
    batch = scene_to_torch(sc, cuda)
    batch["indices"] = torch.tensor([1, 0], device=cuda)
    before = K.sdf_mlp.launches
    m = make_train_step(cfg, phase_idx=1)(
        state, batch, cfg.schedule.weights(0.3),
        torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert K.sdf_mlp.launches > before
    assert np.isfinite(float(m["loss"]))
    pv = state.pose_vecs.cpu().numpy()
    assert np.isfinite(pv).all()
    assert (np.abs(pv[:2] - pv0[:2]).max(1) > 0).all()
    np.testing.assert_array_equal(pv[2:], pv0[2:])
    assert int(state.cam_opt.step) == 1


@pytest.mark.cuda
@WIDTHS
def test_fused_value_grad_matches_autograd_on_the_card(cuda, kw):
    """The export's value + gradient (``fields/fused_grad.value_and_grad``:
    no autograd, the activation kernel's forward and derivative launched
    by hand) against the training path's (``full_value_and_grad`` under
    ``torch.no_grad()``: autograd through the activation kernel) on the
    card in f32 (TF32 off): out and g within the CPU tests' bound, 1e-5."""
    from mvsdf_tpu_torch.fields import fused_grad
    from mvsdf_tpu_torch.tracing.kernels import counts
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**kw),
                              np.random.default_rng(0)).to(cuda)
    x = torch.rand((4097, 3), generator=torch.Generator(device=cuda)
                   .manual_seed(0), device=cuda) * 1.8 - 0.9
    before = counts.snapshot()
    of, gf = fused_grad.value_and_grad(net, x)
    n = counts.since(before)
    hidden = len(net.layers) - 1
    assert n["softplus100_forward"] == n["softplus100_grad"] == hidden
    with torch.no_grad():
        oa, ga = t_sdf.full_value_and_grad(net, x)
    assert of.grad_fn is None and gf.grad_fn is None
    assert (of - oa).abs().max().item() <= 1e-5
    assert (gf - ga).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_jpeg_decoder_on_the_fixtures_on_the_card_machine(cuda):
    """The JPEG decoder (host C++) builds on the card's machine and equals
    the committed OpenCV decode of every fixture (the 1600x1200 view by its
    SHA-256); the progressive fixture raises naming the file."""
    import glob
    import hashlib
    import json
    from mvsdf_tpu_torch.data.convert import imread_color
    from mvsdf_tpu_torch.data.jpeg import read_jpeg
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "jpeg")
    paths = sorted(glob.glob(os.path.join(fixtures, "*.jpg")))
    assert len(paths) >= 9
    for p in paths:
        if "progressive" in p:
            with pytest.raises(ValueError, match="progressive"):
                read_jpeg(p)
        elif os.path.exists(p[:-4] + ".json"):
            want = json.load(open(p[:-4] + ".json"))
            got = np.ascontiguousarray(imread_color(p))
            assert list(got.shape) == want["shape"]
            assert hashlib.sha256(got.tobytes()).hexdigest() == \
                want["sha256"]
        else:
            np.testing.assert_array_equal(imread_color(p),
                                          np.load(p[:-4] + ".npy"))


@pytest.mark.cuda
def test_converter_cli_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The converter CLI on the card (resizes on the device, PNG rows
    unfiltered by the host C code) writes what it writes with --platform
    cpu: equal depth maps, images, masks and cameras."""
    import subprocess
    import sys
    from mvsdf_tpu_torch.data import formats, png
    from mvsdf_tpu_torch.data.synthetic import write_vismvsnet_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    vis = str(tmp_path / "vis")
    write_vismvsnet_dir(vis, 3, 16)
    outs = {}
    for name, extra in (("card", []), ("cpu", ["--platform", "cpu"])):
        outs[name] = str(tmp_path / name / "scan")
        os.makedirs(os.path.dirname(outs[name]))
        res = subprocess.run(
            [sys.executable, "-m", "mvsdf_tpu_torch.data.convert",
             "--data_dir", vis, "--out_dir", outs[name], *extra], cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
            text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip().splitlines()[-2].endswith(
            "cuda" if name == "card" else "cpu")
    a, b = outs["card"], outs["cpu"]
    for k in range(3):
        np.testing.assert_array_equal(
            formats.load_pfm(os.path.join(a, "depth", f"{k:03}.pfm")),
            formats.load_pfm(os.path.join(b, "depth", f"{k:03}.pfm")))
        for sub in ("image_hd", "mask_hd"):
            np.testing.assert_array_equal(
                png.read_png(os.path.join(a, sub, f"{k:03}.png")),
                png.read_png(os.path.join(b, sub, f"{k:03}.png")))
    ca, cb = (np.load(os.path.join(d, "cameras_hd.npz")) for d in (a, b))
    for key in cb.files:
        np.testing.assert_array_equal(ca[key], cb[key])


@pytest.mark.cuda
def test_exported_renderer_loads_on_the_card(cuda, tmp_path):
    """The serving export traced on the CPU, loaded onto the card through
    move_to_device_pass, equals the live eval render of the plain field
    (the gathered trace, autograd's normals) on the card: hit masks on
    0.99 of the rays at least, rgb within 1e-4 where they agree; and it
    serves a second checkpoint through the same artifact. The artifact
    launches the activation kernel's forward and derivative (the
    operators it recorded; the derivative in the shading normals' reverse
    pass) and no other kernel."""
    from mvsdf_tpu_torch.config import ModelConfig, MVSDFConfig
    from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
    from mvsdf_tpu_torch.eval import export
    from mvsdf_tpu_torch.fields.radiance import RenderConfig
    from mvsdf_tpu_torch.rendering.renderer import render_forward
    from mvsdf_tpu_torch.tracing.kernels import counts
    from mvsdf_tpu_torch.train.step import init_params
    cfg = MVSDFConfig(model=ModelConfig(
        implicit=t_sdf.ImplicitConfig(**SMALL),
        render=RenderConfig(feature_vector_size=16, dims=(64, 64))))
    chunk = 512
    cpu_params = init_params(cfg, seed=0, device="cpu").state_dict()
    blob = export.export_renderer(cfg, cpu_params, chunk=chunk,
                                  platforms=("cpu", "cuda"), device="cpu")
    path = tmp_path / "renderer.pt2"
    path.write_bytes(blob)
    served = export.load_renderer(str(path), device=cuda)
    sc = scene_to_torch(make_scene(n_images=1, n_pix=chunk, feat_ch=16),
                        cuda)
    view = {k: sc[k] for k in ("uv", "intrinsics", "pose", "object_mask")}
    for seed in (0, 7):
        net = init_params(cfg, seed=seed, device=cuda)
        with torch.no_grad():
            before = counts.snapshot()
            got = served(net.state_dict(), view["uv"], view["intrinsics"],
                         view["pose"], view["object_mask"].bool())[0]
            torch.cuda.synchronize()
            n = counts.since(before)
            live = render_forward(cfg.model, net, view, training=False)
        act = ("softplus100_forward", "softplus100_grad")
        assert all(n[k] > 0 for k in act)
        assert not any(v for k, v in n.items() if k not in act)
        hit = (got != 1.0).any(-1)
        agree = hit == live.network_object_mask[0]
        assert got.device.type == "cuda" and torch.isfinite(got).all()
        assert 0.05 < hit.float().mean().item() < 0.95
        assert agree.float().mean().item() >= 0.99
        assert (got - live.rgb_values[0])[agree].abs().max().item() <= 1e-4


DDP_ARM = r"""
import os, sys
import numpy as np, torch
from mvsdf_tpu_torch.config import ModelConfig, MVSDFConfig, TrainConfig
from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
from mvsdf_tpu_torch.fields.radiance import RenderConfig
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig
from mvsdf_tpu_torch.parallel import host_ray_slice, init_distributed
from mvsdf_tpu_torch.train.step import init_train_state, make_train_step

dev = init_distributed(sys.argv[2] or None)
cfg = MVSDFConfig(
    model=ModelConfig(
        implicit=ImplicitConfig(feature_vector_size=16, dims=(64,) * 4,
                                skip_in=(2,)),
        render=RenderConfig(feature_vector_size=16, dims=(64, 64)),
        use_pallas_trace=True),
    train=TrainConfig(batch_size=2, num_pixels=512))
batch = scene_to_torch(make_scene(n_images=2, n_pix=512, feat_ch=16), dev)
sl = host_ray_slice(512)
for k in ("uv", "object_mask", "rgb"):
    batch[k] = batch[k][:, sl].contiguous()
state = init_train_state(cfg, seed=0, device=dev)
m = make_train_step(cfg, phase_idx=1)(
    state, batch, cfg.schedule.weights(0.3),
    torch.Generator(device=dev).manual_seed(0))
out = {"m:" + k: float(v) for k, v in m.items()}
for k, p in state.net.named_parameters():
    out["p:" + k] = p.detach().cpu().numpy()
    out["g:" + k] = p.grad.cpu().numpy()
np.savez(os.path.join(sys.argv[1], f"{os.environ.get('RANK', 'one')}.npz"),
         **out)
if torch.distributed.is_initialized():
    torch.distributed.destroy_process_group()
"""


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_equal_one_process(cuda, tmp_path):
    """One phase-B step (the trace through sdf_mlp) in two gloo processes
    on cuda:0, each with half of the rays, against the step in one
    process: the ranks' parameters equal to the bit, the loss terms within
    1e-4 relative and each gradient tensor within 2e-3 of its largest
    entry (the step parity's tolerances), equal hit fractions."""
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for env in ({}, *({"RANK": str(r), "WORLD_SIZE": "2",
                       "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)} for r in range(2))):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DDP_ARM, str(tmp_path), "gloo"],
            env=dict(os.environ, PYTHONPATH=repo, **env),
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    one, r0, r1 = (dict(np.load(tmp_path / f"{n}.npz"))
                   for n in ("one", "0", "1"))
    for k in r0:
        if k.startswith("p:"):
            np.testing.assert_array_equal(r0[k], r1[k], k)
    assert r0["m:hit_frac"] == one["m:hit_frac"]
    assert 0.05 < one["m:hit_frac"] < 0.95
    for k in ("loss", "rgb_loss", "eikonal_loss", "surf_loss",
              "feat_loss"):
        assert abs(r0["m:" + k] - one["m:" + k]) <= \
            1e-4 * abs(one["m:" + k]) + 1e-7, k
    for k in one:
        if k.startswith("g:"):
            scale = max(np.abs(one[k]).max(), 1e-12)
            assert np.abs(r0[k] - one[k]).max() <= 2e-3 * scale, k


@pytest.mark.cuda
def test_validation_capstone_on_the_card(cuda, tmp_path):
    """validation.full_training at --epochs 30 --resolution 64 on the card
    (full width, through sdf_mlp), in a process of its own: its summary
    has the JAX script's keys, finite values, no non-finite epoch, the
    card's name, and sdf_mlp launches in training and in the grid; it
    wrote the mesh, the held-out PNGs and the parameters."""
    import json
    import subprocess
    import sys
    from mvsdf_tpu_torch.validation import full_training as ft
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "v"
    res = subprocess.run(
        [sys.executable, "-m", "mvsdf_tpu_torch.validation.full_training",
         "--epochs", "30", "--resolution", "64", "--out", str(out)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert tuple(summary)[:len(ft.SUMMARY_KEYS)] == ft.SUMMARY_KEYS
    for k in ft.SUMMARY_KEYS:
        if k != "supervised_cascade":
            assert np.isfinite(summary[k]), k
    assert summary["nonfinite_epochs"] == 0 and summary["mesh_verts"] > 0
    assert summary["device"] == torch.cuda.get_device_name(0)
    n = summary["sdf_mlp_launches"]
    assert n["train"] >= 30 and n["grid"] == 64 // 8, n
    for f in ("surface.obj", "heldout_pred.png", "heldout_gt.png",
              "params.pt"):
        assert (out / f).is_file(), f


def _tiny_leg(device):
    """The dry run's tiny leg on the card: its configuration, seed-0 net,
    packed weights and one process's batch."""
    from mvsdf_tpu_torch import graft_entry
    from mvsdf_tpu_torch.data.synthetic import scene_to_torch
    from mvsdf_tpu_torch.train.step import init_params
    cfg, sizes = graft_entry.leg(2, False)
    net = init_params(cfg, seed=0, device=device)
    with torch.no_grad():
        packed = K.pack_sdf_weights(net.implicit)
    sc = graft_entry._scene(sizes["n_images"], sizes["n_pix"], sizes["feat"],
                            sizes["depth_hw"], sizes["img_hw"])
    return cfg, net, packed, scene_to_torch(sc, device)


@pytest.mark.cuda
def test_sdf_mlp_and_secant_at_the_dry_runs_width_64(cuda):
    """The dry run's tiny leg (SDF 3 x 64, skip at 2, multires 6, 4 secant
    steps) through sdf_mlp and secant against their plain versions: the
    SDF within 1e-4; the secant on the first sign crossings of the tiny
    scene's rays (20 samples) within 1e-4 + 1e-4 |z| + 2 e / |slope|, e
    the SDF kernel's distance from f32 (chip_smoke.py's secant gate)."""
    from mvsdf_tpu_torch.geometry.cameras import get_camera_params
    from mvsdf_tpu_torch.tracing.sphere_trace import sphere_intersection
    cfg, net, packed, batch = _tiny_leg(cuda)
    icfg, tcfg = cfg.model.implicit, cfg.model.tracer
    L = icfg.multires
    with torch.no_grad():
        x = torch.rand((1280, 3), device=cuda) * 2 - 1
        got = K.sdf_mlp(packed, positional_encoding(x, L))
        e = (got - K.sdf_mlp_reference(packed, positional_encoding(x, L))
             ).abs().max().item()
        assert e <= 1e-4 and torch.isfinite(got).all()
        dirs, loc = get_camera_params(batch["uv"], batch["pose"],
                                      batch["intrinsics"])
        org = loc[:, None].expand(dirs.shape).reshape(-1, 3)
        dirs = dirs.reshape(-1, 3)
        mi, t0, t1 = sphere_intersection(org, dirs,
                                         tcfg.object_bounding_sphere)
        o, d = org[mi], dirs[mi]
        n = tcfg.n_steps
        ts = t0[mi][:, None] + torch.linspace(0, 1, n, device=cuda) * (
            t1 - t0)[mi][:, None]
        v = K.sdf_mlp_xyz_reference(packed, L, (
            o[:, None] + ts[..., None] * d[:, None]).reshape(-1, 3)
        ).reshape(-1, n)
        ind = torch.argmin(torch.sign(v) * torch.arange(
            n, 0, -1, dtype=v.dtype, device=cuda), -1)
        r = torch.nonzero((v.gather(1, ind[:, None])[:, 0] < 0) & (ind > 0)
                          )[:, 0]
        assert r.numel() > 10
        i = ind[r]
        args = (o[r].contiguous(), d[r].contiguous(), ts[r, i - 1],
                ts[r, i], v[r, i - 1], v[r, i])
        before = S.secant.launches
        z = S.secant(packed, L, tcfg.n_secant_steps, *args)
        assert S.secant.launches == before + 1
        ref = S.secant_reference(packed, L, tcfg.n_secant_steps, *args)
        sdf = lambda t: K.sdf_mlp_xyz_reference(
            packed, L, args[0] + t[:, None] * args[1])
        slope = (sdf(ref + 1e-3) - sdf(ref - 1e-3)).abs() / 2e-3
        assert ((z - ref).abs() <= 1e-4 + 1e-4 * ref.abs() + 2 * e / slope
                ).all()


@pytest.mark.cuda
def test_entry_on_the_card(cuda):
    """entry(): finite outputs of (1, 1024, 3), (1, 1024), (1, 1024) on the
    card, and some rays hit."""
    from mvsdf_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    assert args[1].device.type == "cuda"
    rgb, mask, dists = fn(*args)
    assert rgb.shape == (1, 1024, 3) and mask.shape == dists.shape == \
        (1, 1024)
    assert torch.isfinite(rgb).all() and torch.isfinite(dists).all()
    assert 0 < mask.float().mean().item() < 1


BENCH_RUN = r"""
import dataclasses, json, sys
import torch
from mvsdf_tpu_torch import bench
cfg = bench.bench_config(bench.FUSED_SWITCHES)
m = cfg.model
cfg = dataclasses.replace(cfg, train=dataclasses.replace(
    cfg.train, batch_size=2, num_pixels=512), model=dataclasses.replace(
    m, implicit=dataclasses.replace(m.implicit, dims=(64,) * 3,
                                    skip_in=(2,), feature_vector_size=16),
    render=dataclasses.replace(m.render, dims=(64,), feature_vector_size=16)))
dev = torch.device("cuda")
batch = bench.bench_batch(cfg, dev, img_hw=48, depth_hw=24, feat_ch=8)
res = bench.run_bench(cfg, batch, dev, warmup=2, windows=3, window_iters=2)
json.dump(res, open(sys.argv[1], "w"))
"""


@pytest.mark.cuda
def test_bench_json_line_on_the_card(cuda, tmp_path):
    """run_bench at a narrow width in the fused configuration, in a
    process of its own: one stdout line of bench.py's four keys, a finite
    positive rate, the march kernel in every step, a peak memory."""
    import json
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "res.json"
    res = subprocess.run([sys.executable, "-c", BENCH_RUN, str(out)],
                         cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    (line,) = res.stdout.splitlines()
    line = json.loads(line)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert np.isfinite(line["value"]) and line["value"] > 0
    full = json.load(open(out))
    assert full["launches_per_step"]["sphere_march"] == 1
    assert full["peak_gib"] > 0


REPRO_RUN = r"""
import sys
import numpy as np, torch
from mvsdf_tpu_torch import bench
from mvsdf_tpu_torch.data.synthetic import shaded_features
from mvsdf_tpu_torch.train.step import init_train_state, make_train_step
dev = torch.device("cuda")
rgbs = np.random.default_rng(0).uniform(-1, 1, (12, 96, 96, 3)).astype(
    np.float32)
out = {"features": shaded_features(rgbs, 48, device=dev)}
cfg = bench.bench_config({})
batch = bench.bench_batch(cfg, dev)
state = init_train_state(cfg, seed=0, device=dev)
step = make_train_step(cfg, phase_idx=1)
gen = torch.Generator(device=dev).manual_seed(0)
for k in range(5):
    for n, v in step(state, batch, cfg.schedule.weights(0.3), gen).items():
        out[f"m{k}:{n}"] = v.cpu().numpy()
for n, p in state.net.named_parameters():
    out[n] = p.detach().cpu().numpy()
np.savez(sys.argv[1], **out)
"""


@pytest.mark.cuda
def test_two_runs_on_the_card_are_bit_equal(cuda, tmp_path):
    """Each in a process of its own, twice: the frozen features of 12
    random 96x96 views (the FeatExt on cuDNN's deterministic algorithms),
    and the bench step (full width, B=8 x P=4096, through sdf_mlp) 5 steps
    from seed 0: equal features, metrics and parameters, bit for bit."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for r in range(2):
        out = tmp_path / f"run{r}.npz"
        res = subprocess.run([sys.executable, "-c", REPRO_RUN, str(out)],
                             cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        runs.append(dict(np.load(out)))
    a, b = runs
    assert a.keys() == b.keys() and np.isfinite(a["m4:loss"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


@pytest.mark.cuda
@WIDTHS
def test_count_entries_match_their_plain_versions(cuda, kw):
    """The count entries of kernels 1-3 at a capacity of 4097 rows, at
    counts 0, 1, 64, 65, 1000 and all: the first count rows equal the plain
    entry's kernel on them bit for bit (the same arithmetic), the rest are
    0, and all are within the kernels' own tolerances of the count
    entries' plain versions (1e-4 on SDF values of order 1; the secant's
    roots 1e-4 + 1e-4 |z|, on the brackets of the geometric init's
    sphere)."""
    torch.manual_seed(0)
    packed = _packed(kw, cuda, 0.02)
    sphere = _packed(kw, cuda, 0.0)
    n = 4097
    x = torch.rand((n, 3), device=cuda) * 2 - 1
    pe = positional_encoding(x, 6)
    sec = tuple(a[:n].contiguous() for a in _brackets(sphere, cuda, n))
    for rows in (0, 1, 64, 65, 1000, n):
        c = torch.tensor(rows, dtype=torch.int32, device=cuda)
        for fn, kernel, plain in (
                (lambda: K.sdf_mlp_count(packed, pe, c),
                 lambda: K.sdf_mlp(packed, pe[:rows]),
                 lambda: K.sdf_mlp_count_reference(packed, pe, c)),
                (lambda: K.sdf_mlp_xyz_count(packed, 6, x, c),
                 lambda: K.sdf_mlp_xyz(packed, 6, x[:rows]),
                 lambda: K.sdf_mlp_xyz_count_reference(packed, 6, x, c)),
                (lambda: S.secant_count(sphere, 6, 8, *sec, c),
                 lambda: S.secant(sphere, 6, 8, *(a[:rows] for a in sec)),
                 lambda: S.secant_count_reference(sphere, 6, 8, *sec, c))):
            got, ref = fn(), plain()
            first = kernel() if rows else got[:0]
            torch.cuda.synchronize()
            assert got.shape == (n,)
            assert torch.equal(got[:rows], first), rows
            assert not got[rows:].any()
            assert ((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()


def _capturable(cuda, cameras=False, fused=False, pallas=True,
                cascade=()):
    """A CapturableStep of a small configuration on a 2-image bench batch
    (served whatever the row says), from seed 0, its row at Adam's first
    step; ``cascade`` the supervised tiers."""
    from mvsdf_tpu_torch.config import (ModelConfig, MVSDFConfig,
                                        TrainConfig)
    from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
    from mvsdf_tpu_torch.fields.radiance import RenderConfig
    from mvsdf_tpu_torch.train.cameras_opt import pose_vecs_from_matrices
    from mvsdf_tpu_torch.train.step import (CapturableStep, adam_scalars,
                                            init_train_state)
    flags = dict(use_pallas_march=True, use_pallas_secant=True,
                 pallas_in_kernel_pe=True) if fused else {}
    cfg = MVSDFConfig(
        model=ModelConfig(implicit=t_sdf.ImplicitConfig(**SMALL),
                          render=RenderConfig(feature_vector_size=16,
                                              dims=(64, 64)),
                          use_pallas_trace=pallas,
                          supervised_compact_frac=cascade, **flags),
        train=TrainConfig(batch_size=2, num_pixels=512,
                          train_cameras=cameras))
    sc = make_scene(n_images=2, n_pix=512, feat_ch=16)
    batch = scene_to_torch(sc, cuda)
    batch["indices"] = torch.tensor([1, 0], device=cuda)
    pv0 = pose_vecs_from_matrices(np.concatenate([sc["pose"]] * 2))
    state = init_train_state(cfg, seed=0, device=cuda,
                             pose_init=pv0 if cameras else None)

    class Served:
        device = cuda

        def gather(self, indices, sel):
            return batch

    step = CapturableStep(cfg, 1, cfg.schedule.weights(0.3), state,
                          Served(), torch.Generator(device=cuda).manual_seed(0))

    def row(t):
        for _, _, st in step.adam:
            st += 1
        return torch.from_numpy(step.plan_row(
            np.array([1, 0]), np.arange(512),
            adam_scalars(state.optimizer, t))).to(cuda)
    return step, row


@pytest.mark.cuda
@pytest.mark.parametrize("cameras,fused,pallas", [
    (False, False, True), (True, False, True), (False, True, True),
    (False, False, False)],
    ids=["sdf_mlp", "cameras", "fused_kernels", "plain"])
def test_graph_replay_equals_the_eager_capturable_step(cuda, cameras,
                                                       fused, pallas,
                                                       monkeypatch):
    """The captured step replayed from the same state, row and generator
    state as its eager run: every tensor it writes equal to the bit; the
    kernels' launches and the projected rows added once per replay (no
    trace kernel for the plain field, whose blocks run in 256-row tiles:
    many conditional nodes; the activation kernel in every
    configuration)."""
    from mvsdf_tpu_torch import compaction
    from mvsdf_tpu_torch.tracing.kernels import counts
    monkeypatch.setattr(compaction, "TILE_ROWS", 256)
    step, row = _capturable(cuda, cameras, fused, pallas)
    step.row.copy_(row(1))
    step.capture()
    if pallas:
        assert step.launches.get("sdf_mlp_xyz_count" if fused else
                                 "sdf_mlp_count")
    else:
        # the SDF network's activation kernel runs either way
        assert not any(v for k, v in step.launches.items()
                       if k not in counts.ACT_KERNEL + counts.ROWS)
    assert step.launches["projected_rows"] > 0
    step.row.copy_(row(2))
    written = step.written()
    before = [t.clone() for t in written]
    gen = step.generator.get_state()
    step.eager()
    torch.cuda.synchronize()
    eager = [t.clone() for t in written]
    with torch.no_grad():
        for t, b in zip(written, before):
            t.copy_(b)
    step.generator.set_state(gen)
    launched = counts.snapshot()
    step()
    torch.cuda.synchronize()
    assert counts.since(launched) == {k: step.launches.get(k, 0)
                                      for k in launched}
    for i, (a, b) in enumerate(zip(written, eager)):
        assert torch.equal(a, b), i
    assert torch.isfinite(step.metrics).all()


@pytest.mark.cuda
def test_conditional_nodes_run_the_tiles_below_the_count(cuda):
    """``bounded_rows`` captured with its tiles as conditional nodes: each
    replay computes the tiles that start below the count on the device,
    bit for bit the eager calls on those tiles, leaves the others, and
    never syncs."""
    from mvsdf_tpu_torch.compaction import bounded_rows
    from mvsdf_tpu_torch.tracing.kernels.graph_cond import ConditionalBodies
    n, tile = 1000, 96
    x = torch.rand((n, 3), device=cuda)
    w = torch.rand((3, 64), device=cuda)

    def fn(a, c):
        return (a @ w).relu().sum(-1)

    want = torch.cat([fn(x[s:s + tile], None) for s in range(0, n, tile)])
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    out = torch.zeros(n, device=cuda)
    graph = torch.cuda.CUDAGraph()
    bodies = ConditionalBodies(cuda)
    with torch.cuda.graph(graph), bodies:
        bounded_rows(fn, x, count, out, tile=tile)
    for c in (0, 1, 95, 96, 97, 500, n):
        count.fill_(c)
        out.fill_(-1.0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        live = min(-(-c // tile) * tile, n)
        assert torch.equal(out[:live], want[:live]), c
        assert (out[live:] == -1.0).all(), c
    graph.reset()
    bodies.release()


@pytest.mark.cuda
def test_graph_replays_never_sync(cuda):
    """Replays of a plan uploaded in one pinned copy, each row copied into
    the step's static input on the device: no synchronizing operation
    under set_sync_debug_mode("error"), and the generator moves on as it
    does for eager steps."""
    step, row = _capturable(cuda)
    step.row.copy_(row(1))
    step.capture()
    plan = torch.stack([row(t).cpu() for t in range(2, 6)]).pin_memory()
    out = torch.empty((4, step.metrics.numel()), device=cuda)
    offset = step.generator.get_offset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan_d = plan.to(cuda, non_blocking=True)
        for k in range(4):
            step.row.copy_(plan_d[k])
            step()
            out[k].copy_(step.metrics)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert step.generator.get_offset() > offset


def _adam_pair(device):
    """torch.optim.Adam and ``step.adam_update`` on the same parameters and
    gradients (magnitudes 1 to 1e-5) for 6 steps: their parameters."""
    from mvsdf_tpu_torch.train.step import adam_scalars, adam_update
    g = torch.Generator(device=device).manual_seed(0)
    shapes = [(512, 512), (512,), (39, 512), (1,)]
    init = [torch.randn(s, generator=g, device=device) for s in shapes]
    grads = [[torch.randn(s, generator=g, device=device) * 10.0 ** -(i % 6)
              for i, s in enumerate(shapes)] for _ in range(6)]
    ref = [p.clone().requires_grad_(True) for p in init]
    opt = torch.optim.Adam(ref, lr=1.6e-3, betas=(0.9, 0.999), eps=1e-8)
    got = [p.clone() for p in init]
    state = [(torch.zeros_like(p), torch.zeros_like(p), None) for p in got]
    for t, gs in enumerate(grads, 1):
        for p, gr in zip(ref, gs):
            p.grad = gr.clone()
        opt.step()
        step_neg, bc2, _ = (torch.full((), v, device=device)
                            for v in adam_scalars(opt, t))
        adam_update(got, gs, state, step_neg, bc2, (0.9, 0.999), 1e-8)
    return [p.detach() for p in ref], got


@pytest.mark.cuda
def test_adam_update_equals_torch_adam_on_the_card(cuda):
    """The capturable step's Adam is the optimizer's own multi-tensor
    update on the card, to the bit."""
    ref, got = _adam_pair(cuda)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def _replay_quietly(graph):
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_autograd_passes_through_a_conditional_node(cuda):
    """What ``scripts/port_graph_probe.py --only cond_autograd`` found: a
    ``torch.autograd.Function`` whose forward runs a value + spatial
    gradient (autograd inside) under one ``run_if`` and whose backward
    recomputes it on fresh leaves and calls ``torch.autograd.grad`` under a
    second, captured with ``torch.autograd.grad`` of a loss through it:
    replays with the predicate off and on equal the eager calls to the bit,
    with no sync, and a skipped node gives zero gradient."""
    from mvsdf_tpu_torch.compaction import parameters_as, run_if
    from mvsdf_tpu_torch.tracing.kernels.graph_cond import ConditionalBodies
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**SMALL),
                              np.random.default_rng(0)).to(cuda)
    params = list(net.parameters())

    class Node(torch.autograd.Function):
        @staticmethod
        def forward(ctx, pred, x, *ps):
            out = torch.zeros_like(x)
            run_if(pred, lambda: out.copy_(t_sdf.full_value_and_grad(
                net, x)[1]))
            ctx.save_for_backward(pred, x, *ps)
            return out

        @staticmethod
        def backward(ctx, g_out):
            pred, *args = ctx.saved_tensors
            grads = [torch.zeros_like(a) for a in args]

            def body():
                leaves = [a.detach().requires_grad_(True) for a in args]
                with torch.enable_grad(), parameters_as(net, leaves[1:]):
                    g = t_sdf.full_value_and_grad(net, leaves[0])[1]
                for buf, v in zip(grads, torch.autograd.grad(
                        g, leaves, g_out, allow_unused=True)):
                    if v is not None:
                        buf.copy_(v)
            run_if(pred, body)
            return (None, *grads)

    x = (torch.rand((1000, 3), device=cuda) * 2 - 1).requires_grad_(True)
    pred = torch.zeros((), dtype=torch.bool, device=cuda)
    bufs = [torch.zeros_like(t) for t in [x, x] + params]

    def step():
        g = Node.apply(pred, x, *params)
        loss = ((g ** 2).sum(-1) - 1).square().sum()
        got = torch.autograd.grad(loss, [x] + params)
        with torch.no_grad():
            for buf, v in zip(bufs, [g, *got]):
                buf.copy_(v)

    want = {}
    for p in (False, True):
        pred.fill_(p)
        step()
        want[p] = [b.clone() for b in bufs]
    assert all(not b.any() for b in want[False][2:])
    assert all(b.abs().sum() > 0 for b in want[True][:3])
    graph = torch.cuda.CUDAGraph()
    bodies = ConditionalBodies(cuda)
    with torch.cuda.graph(graph), bodies:
        step()
    for p in (True, False, True):
        pred.fill_(p)
        for b in bufs:
            b.fill_(-1.0)
        _replay_quietly(graph)
        for i, (a, b) in enumerate(zip(bufs, want[p])):
            assert torch.equal(a, b), (p, i)
    graph.reset()
    bodies.release()


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(768,), (512, 1024)],
                         ids=["one_cap", "two_caps"])
def test_cascade_replays_equal_the_eager_call(cuda, caps):
    """``bounded_cascade_call_into`` of a width-64 field's SDF, indicator
    and spatial gradient (a loss on the gradient: second order), captured
    with ``ConditionalBodies``: replays at counts 0, below the first cap,
    at it, between the caps, over the top one and all rows equal the eager
    call's outputs and gradients (inputs and parameters) to the bit, with
    no sync."""
    from mvsdf_tpu_torch.compaction import bounded_cascade_call_into
    from mvsdf_tpu_torch.tracing.kernels.graph_cond import ConditionalBodies
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**SMALL),
                              np.random.default_rng(0)).to(cuda)
    params = list(net.parameters())
    n = 2048
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.rand((n, 3), generator=g, device=cuda) * 2 - 1
         ).requires_grad_(True)
    order = torch.randperm(n, generator=g, device=cuda)
    mask = torch.zeros(n, dtype=torch.bool, device=cuda)
    targets = [torch.zeros((n, 2), device=cuda),
               torch.zeros((n, 3), device=cuda)]
    bufs = [torch.zeros_like(t) for t in targets + [x] + params]

    def fn(p):
        out, grad = t_sdf.full_value_and_grad(net, p)
        return out[..., :2], grad

    def step():
        o, gr = bounded_cascade_call_into(fn, mask, caps, [x], targets,
                                          module=net)
        m = mask.float()
        loss = (m * (o[:, 0] ** 2 + o[:, 1] +
                     ((gr ** 2).sum(-1) - 1) ** 2)).sum()
        got = torch.autograd.grad(loss, [x] + params)
        with torch.no_grad():
            for buf, v in zip(bufs, [o, gr, *got]):
                buf.copy_(v)

    counts = (0, 300, caps[0], (caps[0] + caps[-1]) // 2, caps[-1] + 1, n)
    want = {}
    for c in counts:
        mask.zero_()[order[:c]] = True
        step()
        want[c] = [b.clone() for b in bufs]
    graph = torch.cuda.CUDAGraph()
    bodies = ConditionalBodies(cuda)
    with torch.cuda.graph(graph), bodies:
        step()
    for c in counts[::-1] + counts:
        mask.zero_()[order[:c]] = True
        for b in bufs:
            b.fill_(-1.0)
        _replay_quietly(graph)
        for i, (a, b) in enumerate(zip(bufs, want[c])):
            assert torch.equal(a, b), (c, i)
    graph.reset()
    bodies.release()


def _ulps(a, b):
    """f32 units in the last place between entries (+0 and -0 equal)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _plain_activation(y, b):
    """The hidden layers' bias and activation as PyTorch's ops, on any
    device: the chain the field ran before its kernel."""
    return t_sdf.softplus100(y + b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "extremes"])
def test_softplus100_kernel_entries_match_the_plain_chain(cuda, case):
    """Each entry of ``csrc/softplus100.cu`` at 65,536 x 512 against its
    plain version on the card (the chain of PyTorch's ops): z uniform in
    [-0.5, 0.5], or extremes (|100 z| from 1e-36 to 1e4, both signs,
    zeros); then a 473-wide view of 512-wide rows (the scalar path, row
    strides). Bound: 4 units in the last place; measured (H100 80GB
    HBM3, 700 W): 0 in every entry, the outputs equal to the bit. One
    launch an entry, counted."""
    from mvsdf_tpu_torch.tracing.kernels import counts
    from mvsdf_tpu_torch.tracing.kernels import softplus100 as SP
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = 65536
    if case == "uniform":
        y = torch.rand((n, 512), generator=gen, device=cuda) - 0.5
        b = (torch.rand(512, generator=gen, device=cuda) - 0.5) * 0.1
    else:
        mag = 10 ** (torch.rand((n, 512), generator=gen, device=cuda) * 40
                     - 38)
        y = torch.where(torch.rand((n, 512), generator=gen, device=cuda)
                        < 0.5, -mag, mag)
        y[:, :8] = 0.0
        y[:, 8:16] = -0.0
        b = torch.zeros(512, device=cuda)
    g, gg, a = (torch.randn((n, 512), generator=gen, device=cuda)
                for _ in range(3))
    for cols in (512, 473):
        yc, gc, ggc, ac = (t[:, :cols] for t in (y, g, gg, a))
        bc = b[:cols]
        before = counts.snapshot()
        z, h = SP.forward(yc, bc)
        got = [z, h, SP.grad(gc, z), SP.grad(gc, z, ac),
               *SP.grad_grad(ggc, gc, z)]
        want = [*SP.forward_reference(yc, bc), SP.grad_reference(gc, z),
                SP.grad_reference(gc, z, ac),
                *SP.grad_grad_reference(ggc, gc, z)]
        torch.cuda.synchronize()
        n_act = counts.since(before)
        assert [n_act[k] for k in counts.ACT_KERNEL] == [1, 2, 1]
        for i, (u, w) in enumerate(zip(got, want)):
            assert u.shape == w.shape == (n, cols)
            assert torch.isfinite(u).all(), (cols, i)
            assert _ulps(u, w).max().item() <= 4, (cols, i)


@pytest.mark.cuda
def test_softplus100_kernel_nan_in_nan_out(cuda):
    """A NaN operand gives NaN in every output entry that reads it, and
    leaves its neighbours finite."""
    from mvsdf_tpu_torch.tracing.kernels import softplus100 as SP
    y = torch.tensor([[0.01, float("nan"), -0.02, 0.5]], device=cuda)
    z, h = SP.forward(y, torch.zeros(4, device=cuda))
    ones = torch.ones_like(z)
    for t in (z, h, SP.grad(ones, z), *SP.grad_grad(ones, ones, z)):
        assert t[0, 1].isnan() and torch.isfinite(t[0, [0, 2, 3]]).all()


@pytest.mark.cuda
def test_full_value_and_grad_through_the_activation_kernel(cuda,
                                                           monkeypatch):
    """The full-width field (9 x 512) from the seed's weights on 16,384
    points: the output, the spatial gradient and every parameter's
    gradient of a loss on both, through the kernel (4 launches a hidden
    layer: forward, the spatial gradient's VJP, and in the loss's backward
    its VJP and the VJP's), against the plain chain on the card (no
    launch); within 1e-5 of each tensor's largest entry (the bias
    gradients' f32 row sums may be ordered differently); measured (H100
    80GB HBM3, 700 W): equal to the bit."""
    from mvsdf_tpu_torch.tracing.kernels import counts
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(),
                              np.random.default_rng(0)).to(cuda)
    params = list(net.parameters())
    x = torch.rand((16384, 3), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda) * 2 - 1

    def run():
        before = counts.snapshot()
        out, g = t_sdf.full_value_and_grad(net, x)
        loss = ((g.norm(dim=-1) - 1) ** 2).sum() + out[:, :2].sum() + \
            out[:, 2:].square().mean()
        got = [out.detach(), g.detach(), *torch.autograd.grad(loss, params)]
        torch.cuda.synchronize()
        n = counts.since(before)
        return got, [n[k] for k in counts.ACT_KERNEL]

    got, launched = run()
    n_hidden = len(net.layers) - 1
    assert launched == [n_hidden, 2 * n_hidden, n_hidden]
    monkeypatch.setattr(t_sdf, "bias_softplus100", _plain_activation)
    want, launched = run()
    assert launched == [0, 0, 0]
    for i, (a, w) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), i
        assert (a - w).abs().max() <= 1e-5 * w.abs().max(), i


@pytest.mark.cuda
@pytest.mark.parametrize("cascade,per_layer", [((), 8), ((0.375,), 24)],
                         ids=["dense", "one_tier"])
def test_capturable_step_replay_through_the_activation_kernel(
        cuda, cascade, per_layer, monkeypatch):
    """One replay of the captured step (the kernel's launches in the
    graph: forward, VJP, and in the loss's backward the VJP and the VJP's
    for each of the step's value + gradient calls; a later tier of the
    supervised cascade adds its forward's two and its recompute's four)
    against the eager step of the plain chain from the same state, row
    and generator state: every tensor the step writes within 1e-5 of its
    largest entry; measured (H100 80GB HBM3, 700 W): equal to the bit.
    The graph counts ``per_layer`` launches a hidden layer."""
    from mvsdf_tpu_torch.tracing.kernels import counts
    step, row = _capturable(cuda, cascade=cascade)
    step.row.copy_(row(1))
    step.capture()
    n_hidden = len(step.state.net.implicit.layers) - 1
    assert sum(step.launches[k] for k in counts.ACT_KERNEL) == \
        per_layer * n_hidden
    step.row.copy_(row(2))
    written = step.written()
    before = [t.clone() for t in written]
    gen = step.generator.get_state()
    with monkeypatch.context() as m:
        m.setattr(t_sdf, "bias_softplus100", _plain_activation)
        step.eager()
    torch.cuda.synchronize()
    plain = [t.clone() for t in written]
    with torch.no_grad():
        for t, b in zip(written, before):
            t.copy_(b)
    step.generator.set_state(gen)
    step()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(written, plain)):
        assert torch.isfinite(a).all(), i
        assert (a - b).abs().max() <= 1e-5 * b.abs().max().clamp_min(
            1e-30), i
    step.release()


@pytest.mark.cuda
def test_projection_contraction_on_the_card_equals_the_cpu(cuda):
    """The depth-map unprojection's two contractions at the cells' shapes
    (8 maps of 600 x 800: intrinsics over the shared pixel grid, then
    extrinsics over a point a pixel) from seeded operands: the card's
    ``projections._apply`` equal to the CPU's to the bit (the same
    products, summed in the same order), in one kernel a product and one
    a sum, none of them a ``gemv`` or ``gemm``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mvsdf_tpu_torch.geometry import projections as proj
    gen = torch.Generator().manual_seed(0)
    N, h, w = 8, 600, 800
    cases = ((torch.randn((N, 1, 1, 3, 3), generator=gen),
              proj.pixel_grid(h, w)),
             (torch.randn((N, 1, 1, 4, 4), generator=gen),
              torch.randn((N, h, w, 4), generator=gen) * 100))
    for M, p in cases:
        want = proj._apply(M, p)
        Md, pd = M.to(cuda), p.to(cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = proj._apply(Md, pd)
            torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 2 * M.shape[-1] - 1, kernels
        assert not any("gemv" in k or "gemm" in k for k in kernels), kernels


def _bf16_ulps(a, b):
    """bf16 units in the last place between entries."""
    return _ulps(a.float(), b.float()) // 65536


@pytest.mark.cuda
def test_softplus100_bf16_entries_match_their_plain_versions(cuda):
    """The activation's entries on bf16 operands (h written in bf16, g
    read in bf16, g's cotangent written in bf16) at 65,536 x 512 and a
    473-wide view (the scalar path) against their plain versions on the
    card. z,
    the f32 VJPs: at most 4 f32 units in the last place, as the f32
    entries; h and g's cotangent, bf16 roundings of f32 values that may
    part by those units, so at most 1 bf16 unit. One launch an entry,
    counted."""
    from mvsdf_tpu_torch.tracing.kernels import counts
    from mvsdf_tpu_torch.tracing.kernels import softplus100 as SP
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = 65536
    y = torch.rand((n, 512), generator=gen, device=cuda) - 0.5
    b = (torch.rand(512, generator=gen, device=cuda) - 0.5) * 0.1
    g = torch.randn((n, 512), generator=gen, device=cuda).bfloat16()
    gg, a = (torch.randn((n, 512), generator=gen, device=cuda)
             for _ in range(2))
    for cols in (512, 473):
        yc, gc, ggc, ac = (t[:, :cols] for t in (y, g, gg, a))
        bc = b[:cols]
        before = counts.snapshot()
        z, h = SP.forward(yc, bc, True, torch.bfloat16)
        got = [z, h, SP.grad(gc, z), SP.grad(gc, z, ac),
               *SP.grad_grad(ggc, gc, z)]
        want = [*SP.forward_reference(yc, bc, torch.bfloat16),
                SP.grad_reference(gc, z), SP.grad_reference(gc, z, ac),
                *SP.grad_grad_reference(ggc, gc, z)]
        torch.cuda.synchronize()
        n_act = counts.since(before)
        assert [n_act[k] for k in counts.ACT_KERNEL_BF16] == [1, 2, 1]
        for i, (u, w) in enumerate(zip(got, want)):
            assert u.shape == w.shape == (n, cols) and u.dtype == w.dtype
            assert torch.isfinite(u.float()).all(), (cols, i)
            d = _bf16_ulps(u, w) if u.dtype == torch.bfloat16 else \
                _ulps(u, w)
            assert d.max().item() <= (1 if u.dtype == torch.bfloat16
                                      else 4), (cols, i)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(39, 512), (512, 512), (512, 473),
                                 (512, 258)])
def test_bf16_linear_on_the_card_matches_its_plain_version(cuda, K, N):
    """``mlp.bf16_linear`` at the SDF network's layer shapes on 65,537
    rows: the card's bf16 tensor-core product (f32 sums) against the
    plain version's f32 product of the same bf16 values (TF32 off). The
    products are exact in f32, so the two part only by the order of the
    f32 sums: at most (K - 1) 2^-24 sum_k |x_k w_k| an entry, any order's
    bound. Its gradients are the plain version's own products. The rows
    are counted."""
    from mvsdf_tpu_torch.fields import mlp
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((65537, K), generator=gen, device=cuda).bfloat16()
    w16 = (torch.randn((K, N), generator=gen, device=cuda) /
           K ** 0.5).bfloat16()
    before = mlp.BF16_GEMM_ROWS.launches
    got = mlp.bf16_linear(x, w16.float(), w16)
    torch.cuda.synchronize()
    assert mlp.BF16_GEMM_ROWS.launches == before + 65537
    want = x.float() @ w16.float()
    scale = x.float().abs() @ w16.float().abs()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got - want).abs() <= (K - 1) * 2.0 ** -24 * scale).all()
