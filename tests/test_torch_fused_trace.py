"""The port's fused-trace kernels (in-kernel-PE SDF-MLP, secant, march)
against the JAX package's Pallas kernels and XLA functions on the CPU.

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the plain versions against ``pallas_sdf_apply(in_kernel_pe=True)``,
``pallas_secant`` and ``pallas_sphere_trace`` in interpret mode and
against the JAX package's ``_secant`` and ``_sphere_trace``; then the
port's ``trace_rays`` with the three in place against the JAX package's
with its interpret-mode kernels. The march kernel's control flow (ray
slots refilled from a queue, a state machine per ray) has a plain model,
held here against the lockstep plain version. The CUDA kernels themselves
run only on a GPU: tests/test_torch_cuda.py. The whole fused slice (render, losses and
gradients) is in tests/test_torch_step.py.

Tolerances: SDF values 2e-5 absolute + 1e-5 relative (f32 sums in another
order, as the JAX package's own kernel test); march distances 3e-5 (that of
tests/unit/test_pallas_march.py); secant roots and traced distances 1e-4
absolute + 1e-4 relative, because the secant divides by an SDF
difference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsdf_tpu.fields import sdf as j_sdf
from mvsdf_tpu.geometry.cameras import get_camera_params
from mvsdf_tpu.tracing import sphere_trace as j_st
from mvsdf_tpu.tracing.pallas import pack_sdf_weights as j_pack
from mvsdf_tpu.tracing.pallas import pallas_sdf_apply, pallas_secant
from mvsdf_tpu.tracing.pallas.march_kernel import pallas_sphere_trace
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.convert import params_from_jax
from mvsdf_tpu_torch.data.synthetic import make_scene
from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.network import MVSDFNetwork
from mvsdf_tpu_torch.fields.radiance import RenderConfig as TRender
from mvsdf_tpu_torch.rendering.renderer import render_forward
from mvsdf_tpu_torch.tracing import sphere_trace as t_st
from mvsdf_tpu_torch.tracing.kernels import march_kernel as M
from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
from mvsdf_tpu_torch.tracing.kernels import secant_kernel as S

SMALL = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
NO_SKIP = dict(feature_vector_size=16, dims=(96,) * 3, skip_in=())
MARCH = dict(feature_vector_size=16, dims=(64,) * 3, skip_in=(2,))


def _pair(kw, seed=0, noise=0.05):
    """The same weights in the JAX package and in the port, perturbed by
    ``noise`` from the geometric init."""
    jcfg = j_sdf.ImplicitConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, j_sdf.init_implicit(jcfg, np.random.default_rng(seed)))
    rng = np.random.default_rng(seed + 1)
    params = [{k: (v + noise * rng.normal(size=v.shape)).astype(np.float32)
               for k, v in p.items()} for p in params]
    net = t_sdf.ImplicitNetwork(t_sdf.ImplicitConfig(**kw))
    state = params_from_jax({"implicit": params, "render": []})
    net.load_state_dict({k[len("implicit."):]: v for k, v in state.items()})
    jparams = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    return jcfg, jparams, net


def _rays(n, seed, cam=(0.1, 0.2, 2.2), spread=0.9):
    """n rays from one camera towards points in a cube: some miss the
    unit sphere."""
    rng = np.random.default_rng(seed)
    org = np.tile(np.asarray([cam], np.float32), (n, 1))
    dirs = rng.uniform(-spread, spread, (n, 3)).astype(np.float32) - org
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return org, dirs.astype(np.float32)


def _intersect(org, dirs):
    """mask_intersect, t_near, t_far as the JAX package's trace_rays."""
    d_dot_o = np.sum(dirs * org, -1)
    under = d_dot_o ** 2 - (np.sum(org ** 2, -1) - 1.0)
    mi = under > 0
    sq = np.sqrt(np.where(mi, under, 0.0))
    tn = np.clip(np.where(mi, -d_dot_o - sq, 0.0), 0.0, None)
    tf = np.clip(np.where(mi, -d_dot_o + sq, 0.0), 0.0, None)
    return mi, tn.astype(np.float32), tf.astype(np.float32)


@pytest.mark.parametrize("kw", [SMALL, NO_SKIP, {}],
                         ids=["small_skip_padded", "no_skip", "full_size"])
def test_sdf_mlp_xyz_matches_pallas_in_kernel_pe(kw):
    n = 777 if kw else 300  # ragged against the 256-row Pallas block
    jcfg, params, net = _pair(kw)
    x = np.random.default_rng(2).uniform(-1, 1, (n, 3)).astype(np.float32)
    got = K.sdf_mlp_xyz(K.pack_sdf_weights(net), jcfg.multires,
                        torch.from_numpy(x)).numpy()
    want = np.asarray(pallas_sdf_apply(jcfg, j_pack(jcfg, params),
                                       jnp.asarray(x), block=256,
                                       interpret=True, in_kernel_pe=True))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_secant_matches_pallas_and_xla():
    """Brackets from a real first sign crossing of 64 samples per ray."""
    jcfg, params, net = _pair(SMALL)
    org, dirs = _rays(1000, seed=3, spread=0.5)
    mi, tn, tf = _intersect(org, dirs)
    steps = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    ts = tn[:, None] + steps * (tf - tn)[:, None]
    sdf = lambda x: j_sdf.sdf_apply(jcfg, params, x)
    vals = np.asarray(sdf(jnp.asarray(org[:, None] + ts[..., None] *
                                      dirs[:, None])))
    first = np.argmax(vals < 0, axis=1)
    ok = mi & (vals < 0).any(1) & (first > 0)
    rows = np.flatnonzero(ok)
    assert rows.size > 100
    i = first[rows]
    zl, zh = ts[rows, i - 1], ts[rows, i]
    sl, sh = vals[rows, i - 1], vals[rows, i]
    assert (sl > 0).all() and (sh < 0).all()
    o, d = org[rows], dirs[rows]

    cfg = j_st.TracerConfig()
    jargs = [jnp.asarray(a) for a in (o, d, zl, zh, sl, sh)]
    want_xla = np.asarray(j_st._secant(cfg, sdf, *jargs))
    want_pallas = np.asarray(pallas_secant(
        cfg, jcfg, j_pack(jcfg, params), *jargs, block=128,
        interpret=True))
    got = S.secant(K.pack_sdf_weights(net), jcfg.multires,
                   cfg.n_secant_steps,
                   *(torch.from_numpy(np.ascontiguousarray(a))
                     for a in (o, d, zl, zh, sl, sh))).numpy()
    np.testing.assert_allclose(got, want_pallas, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want_xla, atol=1e-4, rtol=1e-4)
    assert ((got > zl - 1e-4) & (got < zh + 1e-4)).all()


def test_sphere_march_matches_pallas_and_xla():
    """Leading shape (2, 128); some rays miss the sphere, some end the
    march unfinished. The plain version's rows used equal the rows the
    port's own gathering march evaluates."""
    jcfg, params, net = _pair(MARCH, noise=0.02)
    org, dirs = _rays(256, seed=2)
    mi, tn, tf = _intersect(org, dirs)
    shape = (2, 128)
    a = {k: v.reshape(shape + v.shape[1:]) for k, v in
         dict(org=org, dirs=dirs, mi=mi, tn=tn, tf=tf).items()}
    cfg = j_st.TracerConfig()
    ja = [jnp.asarray(a[k]) for k in ("org", "dirs", "mi", "tn", "tf")]
    sdf = lambda x: j_sdf.sdf_apply(jcfg, params, x)
    want_xla = j_st._sphere_trace(cfg, sdf, *ja)
    want_pallas = pallas_sphere_trace(cfg, jcfg, j_pack(jcfg, params), *ja,
                                      block=128, interpret=True)

    packed = K.pack_sdf_weights(net)
    rows = torch.zeros(2, dtype=torch.int64)
    ta = [torch.from_numpy(np.ascontiguousarray(a[k]))
          for k in ("org", "dirs", "mi", "tn", "tf")]
    got = M.sphere_march(t_st.TracerConfig(), packed, jcfg.multires, *ta,
                         rows=rows)
    assert got[1].shape == shape
    for want in (want_pallas, want_xla):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=3e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=3e-5)
    assert got[0].any() and not got[0].all() and not mi.all()

    evaluated = []

    def counted(x):
        evaluated.append(x.shape[0])
        return K.sdf_mlp_xyz(packed, jcfg.multires, x.reshape(-1, 3))

    t_st._sphere_trace(t_st.TracerConfig(), counted, *ta)
    assert int(rows[1]) == sum(evaluated)
    # lockstep: every row at the first evaluation and at each trip
    assert int(rows[0]) == 2 * 256 * (1 + 10 * (1 + 3))


@pytest.fixture(scope="module")
def trace_setup():
    """The 1024-ray fixture of tests/test_torch_trace.py: weights perturbed
    until some rays end the march unfinished, half the object mask off."""
    jcfg, params, net = _pair(SMALL, noise=1.0)
    rng = np.random.default_rng(1)
    rng.normal(size=sum(v.size for p in params for v in p.values()))
    sc = make_scene(n_images=2, n_pix=512, feat_ch=4, img_hw=96,
                    depth_hw=24)
    dirs, loc = get_camera_params(jnp.asarray(sc["uv"]),
                                  jnp.asarray(sc["pose"]),
                                  jnp.asarray(sc["intrinsics"]))
    dirs = np.array(dirs)
    org = np.broadcast_to(np.asarray(loc)[:, None], dirs.shape).copy()
    mask = rng.uniform(size=dirs.shape[:2]) < 0.5
    steps = rng.uniform(size=100).astype(np.float32)
    return jcfg, params, net, org, dirs, mask, steps


def _march_rays(name, trace_setup):
    """(net, leading shape, org, dirs) of a named ray set."""
    if name == "steep1024":
        _, _, net, org, dirs, _, _ = trace_setup
        return net, org.shape[:2], org.reshape(-1, 3), dirs.reshape(-1, 3)
    _, _, net = _pair(MARCH, noise=0.02)
    n = int(name)
    org, dirs = _rays(256, seed=2)
    return net, (2, 128) if n == 256 else (n,), org[:n], dirs[:n]


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("slots", [4, 32])
@pytest.mark.parametrize("rays", ["1", "31", "256", "steep1024"])
def test_march_scheduler_model_matches_lockstep(trace_setup, rays, slots,
                                                blocks):
    """The plain model of the kernel's scheduler (a queue of rays, slots,
    a state machine per ray) against the lockstep plain version: the same
    masks and rows used; t within 3e-5, because the model evaluates other
    batches of rows than the lockstep version and a CPU matmul rounds
    differently at another batch size. Ray sets: the 256-ray fixture of
    test_sphere_march_matches_pallas_and_xla (some rays miss the sphere,
    some end unfinished), its first 1 and 31 rays, and the steep field's
    1024 rays."""
    net, lead, org, dirs = _march_rays(rays, trace_setup)
    mi, tn, tf = _intersect(org, dirs)
    packed = K.pack_sdf_weights(net)
    cfg = t_st.TracerConfig()
    args = [torch.from_numpy(np.ascontiguousarray(a)).reshape(
        lead + a.shape[1:]) for a in (org, dirs, mi, tn, tf)]
    rows, rows_ref = (torch.zeros(2, dtype=torch.int64) for _ in range(2))
    want = M.sphere_march_reference(cfg, packed, 6, *args, rows=rows_ref)
    detail = {}
    got = M.sphere_march_slots_reference(cfg, packed, 6, *args, rows=rows,
                                         slots=slots, blocks=blocks,
                                         detail=detail)
    assert got[0].shape == lead and got[1].shape == lead
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=3e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=3e-5)
    evaluated, used = rows.tolist()
    assert used == int(rows_ref[1]) and used >= 2 * int(mi.sum())
    assert evaluated % (2 * slots) == 0 and evaluated >= used
    assert used <= detail["live_rows"] <= evaluated
    assert evaluated <= 2 * slots * blocks * detail["rounds"]
    assert detail["drained"] <= detail["rounds"]
    assert (1 if mi.any() else 0) <= detail["longest_ray"] <= min(
        detail["rounds"], 1 + 10 * (1 + 3))
    if rays in ("256", "steep1024"):
        assert want[0].any() and not mi.all()


@pytest.mark.parametrize("case", ["eval", "train_unified_nofill"])
def test_trace_rays_with_fused_kernels_matches_jax(trace_setup, case):
    """Port: sdf_mlp_xyz, sphere_march and secant (plain on the CPU).
    JAX: its interpret-mode in-kernel-PE, march and secant kernels. On this
    steep field the JAX package's kernel path and its XLA path themselves
    differ by up to 1.7e-4 in a distance near 2.9."""
    jcfg, params, net, org, dirs, mask, steps = trace_setup
    training = case != "eval"
    kw = dict(fill_misses=False,
              fallback_capacity_frac=(0.0625, 0.09375, 0.375)) \
        if training else dict(sampler_capacity_frac=0.25)
    jt = dataclasses.replace(j_st.TracerConfig(), **kw)
    tt = dataclasses.replace(t_st.TracerConfig(), **kw)
    jp = j_pack(jcfg, params)
    L = jcfg.multires

    @jax.jit
    def run_jax(o, d, m, s):
        return j_st.trace_rays(
            jt, lambda x: pallas_sdf_apply(jcfg, jp, x, block=1024,
                                           interpret=True, in_kernel_pe=True),
            o, d, m, training=training, minimal_steps=s,
            march_fn=lambda *a: pallas_sphere_trace(jt, jcfg, jp, *a,
                                                    block=512,
                                                    interpret=True),
            secant_fn=lambda *a: pallas_secant(jt, jcfg, jp, *a, block=1024,
                                               interpret=True))

    want = run_jax(jnp.asarray(org), jnp.asarray(dirs), jnp.asarray(mask),
                   jnp.asarray(steps))
    packed = K.pack_sdf_weights(net)
    got = t_st.trace_rays(
        tt, lambda x: K.sdf_mlp_xyz(packed, L, x.reshape(-1, 3)).reshape(
            x.shape[:-1]),
        torch.from_numpy(org), torch.from_numpy(dirs),
        torch.from_numpy(mask), training=training,
        minimal_steps=torch.from_numpy(steps),
        march_fn=lambda *a: M.sphere_march(tt, packed, L, *a),
        secant_fn=lambda *a: S.secant(packed, L, tt.n_secant_steps, *a))
    for name in ("network_object_mask", "sampler_mask", "mask_intersect"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.sampler_mask.any() and got.network_object_mask.any()
    assert (~got.mask_intersect).any()
    # a point moves by its distance's error along a unit direction
    dists = np.asarray(want.dists)
    np.testing.assert_allclose(got.dists.numpy(), dists, atol=1e-4,
                               rtol=1e-4)
    perr = np.abs(got.points.numpy() - np.asarray(want.points)).max(-1)
    assert (perr <= 1e-4 + 1e-4 * np.abs(dists)).all(), perr.max()


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    _, _, net = _pair(SMALL)
    packed = K.pack_sdf_weights(net)
    org, dirs = _rays(33, seed=4)
    mi, tn, tf = _intersect(org, dirs)
    o, d, m, n_, f_ = (torch.from_numpy(a) for a in (org, dirs, mi, tn, tf))
    cfg = t_st.TracerConfig()
    before = (K.sdf_mlp_xyz.launches, S.secant.launches,
              M.sphere_march.launches)

    x = o + 0.5 * d
    np.testing.assert_array_equal(
        K.sdf_mlp_xyz(packed, 6, x).numpy(),
        K.sdf_mlp_xyz_reference(packed, 6, x).numpy())
    br = (n_, f_, K.sdf_mlp_xyz_reference(packed, 6, o + n_[:, None] * d),
          K.sdf_mlp_xyz_reference(packed, 6, o + f_[:, None] * d))
    np.testing.assert_array_equal(
        S.secant(packed, 6, 8, o, d, *br).numpy(),
        S.secant_reference(packed, 6, 8, o, d, *br).numpy())
    for a, b in zip(M.sphere_march(cfg, packed, 6, o, d, m, n_, f_),
                    M.sphere_march_reference(cfg, packed, 6, o, d, m, n_,
                                             f_)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (K.sdf_mlp_xyz.launches, S.secant.launches,
            M.sphere_march.launches) == before

    calls = [
        lambda c: K.sdf_mlp_xyz(packed, 6, c(x)),
        lambda c: S.secant(packed, 6, 8, c(o), c(d), *map(c, br)),
        lambda c: M.sphere_march(cfg, packed, 6, c(o), c(d), m.to(
            c(o).device), c(n_), c(f_)),
    ]
    for call in calls:
        with pytest.raises(ValueError):
            call(lambda t: t.double())
        with pytest.raises(ValueError):
            call(lambda t: t.to("meta"))
    with pytest.raises(ValueError, match="multires"):
        K.sdf_mlp_xyz(packed, 4, x)


def test_fused_flags_are_ignored_without_use_pallas_trace():
    """As in the JAX package: use_pallas_march, use_pallas_secant and
    pallas_in_kernel_pe are read only under use_pallas_trace."""
    kw = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))
    base = tc.ModelConfig(implicit=t_sdf.ImplicitConfig(**kw),
                          render=TRender(feature_vector_size=16,
                                         dims=(64,) * 2))
    flags = dataclasses.replace(base, use_pallas_march=True,
                                use_pallas_secant=True,
                                pallas_in_kernel_pe=True)
    torch.manual_seed(0)
    net = MVSDFNetwork(base.implicit, base.render)
    sc = make_scene(n_images=1, n_pix=128, feat_ch=4, img_hw=96,
                    depth_hw=24)
    batch = {k: torch.from_numpy(np.asarray(sc[k]))
             for k in ("uv", "pose", "intrinsics", "object_mask")}
    with torch.no_grad():
        a = render_forward(base, net, batch, training=False)
        b = render_forward(flags, net, batch, training=False)
    for name in ("network_object_mask", "dists", "rgb_values"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), name)
