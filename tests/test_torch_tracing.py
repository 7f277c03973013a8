"""The program's tracing (``train/metrics.Tracer``, the step's stage stamps
and row counters in ``tracing/kernels/stamp.py``).

- Spans nest: parents, chunk ids, arguments and self time; with tracing
  off nothing is kept.
- A span on the profiler's clock brackets the profiler's
  ``record_function`` event of the same name, and ``spans.json`` shows it
  on the axis of the profiler's own ``trace.json``.
- A CPU run of chunks with tracing on ends with the weights, Adam's
  moments and every metric of the same run with tracing off, to the bit
  (plain field and SDF-MLP count entry); its steps carry six monotone
  stamps and counted rows.
- ``bounded_rows``'s SDF tiles and the count entries add the rows they
  were asked for and ran; nothing is counted outside a probe.
- ``Tracer.summary``'s stage, gap and row arithmetic on known stamps.
- ``scripts/port_trace_pass.py`` on a benchmark cell at the harness
  tests' CPU size: every summary quantity, and the traced step's rows on
  the plain reference's batch and weights within 1% of its count.
- On the card (marked ``cuda``): a captured graph's stamps move on replay
  after replay, and with tracing off no stamp or counter is launched
  through capture and replays.

The training runs on the CPU in a subprocess, as the other training
tests do: a torch optimizer step changes XLA:CPU results for the rest of
its process. This file imports neither JAX nor the JAX package.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mvsdf_tpu_torch.compaction import bounded_rows
from mvsdf_tpu_torch.tracing.kernels import stamp
from mvsdf_tpu_torch.train.metrics import Tracer, unix_offset_ns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _busy(ms):
    t = time.perf_counter()
    while time.perf_counter() - t < ms / 1e3:
        pass


def test_spans_nest_with_parents_chunks_and_self_time():
    tr = Tracer(on=True)
    with tr.in_chunk(4):
        with tr.span("outer", e0=4):
            _busy(2)
            with tr.span("inner", k=0):
                _busy(3)
            with tr.span("inner", k=1):
                _busy(1)
    with tr.span("after"):
        pass
    names = [s[0] for s in tr.spans]
    assert names == ["outer", "inner", "inner", "after"]
    parents = [s[3] for s in tr.spans]
    assert parents == [None, 0, 0, None]
    assert [s[4] for s in tr.spans] == [4, 4, 4, None]
    assert [s[5] for s in tr.spans] == [{"e0": 4}, {"k": 0}, {"k": 1}, {}]
    dur = [b - a for _, a, b, _, _, _ in tr.spans]
    own = tr.self_ns()
    assert own[0] == dur[0] - dur[1] - dur[2]
    assert own[1:] == dur[1:]
    assert own[0] >= 2e6 and dur[1] >= 3e6
    a, b = tr.spans[0][1:3]
    assert all(a <= s[1] <= s[2] <= b for s in tr.spans[1:3])

    # a span timed on another thread: no parent, on the worker's track
    tr.add_span("draw_ahead", a, b, 4, e0=5, e1=6)
    assert tr.spans[-1] == ["draw_ahead", a, b, None, 4, {"e0": 5, "e1": 6}]
    assert tr.worker_spans == {len(tr.spans) - 1}

    off = Tracer()
    with off.span("x"):
        pass
    off.add_span("draw_ahead", a, b, 4)
    off.add_plan(1, 2)
    assert off.spans == [] and off.self_ns() == [] and off.plans == []


def test_program_span_brackets_the_profilers_event(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer(on=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("bracketed_region"):
            torch.ones(2000).cumsum(0)
            _busy(1)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "bracketed_region"]
    to_unix = unix_offset_ns()
    _, a, b, _, _, _ = tr.spans[0]
    assert a + to_unix <= ev.start_ns() <= ev.end_ns() <= b + to_unix

    # spans.json puts it on the axis of the profiler's own Chrome trace
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    tr.write(str(tmp_path / "spans.json"))
    theirs = json.load(open(tmp_path / "trace.json"))
    ours = json.load(open(tmp_path / "spans.json"))
    assert ours["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"]
    (t,) = [e for e in theirs["traceEvents"]
            if e.get("name") == "bracketed_region"]
    (o,) = [e for e in ours["traceEvents"]
            if e.get("name") == "bracketed_region"]
    assert o["ts"] <= t["ts"] and t["ts"] + t["dur"] <= o["ts"] + o["dur"]


def test_bounded_rows_counts_its_sdf_tiles():
    """Tiles of 4096 rows over 10,000: each tile that runs adds its rows
    below the count (clamped) to ACTIVE and its whole length to
    COMPUTED; a tile function that is not an SDF (the positional
    encoding's) adds nothing, and nothing is counted outside a probe."""
    x = torch.zeros(10000, 3)
    fn = lambda a, n: a[:, 0] + 1
    probe = stamp.StepProbe("cpu")
    for count, want in ((0, (0, 0)), (1, (1, 4096)), (4096, (4096, 4096)),
                        (4097, (4097, 8192)), (5000, (5000, 8192)),
                        (10000, (10000, 10000))):
        c = torch.tensor(count, dtype=torch.int32)
        with probe:
            bounded_rows(fn, x, c, torch.zeros(10000), tile=4096,
                         sdf_rows=True)
            bounded_rows(fn, x, c, torch.zeros(10000), tile=4096)
        got = tuple(probe.buf[stamp.ACTIVE:].tolist())
        assert got == want, (count, got)
    before = probe.buf.clone()
    bounded_rows(fn, x, torch.tensor(9000, dtype=torch.int32),
                 torch.zeros(10000), tile=4096, sdf_rows=True)
    assert torch.equal(probe.buf, before)


def test_count_entries_count_their_rows():
    """``sdf_mlp_count`` and ``sdf_mlp_xyz_count`` add their count (at most
    their rows), ``secant_count`` its count times the secant steps."""
    from mvsdf_tpu_torch.fields.sdf import ImplicitConfig, init_implicit
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.tracing.kernels.sdf_mlp import (
        pack_sdf_weights, sdf_mlp_count, sdf_mlp_xyz_count)
    from mvsdf_tpu_torch.tracing.kernels.secant_kernel import secant_count
    icfg = ImplicitConfig(feature_vector_size=16, dims=(32,) * 2,
                          skip_in=(), multires=4)
    net = init_implicit(icfg, np.random.default_rng(0))
    packed = pack_sdf_weights(net)
    x = torch.rand(300, 3) - 0.5
    pe = positional_encoding(x, 4)
    rays = [torch.rand(300, 3) - 0.5, torch.nn.functional.normalize(
        torch.rand(300, 3), dim=-1), torch.zeros(300), torch.ones(300),
        torch.ones(300), -torch.ones(300)]
    probe = stamp.StepProbe("cpu")
    c = lambda n: torch.tensor(n, dtype=torch.int32)
    with probe, torch.no_grad():
        sdf_mlp_count(packed, pe, c(120))
        sdf_mlp_xyz_count(packed, 4, x, c(500))     # clamped to 300
        secant_count(packed, 4, 8, *rays, c(7))
    assert probe.buf[stamp.ACTIVE:].tolist() == [120 + 300 + 56] * 2


def test_summary_arithmetic_on_known_stamps(tmp_path):
    """Two chunks of known stamps (host clock): stage means, the gaps
    between replays, the boundary between the chunks, rows and fill; a
    capture's warm-up row takes no part. The second chunk's plan waited 6
    ms and found its 2 epochs drawn ahead, the first's none of its 3; the
    worker's span lies on its own track."""
    tr = Tracer(on=True)
    ms = 10 ** 6

    def row(t0, active, computed):
        # stages: forward 1 + 2 ms, trace 4, backward 5, update 1
        s = [t0, t0 + 1, t0 + 5, t0 + 7, t0 + 12, t0 + 13]
        return [v * ms for v in s] + [active, computed]
    a = [row(0, 0, 0), row(100, 90, 100), row(115, 80, 100)]
    b = [row(150, 70, 100), row(170, 60, 100)]
    tr.add_chunk(0, np.array(a), [False, True, True], 26.0, 2)
    tr.add_chunk(1, np.array(b), [True, True], 33.0, 2)
    for chunk, ahead, epochs in ((0, 0, 3), (1, 2, 2)):
        with tr.in_chunk(chunk):
            tr.add_plan(ahead, epochs)
    tr.spans.append(["plan_wait", 140 * ms, 146 * ms, None, 1, {}])
    tr.add_span("draw_ahead", 120 * ms, 125 * ms, 0, e0=1, e1=2)
    got = tr.summary()
    assert got["steps"] == 4
    assert got["step_stage_ms.forward"] == pytest.approx(3)
    assert got["step_stage_ms.trace"] == pytest.approx(4)
    assert got["step_stage_ms.backward"] == pytest.approx(5)
    assert got["step_stage_ms.update"] == pytest.approx(1)
    assert got["stage_sum_ms"] == pytest.approx(13)
    # within chunks: 115 - 113 and 170 - 163
    assert got["replay_gap_ms_per_step"] == pytest.approx((2 + 7) / 4)
    # across: 150 - 128
    assert got["chunk_boundary_ms_per_step"] == pytest.approx(22 / 4)
    assert got["boundaries"][0]["gap"] == [128 * ms, 150 * ms]
    assert got["trace_rows_per_step"] == pytest.approx(100)
    assert got["trace_row_fill"] == pytest.approx(75)
    assert got["clock_ms_per_replay"] == pytest.approx(59 / 4)
    assert got["plan_wait_ms_per_step"] == pytest.approx(6 / 4)
    assert got["plan_drawn_ahead_share"] == pytest.approx(2 / 5)
    assert got["boundaries"][0]["plan_wait"] == [140 * ms, 146 * ms]
    only_b = tr.summary(chunks=[1])
    assert only_b["steps"] == 2
    assert only_b["plan_wait_ms_per_step"] == pytest.approx(6 / 2)
    assert only_b["plan_drawn_ahead_share"] == 1
    assert only_b["chunk_boundary_ms_per_step"] == pytest.approx(22 / 2)
    assert only_b["replay_gap_ms_per_step"] == pytest.approx(7 / 2)
    assert Tracer(on=True).summary() == {}
    tr.write(str(tmp_path / "spans.json"))
    events = json.load(open(tmp_path / "spans.json"))["traceEvents"]
    tids = {e["name"]: e["tid"] for e in events if e["ph"] == "X" and
            e["name"] in ("draw_ahead", "plan_wait")}
    assert tids == {"draw_ahead": 3, "plan_wait": 1}


RUN = r"""
import os, pickle, sys
import numpy as np, torch
from mvsdf_tpu_torch import config as tc
from mvsdf_tpu_torch.data.scene import SceneData
from mvsdf_tpu_torch.fields.radiance import RenderConfig
from mvsdf_tpu_torch.fields.sdf import ImplicitConfig
from mvsdf_tpu_torch.tracing.sphere_trace import TracerConfig
from mvsdf_tpu_torch.train.loop import Trainer

scene_dir, out, pallas = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
torch.set_num_threads(2)
cfg = tc.MVSDFConfig(
    model=tc.ModelConfig(
        implicit=ImplicitConfig(feature_vector_size=32, dims=(32,) * 2,
                                skip_in=(), multires=4),
        render=RenderConfig(feature_vector_size=32, dims=(32,),
                            multires_view=2),
        tracer=TracerConfig(sphere_tracing_iters=3, n_steps=12,
                            n_secant_steps=2, fill_misses=False),
        use_pallas_trace=pallas),
    train=tc.TrainConfig(batch_size=2, num_pixels=32, nepochs=3,
                         epochs_per_dispatch=2))
sd = SceneData(scene_dir, allow_random_features=True, device="cpu")
res = {}
for trace in (False, True):
    tag = f"trace{int(trace)}"
    t = Trainer(cfg, sd, os.path.join(out, tag), device="cpu",
                log_fn=lambda *a: None, trace=trace,
                trace_dir=os.path.join(out, tag, "tr") if trace else None)
    t.plot = lambda *a, **k: None
    t.run(resume=False)
    opt = t.state.optimizer
    res[tag] = {
        "params": [p.detach().clone() for p in t.state.net.parameters()],
        "moments": [(opt.state[p]["exp_avg"].clone(),
                     opt.state[p]["exp_avg_sq"].clone())
                    for p in t.state.net.parameters()],
        "metrics": open(os.path.join(t.exp_dir, "metrics.jsonl")).read(),
        "chunks": t.tracer.chunks, "spans": t.tracer.spans,
        "summary": t.tracer.summary()}
pickle.dump(res, open(os.path.join(out, "res.pkl"), "wb"))
"""


@pytest.fixture(scope="module", params=[False, True], ids=["plain",
                                                           "pallas"])
def traced_run(request, tmp_path_factory):
    from mvsdf_tpu_torch.data.synthetic import write_scene_dir
    root = tmp_path_factory.mktemp("tracing")
    scene = write_scene_dir(str(root / "s"), n_images=4, img_hw=(24, 32),
                            depth_hw=(12, 16))
    p = subprocess.run(
        [sys.executable, "-c", RUN, scene, str(root),
         str(int(request.param))], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    with open(root / "res.pkl", "rb") as f:
        return pickle.load(f), root


def test_tracing_changes_no_bit_of_the_run(traced_run):
    res, _ = traced_run
    off, on = res["trace0"], res["trace1"]
    for a, b in zip(off["params"], on["params"]):
        assert torch.equal(a, b)
    for (m0, v0), (m1, v1) in zip(off["moments"], on["moments"]):
        assert torch.equal(m0, m1) and torch.equal(v0, v1)
    strip = lambda text: [
        {k: v for k, v in json.loads(line).items()
         if k not in ("wall_s", "rays_per_s", "ms_per_step")}
        for line in text.splitlines()]
    assert strip(off["metrics"]) == strip(on["metrics"])
    assert off["chunks"] == [] and off["spans"] == []


def test_cpu_steps_carry_six_monotone_stamps_and_rows(traced_run):
    res, root = traced_run
    on = res["trace1"]
    chunks = on["chunks"]
    # epochs 0-3, each its own chunk (a save every epoch), 2 steps each
    assert [c["chunk"] for c in chunks] == [0, 1, 2, 3]
    rows = np.concatenate([c["rows"] for c in chunks])
    assert rows.shape == (8, stamp.SLOTS)
    assert all(c["replay"].all() for c in chunks)
    s = rows[:, :stamp.STAMPS]
    assert (np.diff(s, axis=1) >= 0).all()
    assert (s[1:, 0] >= s[:-1, 5]).all()
    assert (rows[:, stamp.ACTIVE] > 0).all()
    assert (rows[:, stamp.ACTIVE] <= rows[:, stamp.COMPUTED]).all()
    # every phase carves, so every chunk's steps projected rows
    assert all(c["projected"] > 0 for c in chunks)
    summ = on["summary"]
    assert summ["steps"] == 8
    stage = sum(summ[f"step_stage_ms.{k}"] for k in
                ("trace", "forward", "backward", "update"))
    assert stage == pytest.approx(summ["stage_sum_ms"])
    total = (s[-1, 5] - s[0, 0]) / 1e6 / 8
    assert stage + summ["replay_gap_ms_per_step"] + \
        summ["chunk_boundary_ms_per_step"] == pytest.approx(total)
    names = {sp[0] for sp in on["spans"]}
    assert {"plan_chunk", "dispatch", "replay", "save",
            "epoch[0]"} <= names
    replay = [sp for sp in on["spans"] if sp[0] == "replay"]
    assert [sp[4] for sp in replay] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [sp[5]["k"] for sp in replay] == [0, 1] * 4
    written = json.load(open(root / "trace1" / "tr" / "spans.json"))
    assert written["otherData"]["summary"]["steps"] == 8


SUMMARY = ("chunk_boundary_ms_per_step", "replay_gap_ms_per_step",
           "replay_host_ms_per_step", "flush_wait_ms_per_step",
           "step_stage_ms.trace", "step_stage_ms.forward",
           "step_stage_ms.backward", "step_stage_ms.update",
           "trace_rows_per_step", "trace_row_fill", "plan_wait_ms_per_step",
           "plan_drawn_ahead_share")


def test_trace_pass_script_on_the_tiny_cell(tmp_path):
    """``scripts/port_trace_pass.py --tiny``: a benchmark cell's set-up and
    window, then tracing switched on and off again around untraced
    chunks; the summary holds every quantity, the traced step on the
    reference's batch asks for the plain reference trace's rows, and
    the plain field's tiles run more."""
    p = subprocess.run(
        [sys.executable, os.path.join("scripts", "port_trace_pass.py"),
         "--workload", "dtu_plain.train_c", "--seed", str(2 ** 31 + 5),
         "--seconds", "0.5", "--chunks", "1", "--tiny", "--out",
         str(tmp_path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    for k in SUMMARY:
        assert isinstance(res["summary"][k], float), k
    assert res["summary"]["steps"] == 8
    assert 0 < res["summary"]["trace_row_fill"] < 100
    assert len(res["boundaries"]) == 1
    assert isinstance(res["boundaries"][0]["plan_wait_ms"], float)
    same = res["same_batch_rows"]
    assert abs(same["active"] - same["reference"]) <= \
        0.01 * same["reference"], same
    assert same["computed"] > same["active"]
    assert set(res["blocks"]) == {"window", "untraced_before", "traced",
                                  "untraced_after"}
    assert os.path.isfile(tmp_path / "dtu_plain.train_c.spans.json")


def _cuda_trainer(tmp_path, trace, pallas=True):
    from mvsdf_tpu_torch import config as tc
    from mvsdf_tpu_torch.data.scene import SceneData
    from mvsdf_tpu_torch.data.synthetic import write_scene_dir
    from mvsdf_tpu_torch.fields.radiance import RenderConfig
    from mvsdf_tpu_torch.fields.sdf import ImplicitConfig
    from mvsdf_tpu_torch.train.loop import Trainer
    scene = write_scene_dir(str(tmp_path / "s"), n_images=4, img_hw=(48, 64),
                            depth_hw=(24, 32))
    cfg = tc.MVSDFConfig(
        model=tc.ModelConfig(
            implicit=ImplicitConfig(feature_vector_size=16, dims=(64,) * 4,
                                    skip_in=(2,)),
            render=RenderConfig(feature_vector_size=16, dims=(64, 64)),
            use_pallas_trace=pallas),
        train=tc.TrainConfig(batch_size=2, num_pixels=512, nepochs=60,
                             epochs_per_dispatch=4))
    sd = SceneData(scene, allow_random_features=True, device="cuda")
    return Trainer(cfg, sd, str(tmp_path / "exp"), device="cuda",
                   log_fn=lambda *a: None, trace=trace)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pallas", [True, False], ids=["kernels", "plain"])
def test_captured_stamps_move_replay_after_replay(cuda, tmp_path, pallas):
    t = _cuda_trainer(tmp_path, True, pallas)
    clock = t.tracer.device_clock
    assert 0 < clock["width_ns"] < 1e6
    t._train_chunk(1, 4)
    t._train_chunk(5, 8)
    t._flush_metrics()
    torch.cuda.synchronize()
    c0, c1 = t.tracer.chunks
    assert not c0["replay"][0] and c0["replay"][1:].all() and \
        c1["replay"].all()
    rows = np.concatenate([c0["rows"][1:], c1["rows"]])
    s = rows[:, :stamp.STAMPS]
    assert (np.diff(s, axis=1) >= 0).all()
    assert (s[1:, 0] > s[:-1, 5]).all()
    assert len(np.unique(s[:, 0])) == len(s)
    assert (rows[:, stamp.ACTIVE] > 0).all()
    assert (rows[:, stamp.ACTIVE] <= rows[:, stamp.COMPUTED]).all()
    summ = t.tracer.summary()
    assert summ["stage_sum_ms"] > 0 and summ["chunk_boundary_ms_per_step"] > 0
    (step,) = t.fused_steps.values()
    assert step.launches["stage_stamp"] == stamp.STAMPS


@pytest.mark.cuda
def test_untraced_capture_launches_no_stamp(cuda, tmp_path):
    from mvsdf_tpu_torch.tracing.kernels import counts
    before = (stamp.stamp.launches, stamp.count.launches)
    t = _cuda_trainer(tmp_path, False)
    t._train_chunk(1, 4)
    t._train_chunk(5, 8)
    t._flush_metrics()
    torch.cuda.synchronize()
    assert (stamp.stamp.launches, stamp.count.launches) == before
    (step,) = t.fused_steps.values()
    assert step.probe is None and not step.launches["stage_stamp"]
    assert not step.launches["stage_count"]
    assert t.tracer.chunks == [] and t.tracer.spans == []
    assert counts.snapshot()["stage_stamp"] == before[0]
