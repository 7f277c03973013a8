"""What CUDA-graph capture of the port's training step meets on the card.

Answers the questions the trainer's graph-replayed chunk path rests on:
  1. syncs: every synchronizing CUDA operation of one eager phase-B step of
     bench_phaseB (torch.cuda.set_sync_debug_mode("warn"), each warning's
     innermost frame in the package), and what a capture of that step
     (after a warm-up on a side stream) refuses first;
  2. generator: whether CUDAGraph.register_generator_state keeps a private
     torch.Generator's draws under replay equal to its eager draws;
  3. cond: whether torch.cond captures (a predicate read on the device,
     each replay taking the branch its predicate says), and whether a
     branch with autograd through it captures;
  4. ctypes: whether the kernels' ctypes launches (sdf_mlp, sdf_mlp_xyz,
     secant, sphere_march) capture, and replay to the eager results;
  5. if_node: whether torch has ``CUDAGraph.begin_capture_to_if_node``;
     whether the port's conditional node (``tracing/kernels/graph_cond``
     through ``compaction.run_if``) captures and follows its predicate;
     and ``compaction.bounded_rows``
     on the training trace's largest block (the fallback's 32,768 rays x
     100 samples): the plain field's SDF column and, for the SDF-MLP
     kernel's count entry, the positional encoding. For counts 0, a
     quarter, a half and all rows: each replay's device ms (CUDA events)
     and its rows below the count against the eager dense call, beside
     the dense call's ms; and no synchronizing op in the replays
     (``set_sync_debug_mode("error")``);
  6. cond_autograd: whether autograd passes through conditional nodes
     under capture: a ``torch.autograd.Function`` whose forward runs the
     full-width ``fields/sdf.full_value_and_grad`` (which calls
     ``torch.autograd.grad(create_graph=True)`` itself) under one
     ``run_if``, and whose backward recomputes it and calls
     ``torch.autograd.grad`` under a second ``run_if`` with the same
     predicate, captured with ``torch.autograd.grad`` of a loss through
     it inside the same capture (as the training step does). The
     backward's recompute reads fresh leaves in place of the parameters
     (``compaction.parameters_as``), as ``compaction._Segment`` does;
     ``cond_autograd_params`` differentiates with respect to the
     parameters themselves instead (run it last: its refusal may end the
     process). Reports the thread and stream the backward ran on, the
     capture's refusal if any (the op's frame), and for the predicate off
     and on: each replay's outputs and gradients against the eager call's
     bits, no sync, the device ms beside the eager call's, and the graph
     and bodies' pools.

    python3 scripts/port_graph_probe.py [--only if_node,...] [--out f]

Prints one JSON object (and writes it to --out if given). Needs a GPU.
"""
import argparse
import faulthandler
import json
import os
import subprocess
import sys
import traceback
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def where(stack):
    """The innermost frame of the port's package in a stack."""
    for f in reversed(stack):
        if "mvsdf_tpu_torch" in f.filename:
            return f"{os.path.relpath(f.filename, REPO)}:{f.lineno} " \
                   f"{f.line.strip() if f.line else ''}"
    return "outside the package"


def step_syncs(step, state, batch, weights, gen):
    import torch
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        found.append(f"{where(traceback.extract_stack()[:-1])}: "
                     f"{str(message).splitlines()[0]}")

    old = warnings.showwarning
    warnings.showwarning = show
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            step(state, batch, weights, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = old
    torch.cuda.synchronize()
    counts = {}
    for f in found:
        counts[f] = counts.get(f, 0) + 1
    return counts


def capture_refusal(fn):
    """fn() warmed up on a side stream, then captured: None, or the first
    error with the package frame it came from."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            fn()
    except Exception as exc:  # what refused, reported
        tb = traceback.extract_tb(exc.__traceback__)
        torch.cuda.synchronize()
        return f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]} " \
               f"at {where(tb)}"
    return None


def probe_generator():
    import torch
    n = 1 << 16
    gen = torch.Generator(device="cuda").manual_seed(7)
    eager = [torch.rand(n, generator=gen, device="cuda") for _ in range(4)]
    gen.manual_seed(7)
    out = {}
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        return {"register_generator_state": False}
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    buf = torch.empty(n, device="cuda")
    # warm-up draws one eager sample (the first), then replays the rest
    first = torch.rand(n, generator=gen, device="cuda")
    with torch.cuda.graph(g):
        buf.copy_(torch.rand(n, generator=gen, device="cuda"))
    reps = []
    for _ in range(3):
        g.replay()
        reps.append(buf.clone())
    torch.cuda.synchronize()
    out["register_generator_state"] = True
    out["eager_first_equal"] = bool(torch.equal(first, eager[0]))
    out["replays_equal_eager"] = [bool(torch.equal(a, b))
                                  for a, b in zip(reps, eager[1:])]
    after = torch.rand(n, generator=gen, device="cuda")
    gen.manual_seed(7)
    for _ in range(4):
        torch.rand(n, generator=gen, device="cuda")
    out["eager_after_replays_equal"] = bool(torch.equal(
        after, torch.rand(n, generator=gen, device="cuda")))
    return out


def probe_cond():
    import torch
    out = {"torch_cond": hasattr(torch, "cond")}
    if not out["torch_cond"]:
        return out
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    pred = torch.zeros((), dtype=torch.bool, device="cuda")
    res = torch.empty(8, device="cuda")

    def body():
        res.copy_(torch.cond(pred, lambda v: v * 2.0, lambda v: v - 1.0,
                             (x,)))

    err = capture_refusal(body)
    out["forward_capture"] = err or "captured"
    if err is None:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            body()
        got = []
        for p in (False, True, False):
            pred.fill_(p)
            g.replay()
            got.append(res.clone())
        torch.cuda.synchronize()
        out["replay_follows_predicate"] = bool(
            torch.equal(got[0], x - 1) and torch.equal(got[1], x * 2) and
            torch.equal(got[2], x - 1))
    w = torch.ones(8, device="cuda", requires_grad=True)
    gbuf = torch.empty(8, device="cuda")

    def grad_body():
        y = torch.cond(pred, lambda v: (v * w).sin(), lambda v: v * w, (x,))
        gbuf.copy_(torch.autograd.grad(y.sum(), w)[0])

    out["autograd_capture"] = capture_refusal(grad_body) or "captured"
    return out


def probe_if_node(state, dev):
    import torch
    from mvsdf_tpu_torch.compaction import bounded_rows, run_if, tile_rows
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.fields.sdf import sdf_apply
    from mvsdf_tpu_torch.tracing.kernels.graph_cond import ConditionalBodies
    out = {"torch_if_node": hasattr(torch.cuda.CUDAGraph,
                                    "begin_capture_to_if_node"),
           "stream_pool": hasattr(torch._C,
                                  "_cuda_beginAllocateCurrentStreamToPool")}
    x = torch.arange(8, dtype=torch.float32, device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    res = torch.zeros(8, device=dev)

    def body():
        res.copy_((x[:, None] * x[None, :]).sum(0))

    g = torch.cuda.CUDAGraph()
    bodies = ConditionalBodies(dev)
    try:
        with torch.cuda.graph(g), bodies:
            res.zero_()
            run_if(pred, body)
    except Exception as exc:  # what refused, reported
        torch.cuda.synchronize()
        return dict(out, capture=f"{type(exc).__name__}: "
                    f"{str(exc).splitlines()[0][:300]}")
    got = []
    for p in (False, True, False):
        pred.fill_(p)
        g.replay()
        got.append(res.clone())
    torch.cuda.synchronize()
    full = (x[:, None] * x[None, :]).sum(0)
    out["replay_follows_predicate"] = bool(
        torch.equal(got[0], torch.zeros_like(x)) and
        torch.equal(got[1], full) and torch.equal(got[2], got[0]))
    g.reset()
    bodies.release()

    net = state.net.implicit
    L = net.cfg.multires
    m = 32768 * 100
    gen = torch.Generator(device=dev).manual_seed(5)
    pts = torch.rand(m, 3, generator=gen, device=dev) * 2 - 1
    count = torch.zeros((), dtype=torch.int32, device=dev)
    arms = {"plain_sdf": (lambda a, c: sdf_apply(net, a),
                          torch.zeros(m, device=dev)),
            "pe": (lambda a, c: positional_encoding(a, L),
                   torch.zeros(m, 3 + 6 * L, device=dev))}
    out["tile_rows"] = tile_rows(m)
    with torch.no_grad():
        for name, (fn, buf) in arms.items():
            dense = fn(pts, None)
            t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t[0].record()
            fn(pts, None)
            t[1].record()
            torch.cuda.synchronize()
            rec = {"dense_ms": t[0].elapsed_time(t[1])}
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            g = torch.cuda.CUDAGraph()
            bodies = ConditionalBodies(dev)
            with torch.cuda.graph(g), bodies:
                bounded_rows(fn, pts, count, buf)
            rec["graph_mib"] = (torch.cuda.memory_reserved(dev) -
                                reserved) / 2 ** 20
            for n in (0, m // 4, m // 2, m):
                count.fill_(n)
                buf.zero_()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    t[0].record()
                    g.replay()
                    t[1].record()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                rec[f"count_{n}"] = {
                    "ms": t[0].elapsed_time(t[1]),
                    "rows_equal_dense": bool(torch.equal(buf[:n],
                                                         dense[:n])),
                    "max_abs_err": float((buf[:n] - dense[:n]).abs().max())
                    if n else 0.0,
                    "past_count_untouched": bool(
                        (buf[-(-n // tile_rows(m)) * tile_rows(m):] == 0
                         ).all())}
            out[name] = rec
            g.reset()
            bodies.release()
            del g, dense
            torch.cuda.empty_cache()
    return out


def probe_cond_autograd(state, dev, leaves=True, n=8192):
    """Probe 6 (module docstring) on ``n`` rows of the bench field."""
    import threading
    import torch
    from mvsdf_tpu_torch.compaction import parameters_as, run_if
    from mvsdf_tpu_torch.fields.sdf import full_value_and_grad
    from mvsdf_tpu_torch.tracing.kernels.graph_cond import ConditionalBodies
    net = state.net.implicit
    params = [p for p in net.parameters()]
    seen = {}

    class Segment(torch.autograd.Function):
        @staticmethod
        def forward(ctx, pred, x, *ps):
            out = x.new_zeros(x.shape[0], 2)
            grad = x.new_zeros(x.shape[0], 3)

            def body():
                o, g = full_value_and_grad(net, x)
                out.copy_(o[..., :2])
                grad.copy_(g)
            run_if(pred, body)
            ctx.save_for_backward(pred, x)
            return out, grad

        @staticmethod
        def backward(ctx, g_out, g_grad):
            pred, x = ctx.saved_tensors
            seen["backward_thread_is_main"] = (
                threading.current_thread() is threading.main_thread())
            seen["backward_stream_capturing"] = (
                torch.cuda.is_current_stream_capturing())
            gx = torch.zeros_like(x)
            gps = [torch.zeros_like(p) for p in params]

            def body():
                ps = [p.detach().requires_grad_(True) for p in params] \
                    if leaves else params
                with torch.enable_grad(), parameters_as(net, ps):
                    xl = x.detach().requires_grad_(True)
                    o, g = full_value_and_grad(net, xl)
                    got = torch.autograd.grad(
                        (o[..., :2], g), [xl] + ps, (g_out, g_grad),
                        allow_unused=True)
                for buf, v in zip([gx] + gps, got):
                    if v is not None:
                        buf.copy_(v)
            run_if(pred, body)
            return (None, gx, *gps)

    gen = torch.Generator(device=dev).manual_seed(6)
    x0 = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
    x = x0.clone().requires_grad_(True)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    outs = [torch.zeros(n, 2, device=dev), torch.zeros(n, 3, device=dev),
            torch.zeros(n, 3, device=dev)] + [torch.zeros_like(p)
                                              for p in params]

    def step():
        o, g = Segment.apply(pred, x, *params)
        loss = (o[:, 0] ** 2).sum() + o[:, 1].sum() + \
            ((g.norm(dim=-1) - 1) ** 2).sum()
        got = torch.autograd.grad(loss, [x] + params)
        with torch.no_grad():   # a copy that records no graph
            for buf, v in zip(outs, [o, g] + list(got)):
                buf.copy_(v)

    def eager(p):
        pred.fill_(p)
        step()
        torch.cuda.synchronize()
        return [t.clone() for t in outs]

    out = {"rows": n, "fresh_leaves": leaves}
    print("cond_autograd: eager", file=sys.stderr, flush=True)
    want = {p: eager(p) for p in (False, True)}
    e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    pred.fill_(True)
    e[0].record()
    step()
    e[1].record()
    torch.cuda.synchronize()
    out["eager_ms"] = e[0].elapsed_time(e[1])
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    bodies = ConditionalBodies(dev)
    print("cond_autograd: capture", file=sys.stderr, flush=True)
    try:
        with torch.cuda.graph(graph), bodies:
            step()
    except Exception as exc:  # what refused, reported
        tb = traceback.extract_tb(exc.__traceback__)
        torch.cuda.synchronize()
        out.update(seen, capture=f"{type(exc).__name__}: "
                   f"{str(exc).splitlines()[0][:300]} at {where(tb)}")
        return out
    torch.cuda.synchronize()
    out.update(seen, capture="captured", pools_mib=(
        torch.cuda.memory_reserved(dev) - reserved) / 2 ** 20)
    print("cond_autograd: replays", file=sys.stderr, flush=True)
    for p in (False, True, False, True):
        pred.fill_(p)
        for t in outs:
            t.fill_(-1.0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            e[0].record()
            graph.replay()
            e[1].record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        diff = [float((a - b).abs().max()) for a, b in zip(outs, want[p])]
        out.setdefault(f"pred_{p}", []).append({
            "ms": e[0].elapsed_time(e[1]),
            "equal_eager": all(torch.equal(a, b)
                               for a, b in zip(outs, want[p])),
            "max_abs_diff": max(diff),
            "grad_x_zero": bool((outs[2] == 0).all())})
    graph.reset()
    bodies.release()
    return out


def probe_kernels(cfg, state, dev):
    import torch
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.tracing.kernels import march_kernel as M
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.tracing.kernels import secant_kernel as S
    from mvsdf_tpu_torch.tracing.sphere_trace import sphere_intersection
    net = state.net.implicit
    packed = K.pack_sdf_weights(net)
    L = net.cfg.multires
    g = torch.Generator(device=dev).manual_seed(3)
    n = 8192
    x = torch.rand(n, 3, generator=g, device=dev) * 2 - 1
    pe = positional_encoding(x, L)
    d = torch.nn.functional.normalize(
        torch.rand(n, 3, generator=g, device=dev) - 0.5, dim=-1)
    o = -2.0 * d + 0.1 * (torch.rand(n, 3, generator=g, device=dev) - 0.5)
    mi, tn, tf = sphere_intersection(o, d, 1.0)
    z_lo = torch.full((n,), 0.5, device=dev)
    z_hi = torch.full((n,), 2.0, device=dev)
    s_lo = K.sdf_mlp_xyz(packed, L, o + z_lo[:, None] * d)
    s_hi = K.sdf_mlp_xyz(packed, L, o + z_hi[:, None] * d)
    calls = {
        "sdf_mlp": lambda: (K.sdf_mlp(packed, pe),),
        "sdf_mlp_xyz": lambda: (K.sdf_mlp_xyz(packed, L, x),),
        "secant": lambda: (S.secant(packed, L, 8, o, d, z_lo, z_hi, s_lo,
                                    s_hi),),
        "sphere_march": lambda: M.sphere_march(cfg.model.tracer, packed, L,
                                               o, d, mi, tn, tf),
    }
    out = {}
    for name, fn in calls.items():
        eager = [t.clone() for t in fn()]
        err = capture_refusal(fn)
        if err is not None:
            out[name] = err
            continue
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = fn()
        equal = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            equal.append(all(torch.equal(a, b) for a, b in zip(outs, eager)))
        out[name] = f"captured; replays equal to eager: {equal}"
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--only", default="generator,cond,kernels,if_node,"
                    "cond_autograd,step_syncs,step_capture",
                    help="comma-separated probes to run")
    args = ap.parse_args()
    only = args.only.split(",")
    faulthandler.enable()
    import torch
    if not torch.cuda.is_available():
        sys.exit("port_graph_probe: needs a CUDA GPU")
    from chip_smoke import B, P, bench_config
    from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
    from mvsdf_tpu_torch.train.step import init_train_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = bench_config()
    batch = scene_to_torch(make_scene(n_images=B, n_pix=P, feat_ch=32,
                                      img_hw=96, depth_hw=48), dev)
    state = init_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, phase_idx=1)
    weights = cfg.schedule.weights(0.3)
    gen = torch.Generator(device=dev).manual_seed(0)
    step(state, batch, weights, gen)
    res = {"card": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    probes = {
        "generator": probe_generator,
        "cond": probe_cond,
        "kernels": lambda: probe_kernels(cfg, state, dev),
        "if_node": lambda: probe_if_node(state, dev),
        "cond_autograd": lambda: probe_cond_autograd(state, dev),
        "cond_autograd_params": lambda: probe_cond_autograd(state, dev,
                                                            leaves=False),
        "step_syncs": lambda: step_syncs(step, state, batch, weights, gen),
        # last: a refused capture may leave the context unusable
        "step_capture": lambda: capture_refusal(
            lambda: step(state, batch, weights, gen)) or "captured"}
    for name, probe in probes.items():
        if name in only:
            res[name] = probe()
            print(json.dumps({name: res[name]}), flush=True)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
