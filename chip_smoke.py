"""Smoke run of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the two trace
configurations of the main path (phase-B training steps of the full-size
model at the bench shapes, then an eval render) through them, trains a
DTU-sized scene directory end to end through the training CLI, evaluates
the checkpoint through the eval CLI, does both again with camera
optimisation, trims the mesh, converts a Vis-MVSNet directory and trains
on it, trains data parallel over two processes, exports the renderer for
serving, draws the figures, trains the shaded scene's 600-epoch capstone
and holds its quality to the JAX package's bars, runs the multi-scan suite
on two synthetic scans, runs the port's bench and driver entry points and
checks that runs repeat to the bit, and prints what it measured.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. build        compile every kernel from the sources in the checkout
  2. kernel       each kernel against its plain version at the main path's
                  widths (tolerances stated below), with timings and bounds;
                  the two SDF-MLP kernels (bf16 tensor-core passes on split
                  operands) are gated by the f32 plain version and, more
                  tightly, by the plain version of the split arithmetic
                  with the tensor cores' sums; their distance from it with
                  f32 sums is printed, and their times at 64 to 65,537
                  rows; the
                  secant and the march, which loop over the same tile, are
                  gated by their f32 plain versions and, more tightly, by
                  the trace's host-driven loops through sdf_mlp_xyz (the
                  same arithmetic on the same points); the march also by a
                  shuffled copy of its rays (equal bits) and its rows
                  evaluated / used beside the scheduler model's; the count
                  entries of kernels 1-3 (sdf_mlp_count, sdf_mlp_xyz_count,
                  secant_count) at count 0, a quarter and all of their
                  capacity: the first count rows equal to the plain entry's
                  kernel bit for bit, the rest 0, all within the plain
                  version's tolerance; their times at those counts; then
                  the bounded blocks' tiles as conditional nodes of a CUDA
                  graph (the plain field on the march's block, the PE on
                  the fallback's) replayed at those counts: the tiles
                  below the count equal the plain call on each tile bit
                  for bit, the rest untouched, no sync; their times;
                  then the SDF
                  network's activation kernel (softplus100: its forward,
                  grad and grad_grad entries, with f32 operands and with
                  the bf16 activations') against the plain chain of
                  PyTorch's ops on 65,536 x 512 operands, uniform,
                  extreme and 473-wide strided (at most SP_ULPS units in
                  the last place of an f32 output, SP_BF16_ULPS of a bf16
                  one, NaN in NaN out), and its times at the supervised
                  groups' rows beside the byte bound; then the
                  supervised cascade (the field's value + gradient on the
                  bench block's 32,768 rows in tiers, the later ones
                  conditional nodes that autograd passes through; tiers
                  (0.375,) and (0.25, 0.5)) with a second-order loss,
                  captured and replayed at count 0, a quarter, one row
                  over the top tier and all rows: outputs and gradients
                  equal to the eager call's bits, no sync, within 1e-4 of
                  the per-epoch pass's with f32 activations (with the
                  bench's bf16 ones the distance is printed); replay
                  times beside the dense call's
  3. train        3 warm-up + 5 timed phase-B steps of bench_phaseB, B=8
                  images x P=4096 rays, full-width model from seed 0, on the
                  synthetic bench scene: the trace through sdf_mlp; then the
                  same step as the trainer's fused dispatch runs it, from
                  seed 0: captured into a CUDA graph (seconds, graph pool),
                  one replay against the eager capturable step (equal
                  bits) and, in its loss terms and gradient norm, against
                  the per-epoch step on the same row (1e-4 relative; the
                  replay's supervised path runs the config's tiers, the
                  per-epoch one the surface rows alone), 5 replays of a
                  plan uploaded in one copy under
                  set_sync_debug_mode("error") (no sync) and their
                  ms/step; sdf_mlp_count in every replay, and the SDF
                  network's activation kernel (its three entries, with
                  the bench's bf16 activations on bf16 operands) in
                  every step and every replay
  4. eval         eval-mode render of one view's 4096 rays; a small render
                  through the kernel against one through the plain field
  5. train_fused  phase 3 in bench_phaseB_fused: the fused march, secant
                  and in-kernel-PE SDF-MLP kernels, and no sdf_mlp; its
                  graph: sphere_march, sdf_mlp_xyz_count, secant_count
                  and the activation kernel's entries in every replay
  6. eval_fused   phase 4 in bench_phaseB_fused; then the march's rows
                  evaluated / used once more, on the field those training
                  steps left
  7. cli          writes a synthetic scene directory at DTU's sizes (49
                  views, 1600x1200 images and masks, 800x600 depth maps),
                  then trains it through the training CLI in this process
                  (--pallas, random FeatExt weights, full-width model, B=8
                  x P=4096, epochs 0..6: phases A, B, C; a checkpoint and a
                  mesh snapshot every epoch, a full render at epoch 4) on
                  its fused default (each phase's step captured once and
                  replayed, sdf_mlp_count and each entry of the
                  activation kernel, f32, in every chunk: the launches
                  the kernels line gives the f32 entries) and gates what it
                  wrote; the host PNG unfilter against its numpy version;
                  phase C's graph: one replay against the eager step
                  (equal bits), an epoch's steps dispatched under
                  set_sync_debug_mode("error"); then resumes from epoch 3
                  with --no_fused (the per-epoch path): the restored state
                  must equal the saved one exactly, epochs 4-6 must repeat
                  the first run's losses within RESUME_RTOL and its
                  epoch-6 parameters within LOOP_RTOL / LOOP_ATOL; ms/step
                  per phase fused and --no_fused, capture s, graph pool
  8. eval         evaluates phase 7's epoch-6 checkpoint through the eval
                  CLI in this process (--pallas --resolution 512
                  --eval_rendering) on a second scene directory at the same
                  sizes with 8 views of 49 (the cut: the checkpoint does not
                  depend on the views); gates its files, a finite PSNR, the
                  sdf_mlp launches (and no other kernel's); holds the
                  kernel's 512^3 grid to the plain field's (TOL) and the
                  native triangulator to the numpy one on a 128^3 grid;
                  times one of the grid's 2,097,152-row sdf_mlp launches
                  beside its plain version and the library chain; prints
                  the mesh's distance to the scene's sphere of radius 0.5
                  from the kernel's 512^3 grid and from the plain field's
  9. cams         gives phase 7's scene directory initial cameras 2 degrees
                  and 1% of their distance off (cameras_linear_init.npz) and
                  trains it through the training CLI with --train_cameras
                  (epochs 0..3: phases A, B, C); gates finite losses,
                  sdf_mlp in every epoch and no other kernel, poses that
                  moved and are finite, moments and moves only on rows a
                  batch drew, and the last checkpoint's camera state
                  restored equal; prints ms/step per phase beside phase 7's
  10. eval_cams   the eval CLI with --eval_cameras on phase 9's last
                  checkpoint (--pallas --resolution 512, no rendering):
                  cameras.txt, finite errors, only sdf_mlp launched; prints
                  the initial and the optimised cameras' errors. Then the
                  trimming CLI (--thresh auto, then 15) on phase 8's 512^3
                  mesh, each native cut held to scipy's max-flow on the same
                  graph: equal flow values and faces removed
  12. convert     the JPEG decoder on every committed fixture (equal to
                  OpenCV's decode) and its ms per megapixel; a Vis-MVSNet
                  directory made of phase 7's scene (its PNG images, depth
                  maps, cam files and pair.txt; probability maps at 1/4,
                  1/2 and 1x with low regions; a binary cut.ply) through
                  the converter CLI in a subprocess: depth maps equal
                  phase 7's times the thresholded masks, image_hd equal to
                  phase 7's images, world_mats within f32 rounding of phase
                  7's; then the training CLI on the converted scene
                  (--nepoch 2) on its plain default (no --pallas: the
                  plain field's trace, each phase's step captured with the
                  field's tiles as conditional nodes and replayed): finite
                  losses, no kernel launched; its last phase's graph: one
                  replay against the eager step (equal bits), an epoch's
                  steps under set_sync_debug_mode("error"); capture s,
                  graph pool, ms/step
  13. ddp         data parallel: epoch 0 (phase A) of phase 7's scene and
                  configuration through the training CLI's Trainer in two
                  processes on this card, a gloo group (NCCL refuses two
                  ranks on one device), 2,048 rays a rank, and beside them
                  in this process alone: the first step's loss terms within
                  DDP_LOSS_RTOL and its gradients within DDP_GRAD_TOL of the
                  single process's, the ranks' parameters equal after the
                  epoch; ms/step per rank and alone, the all-reduce time,
                  sdf_mlp launches per rank. Then the training CLI under
                  python -m torch.distributed.run --nproc_per_node 1 (a NCCL
                  group of one) for epochs 0..1: its files and scene_1.png
  14. export      the serving export of the full-width renderer traced on
                  the card (the plain field, the static trace), saved,
                  loaded and fed phase 7's epoch-6 checkpoint: one
                  EXPORT_CHUNK-ray chunk of view 0 against the live render
                  of the plain field (hit masks agree on EXPORT_AGREE of the
                  rays, rgb within EXPORT_TOL where they agree) and against
                  the live --pallas render (eval_render's gates); the
                  artifact launches the activation kernel's forward and
                  derivative (the operators it recorded) and no other
                  kernel; export, load and render times, peak memory
  15. figures     the scene snapshot of phase 8's mesh with the 49 cameras,
                  and the depth maps of 8 views: PNGs that decode to the
                  expected shapes and are not blank; their seconds
  16. validation  the trained-quality capstone (validation.full_training)
                  in this process: 600 epochs of the shaded scene (12
                  views at 96x96, 11 trained), B=8 x P=4096, full width,
                  seed 0, the trace through sdf_mlp; its ms/step and
                  rays/s by 50-epoch window, the sdf_mlp launches in
                  training and in the 160^3 grid (both gated > 0, no other
                  kernel), and its chamfer, held-out PSNR and indicator
                  accuracy held to the JAX package's reference bars
                  (validation/quality_pin.REFERENCE_BARS); the distance
                  from the port's own pin is printed
  17. suite       two shaded scans (scan24, scan37; 12 views, 96x96
                  images, 48x48 depths) written as scene directories, then
                  validation.dtu_suite in a subprocess: the training CLI
                  (--pallas, 5 epochs), the eval CLI (128^3 grid,
                  rendering PSNR) and the trimming CLI (--thresh auto) on
                  each, every one in a process of its own; gates every
                  CLI's success, SUITE.json's two rows with a PSNR and the
                  reference columns, and logs that name the port's three
                  CLIs alone
  18. bench       the port's bench (python -m mvsdf_tpu_torch.bench) in a
                  subprocess with the default switches and with
                  MVSDF_BENCH_MARCH=1 MVSDF_BENCH_INKPE=1
                  MVSDF_BENCH_SECANT=1: one stdout line each, bench.py's
                  four keys, a finite positive rate; graft_entry.entry() on
                  the card: finite outputs of the stated shapes, no trace
                  kernel (the activation kernel runs);
                  sdf_mlp and secant at the dry run's width 64 against
                  their plain versions, then dryrun_multichip(2), both
                  legs (two gloo ranks and one process on this card, the
                  JAX dry run's bounds); the frozen features computed
                  twice, bench_phaseB run twice from seed 0 for 5 steps,
                  and the fused training CLI run twice (17 views, epochs
                  0..2): equal bits
Every kernel count is set to 0 just before each of phases 3-16 and 18's
entry and reproducibility runs (and phases 3 and 5's graph runs), and
read just after it; a CUDA graph's launches are counted at its capture
and added once per replay (tracing/kernels/counts.py) (phase 17's
kernels, and phase 18's bench and dry run, run in processes of their own:
the bench prints its launches a step, and the dry run's width-64 tiny leg
supplies the launches of the kernels line's width-64 entries). The
line before the last is a JSON object listing each kernel; the last is
{"ok": true, "device": {...}}. Without a GPU it exits non-zero
and prints no result.
"""
import contextlib
import copy
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# bench_phaseB and bench_phaseB_fused: the configurations of the port's
# bench (python -m mvsdf_tpu_torch.bench) with its default switches and
# with MVSDF_BENCH_MARCH=1 MVSDF_BENCH_INKPE=1 MVSDF_BENCH_SECANT=1
from mvsdf_tpu_torch.bench import bench_config, fused_config

B, P = 8, 4096                 # the bench shapes: 8 images x 4096 rays
N_KERNEL = 65537               # ragged row count for the SDF-MLP checks
TOL = 1e-4                     # max |kernel - plain| on |sdf| <~ 1, f32
# the SDF-MLP kernels against the plain version of their split arithmetic
# with the tensor cores' sums (sdf_mlp.tc_k_step) on the first MODEL_ROWS
# rows: 4.8e-6 measured on an H100 (this script's own line), from the
# epilogue's f32 roundings and the SDF column's order of sums
MODEL_ROWS, MODEL_TOL = 4096, 1e-5
# one tile, the path's mean launch, one row more than fills the card's 132
# SMs with 64-row tiles, the check
SIZES = (64, 4096, 8449, N_KERNEL)
SP_ROWS = 65536                # rows of the activation kernel's checks
SP_ULPS = 4                    # its tolerance from the plain chain
SP_BF16_ULPS = 1               # that of its bf16 outputs (f32 values that
                               # may part by SP_ULPS, rounded to bf16)
SP_TIME_ROWS = (12288, 16384, 65536)  # rt_surf's tier, eik's group
# secant roots against the f32 plain version: |dz| <= 1e-4 + 1e-4 |z| (it
# divides by SDF differences) + 2 e / |slope|, where e is the distance of
# the tile's SDF from f32 measured in this run and slope the f32 SDF's
# derivative along the ray at the root, by central differences of SLOPE_H:
# an SDF that is off by e has its root e / |slope| away
SECANT_ATOL = SECANT_RTOL = 1e-4
SLOPE_H = 1e-3
MARCH_AGREE = 0.999            # share of rays whose unfinished masks agree
MARCH_TOL = 1e-4               # |dt| where they agree
# against the host-driven loops through sdf_mlp_xyz, the same tile
# arithmetic on the same points: every mask equal, and
HOST_TOL = 1e-6                # |dt|; |dz| <= HOST_TOL (1 + |z|)
WARMUP, TIMED = 3, 5
# the count entries' checks and times: count 0, this share of the
# capacity, all of it (the tiers the JAX package sizes its compacted
# fallback blocks at run from 1/16 to 3/8 of the rays)
COUNT_SHARE = 0.25
# the supervised cascade's check: the tiers of the bench config and a two
# tier cascade, and, for the field in f32, its bound against the per-epoch
# pass, of each tensor's largest entry (f32 sums over other row blocks and
# GEMM shapes). With the bench config's bf16 activations such a difference
# flips bf16 roundings, which gradients sum: that distance is printed only
CASCADE_FRACS = ((0.375,), (0.25, 0.5))
CASCADE_TOL = 1e-4
PEAK_BF16 = 989e12             # H100 SXM, dense bf16 tensor cores
HBM_BYTES_S = 3.35e12
# the cli phase: a DTU scan's sizes (image_hd is 2x Vis-MVSNet's depth)
CLI_VIEWS, CLI_IMG, CLI_DEPTH = 49, (1200, 1600), (600, 800)
CLI_EPOCHS = 6
CLI_ARGS = ("--pallas", "--allow_random_features", "--nepoch",
            str(CLI_EPOCHS), "--batch_size", str(B), "--num_pixels", str(P))
RESUME_FROM = 3
# the fused run's epoch-6 parameters against the --no_fused resume's: the
# JAX package's bound on its fused and per-epoch paths
# (tests/unit/test_fused_dispatch.py)
LOOP_RTOL, LOOP_ATOL = 2e-5, 2e-6
# the eval phase: views rendered of CLI_VIEWS, the CLI's grid, the grid of
# the kernel / plain and native / numpy checks, the scene's sphere
EVAL_VIEWS = 8
EVAL_RES = 512
EVAL_ARGS = ("--pallas", "--resolution", str(EVAL_RES), "--eval_rendering")
CHECK_RES = 128
SPHERE_R = 0.5
# the camera phases: phase 7's scene directory given initial cameras
# CAMS_NOISE (degrees, share of the distance) off the true ones, trained
# through epochs 0..CAMS_EPOCHS (phases A, B, C, C) with --train_cameras,
# then scored with --eval_cameras; the trimming runs on phase 8's mesh
CAMS_NOISE = (2.0, 0.01)
CAMS_EPOCHS = 3
CAMS_ARGS = ("--pallas", "--allow_random_features", "--train_cameras",
             "--nepoch", str(CAMS_EPOCHS), "--batch_size", str(B),
             "--num_pixels", str(P))
CAMS_EVAL_ARGS = ("--pallas", "--eval_cameras", "--resolution",
                  str(EVAL_RES))
TRIM_THRESHOLDS = ("auto", "15")
# resumed epochs' losses against the first run's, relative (5.6e-5
# measured on an H100 at this size while the resumed run's frozen features
# came from nondeterministic cuDNN convolutions; scene.frozen_features now
# runs them on cuDNN's deterministic algorithms)
RESUME_RTOL = 1e-3
LOSSES = ("loss", "rgb_loss", "eikonal_loss", "depth_loss", "feat_loss",
          "surf_loss")
# the convert phase: phase 7's scene as Vis-MVSNet output; probability
# maps at 1/PROB_DIVS of the depth size, PROB_HIGH with PROB_LOW regions
# (no bilinear sample of them lies near a threshold of 0.8 or 0.7)
PROB_DIVS = (4, 2, 1)
PROB_HIGH, PROB_LOW = 0.95, 0.05
CUT_HALF = 1.1                 # cut.ply: uniform in [-1.1, 1.1]^3
CONVERT_EPOCHS = 2
# the training CLI's plain default: the trace through the plain field
CONVERT_ARGS = ("--allow_random_features", "--nepoch",
                str(CONVERT_EPOCHS), "--batch_size", str(B),
                "--num_pixels", str(P))
REPO = os.path.dirname(os.path.abspath(__file__))
JPEG_FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
# a DTU-sized JPEG (view 0 of phase 7's scene, written by OpenCV) and the
# shape and SHA-256 of OpenCV's decode of it
FULL_VIEW = os.path.join(JPEG_FIXTURES, "view_1600x1200")
JPEG_REPS = 9
# the ddp phase: two ranks against one process, one step, the step
# parity's tolerances (loss terms relative, each gradient tensor against
# its largest entry); the ranks' parameters equal to the bit
DDP_RANKS = 2
DDP_LOSS_RTOL, DDP_GRAD_TOL = 1e-4, 2e-3
DDP_TIMEOUT_S = 300
# the export phase: a chunk of view 0 (rays through the image's middle),
# against the live plain render
EXPORT_CHUNK = 10000
EXPORT_AGREE, EXPORT_TOL = 0.999, 1e-4
# the kernels the artifact launches: the activation's operators, which it
# recorded (the forward, and the derivative of the shading normals'
# reverse pass)
EXPORT_KERNELS = ("softplus100_forward", "softplus100_grad")
DEPTH_VIEWS = 8
# the validation phase: the 600-epoch capstone at full width through the
# kernels, seed 0, gated by the JAX package's quality bars
# (validation/quality_pin.REFERENCE_BARS)
VALIDATION_ARGS = ("--epochs", "600", "--seed", "0")
# the suite phase: two shaded scans written as scene directories, then the
# suite's training, eval and trimming CLIs on each
SUITE_SCANS = ("scan24", "scan37")
SUITE_VIEWS, SUITE_IMG, SUITE_DEPTH = 12, 96, 48
SUITE_ARGS = ("--pallas", "--allow_random_features", "--nepoch", "4",
              "--resolution", "128", "--meshcut_thresh", "auto")
SUITE_CLIS = ("mvsdf_tpu_torch.train.cli", "mvsdf_tpu_torch.eval.cli",
              "mvsdf_tpu_torch.meshcut.cli")
SUITE_TIMEOUT_S = 600
# the bench phase: the bench CLI's time limit, the sdf_mlp rows of the
# width-64 check (the tiny leg's 2 images x 32 rays x 20 samples), the
# steps of each reproducibility run, the views and depth size of the
# features computed twice (the validation scene's)
BENCH_TIMEOUT_S = 600
W64_ROWS = 1280
REPRO_STEPS = 5
REPRO_VIEWS, REPRO_DEPTH = 12, 48
REPRO_CLI_VIEWS = 17           # two steps of B=8 an epoch


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=10):
    """Mean device time of fn() over iters launches after warm-up calls
    (as many, at most 3)."""
    import torch
    for _ in range(min(3, iters)):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(flops, nbytes, peak):
    """(least ms for the work on one H100 at the peak rate of the unit the
    kernel's products run on, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def library_chain(net, x):
    """The SDF column as plain torch library calls at the true widths:
    F.linear + F.softplus(beta=100). A yardstick only."""
    import torch
    import torch.nn.functional as F
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    cfg = net.cfg
    pe = positional_encoding(x, cfg.multires)
    h = pe
    n = len(net.layers)
    for l, layer in enumerate(net.layers):
        if l in cfg.skip_in:
            h = torch.cat([h, pe], -1) * (2 ** -0.5)
        W = layer.effective_weight()
        if l == n - 1:
            return F.linear(h, W[:, :1].T, layer.b[:1])[:, 0]
        h = F.softplus(F.linear(h, W.T, layer.b), beta=100)


def kernel_entry(name, source, replaces, err, ms, plain_ms, flops, nbytes,
                 library_ms):
    """``bound_ms`` takes the function's operations (at the net's true
    widths, counted once, whatever passes the kernel's design spends on
    them) at the bf16 rate of the tensor cores, where every kernel's
    products run."""
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
    log(f"[kernel] {name} {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.3f} ms'}; "
        f"{flops / 1e9:.1f} GFLOP -> bound {bound_ms:.3f} ms at the "
        f"bf16 tensor-core peak, by {bound_by}: {ms / bound_ms:.2f} x the "
        f"bound; "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"name": name, "route": "cuda",
            "source": f"mvsdf_tpu_torch/tracing/kernels/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def check_sdf_mlps(net, packed, x, pe, weight_bytes):
    """sdf_mlp on pe and sdf_mlp_xyz on x, each through its wrapper (the
    counts are zeroed before the main path) against the f32 plain version
    (TOL) and, on MODEL_ROWS rows, the split arithmetic with the tensor
    cores' sums (MODEL_TOL); the distance from the split arithmetic with f32
    sums is printed. Returns the kernels' entries and the time of a
    one-tile launch."""
    import torch
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    L = net.cfg.multires
    flops = K.flops_per_point(net.cfg) * N_KERNEL
    tiles = -(-N_KERNEL // 64)
    log(f"[kernel] split weights: {2 * packed.w_tc.numel() / 1e6:.2f} MB "
        f"streamed from L2 by each 64-row block, "
        f"{tiles * 2 * packed.w_tc.numel() / 1e9:.2f} GB a launch of "
        f"{N_KERNEL} rows")
    ref = K.sdf_mlp_reference(packed, pe)
    split = K.sdf_mlp_split_reference(packed, pe)
    one = K.mlp_chain(packed, pe, lambda a, w, acc: (
        0 if acc is None else acc) + a.bfloat16().float() @ w.bfloat16(
        ).float())
    log(f"[kernel] plain versions on the card, N={N_KERNEL}: max|split - "
        f"f32| = {(split - ref).abs().max().item():.3e}, max|one bf16 pass "
        f"- f32| = {(one - ref).abs().max().item():.3e}")
    tc = K.sdf_mlp_split_reference(packed, pe[:MODEL_ROWS], "tensor_core")
    library_ms = cuda_ms(lambda: library_chain(net, x))
    out = []
    for name, fn, ref_fn, inp, replaces in (
            ("sdf_mlp", lambda: K.sdf_mlp(packed, pe),
             lambda: K.sdf_mlp_reference(packed, pe), pe,
             "mvsdf_tpu/tracing/pallas/sdf_kernel.py:205"),
            ("sdf_mlp_xyz", lambda: K.sdf_mlp_xyz(packed, L, x),
             lambda: K.sdf_mlp_xyz_reference(packed, L, x), x,
             "mvsdf_tpu/tracing/pallas/sdf_kernel.py:205 (in_kernel_pe, "
             "_make_pe_kernel :137)")):
        got, ref = fn(), ref_fn()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"[kernel] {name} N={N_KERNEL}: max|kernel - f32 plain| = "
            f"{err:.3e} (tolerance {TOL:g}), mean {(got - ref).mean():.3e}, "
            f"mean|.| {(got - ref).abs().mean():.3e}; max|kernel - split "
            f"plain| = {(got - split).abs().max():.3e}, mean "
            f"{(got - split).mean():.3e}; split plain - f32 plain: mean "
            f"{(split - ref).mean():.3e}, mean|.| "
            f"{(split - ref).abs().mean():.3e}; max|sdf| = "
            f"{ref.abs().max().item():.3f}")
        d_tc = got[:MODEL_ROWS] - tc
        tc_err = d_tc.abs().max().item()
        log(f"[kernel] {name} against the split arithmetic with the tensor "
            f"cores' sums on {MODEL_ROWS} rows: max|.| = {tc_err:.3e} "
            f"(tolerance {MODEL_TOL:g}), mean {d_tc.mean():.3e}, mean|.| "
            f"{d_tc.abs().mean():.3e}")
        if not (err <= TOL and tc_err <= MODEL_TOL and
                torch.isfinite(got).all()):
            raise AssertionError(f"{name} disagrees with its plain version:"
                                 f" {err}, {tc_err}")
        nbytes = 4 * (inp.numel() + N_KERNEL) + weight_bytes
        out.append(kernel_entry(name, "sdf_mlp.cu", replaces, err,
                                cuda_ms(fn), cuda_ms(ref_fn), flops, nbytes,
                                library_ms))
    for n in SIZES:
        xs, ps = x[:n].contiguous(), pe[:n].contiguous()
        xyz_ms = cuda_ms(lambda: K.sdf_mlp_xyz(packed, L, xs))
        if n == SIZES[0]:
            tile_ms = xyz_ms
        log(f"[kernel] N={n}: sdf_mlp "
            f"{cuda_ms(lambda: K.sdf_mlp(packed, ps)):.4f} ms, sdf_mlp_xyz "
            f"{xyz_ms:.4f} ms, "
            f"library {cuda_ms(lambda: library_chain(net, xs)):.4f} ms")
    return out, tile_ms


def ulps(a, b):
    """Distance in f32 units in the last place of each pair of entries
    (0 for +0 and -0); -1 where exactly one is NaN, 0 where both are."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs()
    d = torch.where(a.isnan() | b.isnan(), torch.full_like(d, -1), d)
    return torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d)


def check_softplus100(dev):
    """The SDF network's activation kernel (csrc/softplus100.cu), each of
    its three entries against its plain version on the card (the chain of
    PyTorch's ops the field ran before), with f32 operands and with the
    bf16 activations' (h written in bf16, g read in bf16, g's cotangent
    written in bf16), on SP_ROWS x 512 operands over uniform z in
    [-0.5, 0.5] and over extremes (|100 z| from 1e-36 to 1e4, both signs,
    zeros), and through the scalar path on a 473-wide view of 512-wide
    rows; NaN where the plain chain has NaN and, elsewhere, at most
    SP_ULPS units in the last place of an f32 output and SP_BF16_ULPS of
    a bf16 one. Times at the supervised groups' row counts beside the
    byte bound. Returns the entries, named as ``counts`` names them."""
    import torch
    from mvsdf_tpu_torch.tracing.kernels import softplus100 as SP
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def extremes(n):
        mag = 10 ** (rand(n, 512) * 40 - 38)
        sign = torch.where(rand(n, 512) < 0.5, -1.0, 1.0)
        z = mag * sign
        z[:, :8] = 0.0
        z[:, 8:16] = -0.0
        return z

    def units(got, ref):
        # bf16 values widened to f32 part by multiples of 2^16 f32 units
        if got.dtype == bf16:
            return ulps(got.float(), ref.float()) // 65536
        return ulps(got, ref)

    def name(entry, dt):
        return f"softplus100_{'bf16_' if dt == bf16 else ''}{entry}"
    entries, worst = {}, {}
    for case in ("uniform", "extremes", "strided"):
        if case == "extremes":
            y, b = extremes(SP_ROWS), torch.zeros(512, device=dev)
        else:
            y, b = rand(SP_ROWS, 512) - 0.5, (rand(512) - 0.5) * 0.1
        g, gg, a = (torch.randn((SP_ROWS, 512), generator=gen, device=dev)
                    for _ in range(3))
        if case == "strided":
            y, b, g, gg, a = (t[..., :473] for t in (y, b, g, gg, a))
            b = b.contiguous()
        for dt in (torch.float32, bf16):
            gd = g.to(dt)
            z, h = SP.forward(y, b, True, dt)
            zr, hr = SP.forward_reference(y, b, dt)
            pairs = {
                "forward": [(z, zr), (h, hr)],
                "grad": [(SP.grad(gd, z), SP.grad_reference(gd, zr)),
                         (SP.grad(gd, z, a), SP.grad_reference(gd, zr, a))],
                "grad_grad": list(zip(SP.grad_grad(gg, gd, z),
                                      SP.grad_grad_reference(gg, gd, zr)))}
            torch.cuda.synchronize()
            for entry, ps in pairs.items():
                key = name(entry, dt)
                for got, ref in ps:
                    u = units(got, ref)
                    if got.dtype != ref.dtype or (u < 0).any() or \
                            not torch.equal(got.isinf(), ref.isinf()):
                        raise AssertionError(
                            f"{key} {case}: NaN or inf where the plain "
                            f"chain has none, or another dtype")
                    prev = worst.get(key, {})
                    k = "bf16" if got.dtype == bf16 else "f32"
                    worst[key] = dict(prev, **{k: max(prev.get(k, 0),
                                                       int(u.max()))},
                                      err=max(prev.get("err", 0.0), (
                                          got.float() - ref.float()
                                      ).abs().nan_to_num(0.0).max().item()),
                                      equal=min(prev.get("equal", 1.0), (
                                          u == 0).float().mean().item()))
                w = worst[key]
                bf16_units = f", {w['bf16']} bf16 ulp" if "bf16" in w else ""
                log(f"[kernel] {key} {case} {tuple(y.shape)}: max "
                    f"{w.get('f32', 0)} f32 ulp{bf16_units}, max|kernel - "
                    f"plain| {w['err']:.3e}, bit-equal share (worst) "
                    f"{w['equal']:.6f}")
    for key, w in worst.items():
        if w.get("f32", 0) > SP_ULPS or w.get("bf16", 0) > SP_BF16_ULPS:
            raise AssertionError(f"{key}: {w} units in the last place from "
                                 f"the plain chain (tolerance {SP_ULPS} "
                                 f"f32, {SP_BF16_ULPS} bf16)")
    nan = torch.tensor([[float("nan"), 0.01]], device=dev)
    for dt in (torch.float32, bf16):
        z, h = SP.forward(nan, torch.zeros(2, device=dev), True, dt)
        one = torch.ones_like(z)
        if not (h[0, 0].isnan() and SP.grad(one.to(dt), z)[0, 0].isnan()
                and all(t[0, 0].isnan() for t in SP.grad_grad(
                    one, one.to(dt), z))):
            raise AssertionError(f"softplus100 ({dt}): NaN in did not give "
                                 f"NaN out")
    # bytes an element: operands read + outputs written, 4 an f32 value and
    # 2 a bf16 one (forward: y, z, h; grad: g, z, a, out; grad_grad: gg, g,
    # z, g's and z's cotangents)
    plans = {"forward": ({torch.float32: 12, bf16: 10},
                         lambda y, b, g, gg, a, z, dt: SP.forward(y, b, True,
                                                                  dt),
                         lambda y, b, g, gg, a, z, dt:
                         SP.forward_reference(y, b, dt)),
             "grad": ({torch.float32: 16, bf16: 14},
                      lambda y, b, g, gg, a, z, dt: SP.grad(g, z, a),
                      lambda y, b, g, gg, a, z, dt:
                      SP.grad_reference(g, z, a)),
             "grad_grad": ({torch.float32: 20, bf16: 16},
                           lambda y, b, g, gg, a, z, dt:
                           SP.grad_grad(gg, g, z),
                           lambda y, b, g, gg, a, z, dt:
                           SP.grad_grad_reference(gg, g, z))}
    for n in SP_TIME_ROWS:
        ops = [rand(n, 512) - 0.5, rand(512) * 0.1, *(rand(n, 512)
                                                      for _ in range(3))]
        ops.append(SP.forward(ops[0], ops[1])[0])
        for dt in (torch.float32, bf16):
            args = ops[:2] + [ops[2].to(dt)] + ops[3:] + [dt]
            for entry, (per, fn, ref_fn) in plans.items():
                key = name(entry, dt)
                ms, plain_ms = cuda_ms(lambda: fn(*args)), cuda_ms(
                    lambda: ref_fn(*args))
                bound_ms = per[dt] * n * 512 / HBM_BYTES_S * 1e3
                log(f"[kernel] {key} {n} x 512: {ms:.4f} ms, plain chain "
                    f"{plain_ms:.4f} ms, byte bound {bound_ms:.4f} ms "
                    f"({bound_ms / ms * 100:.1f}% of it)")
                if n == SP_TIME_ROWS[-1]:
                    w = worst[key]
                    entries[key] = {
                        "name": key, "route": "cuda",
                        "source": "mvsdf_tpu_torch/tracing/kernels/csrc/"
                                  "softplus100.cu",
                        "replaces": "none (XLA fuses the chain in the JAX "
                                    "package)", "launches": None,
                        "max_abs_err": w["err"], "max_ulp": w["f32"],
                        **({"max_bf16_ulp": w["bf16"]} if "bf16" in w
                           else {}),
                        "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes",
                        "library_ms": None}
    return list(entries.values())


def bench_rays(batch, tcfg):
    """The bench batch's 32,768 rays and their bounding-sphere
    intersection, as the trace computes them."""
    from mvsdf_tpu_torch.geometry.cameras import get_camera_params
    from mvsdf_tpu_torch.tracing.sphere_trace import sphere_intersection
    dirs, loc = get_camera_params(batch["uv"], batch["pose"],
                                  batch["intrinsics"])
    org = loc[:, None, :].expand(dirs.shape).reshape(-1, 3).contiguous()
    dirs = dirs.reshape(-1, 3).contiguous()
    mi, t_near, t_far = sphere_intersection(org, dirs,
                                            tcfg.object_bounding_sphere)
    return org, dirs, mi, t_near, t_far


def march_rows(tag, tcfg, packed, L, rays, tile_ms):
    """Runs the march on ``rays`` and prints its rows evaluated / used
    beside the scheduler model's for the same rays, with the model's split
    of the rows whose value no ray kept. Returns (the march's result, [rows
    evaluated, rows used], its time in ms)."""
    import torch
    from mvsdf_tpu_torch.tracing.kernels import march_kernel as M
    dev = rays[0].device
    rows, rows_model = (torch.zeros(2, dtype=torch.int64, device=dev)
                        for _ in range(2))
    got = M.sphere_march(tcfg, packed, L, *rays, rows=rows)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(sms, -(-rays[2].numel() // 32))
    detail = {}
    M.sphere_march_slots_reference(tcfg, packed, L, *rays, rows=rows_model,
                                   blocks=blocks, detail=detail)
    (ev, used), (m_ev, m_used) = rows.tolist(), rows_model.tolist()
    ms = cuda_ms(lambda: M.sphere_march(tcfg, packed, L, *rays))
    log(f"[march rows] {tag}: kernel {ms:.3f} ms, rows evaluated / used "
        f"{ev} / {used} = {ev / used:.3f} ({ev / 64 / blocks:.1f} tile "
        f"evaluations a block x {tile_ms:.4f} ms a one-tile launch = "
        f"{ev / 64 / blocks * tile_ms:.3f} ms); scheduler model on {blocks} "
        f"blocks {m_ev} / {m_used} = {m_ev / m_used:.3f}, its longest block "
        f"{detail['rounds']} evaluations, the queue empty after "
        f"{detail['drained']}, the longest ray {detail['longest_ray']} "
        f"evaluations; of its {m_ev - m_used} rows no "
        f"ray kept, {m_ev - detail['live_rows']} were free slots and "
        f"{detail['live_rows'] - m_used} rows of live rays that waited for "
        f"no value")
    return got, [ev, used], ms


def check_march(icfg, tcfg, packed, rays, weight_bytes, tile_ms):
    import torch
    from mvsdf_tpu_torch.tracing.kernels import march_kernel as M
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.tracing.sphere_trace import _sphere_trace
    L = icfg.multires
    dev = rays[0].device
    rows_ref = torch.zeros(2, dtype=torch.int64, device=dev)
    ref = M.sphere_march_reference(tcfg, packed, L, *rays, rows=rows_ref)
    got, rows, ms = march_rows("seed-0 weights", tcfg, packed, L, rays,
                               tile_ms)
    torch.cuda.synchronize()
    agree = got[0] == ref[0]
    share = agree.float().mean().item()
    err = max((a - b)[agree].abs().max().item()
              for a, b in zip(got[1:], ref[1:]))
    finite = all(torch.isfinite(a).all() for a in got[1:])
    rows_ref = rows_ref.tolist()
    R = rays[2].numel()
    log(f"[kernel] sphere_march R={R} ({int(rays[2].sum())} meet the "
        f"sphere) against the f32 plain version: unfinished masks agree on "
        f"{share:.5f} (>= {MARCH_AGREE}), {int((~agree).sum())} rays differ"
        f"; max|dt| where they agree = {err:.3e} (tolerance {MARCH_TOL:g})"
        f", mean signed dt_s {(got[1] - ref[1])[agree].mean():.3e}, dt_e "
        f"{(got[2] - ref[2])[agree].mean():.3e}; unfinished "
        f"{int(got[0].sum())}, hits {int((got[1] < got[2]).sum())}")
    log(f"[kernel] sphere_march rows evaluated / used of the lockstep "
        f"plain version: {rows_ref[0]} / {rows_ref[1]}")
    # the same arithmetic on the same points: the trace's host-driven march
    # through the sdf_mlp_xyz kernel
    host = _sphere_trace(tcfg, lambda x: K.sdf_mlp_xyz(packed, L, x), *rays)
    h_equal = int((got[0] != host[0]).sum())
    h_err = max((a - b).abs().max().item() for a, b in zip(got[1:], host[1:]))
    log(f"[kernel] sphere_march against the host-driven march through "
        f"sdf_mlp_xyz: {h_equal} masks differ (0), max|dt| = {h_err:.3e} "
        f"(tolerance {HOST_TOL:g})")
    if share < MARCH_AGREE or err > MARCH_TOL or not finite:
        raise AssertionError("sphere_march disagrees with its plain version")
    if h_equal or h_err > HOST_TOL:
        raise AssertionError("sphere_march disagrees with the host-driven "
                             "march on the same arithmetic")
    # scheduling must not reach values
    perm = torch.randperm(R, device=dev)
    shuffled = M.sphere_march(tcfg, packed, L,
                              *(a[perm].contiguous() for a in rays))
    if not all(torch.equal(a[perm], b) for a, b in zip(got, shuffled)):
        raise AssertionError("sphere_march changes with the order of rays")
    log("[kernel] sphere_march on a shuffled copy of the rays: equal bits")
    plain_ms = cuda_ms(lambda: M.sphere_march_reference(tcfg, packed, L,
                                                        *rays), iters=2)
    flops = K.flops_per_point(icfg) * rows[1]
    nbytes = R * (24 + 1 + 8 + 9) + weight_bytes
    return kernel_entry("sphere_march", "march.cu",
                        "mvsdf_tpu/tracing/pallas/march_kernel.py:258", err,
                        ms, plain_ms, flops, nbytes, None)


def check_secant(icfg, tcfg, packed, rays, weight_bytes, tile_ms, sdf_err):
    """Brackets from a plain 100-sample pass over the bench rays: each
    ray's first sign crossing, as the trace's sampler picks it."""
    import torch
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.tracing.kernels import secant_kernel as S
    from mvsdf_tpu_torch.tracing.sphere_trace import _secant
    L = icfg.multires
    org, dirs, mi, t_near, t_far = rays
    o, d = org[mi], dirs[mi]
    S_ = tcfg.n_steps
    ts = t_near[mi][:, None] + torch.linspace(
        0, 1, S_, device=org.device) * (t_far - t_near)[mi][:, None]
    pts = (o[:, None] + ts[..., None] * d[:, None]).reshape(-1, 3)
    v = torch.cat([K.sdf_mlp_xyz_reference(packed, L, c)
                   for c in pts.split(1 << 18)]).reshape(-1, S_)
    weight = torch.arange(S_, 0, -1, dtype=v.dtype, device=v.device)
    ind = torch.argmin(torch.sign(v) * weight, dim=-1)
    r = torch.nonzero((v.gather(1, ind[:, None])[:, 0] < 0) & (ind > 0)
                      )[:, 0]
    i = ind[r]
    args = (o[r].contiguous(), d[r].contiguous(), ts[r, i - 1], ts[r, i],
            v[r, i - 1], v[r, i])
    n = r.numel()
    if n == 0:
        raise AssertionError("no bench ray crosses the surface")
    k = tcfg.n_secant_steps
    got = S.secant(packed, L, k, *args)
    ref = S.secant_reference(packed, L, k, *args)
    host = _secant(k, lambda x: K.sdf_mlp_xyz(packed, L, x), *args)
    # the f32 SDF's slope along each ray at its root: an SDF error e moves
    # a root by e / |slope|
    sdf = lambda z: K.sdf_mlp_xyz_reference(packed, L,
                                            args[0] + z[:, None] * args[1])
    slope = (sdf(ref + SLOPE_H) - sdf(ref - SLOPE_H)).abs() / (2 * SLOPE_H)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    err = diff.max().item()
    plain_gate = SECANT_ATOL + SECANT_RTOL * ref.abs()
    gate = plain_gate + 2 * sdf_err / slope
    worst = torch.argmax(diff / gate)
    log(f"[kernel] secant on {n} bracketed bench rays against the f32 plain "
        f"version: max|dz| = {err:.3e}, mean signed dz "
        f"{(got - ref).mean():.3e}, median |dz| {diff.median():.3e}; "
        f"{int((diff > plain_gate).sum())} rays beyond atol + rtol |z| "
        f"(worst ratio {(diff / plain_gate).max().item():.3f}); worst |dz| /"
        f" (atol + rtol |z| + 2 x {sdf_err:.3e} / |slope|) = "
        f"{(diff / gate).max().item():.3f} (<= 1), on a ray of slope "
        f"{slope[worst].item():.4f}, |dz| {diff[worst].item():.3e}; least "
        f"slope {slope.min().item():.4f}")
    h_diff = (got - host).abs()
    log(f"[kernel] secant against the host-driven secant through "
        f"sdf_mlp_xyz: max|dz| = {h_diff.max().item():.3e}, worst |dz| / "
        f"({HOST_TOL:g} (1 + |z|)) = "
        f"{(h_diff / (HOST_TOL * (1 + host.abs()))).max().item():.3f} (<= 1)")
    if not (diff <= gate).all():
        raise AssertionError("secant disagrees with its plain version")
    if not (h_diff <= HOST_TOL * (1 + host.abs())).all():
        raise AssertionError("secant disagrees with the host-driven secant "
                             "on the same arithmetic")
    ms = cuda_ms(lambda: S.secant(packed, L, k, *args))
    plain_ms = cuda_ms(lambda: S.secant_reference(packed, L, k, *args))
    log(f"[kernel] secant: {-(-n // 64)} blocks of 64 rays, {k} dependent "
        f"evaluations x {tile_ms:.4f} ms a one-tile launch = "
        f"{k * tile_ms:.3f} ms, the floor of any launch")
    flops = K.flops_per_point(icfg) * n * k
    nbytes = n * (36 + 4) + weight_bytes
    entry = kernel_entry("secant", "secant.cu",
                         "mvsdf_tpu/tracing/pallas/secant_kernel.py:137", err,
                         ms, plain_ms, flops, nbytes, None)
    return entry, args, gate


def check_count_entries(net, tcfg, packed, x, pe, sec_args, sec_gate,
                        weight_bytes):
    """The count entries of kernels 1-3 at the checks' capacities (N_KERNEL
    rows for the SDF-MLP, the bracketed bench rays for the secant), each
    at count 0, COUNT_SHARE of the capacity and all of it: the first count
    rows equal the plain entry's kernel on them, bit for bit (the same
    arithmetic), the rest are 0, and the whole is within the plain
    version's tolerance of the count entry's plain version (TOL; the
    secant's gate of check_secant). Returns their kernels-line entries,
    timed at COUNT_SHARE of the capacity, the count the trace's compacted
    blocks typically hold."""
    import torch
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.tracing.kernels import secant_kernel as S
    L = net.cfg.multires
    k = tcfg.n_secant_steps
    n_sec = sec_args[0].shape[0]
    dev = x.device
    cases = (
        ("sdf_mlp_count", N_KERNEL, "sdf_mlp.cu",
         "mvsdf_tpu/tracing/pallas/sdf_kernel.py:205",
         lambda c: K.sdf_mlp_count(packed, pe, c),
         lambda r: K.sdf_mlp(packed, pe[:r]),
         lambda c: K.sdf_mlp_count_reference(packed, pe, c),
         lambda d, ref: d <= TOL, pe.shape[1]),
        ("sdf_mlp_xyz_count", N_KERNEL, "sdf_mlp.cu",
         "mvsdf_tpu/tracing/pallas/sdf_kernel.py:205 (in_kernel_pe, "
         "_make_pe_kernel :137)",
         lambda c: K.sdf_mlp_xyz_count(packed, L, x, c),
         lambda r: K.sdf_mlp_xyz(packed, L, x[:r]),
         lambda c: K.sdf_mlp_xyz_count_reference(packed, L, x, c),
         lambda d, ref: d <= TOL, 3),
        ("secant_count", n_sec, "secant.cu",
         "mvsdf_tpu/tracing/pallas/secant_kernel.py:137",
         lambda c: S.secant_count(packed, L, k, *sec_args, c),
         lambda r: S.secant(packed, L, k, *(a[:r] for a in sec_args)),
         lambda c: S.secant_count_reference(packed, L, k, *sec_args, c),
         lambda d, ref: d <= sec_gate, 9))
    out = []
    for name, cap, src, replaces, fn, kernel, plain, ok, width in cases:
        errs = []
        for rows in (0, int(cap * COUNT_SHARE), cap):
            c = torch.tensor(rows, dtype=torch.int32, device=dev)
            got, ref = fn(c), plain(c)
            first = kernel(rows) if rows else got[:0]
            torch.cuda.synchronize()
            d = (got - ref).abs()
            errs.append(d.max().item())
            if not (torch.equal(got[:rows], first) and
                    not got[rows:].any() and ok(d, ref).all()):
                raise AssertionError(f"{name} at count {rows} of {cap}: "
                                     f"max|count entry - plain| {errs[-1]}")
        rows = int(cap * COUNT_SHARE)
        ms = {}
        for n in (0, rows, cap):
            c = torch.tensor(n, dtype=torch.int32, device=dev)
            ms[n] = cuda_ms(lambda: fn(c))
        log(f"[kernel] {name}, capacity {cap}: the first count rows equal "
            f"the plain entry's kernel bit for bit and the rest are 0 at "
            f"counts 0, {rows} and {cap}; max|count entry - plain version| "
            f"{[f'{e:.3e}' for e in errs]}; "
            f"{ms[0]:.4f} / {ms[rows]:.4f} / {ms[cap]:.4f} ms at those "
            f"counts (the output's zeroing included), the plain entry's "
            f"kernel on the first {rows}: "
            f"{cuda_ms(lambda: kernel(rows)):.4f} ms")
        c = torch.tensor(rows, dtype=torch.int32, device=dev)
        per = K.flops_per_point(net.cfg) * (k if name == "secant_count"
                                            else 1)
        nbytes = 4 * (rows * width + cap) + weight_bytes
        library = None if name == "secant_count" else cuda_ms(
            lambda: library_chain(net, x[:rows]))
        out.append(kernel_entry(name, src, replaces, max(errs), ms[rows],
                                cuda_ms(lambda: plain(c)), per * rows,
                                nbytes, library))
    return out


def check_conditional_nodes(net, x, rays):
    """The bounded blocks' tiles as conditional nodes of a CUDA graph
    (``compaction.bounded_rows`` on ``tracing/kernels/graph_cond``): the
    plain field's SDF column on the march's block (two lanes a bench ray)
    and the positional encoding on the fallback's (n_steps samples a
    bench ray), captured once and replayed at count 0, COUNT_SHARE and all
    rows under set_sync_debug_mode("error"): the tiles below the count
    equal the plain call on each tile's rows bit for bit (what
    ``bounded_rows`` computes; with bf16 activations cuBLAS's bf16
    products choose their kernel, and so their order of sums, by the
    rows, so a call on the whole block may part from the tiles' in the
    last bits), the others keep what they held. Prints each replay's
    device ms beside the plain call's on the whole block."""
    import torch
    from mvsdf_tpu_torch.compaction import bounded_rows, tile_rows
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.fields.sdf import sdf_apply
    from mvsdf_tpu_torch.tracing.kernels.graph_cond import ConditionalBodies
    dev = x.device
    n_rays = rays[0].shape[0]
    g = torch.Generator(device=dev).manual_seed(4)
    arms = (("plain field, march block", 2 * n_rays,
             lambda a, c: sdf_apply(net, a), ()),
            ("positional encoding, fallback block", 100 * n_rays,
             lambda a, c: positional_encoding(a, net.cfg.multires),
             (3 + 6 * net.cfg.multires,)))
    for name, m, fn, width in arms:
        pts = torch.rand((m, 3), generator=g, device=dev) * 2 - 1
        tile = tile_rows(m)
        whole = torch.cat([fn(pts[s:s + tile], None)
                           for s in range(0, m, tile)])
        buf = torch.full((m, *width), -1.0, device=dev)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        graph = torch.cuda.CUDAGraph()
        bodies = ConditionalBodies(dev)
        with torch.cuda.graph(graph), bodies:
            bounded_rows(fn, pts, count, buf)
        ms = []
        for n in (0, int(m * COUNT_SHARE), m):
            count.fill_(n)
            buf.fill_(-1.0)
            torch.cuda.synchronize()
            with sync_debug_error():
                ms.append(cuda_ms(graph.replay, iters=3))
            live = min(-(-n // tile) * tile, m)
            if not (torch.equal(buf[:live], whole[:live]) and
                    (buf[live:] == -1.0).all()):
                raise AssertionError(f"conditional nodes, {name}, count {n}"
                                     f": the tiles differ")
        log(f"[kernel] conditional nodes ({name}, {m} rows in tiles of "
            f"{tile}): replays at counts 0 / {int(m * COUNT_SHARE)} / {m} "
            f"equal the plain call on each tile below the count bit for "
            f"bit and leave the rest, no sync; {ms[0]:.3f} / {ms[1]:.3f} / "
            f"{ms[2]:.3f} ms against {cuda_ms(lambda: fn(pts, None)):.3f} "
            f"ms for the plain call on the whole block")
        graph.reset()
        bodies.release()
        del whole, buf


def check_cascade(net):
    """The supervised cascade (``compaction.bounded_cascade_call_into``) at
    full width on the bench block (B*P rows), in the net's activation
    precision: the rt_surf group's SDF,
    indicator logit and spatial gradient of the field, with a loss that
    reads the gradient (second order) and its gradients with respect to
    the points and the parameters, for the tiers of each of
    CASCADE_FRACS, captured once and replayed at count 0, COUNT_SHARE of
    the rows, one row over the top tier and all rows under
    set_sync_debug_mode("error"): outputs and gradients equal to the
    eager call's bits, and, in f32, within CASCADE_TOL of the per-epoch
    pass's
    (``compact_call_into``, exactly the active rows; the outputs on those
    rows). Prints each replay's device ms beside the dense call's."""
    import torch
    from mvsdf_tpu_torch.compaction import (bounded_cascade_call_into,
                                            compact_call_into)
    from mvsdf_tpu_torch.fields.sdf import full_value_and_grad
    from mvsdf_tpu_torch.tracing.kernels.graph_cond import ConditionalBodies
    dev = next(net.parameters()).device
    bf16 = net.cfg.bf16_activations
    n = B * P
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.rand((n, 3), generator=g, device=dev) * 2 - 1
         ).requires_grad_(True)
    order = torch.randperm(n, generator=g, device=dev)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    targets = [torch.zeros((n, 2), device=dev), torch.zeros((n, 3), device=dev)]
    params = list(net.parameters())
    bufs = [torch.zeros_like(t) for t in targets + [x] + params]

    def fn(p):
        out, grad = full_value_and_grad(net, p)
        return out[..., :2], grad

    def step(call):
        o, gr = call()
        m = mask.float()
        loss = (m * (o[:, 0] ** 2 + o[:, 1] +
                     ((gr ** 2).sum(-1) - 1) ** 2)).sum()
        got = torch.autograd.grad(loss, [x] + params)
        with torch.no_grad():
            for buf, v in zip(bufs, [o, gr, *got]):
                buf.copy_(v)

    def gathered():
        return compact_call_into(fn, mask, [x], targets)

    for fracs in CASCADE_FRACS:
        caps = tuple(max(128, int(n * f)) for f in fracs)

        def cascade(caps=caps):
            return bounded_cascade_call_into(fn, mask, caps, [x], targets,
                                             module=net)
        counts = (0, int(n * COUNT_SHARE), max(caps) + 1, n)
        want, err = {}, 0.0
        for c in counts:
            mask.zero_()[order[:c]] = True
            if c:
                step(gathered)
                ref = [b.clone() for b in bufs]
            step(cascade)
            want[c] = [b.clone() for b in bufs]
            if c:
                act = mask[:, None]
                for i, (a, b) in enumerate(zip(want[c], ref)):
                    if i < 2:
                        a, b = a * act, b * act
                    e = ((a - b).abs().max() / b.abs().max().clamp_min(
                        1e-30)).item()
                    if not (bf16 or e <= CASCADE_TOL):
                        raise AssertionError(
                            f"cascade {fracs}, count {c}: tensor {i} is "
                            f"{e:.3e} of its largest entry from the "
                            f"per-epoch pass's")
                    err = max(err, e)
        mask.fill_(True)
        dense_ms = cuda_ms(lambda: step(lambda: bounded_cascade_call_into(
            fn, mask, (), [x], targets, module=net)), iters=3)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        bodies = ConditionalBodies(dev)
        with torch.cuda.graph(graph), bodies:
            step(cascade)
        pool = (torch.cuda.memory_reserved(dev) - reserved) / 2 ** 20
        ms = []
        for c in counts:
            mask.zero_()[order[:c]] = True
            for b in bufs:
                b.fill_(-1.0)
            torch.cuda.synchronize()
            with sync_debug_error():
                graph.replay()
            torch.cuda.synchronize()
            bad = [i for i, (a, b) in enumerate(zip(bufs, want[c]))
                   if not torch.equal(a, b)]
            with sync_debug_error():
                ms.append(cuda_ms(graph.replay, iters=3))
            if bad:
                raise AssertionError(f"cascade {fracs}, count {c}: a replay "
                                     f"differs from the eager call in "
                                     f"tensors {bad}")
        log(f"[kernel] supervised cascade, {'bf16' if bf16 else 'f32'} "
            f"activations, tiers {caps} of {n} rows (a loss "
            f"on the value + gradient, gradients of points and parameters;"
            f" graph pools {pool:.1f} MiB): replays at counts "
            f"{' / '.join(map(str, counts))} equal the eager call bit for "
            f"bit, no sync; {' / '.join(f'{t:.3f}' for t in ms)} ms "
            f"against {dense_ms:.3f} ms for the dense call; the per-epoch "
            f"pass within {err:.3e} of each tensor's largest entry"
            f"{' (not gated)' if bf16 else f' (bound {CASCADE_TOL})'}")
        graph.reset()
        bodies.release()
        del graph
    del bufs, want
    torch.cuda.empty_cache()


class BatchCache:
    """Serves the bench batch to a CapturableStep whatever its row's
    image and pixel ids say: every bench step takes the same batch, as the
    eager bench steps of phases 3 and 5 do."""

    def __init__(self, batch):
        self.batch = batch
        self.device = batch["uv"].device

    def gather(self, indices, sel):
        return self.batch


@contextlib.contextmanager
def sync_debug_error():
    """Any synchronizing CUDA operation inside raises."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def replay_against_eager(step):
    """The captured step's replay against its eager run from the same
    state, the same row and the same generator state: every tensor it
    writes, bit for bit. Leaves the replay's result in place. Returns the
    names of the tensors that differ with their max |difference|."""
    import torch
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
    step()
    torch.cuda.synchronize()
    return [(i, (a.double() - b.double()).abs().max().item())
            for i, (a, b) in enumerate(zip(written, eager))
            if not torch.equal(a, b)]


def per_epoch_metrics(step):
    """The loss terms, hit_frac and grad norm of the per-epoch step's
    gradients (``mode=GATHERED``: the supervised path on exactly the
    surface rows) on the captured step's state, row and generator state;
    the state, the generator and the kernel counts are left as they
    were."""
    import torch
    from mvsdf_tpu_torch.tracing.kernels import counts as C
    from mvsdf_tpu_torch.train.step import _gradients
    before = C.snapshot()
    gen = step.generator.get_state()
    row = step.row
    batch = step.cache.gather(row[:step.B].long(),
                              row[step.B:step.B + step.P].long())
    *_, shares, gnorm = _gradients(step.cfg, step.gates, step.state, batch,
                                   step.weights, step.generator, None)
    step.generator.set_state(gen)
    C.add({k: -v for k, v in C.since(before).items()})
    return torch.cat([shares, gnorm.reshape(1)]).detach()


def graph_steps(tag, cfg, batch, gen, dev, eager_ms, every):
    """The configuration's phase-B step as the trainer's fused path runs
    it (a CapturableStep captured into a CUDA graph) on the bench batch,
    from seed 0: the capture (its seconds and graph pool); one replay
    against the eager capturable step (equal bits), its loss terms,
    hit_frac and grad norm against the per-epoch step's on the same row
    (within 1e-4 relative + 1e-7, ``tests/test_torch_step.py``'s bounds:
    the supervised path there runs on exactly the surface rows, here on
    the tiers of ``supervised_compact_frac``); TIMED replays of a
    plan uploaded in one copy under set_sync_debug_mode("error") (no
    synchronizing operation), their ms/step beside the eager path's
    ``eager_ms``. Every kernel in ``every`` must launch in a replay.
    Returns the launches of the run (counted from 0 at its start)."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.train.step import (CapturableStep, adam_scalars,
                                            init_train_state)
    state = init_train_state(cfg, seed=0, device=dev)
    step = CapturableStep(cfg, 1, cfg.schedule.weights(0.3), state,
                          BatchCache(batch), gen)
    opt = state.optimizer

    def row(t):
        for _, _, st in step.adam:
            st += 1
        return step.plan_row(np.arange(B), np.arange(P),
                             adam_scalars(opt, t))

    zero_counts()
    step.row.copy_(torch.from_numpy(row(1)))
    step.capture()
    step.row.copy_(torch.from_numpy(row(2)))
    ref = per_epoch_metrics(step)
    bad = replay_against_eager(step)
    got = step.metrics[:ref.numel()]
    # tests/test_torch_step.py's bounds: 1e-4 relative + 1e-7
    off = ((got - ref).abs() - 1e-4 * ref.abs()).max().item()
    rel = ((got - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
    plan = torch.from_numpy(np.stack([row(t) for t in range(3, 3 + TIMED)])
                            ).pin_memory()
    out = torch.empty((TIMED, step.metrics.numel()), device=dev)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with sync_debug_error():
        plan_d = plan.to(dev, non_blocking=True)
        e0.record()
        for k in range(TIMED):
            step.row.copy_(plan_d[k])
            step()
            out[k].copy_(step.metrics)
        e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / TIMED
    launches = counts()
    log(f"[{tag} graph] captured in {step.capture_s:.2f} s, graph pool "
        f"{step.graph_bytes / 2 ** 20:.1f} MiB; one replay against the "
        f"eager capturable step: "
        f"{'equal bits' if not bad else f'{len(bad)} tensors differ {bad[:5]}'}"
        f"; {TIMED} replays under set_sync_debug_mode('error'): no sync, "
        f"{ms:.1f} ms/step against the per-epoch step's {eager_ms:.1f}; "
        f"the replay's loss terms, hit_frac and grad norm within {rel:.3e} "
        f"(relative) of the per-epoch step's on the same row; "
        f"launches a replay {step.launches}; last metrics "
        f"{[round(v, 5) for v in out[-1].tolist()]}")
    if bad:
        raise AssertionError(f"{tag}: a replay differs from the eager step")
    if not off <= 1e-7:
        raise AssertionError(f"{tag}: the replay's metrics are off the "
                             f"per-epoch step's: {got.tolist()} against "
                             f"{ref.tolist()}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{tag}: non-finite metrics under replay")
    for k in every:
        if not step.launches.get(k):
            raise AssertionError(f"{tag}: a replay never launched {k}")
    return launches


def counters():
    from mvsdf_tpu_torch.tracing.kernels import counts as C
    return C.wrappers()


def counts():
    from mvsdf_tpu_torch.tracing.kernels import counts as C
    return C.snapshot()


def zero_counts():
    from mvsdf_tpu_torch.tracing.kernels import counts as C
    C.zero()


def train(tag, cfg, batch, gen, dev, every_step, some_step, never):
    """WARMUP + TIMED phase-B steps from the seed-0 weights; every kernel
    in ``every_step`` must launch in each step, each in ``some_step`` in
    one step at least, none in ``never``. Returns (state, launches,
    (ms/step, peak GiB))."""
    import torch
    from mvsdf_tpu_torch.train.step import init_train_state, make_train_step
    state = init_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, phase_idx=1)
    weights = cfg.schedule.weights(0.3)
    per_step = []

    def run(n):
        for _ in range(n):
            before = counts()
            out = step(state, batch, weights, gen)
            per_step.append({k: v - before[k] for k, v in counts().items()})
        torch.cuda.synchronize()
        return out

    zero_counts()
    t0 = time.perf_counter()
    run(WARMUP)
    log(f"[{tag}] warm-up {WARMUP} steps: {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = run(TIMED)
    dt = (time.perf_counter() - t0) / TIMED
    launches = counts()
    m = {k: float(v) for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] {dt * 1e3:.1f} ms/step, {B * P / dt:.1f} rays/s, hit "
        f"{m['hit_frac']:.4f}, peak memory {peak:.2f} GiB")
    log(f"[{tag}] last step: " + json.dumps(
        {k: round(v, 6) for k, v in m.items()}))
    for k in counters():
        log(f"[{tag}] {k} launches per step: {[s[k] for s in per_step]}")
    if not all(torch.isfinite(torch.tensor(list(m.values())))):
        raise AssertionError(f"non-finite training metrics: {m}")
    for k in every_step:
        if min(s[k] for s in per_step) == 0:
            raise AssertionError(f"a {tag} step never launched {k}")
    for k in some_step:
        if launches[k] == 0:
            raise AssertionError(f"no {tag} step launched {k}")
    for k in never:
        if launches[k]:
            raise AssertionError(f"{tag} launched {k}")
    return state, launches, (dt * 1e3, peak)


def eval_render(tag, cfg, state, batch, must):
    """An eval render of one view through ``cfg``; then 256 of its rays
    against the plain f32 field with the same weights."""
    import torch
    from mvsdf_tpu_torch.rendering.renderer import render_forward
    view = {k: v[:1] for k, v in batch.items()}
    zero_counts()
    with torch.no_grad():
        out = render_forward(cfg.model, state.net, view, training=False)
    torch.cuda.synchronize()
    launches = counts()
    rgb = out.rgb_values
    log(f"[{tag}] rgb {tuple(rgb.shape)}, hit "
        f"{out.network_object_mask.float().mean().item():.4f}, launches "
        f"{launches}")
    if rgb.shape != (1, P, 3) or not torch.isfinite(rgb).all():
        raise AssertionError("eval render is not finite RGB of (1, P, 3)")
    for k in must:
        if launches[k] == 0:
            raise AssertionError(f"the {tag} render never launched {k}")
    small = {"uv": batch["uv"][:1, :256], "pose": batch["pose"][:1],
             "intrinsics": batch["intrinsics"][:1],
             "object_mask": batch["object_mask"][:1, :256]}
    plain_net = copy.deepcopy(state.net)
    plain_net.implicit.cfg = dataclasses.replace(cfg.model.implicit,
                                                 bf16_activations=False)
    plain_cfg = dataclasses.replace(cfg.model, use_pallas_trace=False)
    with torch.no_grad():
        a = render_forward(cfg.model, state.net, small, training=False)
        b = render_forward(plain_cfg, plain_net, small, training=False)
    agree = (a.network_object_mask == b.network_object_mask)
    both = agree & a.network_object_mask
    derr = (a.dists - b.dists)[both].abs().max().item() if both.any() else 0
    log(f"[{tag}] kernels vs plain field on 256 rays: hit masks agree on "
        f"{agree.float().mean().item():.4f}, max |d dists| on common hits "
        f"{derr:.2e}")
    if agree.float().mean().item() < 0.99 or derr > 1e-3:
        raise AssertionError("traced render through the kernels disagrees "
                             "with the plain field")


class Tee(io.TextIOBase):
    """Writes through to ``out`` and keeps a copy of the text."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def check_png_unfilter(data_dir):
    """The host C unfilter against its numpy version on a crop of a view
    (the numpy version takes tens of seconds for a whole one)."""
    import numpy as np
    from mvsdf_tpu_torch.data import png
    view = png.read_png(os.path.join(data_dir, "image_hd", "000.png"),
                        native=True)
    h, w = view.shape[0] // 2, view.shape[1] // 2
    crop = np.ascontiguousarray(view[h - 100:h + 100, w - 125:w + 125])
    raw = crop.reshape(crop.shape[0], -1)
    rows = png.filter_rows(raw, 3)
    kinds = np.bincount(rows[:, 0], minlength=5).tolist()
    same = np.array_equal(png.unfilter(rows, 3, native=True),
                          png.unfilter_reference(rows, 3))
    log(f"[cli] png unfilter: host C function against numpy on a "
        f"{crop.shape[1]}x{crop.shape[0]} crop of a view (rows by filter "
        f"none/sub/up/average/paeth {kinds}): "
        f"{'equal' if same else 'DIFFERENT'}")
    if not same or not np.array_equal(png.unfilter_reference(rows, 3), raw):
        raise AssertionError("the PNG unfilter disagrees with its numpy "
                             "version")


def train_cli(argv, launches):
    """Runs the training CLI in this process, counting the kernel launches
    of each chunk (the fused dispatch) or epoch (--no_fused) into
    ``launches``; returns the trainer."""
    from mvsdf_tpu_torch.train import cli, loop
    runs = {name: getattr(loop.Trainer, name)
            for name in ("train_epoch", "_train_chunk")}

    def counted(run):
        def wrapped(self, *epochs):
            before = counts()
            out = run(self, *epochs)
            launches.append({k: v - before[k] for k, v in counts().items()})
            return out
        return wrapped

    for name, run in runs.items():
        setattr(loop.Trainer, name, counted(run))
    try:
        if "--is_continue" not in argv:
            return cli.main(argv)
        # the CLI's own setup and run, with the restore checked in between
        trainer, _ = cli.setup(argv)
        trainer.maybe_resume(RESUME_FROM)
        check_restored(trainer)
        trainer.run(resume=False)
        return trainer
    finally:
        for name, run in runs.items():
            setattr(loop.Trainer, name, run)


def check_launches(launches, fused=True, pallas=True):
    """A training CLI's kernel launches, by chunk or by epoch: the SDF-MLP's
    count entry in every chunk of a fused run (the captured step's trace),
    sdf_mlp in every epoch of a --no_fused run, and no other trace kernel;
    none of them without --pallas. The SDF network's activation kernel
    runs either way: each of its entries in every chunk of a fused run.
    The counts of rows (``counts.ROWS``) are no launches. Returns (that
    kernel, its launches by chunk or epoch)."""
    from mvsdf_tpu_torch.tracing.kernels.counts import ACT_KERNEL, ROWS
    want = ("sdf_mlp_count" if fused else "sdf_mlp") if pallas else None
    if not launches or (want and min(e[want] for e in launches) == 0) or \
            (fused and min(e[k] for e in launches for k in ACT_KERNEL) == 0) \
            or any(e[k] for e in launches for k in e
                   if k != want and k not in ACT_KERNEL + ROWS):
        raise AssertionError(f"kernel launches by "
                             f"{'chunk' if fused else 'epoch'} {launches}")
    return want, [e[want] if want else 0 for e in launches]


def check_restored(trainer):
    """Just after the restore, everything that was saved is back, exactly."""
    import torch
    from mvsdf_tpu_torch.train import checkpoints as ckpt
    tree, rng = ckpt.load_checkpoint(trainer.ckpt_dir, RESUME_FROM,
                                     map_location=trainer.device)
    st = trainer.state
    bad = [k for k, v in st.net.state_dict().items()
           if not torch.equal(v, tree["net"][k])]
    saved, live = tree["optimizer"], st.optimizer.state_dict()
    for i, s in saved["state"].items():
        bad += [f"adam {i} {k}" for k, v in s.items()
                if not torch.equal(live["state"][i][k].to(v.device), v)]
    bad += [f"lr {g['lr']} != {h['lr']}" for g, h in
            zip(saved["param_groups"], live["param_groups"])
            if g["lr"] != h["lr"]]
    if st.scheduler.state_dict() != tree["scheduler"]:
        bad.append("scheduler")
    if trainer.rng.bit_generator.state != rng["np_rng"]:
        bad.append("numpy RNG")
    if not torch.equal(trainer.generator.get_state(),
                       torch.from_numpy(rng["torch_generator"])):
        bad.append("torch generator")
    if trainer.start_epoch != RESUME_FROM + 1:
        bad.append(f"start epoch {trainer.start_epoch}")
    log(f"[cli] restored from epoch {RESUME_FROM}: {len(st.net.state_dict())}"
        f" tensors, Adam state of {len(saved['state'])} parameters, lr "
        f"{live['param_groups'][0]['lr']:.3e}, scheduler at epoch "
        f"{st.scheduler.last_epoch}, numpy RNG and generator state: "
        f"{'all equal to the saved' if not bad else bad}")
    if bad:
        raise AssertionError(f"restored state differs from the saved: {bad}")


def check_cli_graph(trainer, tag="cli"):
    """After the CLI's fused run, its last phase's graph (the one the
    trainer keeps): one more epoch's plan drawn; its first step replayed
    against the eager capturable step from the same state (equal bits),
    its other steps dispatched as the chunk path does under
    set_sync_debug_mode("error") (no synchronizing operation). Leaves the
    trainer a step ahead of its checkpoint."""
    import torch
    (phase, step), = trainer.fused_steps.items()
    e = trainer.cfg.train.nepochs
    plan, epochs, _ = trainer._plan_chunk(e, e, step)
    step.row.copy_(torch.from_numpy(plan[0]).to(trainer.device))
    bad = replay_against_eager(step)
    with sync_debug_error():
        chunk = trainer._dispatch(step, plan[1:], epochs[1:])
    chunk["done"].synchronize()
    m = chunk["out"]
    log(f"[{tag} graph] phase {'ABC'[phase]}'s captured step: one replay "
        f"against the "
        f"eager capturable step "
        f"{'equal bits' if not bad else f'differs: {bad[:5]}'}; "
        f"{len(epochs) - 1} steps dispatched under set_sync_debug_mode("
        f"'error'): no sync, metrics finite {bool(torch.isfinite(m).all())}"
        f"; launches a replay {step.launches}")
    if bad or not torch.isfinite(m).all():
        raise AssertionError("the CLI's graph differs from its eager step "
                             "or gave non-finite metrics")


def metric_rows(trainer):
    with open(os.path.join(trainer.exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_cli_run(trainer, rows, launches, printed):
    import numpy as np
    from mvsdf_tpu_torch.data import png
    epochs = list(range(CLI_EPOCHS + 1))
    if [r["step"] for r in rows] != epochs:
        raise AssertionError(f"metrics.jsonl rows {[r['step'] for r in rows]}")
    bad = [r["step"] for r in rows
           if not all(np.isfinite(r[k]) for k in LOSSES + ("grad_norm",))]
    if bad:
        raise AssertionError(f"non-finite losses in epochs {bad}")
    phases = [r["phase"] for r in rows]
    if phases != [0, 1, 1, 2, 2, 2, 2]:
        raise AssertionError(f"phases by epoch {phases}")
    # MultiStepLR x0.1 at int(4/6 n) and int(5/6 n), as lr_for_epoch gives
    ms = [int(m * CLI_EPOCHS) for m in (4 / 6, 5 / 6)]
    want = [rows[0]["lr"] * 0.1 ** sum(e >= m for m in ms) for e in epochs]
    if not np.allclose([r["lr"] for r in rows], want, rtol=1e-6, atol=0):
        raise AssertionError(f"lr by epoch {[r['lr'] for r in rows]}")
    kernel, by_chunk = check_launches(launches)
    ck = trainer.ckpt_dir
    steps = sorted(int(d[5:]) for d in os.listdir(ck)
                   if d.startswith("step_"))
    latest = open(os.path.join(ck, "latest.txt")).read()
    if steps != epochs[1:] or latest != str(CLI_EPOCHS):
        raise AssertionError(f"checkpoints {steps}, latest.txt {latest}")
    faces = []
    for e in epochs[1:]:
        with open(os.path.join(trainer.plots_dir, f"surface_{e}.obj")) as f:
            faces.append(sum(line.startswith("f ") for line in f))
    if min(faces) == 0:
        raise AssertionError(f"faces of the mesh snapshots {faces}")
    grid = png.read_png(os.path.join(trainer.plots_dir, "rendering_4.png"),
                        native=True)
    H, W = CLI_IMG
    _, idx, rgb = trainer.last_render
    if grid.shape != (H, 2 * W, 3) or not np.isfinite(rgb).all() or \
            grid[:, :W].std() == 0:
        raise AssertionError(f"rendering_4.png {grid.shape}: rendered half "
                             f"finite {np.isfinite(rgb).all()}, std "
                             f"{grid[:, :W].std()}")
    if "plot failed" in printed:
        raise AssertionError("a mesh snapshot or render failed")
    lrs = [f"{r['lr']:.2e}" for r in rows]
    log(f"[cli] {len(rows)} metric rows, losses finite, phases {phases}, lr "
        f"{lrs}; {kernel} launches by chunk {by_chunk}, the other kernels "
        f"none; "
        f"checkpoints {steps}, latest {latest}; mesh faces {faces}; "
        f"rendering_4.png {grid.shape} (view {idx}), rendered half std "
        f"{grid[:, :W].std():.2f}")


def phase_times(rows, n_rays):
    """ms/step and rays/s per phase over the steps after each epoch's
    first."""
    out = {}
    for ph, name in enumerate("ABC"):
        ms = [r["ms_per_step"] for r in rows if r["phase"] == ph]
        if ms:
            mean = sum(ms) / len(ms)
            out[name] = (mean, n_rays / mean * 1e3, ms)
    return out


def cli_phase(tmp):
    """Phase 7: the training CLI on a DTU-sized scene directory under
    ``tmp``, then its resume. Returns the scene directory, the experiments
    folder, the first run's ms/step per phase and its kernel launches."""
    import torch
    from mvsdf_tpu_torch.data.synthetic import write_scene_dir
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data_dir = write_scene_dir(tmp, n_images=CLI_VIEWS, img_hw=CLI_IMG,
                               depth_hw=CLI_DEPTH)
    log(f"[cli] wrote a {CLI_VIEWS}-view scene directory, images "
        f"{CLI_IMG[1]}x{CLI_IMG[0]}, depth maps {CLI_DEPTH[1]}x"
        f"{CLI_DEPTH[0]}: {time.perf_counter() - t0:.2f} s")
    check_png_unfilter(data_dir)
    argv = ["--data_dir", data_dir, "--exps_folder",
            os.path.join(tmp, "exps"), "--expname", "smoke", *CLI_ARGS]
    tee = Tee(sys.stdout)
    launches = []
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        trainer = train_cli(argv, launches)
    wall = time.perf_counter() - t0
    total = counts()
    rows = metric_rows(trainer)
    check_cli_run(trainer, rows, launches, "".join(tee.text))
    sc = trainer.scene
    log(f"[cli] run 1: {wall:.1f} s in the CLI; scene load "
        f"{sc.timings['load_s']:.2f} s, of which "
        f"{sc.timings['png_decode_s']:.2f} s to decode "
        f"{sc.timings['png_files']} PNGs = "
        f"{sc.timings['png_decode_s'] / sc.timings['png_files'] * 1e3:.1f}"
        f" ms each; FeatExt on {sc.n_images} views "
        f"{sc.timings['featext_s'] * 1e3:.1f} ms (features "
        f"{tuple(sc.feats.shape)}); device scene cache "
        f"{trainer.cache.nbytes()} bytes")
    for name, (ms, rays, each) in phase_times(rows, B * P).items():
        log(f"[cli] phase {name}: {ms:.1f} ms/step, {rays:.1f} rays/s "
            f"(epochs' ms/step after their first step "
            f"{[round(x, 1) for x in each]})")
    t = trainer.timings
    log(f"[cli] checkpoint save ms {[round(x, 1) for x in t['save_ms']]}"
        f"; mesh snapshot ms {[round(x, 1) for x in t['mesh_ms']]}; full "
        f"render of {CLI_IMG[0] * CLI_IMG[1]} rays "
        f"{[round(x, 2) for x in t['render_s']]} s; launches {total}")
    log(f"[cli] the fused dispatch: capture s by phase "
        f"{ {k: round(v, 2) for k, v in t['capture_s'].items()} }, graph "
        f"pool MiB by phase "
        f"{ {k: round(v / 2 ** 20, 1) for k, v in t['graph_bytes'].items()} }"
        f"; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB")
    fused_params = [p.detach().clone() for p in trainer.state.net.parameters()]
    check_cli_graph(trainer)
    del trainer

    # resume from epoch 3 into the same experiment, on the per-epoch path
    resumed = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        trainer2 = train_cli(argv + ["--is_continue", "--checkpoint",
                                     str(RESUME_FROM), "--no_fused"],
                             resumed)
    rows2 = metric_rows(trainer2)[len(rows):]
    if [r["step"] for r in rows2] != list(range(RESUME_FROM + 1,
                                                CLI_EPOCHS + 1)):
        raise AssertionError(f"resumed rows {[r['step'] for r in rows2]}")
    worst = 0.0
    for a, b in zip(rows[RESUME_FROM + 1:], rows2):
        for k in LOSSES:
            d = abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
            worst = max(worst, d)
    log(f"[cli] resumed: {time.perf_counter() - t0:.1f} s, restore "
        f"{trainer2.timings['restore_ms'][0]:.1f} ms; epochs "
        f"{[r['step'] for r in rows2]} losses "
        f"{[round(r['loss'], 6) for r in rows2]} against "
        f"{[round(r['loss'], 6) for r in rows[RESUME_FROM + 1:]]}: worst "
        f"relative difference of a loss term {worst:.3e} (tolerance "
        f"{RESUME_RTOL:g}); sdf_mlp launches by epoch "
        f"{check_launches(resumed, fused=False)[1]}")
    if worst > RESUME_RTOL or "plot failed" in "".join(tee.text):
        raise AssertionError("the resumed run does not repeat the first")
    d = [(a - b).abs() - LOOP_ATOL - LOOP_RTOL * b.abs() for a, b in zip(
        fused_params, trainer2.state.net.parameters())]
    worst_p = max(x.max().item() for x in d)
    log(f"[cli] epoch-6 parameters, fused run against the --no_fused "
        f"resume: max(|d| - atol - rtol |p|) = {worst_p:.3e} (<= 0 at rtol "
        f"{LOOP_RTOL:g}, atol {LOOP_ATOL:g}), max|d| "
        f"{max((a - b).abs().max().item() for a, b in zip(fused_params, trainer2.state.net.parameters())):.3e}")
    fused_t = phase_times(rows, B * P)
    for name, (ms, _, _) in phase_times(rows2, B * P).items():
        log(f"[cli] phase {name}: fused {fused_t[name][0]:.1f} ms/step, "
            f"--no_fused {ms:.1f} ms/step (epochs "
            f"{[r['step'] for r in rows2]})")
    if worst_p > 0:
        raise AssertionError("the fused run and the --no_fused resume part")
    log(f"[cli] peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {"data_dir": data_dir, "exps": os.path.join(tmp, "exps"),
            "times": phase_times(rows, B * P), "launches": total}


def sphere_distance(verts):
    """(mean, max) of | |v| - SPHERE_R | over a mesh's vertices: the
    trained surface's distance to the scene's sphere (the scene's scale
    matrix is the identity, so world and unit frame agree)."""
    import numpy as np
    d = np.abs(np.linalg.norm(verts.astype(np.float64), axis=1) - SPHERE_R)
    return float(d.mean()), float(d.max())


def oriented_faces(faces):
    """Each face rotated to start at its least vertex (keeping its
    orientation), the faces sorted: the faces as a set."""
    import numpy as np
    k = np.argmin(faces, 1)[:, None]
    rolled = np.take_along_axis(faces, (k + np.arange(3)) % 3, 1)
    return rolled[np.lexsort(rolled.T[::-1])]


def check_triangulator(net, dev):
    """The native triangulator against the numpy one on the kernel's grid
    at CHECK_RES^3: equal vertices to the bit, equal faces."""
    import numpy as np
    from mvsdf_tpu_torch.eval.cli import grid_sdf_fn
    from mvsdf_tpu_torch.eval.marching import (eval_sdf_grid,
                                               marching_tetrahedra)
    vol = eval_sdf_grid(grid_sdf_fn(net, True), CHECK_RES, device=dev)
    step = 2.0 / (CHECK_RES - 1)
    kw = dict(spacing=(step,) * 3, origin=(-1.0,) * 3)
    t0 = time.perf_counter()
    nv, nf = marching_tetrahedra(vol, 0.0, native=True, **kw)
    t1 = time.perf_counter()
    pv, pf = marching_tetrahedra(vol, 0.0, **kw)
    t2 = time.perf_counter()
    same_v = np.array_equal(nv, pv)
    same_f = nf.shape == pf.shape and np.array_equal(oriented_faces(nf),
                                                     oriented_faces(pf))
    log(f"[eval] {CHECK_RES}^3 triangulation: native {t1 - t0:.3f} s, "
        f"numpy {t2 - t1:.3f} s; {len(nv)} vertices "
        f"{'equal to the bit' if same_v else 'DIFFERENT'}, {len(nf)} faces "
        f"{'equal' if same_f else 'DIFFERENT'}")
    if not (same_v and same_f and len(nf)):
        raise AssertionError("the native triangulator disagrees with the "
                             "numpy one")


def time_grid_launch(net, dev):
    """Device times of one of the grid's sdf_mlp launches (the first slab
    of eval_sdf_grid's 8 x-planes at EVAL_RES^2 points), of its plain
    version and of the library chain, on the same inputs; returns the
    kernel's ms."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    icfg = net.implicit.cfg
    xs = torch.from_numpy(np.linspace(-1.0, 1.0, EVAL_RES,
                                      dtype=np.float32)).to(dev)
    x = torch.stack(torch.meshgrid(xs[:8], xs, xs, indexing="ij"),
                    -1).reshape(-1, 3)
    with torch.no_grad():
        packed = K.pack_sdf_weights(net.implicit)
        pe = positional_encoding(x, icfg.multires).contiguous()
        ms = cuda_ms(lambda: K.sdf_mlp(packed, pe), iters=5)
        plain_ms = cuda_ms(lambda: K.sdf_mlp_reference(packed, pe), iters=2)
        library_ms = cuda_ms(lambda: library_chain(net.implicit, x), iters=2)
    rows = x.shape[0]
    nbytes = 4 * (pe.numel() + rows) + 2 * packed.w_tc.numel() + \
        4 * (packed.v_tc.numel() + 1)
    bound_ms, by = bound(K.flops_per_point(icfg) * rows, nbytes, PEAK_BF16)
    log(f"[eval] one grid launch of {rows} rows: sdf_mlp {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {library_ms:.3f} ms; bound "
        f"{bound_ms:.3f} ms by {by}, {ms / bound_ms:.2f} x the bound")
    return ms


def eval_phase(tmp, exps, dev):
    """Phase 8: the eval CLI on phase 7's last checkpoint, on a second
    scene directory of EVAL_VIEWS views under ``tmp``."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.config import MVSDFConfig
    from mvsdf_tpu_torch.data.synthetic import write_scene_dir
    from mvsdf_tpu_torch.eval import cli as eval_cli
    from mvsdf_tpu_torch.eval import marching
    from mvsdf_tpu_torch.eval.mesh import biggest_component
    from mvsdf_tpu_torch.fields.network import MVSDFNetwork
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.train import checkpoints as ckpt
    t0 = time.perf_counter()
    data_dir = write_scene_dir(os.path.join(tmp, "eval"),
                               n_images=EVAL_VIEWS, img_hw=CLI_IMG,
                               depth_hw=CLI_DEPTH)
    log(f"[eval] views {EVAL_VIEWS} of {CLI_VIEWS}: wrote a second scene "
        f"directory at the same sizes in {time.perf_counter() - t0:.2f} s")
    evals = os.path.join(tmp, "evals")
    argv = ["--data_dir", data_dir, "--exps_folder", exps, "--expname",
            "smoke", "--evals_folder", evals, *EVAL_ARGS]
    grid_launches = []
    eval_sdf_grid = marching.eval_sdf_grid

    def counted_grid(*a, **kw):
        before = K.sdf_mlp.launches
        out = eval_sdf_grid(*a, **kw)
        grid_launches.append(K.sdf_mlp.launches - before)
        return out

    marching.eval_sdf_grid = counted_grid
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    try:
        result = eval_cli.main(argv)
    finally:
        marching.eval_sdf_grid = eval_sdf_grid
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    evaldir = os.path.join(evals, "smoke")
    e = result.epoch
    want = [f"surface_world_coordinates_{e}.obj", f"scene_{e}.html",
            "psnr.txt"] + [os.path.join("rendering", f"eval_{i:03d}.png")
                           for i in range(EVAL_VIEWS)]
    missing = [f for f in want if not os.path.isfile(os.path.join(evaldir,
                                                                  f))]
    psnrs = np.asarray(result.psnrs)
    t = result.timings
    rows = EVAL_RES ** 3
    flops = K.flops_per_point(MVSDFConfig().model.implicit) * rows
    grid_bound = flops / PEAK_BF16
    log(f"[eval] the eval CLI: {wall:.1f} s; epoch {e}; grid {EVAL_RES}^3 "
        f"= {rows} rows through sdf_mlp in {grid_launches} launches: "
        f"{t['grid_s']:.3f} s (bound {grid_bound:.3f} s at the bf16 "
        f"tensor-core peak, {t['grid_s'] / grid_bound:.2f} x); "
        f"triangulation {t['triangulate_s']:.3f} s; mesh "
        f"{len(result.verts)} vertices {len(result.faces)} faces; render "
        f"{np.mean(t['render_s']):.2f} s a view "
        f"{[round(x, 2) for x in t['render_s']]}; PSNR mean "
        f"{psnrs.mean():.4f} std {psnrs.std():.4f}; launches {launches}; "
        f"peak memory {peak:.2f} GiB")
    if missing or len(psnrs) != EVAL_VIEWS or not np.isfinite(psnrs).all():
        raise AssertionError(f"eval outputs: missing {missing}, PSNRs "
                             f"{psnrs}")
    if e != CLI_EPOCHS or launches["sdf_mlp"] == 0 or any(
            launches[k] for k in ("sdf_mlp_xyz", "secant", "sphere_march")):
        raise AssertionError(f"eval of epoch {e}, launches {launches}")

    # the same checkpoint through the plain field: its grid against the
    # kernel's, the triangulator, one grid launch's times, the surface
    stamp = sorted(os.listdir(os.path.join(exps, "smoke")))[-1]
    tree, _ = ckpt.load_checkpoint(
        os.path.join(exps, "smoke", stamp, "checkpoints"), None,
        map_location=dev)
    model = MVSDFConfig().model
    net = MVSDFNetwork(model.implicit, model.render).to(dev)
    net.load_state_dict(tree["net"])
    t0 = time.perf_counter()
    vol = marching.eval_sdf_grid(eval_cli.grid_sdf_fn(net, False), EVAL_RES,
                                 device=dev)
    plain_s = time.perf_counter() - t0
    d = result.grid - vol
    err = float(np.abs(d).max())
    log(f"[eval] {EVAL_RES}^3 grid through sdf_mlp against the plain "
        f"field's ({plain_s:.3f} s): max|d sdf| = {err:.3e} (tolerance "
        f"{TOL:g}), mean signed {d.mean():.3e}, "
        f"{int((np.sign(result.grid) != np.sign(vol)).sum())} signs differ")
    del d
    if not (err <= TOL and np.isfinite(result.grid).all()):
        raise AssertionError("the kernel's grid disagrees with the plain "
                             "field's")
    check_triangulator(net, dev)
    launch_ms = time_grid_launch(net, dev)
    log(f"[eval] the grid's wall time in the CLI {t['grid_s']:.3f} s, of "
        f"which {sum(grid_launches)} launches x {launch_ms:.3f} ms = "
        f"{sum(grid_launches) * launch_ms / 1e3:.3f} s in the kernel")
    pv, pf = biggest_component(*marching.mesh_from_grid(vol))
    k_mean, k_max = sphere_distance(result.verts)
    p_mean, p_max = sphere_distance(pv)
    log(f"[eval] trained surface against the sphere of radius {SPHERE_R}: "
        f"| |v| - {SPHERE_R} | mean {k_mean:.6e} max {k_max:.6e} from the "
        f"kernel's {EVAL_RES}^3 grid ({len(result.verts)} vertices); mean "
        f"{p_mean:.6e} max {p_max:.6e} from the plain field's {EVAL_RES}^3 "
        f"grid ({len(pv)} vertices); kernel - plain: mean "
        f"{k_mean - p_mean:.3e}, max {k_max - p_max:.3e}")
    if not (np.isfinite([k_mean, p_mean]).all() and len(pf)):
        raise AssertionError("no trained surface to measure")
    return result.verts, result.faces


def cams_phase(tmp, data_dir, cli_times):
    """Phase 9: the training CLI with --train_cameras on phase 7's scene
    directory, given initial cameras CAMS_NOISE off the true ones. Returns
    its experiments folder."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.data.synthetic import write_pose_init
    from mvsdf_tpu_torch.train import checkpoints as ckpt
    from mvsdf_tpu_torch.train import loop
    from mvsdf_tpu_torch.train.cameras_opt import pose_vecs_from_matrices
    from mvsdf_tpu_torch.train.step import init_train_state
    write_pose_init(data_dir, *CAMS_NOISE)
    exps = os.path.join(tmp, "exps_cams")
    argv = ["--data_dir", data_dir, "--exps_folder", exps, "--expname",
            "cams", *CAMS_ARGS]
    drawn = []                  # each step's image indices
    plan_chunk = loop.Trainer._plan_chunk

    def recorded(self, e0, e1, step):
        # the fused path's plan: a row a step, the B image indices first
        plan, epochs, n_sel = plan_chunk(self, e0, e1, step)
        drawn.extend(torch.from_numpy(plan[:, :step.B]).long())
        return plan, epochs, n_sel

    tee = Tee(sys.stdout)
    launches = []
    loop.Trainer._plan_chunk = recorded
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            trainer = train_cli(argv, launches)
    finally:
        loop.Trainer._plan_chunk = plan_chunk
    wall = time.perf_counter() - t0
    rows = metric_rows(trainer)
    epochs = list(range(CAMS_EPOCHS + 1))
    sched = trainer.cfg.schedule
    phases = [r["phase"] for r in rows]
    if [r["step"] for r in rows] != epochs or phases != [
            sched.phase_index(e / CAMS_EPOCHS) for e in epochs] or not all(
                np.isfinite(r[k]) for r in rows for k in LOSSES):
        raise AssertionError(f"camera run's metric rows {rows}")
    kernel, by_chunk = check_launches(launches)
    if "plot failed" in "".join(tee.text):
        raise AssertionError("a mesh snapshot failed")
    st = trainer.state
    n = trainer.scene.n_images
    pv0 = torch.from_numpy(pose_vecs_from_matrices(trainer.scene.pose_init))
    pv = st.pose_vecs.cpu()
    moved = (pv - pv0).abs().amax(1)
    seen = torch.zeros(n, dtype=torch.bool)
    seen[torch.cat(drawn).cpu()] = True
    m_rows = (st.cam_opt.m.cpu() != 0).any(1)
    log(f"[cams] {len(drawn)} steps drew {int(seen.sum())} of {n} images; "
        f"poses moved by max|d| {moved.max().item():.3e} (mean "
        f"{moved.mean().item():.3e}), {int((moved > 0).sum())} rows moved, "
        f"{int(m_rows.sum())} rows with nonzero moments, SparseAdam step "
        f"{int(st.cam_opt.step)}; {kernel} launches by chunk {by_chunk}, "
        f"the other kernels none")
    if not torch.isfinite(pv).all() or moved.max() == 0 or \
            (m_rows & ~seen).any() or (moved[~seen] > 0).any():
        raise AssertionError("the poses did not move, are not finite, or "
                             "moved on rows no batch drew")
    # the last checkpoint's camera state, restored into a fresh state
    fresh = init_train_state(trainer.cfg, seed=trainer.cfg.train.seed,
                             device=trainer.device,
                             pose_init=trainer.scene.pose_init)
    ckpt.restore_checkpoint(trainer.ckpt_dir, CAMS_EPOCHS, fresh)
    same = [torch.equal(getattr(fresh.cam_opt, k), getattr(st.cam_opt, k))
            for k in ("m", "v", "step")]
    same.append(torch.equal(fresh.pose_vecs, st.pose_vecs))
    log(f"[cams] restored epoch {CAMS_EPOCHS}'s camera state (m, v, step, "
        f"pose_vecs): {'equal to the saved' if all(same) else same}")
    if not all(same):
        raise AssertionError("restored camera state differs from the saved")
    sc = trainer.scene
    log(f"[cams] run: {wall:.1f} s in the CLI; scene load "
        f"{sc.timings['load_s']:.2f} s, FeatExt "
        f"{sc.timings['featext_s'] * 1e3:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for name, (ms, rays, each) in phase_times(rows, B * P).items():
        ref = cli_times.get(name)
        log(f"[cams] phase {name}: {ms:.1f} ms/step, {rays:.1f} rays/s "
            f"(epochs' {[round(x, 1) for x in each]}); phase 7 without "
            f"cameras: " + (f"{ref[0]:.1f} ms/step" if ref else "none"))
    return exps


def error_summary(acc):
    """(R error mean, t error mean, R median, t median) of a
    ``camera_accuracy`` dict, as the eval CLI's CAMERAS EVALUATION line
    reports them."""
    import numpy as np
    e_R, e_t = acc["R_errors_deg"], acc["t_errors"]
    return (float(e_R.mean()), float(e_t.mean()), float(np.median(e_R)),
            float(np.median(e_t)))


def initial_camera_errors(data_dir):
    """The scene's initial cameras (cameras_linear_init.npz, in the
    training frame), scored against the ground truth as the eval CLI
    scores the optimised ones: through their 7-d rows."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.eval.cameras import camera_accuracy
    from mvsdf_tpu_torch.geometry.cameras import (decompose_projection,
                                                  quat_to_rot)
    from mvsdf_tpu_torch.train.cameras_opt import pose_vecs_from_matrices

    def poses(name, scaled):
        cams = np.load(os.path.join(data_dir, name))
        n = sum(k.startswith("world_mat_") for k in cams.files)
        return np.stack([decompose_projection(
            (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"] if scaled
             else cams[f"world_mat_{i}"])[:3, :4])[1] for i in range(n)])

    pv = pose_vecs_from_matrices(poses("cameras_linear_init.npz", True))
    R = quat_to_rot(torch.from_numpy(pv[:, :4])).numpy()
    gt = poses("cameras_hd.npz", False)
    return error_summary(camera_accuracy(R, pv[:, 4:].astype(np.float64),
                                         gt[:, :3, :3], gt[:, :3, 3]))


def eval_cams_phase(tmp, data_dir, exps, dev):
    """Phase 10, first half: the eval CLI with --eval_cameras on phase 9's
    last checkpoint."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.eval import cli as eval_cli
    evals = os.path.join(tmp, "evals_cams")
    argv = ["--data_dir", data_dir, "--exps_folder", exps, "--expname",
            "cams", "--evals_folder", evals, *CAMS_EVAL_ARGS]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    result = eval_cli.main(argv)
    wall = time.perf_counter() - t0
    launches = counts()
    evaldir = os.path.join(evals, "cams")
    acc = result.cameras
    opt = error_summary(acc)
    init = initial_camera_errors(data_dir)
    t = result.timings
    log(f"[eval_cams] the eval CLI: {wall:.1f} s; epoch {result.epoch}; "
        f"grid {t['grid_s']:.3f} s, triangulation {t['triangulate_s']:.3f} "
        f"s; mesh in the ground-truth frame {len(result.verts)} vertices "
        f"{len(result.faces)} faces; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"[eval_cams] cameras against the ground truth, R error mean / t "
        f"error mean / R median / t median: initial "
        f"{' / '.join(f'{x:.6f}' for x in init)}; optimised "
        f"{' / '.join(f'{x:.6f}' for x in opt)}; similarity scale "
        f"{acc['scale']:.6f}; R error mean "
        f"{'fell' if opt[0] < init[0] else 'did not fall'}, t error mean "
        f"{'fell' if opt[1] < init[1] else 'did not fall'}")
    want = ["cameras.txt", f"surface_world_coordinates_{result.epoch}.obj",
            f"scene_{result.epoch}.html"]
    missing = [f for f in want if not os.path.isfile(os.path.join(evaldir,
                                                                  f))]
    if missing or not np.isfinite(opt + init).all() or \
            result.epoch != CAMS_EPOCHS or len(result.faces) == 0:
        raise AssertionError(f"camera eval: missing {missing}, errors "
                             f"{opt} from {init}, epoch {result.epoch}")
    if launches["sdf_mlp"] == 0 or any(
            launches[k] for k in ("sdf_mlp_xyz", "secant", "sphere_march")):
        raise AssertionError(f"camera eval launches {launches}")


def trim_phase(tmp, obj):
    """Phase 10, second half: the trimming CLI on ``obj`` at each of
    TRIM_THRESHOLDS; each native cut held to the plain version (scipy's
    max-flow) on the same graph: equal flow values, equal faces
    removed."""
    import numpy as np
    from mvsdf_tpu_torch.meshcut import cli as trim_cli
    from mvsdf_tpu_torch.meshcut import cut
    calls, adj_s = [], []
    maxflow, adjacency = cut.maxflow_cut, cut.face_adjacency_edges

    def timed_maxflow(labels, edges):
        t0 = time.perf_counter()
        flow, side = maxflow(labels, edges)
        calls.append((labels, edges, flow, side, time.perf_counter() - t0))
        return flow, side

    def timed_adjacency(faces):
        t0 = time.perf_counter()
        out = adjacency(faces)
        adj_s.append(time.perf_counter() - t0)
        return out

    cut.maxflow_cut, cut.face_adjacency_edges = timed_maxflow, \
        timed_adjacency
    try:
        for thresh in TRIM_THRESHOLDS:
            out = os.path.join(tmp, f"trimmed_{thresh}.obj")
            tee = Tee(sys.stdout)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                trim_cli.main([obj, out, "--thresh", thresh])
            wall = time.perf_counter() - t0
            labels, edges, flow, side, cut_s = calls[-1]
            t0 = time.perf_counter()
            ref_flow, ref_side = cut.maxflow_cut_reference(labels, edges)
            scipy_s = time.perf_counter() - t0
            same = ref_flow == flow and np.array_equal(ref_side, side)
            log(f"[trim] --thresh {thresh}: {wall:.2f} s in the CLI on "
                f"{len(labels)} faces ({int(labels.sum())} source-linked), "
                f"{len(edges)} adjacency edges in {adj_s[-1]:.3f} s; native "
                f"cut {cut_s:.3f} s, flow {flow}, {int(side.sum())} faces "
                f"removed; scipy's max-flow on the same graph {scipy_s:.3f} "
                f"s, flow {ref_flow}, {int(ref_side.sum())} removed: "
                f"{'equal' if same else 'DIFFERENT'}")
            if not same or not os.path.isfile(out):
                raise AssertionError(f"the native cut at --thresh {thresh} "
                                     f"disagrees with scipy's")
    finally:
        cut.maxflow_cut, cut.face_adjacency_edges = maxflow, adjacency


def check_jpeg_fixtures():
    """Every committed JPEG fixture decoded equal to its committed OpenCV
    decode (the 1600x1200 view: to the SHA-256 of it), the progressive one
    refused naming the file; the decoder's ms per megapixel on the
    1600x1200 view, the median of JPEG_REPS decodes."""
    import glob
    import numpy as np
    from mvsdf_tpu_torch.data import jpeg
    from mvsdf_tpu_torch.data.convert import imread_color
    t0 = time.perf_counter()
    jpeg._lib()
    build_s = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(JPEG_FIXTURES, "*.jpg")))
    prog = [p for p in paths if "progressive" in os.path.basename(p)]
    small = [p for p in paths if os.path.exists(p[:-4] + ".npy")]
    bad = [os.path.basename(p) for p in small
           if not np.array_equal(imread_color(p), np.load(p[:-4] + ".npy"))]
    want = full_view_decode()
    full = imread_color(FULL_VIEW + ".jpg")
    full_ok = (list(full.shape) == want["shape"] and
               sha256(full) == want["sha256"])
    refused = []
    for p in prog:
        try:
            jpeg.read_jpeg(p)
        except ValueError as e:
            refused.append(p in str(e) and "progressive" in str(e))
    data = open(FULL_VIEW + ".jpg", "rb").read()
    mpix = full.shape[0] * full.shape[1] / 1e6
    times = []
    for _ in range(JPEG_REPS):
        t0 = time.perf_counter()
        jpeg.decode_jpeg(data)
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    log(f"[convert] JPEG decoder: built in {build_s:.2f} s; {len(small)} "
        f"small fixtures {'all equal to' if not bad else f'{bad} differ from'}"
        f" their OpenCV decodes; the {full.shape[1]}x{full.shape[0]} view "
        f"{'equal to' if full_ok else 'DIFFERS from'} OpenCV's decode "
        f"(SHA-256); {len(prog)} progressive refused naming the file: "
        f"{all(refused) and len(refused) == len(prog)}; the "
        f"{full.shape[1]}x{full.shape[0]} view ({len(data)} bytes) in "
        f"{ms:.3f} ms = {ms / mpix:.3f} ms per megapixel (median of "
        f"{JPEG_REPS}, range {min(times) * 1e3:.3f}-{max(times) * 1e3:.3f} "
        f"ms)")
    if bad or not full_ok or not prog or not all(refused) or \
            len(refused) != len(prog):
        raise AssertionError("the JPEG decoder disagrees with its fixtures")


def full_view_decode():
    with open(FULL_VIEW + ".json") as f:
        return json.load(f)


def sha256(img):
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def bilinear_np(a, size):
    """The samples of cv2.resize(INTER_LINEAR) / F.interpolate(bilinear,
    align_corners=False) in float64: a plain reference."""
    import numpy as np

    def taps(n_out, n_in):
        src = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0)
        i0 = np.minimum(np.floor(src).astype(int), n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), src - i0

    y0, y1, ly = taps(size[0], a.shape[0])
    x0, x1, lx = taps(size[1], a.shape[1])
    a = a.astype(np.float64)
    top = a[y0][:, x0] * (1 - lx) + a[y0][:, x1] * lx
    bot = a[y1][:, x0] * (1 - lx) + a[y1][:, x1] * lx
    return top * (1 - ly)[:, None] + bot * ly[:, None]


def write_vis_dir(vis, data_dir):
    """Phase 7's scene as Vis-MVSNet output under ``vis``; returns each
    view's expected mask (the thresholds of the probability maps through
    the float64 reference resize) and the cut's normalised sphere
    radius."""
    import shutil
    import numpy as np
    from mvsdf_tpu_torch.data import formats
    from mvsdf_tpu_torch.data.convert import (scene_bbox_from_points,
                                              write_ply_points)
    root = os.path.dirname(data_dir)
    os.makedirs(vis)
    shutil.copyfile(os.path.join(root, "pair.txt"),
                    os.path.join(vis, "pair.txt"))
    h, w = CLI_DEPTH
    masks = []
    for i in range(CLI_VIEWS):
        stem = f"{i:08}"
        shutil.copyfile(os.path.join(data_dir, "image_hd", f"{i:03}.png"),
                        os.path.join(vis, stem + ".png"))
        shutil.copyfile(os.path.join(data_dir, "depth", f"{i:03}.pfm"),
                        os.path.join(vis, f"{stem}_flow3.pfm"))
        shutil.copyfile(os.path.join(root, f"cam_{stem}_flow3.txt"),
                        os.path.join(vis, f"cam_{stem}_flow3.txt"))
        mask = np.ones((h, w), bool)
        for s, (div, th) in enumerate(zip(PROB_DIVS, (0.8, 0.7, 0.8))):
            ph, pw = h // div, w // div
            prob = np.full((ph, pw), PROB_HIGH, np.float32)
            if i % 3 == s:       # a low region on one map a view
                prob[ph // 5:ph // 2, pw // 4 + i % 7:pw // 2] = PROB_LOW
            formats.write_pfm(os.path.join(vis, f"{stem}_flow{s + 1}_prob"
                                                f".pfm"), prob)
            mask &= (bilinear_np(prob, (h, w)) if div > 1 else prob) > th
        masks.append(mask)
    pts = np.random.default_rng(0).uniform(-CUT_HALF, CUT_HALF, (20000, 3))
    write_ply_points(os.path.join(vis, "cut.ply"), pts, binary=True)
    _, size = scene_bbox_from_points(pts.astype(np.float32), perc=0.99)
    return masks, SPHERE_R / (size / 2)


def run_converter(vis, out, kind):
    """The converter CLI in a subprocess from ``vis`` to ``out``; logs its
    last line and its timings and returns them (seconds by stage)."""
    import re
    os.makedirs(os.path.dirname(out))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mvsdf_tpu_torch.data.convert", "--data_dir",
         vis, "--out_dir", out], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the converter CLI failed:\n{res.stderr}")
    lines = res.stdout.strip().splitlines()
    times = {k: float(v) for k, v in re.findall(
        r"(decode|resize|write|all) ([0-9.]+) s", lines[-2])}
    log(f"[convert] CLI on {kind} images: {lines[-1]}")
    log(f"[convert] CLI on {kind} images {wall:.2f} s in its process; "
        f"decode {times['decode']:.3f} s, resize {times['resize']:.3f} s, "
        f"PNG write {times['write']:.3f} s, all {times['all']:.3f} s = "
        f"{times['all'] / CLI_VIEWS * 1e3:.1f} ms a view")
    return times


def convert_jpeg(tmp, vis, out_png):
    """The converter CLI on ``vis`` with every view's image the 1600x1200
    JPEG fixture, as Vis-MVSNet writes ``%08d.jpg``: each ``image_hd``
    equal to OpenCV's decode of it (SHA-256), the depth maps and cameras
    equal to the PNG run's ``out_png``."""
    import glob
    import numpy as np
    from mvsdf_tpu_torch.data import png
    vis_jpg = os.path.join(tmp, "vis_jpg")
    os.makedirs(vis_jpg)
    for f in os.listdir(vis):
        if not f.endswith(".png"):
            os.symlink(os.path.join(vis, f), os.path.join(vis_jpg, f))
    for i in range(CLI_VIEWS):
        os.symlink(FULL_VIEW + ".jpg", os.path.join(vis_jpg, f"{i:08}.jpg"))
    out = os.path.join(tmp, "converted_jpg", "scan", "imfunc4")
    times = run_converter(vis_jpg, out, "JPEG")
    want = full_view_decode()
    mpix = CLI_VIEWS * want["shape"][0] * want["shape"][1] / 1e6
    bad = [i for i in range(CLI_VIEWS) if sha256(png.read_png(
        os.path.join(out, "image_hd", f"{i:03}.png"), native=True)) !=
        want["sha256"]]
    same = [os.path.relpath(p, out_png) for p in sorted(
        glob.glob(os.path.join(out_png, "depth", "*.pfm")))]
    differ = [r for r in same if open(os.path.join(out, r), "rb").read() !=
              open(os.path.join(out_png, r), "rb").read()]
    cams = [np.load(os.path.join(d, "cameras_hd.npz")) for d in (out,
                                                                 out_png)]
    cams_ok = all(np.array_equal(cams[0][k], cams[1][k]) for k in cams[1])
    log(f"[convert] JPEG run: decode {times['decode'] * 1e3 / CLI_VIEWS:.1f}"
        f" ms a view = {times['decode'] * 1e3 / mpix:.3f} ms per megapixel "
        f"(file read and signature check included); image_hd "
        f"{'all equal to' if not bad else f'views {bad} differ from'} "
        f"OpenCV's decode (SHA-256); {len(same) - len(differ)} of "
        f"{len(same)} depth maps and the cameras "
        f"{'equal' if cams_ok else 'DIFFER'} to the PNG run's")
    if bad or differ or not cams_ok or len(same) != CLI_VIEWS:
        raise AssertionError("the converter on JPEG images disagrees")


def convert_phase(tmp, data_dir):
    """Phase 12: the JPEG decoder, then the converter CLI on phase 7's scene
    as Vis-MVSNet output (with phase 7's PNG images, then with the
    1600x1200 JPEG fixture as every view's image) and the training CLI on
    what the PNG run wrote."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.data import formats, png
    check_jpeg_fixtures()
    t_phase = time.perf_counter()
    vis = os.path.join(tmp, "vis")
    t0 = time.perf_counter()
    masks, radius = write_vis_dir(vis, data_dir)
    log(f"[convert] wrote a {CLI_VIEWS}-view Vis-MVSNet directory from "
        f"phase 7's scene (PNG images {CLI_IMG[1]}x{CLI_IMG[0]}, depth "
        f"{CLI_DEPTH[1]}x{CLI_DEPTH[0]}, probability maps at 1/"
        f"{PROB_DIVS}, a binary cut.ply): {time.perf_counter() - t0:.2f} s;"
        f" the radius-{SPHERE_R} sphere normalises to radius {radius:.4f}")
    out = os.path.join(tmp, "converted", "scan", "imfunc4")
    run_converter(vis, out, "PNG")
    flips, bad_img = 0, []
    cams_in = np.load(os.path.join(data_dir, "cameras_hd.npz"))
    cams_out = np.load(os.path.join(out, "cameras_hd.npz"))
    wm_err = 0.0
    for i in range(CLI_VIEWS):
        want = formats.load_pfm(os.path.join(data_dir, "depth",
                                             f"{i:03}.pfm")) * masks[i]
        got = formats.load_pfm(os.path.join(out, "depth", f"{i:03}.pfm"))
        flips += int((got != want).sum())
        if not np.array_equal(
                png.read_png(os.path.join(out, "image_hd", f"{i:03}.png"),
                             native=True),
                png.read_png(os.path.join(data_dir, "image_hd",
                                          f"{i:03}.png"), native=True)):
            bad_img.append(i)
        a, b = cams_out[f"world_mat_{i}"], cams_in[f"world_mat_{i}"]
        wm_err = max(wm_err, float(np.abs(a - b).max() / np.abs(b).max()))
    mask_hd = png.read_png(os.path.join(out, "mask_hd", "000.png"))
    masked = sum(int((~m).sum()) for m in masks)
    log(f"[convert] depth maps against phase 7's times the reference "
        f"masks ({masked} pixels masked out): {flips} pixels differ; "
        f"image_hd against phase 7's images: "
        f"{'all equal' if not bad_img else f'views {bad_img} differ'}; "
        f"world_mat max |d| / max |w| {wm_err:.2e}; mask_hd "
        f"{mask_hd.shape} all 255: {bool((mask_hd == 255).all())}")
    if flips or bad_img or wm_err > 1e-6 or not (mask_hd == 255).all():
        raise AssertionError("the converted scene differs from phase 7's")
    convert_jpeg(tmp, vis, out)

    # train on the converted scene
    argv = ["--data_dir", out, "--exps_folder",
            os.path.join(tmp, "exps_convert"), "--expname", "convert",
            *CONVERT_ARGS]
    tee = Tee(sys.stdout)
    launches = []
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        trainer = train_cli(argv, launches)
    wall = time.perf_counter() - t0
    rows = metric_rows(trainer)
    if [r["step"] for r in rows] != list(range(CONVERT_EPOCHS + 1)) or \
            not all(np.isfinite(r[k]) for r in rows for k in LOSSES):
        raise AssertionError(f"training on the converted scene: {rows}")
    check_launches(launches, pallas=False)
    sc = trainer.scene
    t = trainer.timings
    log(f"[convert] training CLI on the converted scene, the plain field on "
        f"the fused default: {wall:.1f} s, "
        f"scene load {sc.timings['load_s']:.2f} s; losses "
        f"{[round(r['loss'], 6) for r in rows]}, finite; no kernel "
        f"launched in {len(launches)} chunks; capture s "
        f"{ {k: round(v, 2) for k, v in t['capture_s'].items()} }, graph "
        f"pool MiB "
        f"{ {k: round(v / 2 ** 20, 1) for k, v in t['graph_bytes'].items()} }"
        f"; ms/step by phase "
        f"{ {k: round(v[0], 1) for k, v in phase_times(rows, B * P).items()} }"
        f"; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check_cli_graph(trainer, "convert")
    log(f"[convert] phase 12 after the fixtures: "
        f"{time.perf_counter() - t_phase:.1f} s")


def ddp_args(data_dir, exps, name, nepoch=CLI_EPOCHS):
    """Phase 7's training CLI arguments for experiment ``name``."""
    return ["--data_dir", data_dir, "--exps_folder", exps, "--expname",
            name, "--pallas", "--allow_random_features", "--nepoch",
            str(nepoch), "--batch_size", str(B), "--num_pixels", str(P)]


def first_epoch(trainer):
    """Epoch 0 through ``trainer``, recording the first step's metrics and
    gradients (the ones Adam applied), each step's wall ms, the wall ms in
    the step's reductions (``sum_`` and the losses' ``sum_counts``, the
    wait for the other ranks included), the kernel launches and the
    parameters after the epoch."""
    from mvsdf_tpu_torch.supervision import losses
    from mvsdf_tpu_torch.train import step as step_mod
    rec = {"step_ms": [], "reduce_ms": 0.0}
    sync = trainer._sync

    def timed(fn):
        def wrapper(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            rec["reduce_ms"] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    phase = trainer.cfg.schedule.phase_index(0)
    step = trainer._get_step(phase)

    def recorded(state, batch, weights, generator=None):
        sync()
        t0 = time.perf_counter()
        m = step(state, batch, weights, generator)
        sync()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if "first" not in rec:
            rec["first"] = {k: float(v) for k, v in m.items()}
            rec["grads"] = {n: p.grad.detach().cpu().clone()
                            for n, p in state.net.named_parameters()}
        return m

    patched = [(step_mod, "sum_"), (losses, "sum_counts")]
    saved = [getattr(m, n) for m, n in patched]
    for m, n in patched:
        setattr(m, n, timed(getattr(m, n)))
    trainer.steps[phase] = recorded
    zero_counts()
    try:
        trainer.train_epoch(0)
    finally:
        for (m, n), f in zip(patched, saved):
            setattr(m, n, f)
        trainer.steps[phase] = step
    rec["launches"] = counts()
    rec["params"] = {k: v.detach().cpu().clone()
                     for k, v in trainer.state.net.state_dict().items()}
    return rec


def ddp_worker(out, *argv):
    """One rank of phase 13 (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT set by the caller): a gloo group (NCCL refuses two ranks
    on one device), the training CLI's setup, epoch 0, the record saved to
    ``out``."""
    import torch
    from mvsdf_tpu_torch.parallel import init_distributed
    from mvsdf_tpu_torch.train import cli
    init_distributed("gloo")
    trainer, _ = cli.setup(list(argv))
    t0 = time.perf_counter()
    rec = first_epoch(trainer)
    rec["epoch_s"] = time.perf_counter() - t0
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(rec, out)
    torch.distributed.destroy_process_group()
    return 0


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp, argv):
    """DDP_RANKS processes of ``ddp_worker`` on this card; their records.
    Every process is stopped before this returns."""
    import torch
    port = free_port()
    procs, outs = [], []
    try:
        for r in range(DDP_RANKS):
            out = os.path.join(tmp, f"ddp_rank{r}.pt")
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DDP_RANKS),
                       LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), PYTHONPATH=REPO)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "ddp_worker",
                 out, *argv], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
            outs.append(out)
        texts = [p.communicate(timeout=DDP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} exited {p.returncode}:\n{text[-3000:]}"
              for r, (p, text) in enumerate(zip(procs, texts))
              if p.returncode != 0]
    if failed:
        raise AssertionError("\n".join(failed))
    return [torch.load(o) for o in outs]


def ddp_phase(tmp, data_dir):
    """Phase 13: epoch 0 of phase 7's configuration in DDP_RANKS gloo
    processes on this card and in this process alone; then a NCCL group
    of one through torchrun. Returns the single process's trainer."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.train import cli
    exps = os.path.join(tmp, "ddp_exps")
    t_phase = time.perf_counter()
    # the ranks share the card with this process: hand back its cache
    torch.cuda.empty_cache()
    log(f"[ddp] this process holds {torch.cuda.memory_reserved() / 2 ** 30:.2f}"
        f" GiB of the card before the ranks start")
    t0 = time.perf_counter()
    ranks = run_ranks(tmp, ddp_args(data_dir, exps, "ddp"))
    ranks_s = time.perf_counter() - t0
    trainer, _ = cli.setup(ddp_args(data_dir, exps, "ddp_single"))
    t0 = time.perf_counter()
    single = first_epoch(trainer)
    single_s = time.perf_counter() - t0
    a = ranks[0]
    loss = max(abs(a["first"][k] - single["first"][k]) /
               max(abs(single["first"][k]), 1e-12) for k in LOSSES
               if single["first"][k] != 0)
    each = {n: ((a["grads"][n] - g).abs().max() /
                g.abs().max().clamp_min(1e-12)).item()
            for n, g in single["grads"].items()}
    worst = max(each, key=each.get)
    same = all(torch.equal(v, ranks[1]["params"][k])
               for k, v in a["params"].items())
    n_steps = len(single["step_ms"])
    for r, rec in enumerate(ranks):
        log(f"[ddp] rank {r} of {DDP_RANKS} (gloo, cuda:0, "
            f"{P // DDP_RANKS} rays an image): {np.mean(rec['step_ms'][1:]):.1f}"
            f" ms/step after the first (steps "
            f"{[round(x, 1) for x in rec['step_ms']]}), reductions "
            f"{rec['reduce_ms'] / n_steps:.2f} ms a step (the wait for the "
            f"other rank included); sdf_mlp launches "
            f"{rec['launches']['sdf_mlp']} in {n_steps} steps, the other "
            f"kernels {[rec['launches'][k] for k in ('sdf_mlp_xyz', 'secant', 'sphere_march')]}"
            f"; hit {rec['first']['hit_frac']:.4f}; peak "
            f"{rec['peak_gib']:.2f} GiB")
    log(f"[ddp] one process: {np.mean(single['step_ms'][1:]):.1f} ms/step "
        f"after the first (steps "
        f"{[round(x, 1) for x in single['step_ms']]}); sdf_mlp launches "
        f"{single['launches']['sdf_mlp']}; hit "
        f"{single['first']['hit_frac']:.4f}; the ranks' processes "
        f"{ranks_s:.1f} s with their start and scene load, this one's "
        f"epoch {single_s:.1f} s")
    ok = loss <= DDP_LOSS_RTOL and each[worst] <= DDP_GRAD_TOL and same
    log(f"[ddp] first step, {DDP_RANKS} ranks against one process: worst "
        f"loss term {loss:.3e} relative (tolerance {DDP_LOSS_RTOL:g}), worst "
        f"gradient {each[worst]:.3e} of its largest entry ({worst}; "
        f"tolerance {DDP_GRAD_TOL:g}); the ranks' parameters after the "
        f"epoch {'equal to the bit' if same else 'DIFFERENT'}: "
        f"{'ok' if ok else 'FAILED'}")
    if not ok or min(r["launches"]["sdf_mlp"] for r in ranks) == 0:
        raise AssertionError("the data-parallel step disagrees with the "
                             "single process")
    # the CLI under torchrun: a NCCL group of one
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "mvsdf_tpu_torch.train.cli",
         *ddp_args(data_dir, exps, "ddp_nccl", nepoch=1)],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=DDP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    exp = os.path.join(exps, "ddp_nccl")
    exp = os.path.join(exp, sorted(os.listdir(exp))[-1]) if \
        os.path.isdir(exp) else exp
    group = [line for line in res.stdout.splitlines()
             if line.startswith("process group")]
    files = {f: os.path.isfile(os.path.join(exp, f)) for f in (
        "metrics.jsonl", os.path.join("checkpoints", "latest.txt"),
        os.path.join("plots", "scene_1.png"))}
    log(f"[ddp] torchrun --nproc_per_node 1 (training CLI, epochs 0..1): "
        f"exit {res.returncode} in {wall:.1f} s; {group}; files {files}")
    if res.returncode != 0 or not all(files.values()) or \
            "backend nccl" not in "".join(group):
        raise AssertionError(f"the CLI under torchrun failed:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    log(f"[ddp] phase 13: {time.perf_counter() - t_phase:.1f} s")
    return trainer


def rendered(rgb):
    """Hit mask of an eval render's rgb: a miss is exactly (1, 1, 1)."""
    return (rgb != 1.0).any(-1)


def export_phase(tmp, exps, trainer, dev):
    """Phase 14: the serving export of the full-width renderer, fed phase
    7's epoch-6 checkpoint, against the live renders."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.config import MVSDFConfig
    from mvsdf_tpu_torch.eval import export
    from mvsdf_tpu_torch.fields.network import MVSDFNetwork
    from mvsdf_tpu_torch.rendering.renderer import render_forward
    from mvsdf_tpu_torch.train import checkpoints as ckpt
    t_phase = time.perf_counter()
    # full f32, as the eval CLI renders (the training CLIs of phase 13 left
    # TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MVSDFConfig()
    stamp = sorted(os.listdir(os.path.join(exps, "smoke")))[-1]
    tree, _ = ckpt.load_checkpoint(
        os.path.join(exps, "smoke", stamp, "checkpoints"), CLI_EPOCHS,
        map_location=dev)
    params = tree["net"]
    zero_counts()
    t0 = time.perf_counter()
    # checked to load on the card only: the CPU tests load it on the CPU
    blob = export.export_renderer(cfg, params, chunk=EXPORT_CHUNK,
                                  platforms=("cuda",), device=dev)
    export_s = time.perf_counter() - t0
    path = os.path.join(tmp, "renderer.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    t0 = time.perf_counter()
    served = export.load_renderer(path, device=dev)
    load_s = time.perf_counter() - t0
    c = trainer.cache
    H, W = trainer.scene.img_res
    sel = torch.arange(EXPORT_CHUNK, device=dev) + (H // 2) * W
    inputs = (c.uv[sel][None], c.intrinsics[:1], c.poses[:1],
              c.masks[0][sel][None])
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        served(params, *inputs)            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = served(params, *inputs)
        torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = counts()
    net = MVSDFNetwork(cfg.model.implicit, cfg.model.render).to(dev)
    net.load_state_dict(params)
    view = dict(zip(("uv", "intrinsics", "pose", "object_mask"), inputs))
    pallas = dataclasses.replace(cfg.model, use_pallas_trace=True)
    with torch.no_grad():
        plain = render_forward(cfg.model, net, view, training=False)
        zero_counts()
        live_k = render_forward(pallas, net, view, training=False)
        torch.cuda.synchronize()
    k_launches = counts()
    got, plain_rgb = got[0], plain.rgb_values[0]
    hit, plain_hit = rendered(got), plain.network_object_mask[0]
    agree = (hit == plain_hit)
    err = (got - plain_rgb)[agree].abs().max().item()
    k_hit = live_k.network_object_mask[0]
    k_agree = (hit == k_hit).float().mean().item()
    both = (k_hit & plain_hit)
    derr = (live_k.dists - plain.dists)[0][both].abs().max().item() if \
        both.any() else 0.0
    k_rgb = (got - live_k.rgb_values[0])[hit & k_hit].abs()
    log(f"[export] full-width renderer, chunk {EXPORT_CHUNK}: exported on "
        f"the card in {export_s:.2f} s ({len(blob) / 1e6:.2f} MB, checked "
        f"to load on cuda), loaded in {load_s:.2f} s, one chunk "
        f"rendered in {render_ms:.1f} ms, peak {peak:.2f} GiB; kernel "
        f"launches by the artifact {launched}")
    log(f"[export] against the live plain render of the same rays: hit "
        f"{hit.float().mean().item():.4f} / {plain_hit.float().mean().item():.4f}"
        f", masks agree on {agree.float().mean().item():.5f} (gate "
        f"{EXPORT_AGREE}), max |d rgb| where they agree {err:.3e} (gate "
        f"{EXPORT_TOL:g})")
    log(f"[export] against the live --pallas render: masks agree on "
        f"{k_agree:.5f} (gate 0.99), max |d rgb| on common hits "
        f"{(k_rgb.max().item() if k_rgb.numel() else 0):.3e}; the --pallas "
        f"render against the plain one: max |d dists| on common hits "
        f"{derr:.2e} (gate 1e-3); its launches {k_launches}")
    # the exported program launches the field's activation kernels (the
    # operators it recorded: the activation, and its derivative in the
    # shading normals' reverse pass) and none of the trace's kernels
    if agree.float().mean().item() < EXPORT_AGREE or err > EXPORT_TOL or \
            k_agree < 0.99 or derr > 1e-3 or \
            not all(launched[k] for k in EXPORT_KERNELS) or \
            any(v for k, v in launched.items()
                if k not in EXPORT_KERNELS) or \
            k_launches["sdf_mlp"] == 0 or not torch.isfinite(got).all() \
            or got.shape != (EXPORT_CHUNK, 3):
        raise AssertionError("the exported renderer disagrees with the "
                             "live renders")
    log(f"[export] phase 14: {time.perf_counter() - t_phase:.1f} s")


def figures_phase(tmp, mesh, trainer):
    """Phase 15: the scene snapshot of phase 8's mesh with the cameras,
    and DEPTH_VIEWS depth maps."""
    import numpy as np
    from mvsdf_tpu_torch.data import png
    from mvsdf_tpu_torch.eval import plots
    verts, faces = mesh
    zero_counts()
    snap = os.path.join(tmp, "scene.png")
    t0 = time.perf_counter()
    plots.plot_scene_snapshot(snap, verts, faces, poses=trainer.scene.poses)
    snap_s = time.perf_counter() - t0
    depths = trainer.scene.depths[:DEPTH_VIEWS, 0]
    h, w = depths.shape[1:]
    dpath = os.path.join(tmp, "depth.png")
    t0 = time.perf_counter()
    plots.plot_depth_maps(dpath, depths.reshape(DEPTH_VIEWS, -1), (h, w))
    depth_s = time.perf_counter() - t0
    img, dimg = png.read_png(snap, native=True), png.read_png(dpath,
                                                              native=True)
    drawn = (img != 255).any(-1).mean()
    cones = (img == plots._CRIMSON).all(-1).sum()
    colours = [len(np.unique(dimg[:, i * w:(i + 1) * w].reshape(-1, 3),
                             axis=0)) for i in range(DEPTH_VIEWS)]
    log(f"[figures] scene snapshot of {len(faces)} faces (drawn "
        f"{min(len(faces), 30000)}) and {len(trainer.scene.poses)} cameras: "
        f"{snap_s:.2f} s, {img.shape}, {drawn:.4f} of the pixels drawn, "
        f"{cones} camera pixels; {DEPTH_VIEWS} depth maps {w}x{h}: "
        f"{depth_s:.2f} s, {dimg.shape}, viridis colours a map {colours}; "
        f"launches {counts()}")
    if img.shape != (plots.SNAPSHOT_PX, plots.SNAPSHOT_PX, 3) or \
            drawn < 1e-3 or cones == 0 or \
            dimg.shape != (h, DEPTH_VIEWS * w, 3) or min(colours) < 2:
        raise AssertionError("a figure is blank or of the wrong shape")


def validation_phase(tmp):
    """Phase 16: the 600-epoch three-phase capstone on the shaded scene,
    in this process, at full width through sdf_mlp; its summary held to
    the JAX package's reference bars. Returns (summary, launches)."""
    from mvsdf_tpu_torch.validation import full_training as ft
    from mvsdf_tpu_torch.validation import quality_pin as qp
    args = ft.parse_args([*VALIDATION_ARGS, "--out",
                          os.path.join(tmp, "validation")])
    zero_counts()
    t0 = time.perf_counter()
    summary, stats = ft.run(args, log=lambda m: log(f"[validation] {m}"))
    wall = time.perf_counter() - t0
    launches = counts()
    clean = [w[1] for w in stats["windows"] if w[3]] or [float("nan")]
    log(f"[validation] ms/step by {ft.WIN}-epoch window (a * holds a "
        f"phase's first step): " + " ".join(
            f"{w[1]:.1f}{'' if w[3] else '*'}" for w in stats["windows"]))
    log(f"[validation] rays/s by window: " + " ".join(
        f"{w[2]:.0f}" for w in stats["windows"]))
    log(f"[validation] {args.epochs} steps in {stats['train_s']:.1f} s, "
        f"clean windows {min(clean):.1f}-{max(clean):.1f} ms/step; "
        f"{ft.BOUNDS} "
        f"{args.resolution}^3 grid {stats['grid_s']:.2f} s; phase "
        f"{wall:.1f} s; sdf_mlp launches {summary['sdf_mlp_launches']} "
        f"({summary['sdf_mlp_launches']['train'] / args.epochs:.2f} a "
        f"step), all counts {launches}")
    log(f"[validation] summary {json.dumps(summary)}")
    n = summary["sdf_mlp_launches"]
    if min(n["train"], n["grid"]) == 0 or \
            sum(n.values()) != launches["sdf_mlp"]:
        raise AssertionError(f"the validation did not run through sdf_mlp "
                             f"in training and in the grid: {n}, "
                             f"{launches}")
    if any(launches[k] for k in ("sdf_mlp_xyz", "secant", "sphere_march")):
        raise AssertionError(f"the validation launched another kernel: "
                             f"{launches}")
    drift = qp.gate(summary, bars=False)
    log(f"[validation] the port's pin (quality_pin.PIN): "
        f"{'; '.join(drift) if drift else 'inside'}")
    misses = qp.gate(summary, pin=False)
    if misses:
        raise AssertionError("the validation misses the JAX reference "
                             "bars: " + "; ".join(misses))
    log(f"[validation] inside the JAX reference bars: " + ", ".join(
        f"{k} {summary[k]} {op} {lim:g}"
        for k, (op, lim) in qp.REFERENCE_BARS.items()))
    return summary, launches


def suite_phase(tmp):
    """Phase 17: two shaded scans written as scene directories, then the
    suite (in a subprocess) trains, evaluates and trims each through the
    port's CLIs, each in a process of its own."""
    import math
    from mvsdf_tpu_torch.data.synthetic import write_shaded_scene_dir
    from mvsdf_tpu_torch.validation import dtu_suite
    root = os.path.join(tmp, "suite")
    data = os.path.join(root, "data")
    for scan in SUITE_SCANS:
        write_shaded_scene_dir(os.path.join(data, scan, "imfunc4"),
                               views=SUITE_VIEWS, img_hw=SUITE_IMG,
                               depth_hw=SUITE_DEPTH)
    ids = ",".join(str(dtu_suite.scan_id(s)) for s in SUITE_SCANS)
    cmd = [sys.executable, "-m", "mvsdf_tpu_torch.validation.dtu_suite",
           "--data_root", data, "--scans", ids, *SUITE_ARGS]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=SUITE_TIMEOUT_S,
                         env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    for line in res.stdout.strip().splitlines():
        log(f"[suite] {line}")
    if res.returncode != 0 or "FAILED" in res.stdout:
        raise AssertionError(f"the suite failed (rc {res.returncode}): "
                             f"{res.stderr[-3000:]}")
    with open(os.path.join(root, "SUITE.json")) as f:
        suite = json.load(f)
    rows = {r["scan"]: r for r in suite["scans"]}
    for scan in SUITE_SCANS:
        r = rows.get(scan, {})
        ref = dtu_suite.REFERENCE_TABLE[dtu_suite.scan_id(scan)]
        if not isinstance(r.get("psnr"), float) or \
                not math.isfinite(r["psnr"]) or \
                (r.get("ref_chamfer"), r.get("ref_psnr")) != ref:
            raise AssertionError(f"SUITE.json has no full row for {scan}: "
                                 f"{r}")
        with open(os.path.join(root, f"suite_{scan}.log")) as f:
            mods = [line.split(" -m ", 1)[1].split()[0]
                    for line in f if line.startswith("$ ")]
        if tuple(mods) != SUITE_CLIS:
            raise AssertionError(f"suite_{scan}.log ran {mods}, not "
                                 f"{SUITE_CLIS}")
        evaldir = os.path.join(root, "evals", scan)
        if not any(f.endswith("_trimmed.obj") for f in os.listdir(evaldir)):
            raise AssertionError(f"no trimmed mesh for {scan}")
        log(f"[suite] {scan}: psnr {r['psnr']} (reference {ref[1]}), train "
            f"{r['train_s']} s, eval {r['eval_s']} s; CLIs {mods}")
    if not os.path.exists(os.path.join(root, "SUITE.md")):
        raise AssertionError("the suite wrote no SUITE.md")
    log(f"[suite] {len(SUITE_SCANS)} scans of {SUITE_VIEWS} views "
        f"{SUITE_IMG}x{SUITE_IMG} in {wall:.1f} s (suite wall "
        f"{suite['wall_s']} s), mean psnr {suite['mean_psnr']}")


def run_bench_cli(name, switches):
    """The port's bench CLI in a subprocess with ``switches`` set: its one
    stdout line, parsed, and its stderr logged. Requires rc 0, exactly one
    line of bench.py's four keys and a finite positive rate."""
    import math
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "mvsdf_tpu_torch.bench"],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                                            **switches),
                         capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in res.stderr.strip().splitlines()[-12:]:
        log(f"[bench {name}] {line}")
    lines = res.stdout.splitlines()
    log(f"[bench {name}] stdout ({wall:.1f} s, rc {res.returncode}): "
        f"{lines}")
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"the bench ({name}) failed or printed "
                             f"{len(lines)} lines: {res.stderr[-3000:]}")
    line = json.loads(lines[0])
    if list(line) != ["metric", "value", "unit", "vs_baseline"] or \
            line["metric"] != "train_rays_per_s_per_chip" or \
            not math.isfinite(line["value"]) or line["value"] <= 0:
        raise AssertionError(f"the bench ({name}) printed {line}")
    return line


def check_width64(dev):
    """Kernels 1 and 3 at the dry run's tiny width (SDF 3 x 64, skip at 2,
    4 secant steps) against their plain versions, sdf_mlp on W64_ROWS
    points (TOL) and the secant on the brackets of the tiny scene's rays
    (check_secant's gate). Returns their kernels-line entries."""
    import torch
    from mvsdf_tpu_torch import graft_entry
    from mvsdf_tpu_torch.data.synthetic import scene_to_torch
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.train.step import init_params
    cfg, sizes = graft_entry.leg(2, False)
    icfg, tcfg = cfg.model.implicit, cfg.model.tracer
    net = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        packed = K.pack_sdf_weights(net.implicit)
        weight_bytes = 2 * packed.w_tc.numel() + 4 * (packed.v_tc.numel() + 1)
        L = icfg.multires
        x = torch.rand((W64_ROWS, 3), generator=gen, device=dev) * 2 - 1
        pe = positional_encoding(x, L).contiguous()
        got, ref = K.sdf_mlp(packed, pe), K.sdf_mlp_reference(packed, pe)
        xyz = K.sdf_mlp_xyz(packed, L, x)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        xyz_err = (xyz - ref).abs().max().item()
        log(f"[width 64] sdf_mlp on {W64_ROWS} rows of the tiny leg's net "
            f"({len(icfg.dims)}x{icfg.dims[0]}): max|kernel - f32 plain| = "
            f"{err:.3e}, sdf_mlp_xyz {xyz_err:.3e} (tolerance {TOL:g})")
        if max(err, xyz_err) > TOL or not torch.isfinite(got).all():
            raise AssertionError("sdf_mlp at width 64 disagrees with its "
                                 "plain version")
        flops = K.flops_per_point(icfg) * W64_ROWS
        entries = [kernel_entry(
            "sdf_mlp (width 64)", "sdf_mlp.cu",
            "mvsdf_tpu/tracing/pallas/sdf_kernel.py:205", err,
            cuda_ms(lambda: K.sdf_mlp(packed, pe)),
            cuda_ms(lambda: K.sdf_mlp_reference(packed, pe)), flops,
            4 * (pe.numel() + W64_ROWS) + weight_bytes,
            cuda_ms(lambda: library_chain(net.implicit, x)))]
        tile_ms = cuda_ms(lambda: K.sdf_mlp_xyz(packed, L, x[:64]))
        sc = graft_entry._scene(sizes["n_images"], sizes["n_pix"],
                                sizes["feat"], sizes["depth_hw"],
                                sizes["img_hw"])
        rays = bench_rays(scene_to_torch(sc, dev), tcfg)
        sec, _, _ = check_secant(icfg, tcfg, packed, rays, weight_bytes,
                                 tile_ms, max(err, xyz_err))
    sec["name"] = "secant (width 64)"
    return entries + [sec]


def repro_check(batch, dev):
    """The repair of the runs' reproducibility: the frozen FeatExt features
    of REPRO_VIEWS random views computed twice (scene.frozen_features, on
    cuDNN's deterministic algorithms) are equal, bit for bit; and
    bench_phaseB from seed 0, REPRO_STEPS steps, twice: every metric of
    every step and every parameter equal, bit for bit. Returns the
    launches."""
    import numpy as np
    import torch
    from mvsdf_tpu_torch.data.synthetic import shaded_features
    from mvsdf_tpu_torch.train.step import init_train_state, make_train_step
    rgbs = np.random.default_rng(0).uniform(
        -1, 1, (REPRO_VIEWS, 2 * REPRO_DEPTH, 2 * REPRO_DEPTH, 3)
    ).astype(np.float32)
    feats = [shaded_features(rgbs, REPRO_DEPTH, device=dev)
             for _ in range(2)]
    log(f"[repro] frozen features of {REPRO_VIEWS} views at "
        f"{2 * REPRO_DEPTH}^2, twice: "
        f"{'equal' if np.array_equal(*feats) else 'DIFFERENT'} "
        f"(max |d| {np.abs(feats[0] - feats[1]).max():.3e})")
    if not np.array_equal(*feats):
        raise AssertionError("the frozen features differ between two calls")
    cfg = bench_config()
    runs = []
    zero_counts()
    for _ in range(2):
        t0 = time.perf_counter()
        state = init_train_state(cfg, seed=0, device=dev)
        step = make_train_step(cfg, phase_idx=1)
        gen = torch.Generator(device=dev).manual_seed(0)
        metrics = [step(state, batch, cfg.schedule.weights(0.3), gen)
                   for _ in range(REPRO_STEPS)]
        torch.cuda.synchronize()
        runs.append(([{k: v.item() for k, v in m.items()} for m in metrics],
                     [p.detach().clone() for p in state.net.parameters()],
                     time.perf_counter() - t0))
    launches = counts()
    (m_a, p_a, s_a), (m_b, p_b, s_b) = runs
    same_p = sum(torch.equal(a, b) for a, b in zip(p_a, p_b))
    log(f"[repro] bench_phaseB {REPRO_STEPS} steps from seed 0, twice "
        f"({s_a:.1f} / {s_b:.1f} s): metrics "
        f"{'equal' if m_a == m_b else 'DIFFERENT'} in every step (last "
        f"loss {m_a[-1]['loss']!r} / {m_b[-1]['loss']!r}); {same_p} of "
        f"{len(p_a)} parameter tensors equal to the bit; launches {launches}")
    if m_a != m_b or same_p != len(p_a):
        raise AssertionError("two runs of the bench step differ")
    if launches["sdf_mlp"] == 0:
        raise AssertionError("the deterministic runs never launched sdf_mlp")
    return launches


def repro_cli():
    """The fused training CLI twice from the same seed on a small scene
    directory (REPRO_CLI_VIEWS views, full width, --nepoch 2: phases A, B,
    C, each captured): every metric of every epoch and every parameter
    equal, bit for bit."""
    import torch
    from mvsdf_tpu_torch.data.synthetic import write_scene_dir
    runs = []
    with tempfile.TemporaryDirectory(prefix="mvsdf_repro_") as tmp:
        data = write_scene_dir(tmp, n_images=REPRO_CLI_VIEWS,
                               img_hw=(96, 128), depth_hw=(48, 64))
        for i in range(2):
            argv = ["--data_dir", data, "--exps_folder",
                    os.path.join(tmp, "exps"), "--expname", f"repro{i}",
                    "--pallas", "--allow_random_features", "--nepoch", "2"]
            launches = []
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = train_cli(argv, launches)
            rows = [{k: r[k] for k in LOSSES + ("grad_norm", "lr",
                                                 "hit_frac")}
                    for r in metric_rows(trainer)]
            runs.append((rows, [p.detach().clone()
                                for p in trainer.state.net.parameters()],
                         time.perf_counter() - t0, check_launches(launches)))
            del trainer
    (m_a, p_a, s_a, l_a), (m_b, p_b, s_b, _) = runs
    same_p = sum(torch.equal(a, b) for a, b in zip(p_a, p_b))
    log(f"[repro] the fused training CLI, {REPRO_CLI_VIEWS} views, epochs "
        f"0..2, twice ({s_a:.1f} / {s_b:.1f} s): metrics "
        f"{'equal' if m_a == m_b else 'DIFFERENT'} in every epoch (last "
        f"loss {m_a[-1]['loss']!r} / {m_b[-1]['loss']!r}); {same_p} of "
        f"{len(p_a)} parameter tensors equal to the bit; {l_a[0]} launches "
        f"by chunk {l_a[1]}")
    if m_a != m_b or same_p != len(p_a):
        raise AssertionError("two fused CLI runs of one seed differ")


def bench_phase(batch, dev):
    """Phase 18: the port's bench CLI with the default and the fused
    switches; entry() on the card; kernels 1 and 3 at width 64, then
    dryrun_multichip(2), both legs; the reproducibility checks. Returns
    the width-64 entries of the kernels line."""
    import math
    import torch
    from mvsdf_tpu_torch import graft_entry
    from mvsdf_tpu_torch.bench import FUSED_SWITCHES
    from mvsdf_tpu_torch.tracing.kernels.counts import ACT_KERNEL, ROWS
    t_phase = time.perf_counter()
    lines = {name: run_bench_cli(name, sw) for name, sw in (
        ("default", {}), ("fused", FUSED_SWITCHES))}
    log(f"[bench] rays/s: default {lines['default']['value']}, fused "
        f"{lines['fused']['value']}")
    zero_counts()
    fn, args = graft_entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    shapes = [tuple(o.shape) for o in out]
    log(f"[entry] outputs {shapes}, hit "
        f"{out[1].float().mean().item():.4f}, launches {counts()}")
    if shapes != [(1, 1024, 3), (1, 1024), (1, 1024)] or not all(
            torch.isfinite(o.float()).all() for o in out) or any(
            v for k, v in counts().items() if k not in ACT_KERNEL + ROWS):
        raise AssertionError("entry() gave the wrong shapes, a non-finite "
                             "value or launched a trace kernel")
    del out, args
    entries = check_width64(dev)
    torch.cuda.empty_cache()
    legs = graft_entry.dryrun_multichip(2)
    tiny = legs[0]["launches"][0]
    for e in entries:
        e["launches"] = tiny[e["name"].split()[0]]
    if not all(math.isfinite(v["loss"]) for v in legs):
        raise AssertionError("the dry run's loss is not finite")
    repro_check(batch, dev)
    repro_cli()
    log(f"[bench] phase 18: {time.perf_counter() - t_phase:.1f} s")
    return entries


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    from mvsdf_tpu_torch.data.synthetic import make_scene, scene_to_torch
    from mvsdf_tpu_torch.fields.embedder import positional_encoding
    from mvsdf_tpu_torch.tracing.kernels import build
    from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K
    from mvsdf_tpu_torch.tracing.kernels.counts import (ACT_KERNEL,
                                                         ACT_KERNEL_BF16)
    from mvsdf_tpu_torch.train.step import init_params

    # 1. build
    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"[build] {build.library_path()} built in "
        f"{time.perf_counter() - t0:.2f} s")

    # 2. kernels against their plain versions
    cfg, fcfg = bench_config(), fused_config()
    icfg, tcfg = cfg.model.implicit, cfg.model.tracer
    # the activation's entries each configuration's steps launch: the bf16
    # ones with the bench's bf16 activations
    act, f_act = (ACT_KERNEL_BF16 if c.model.implicit.bf16_activations
                  else ACT_KERNEL for c in (cfg, fcfg))
    net = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    scene = make_scene(n_images=B, n_pix=P, feat_ch=32, img_hw=96,
                       depth_hw=48)
    batch = scene_to_torch(scene, dev)
    with torch.no_grad():
        packed = K.pack_sdf_weights(net.implicit)
        # the split weights, which every kernel reads
        weight_bytes = 2 * packed.w_tc.numel() + 4 * (packed.v_tc.numel() + 1)
        x = torch.rand((N_KERNEL, 3), generator=gen, device=dev) * 2 - 1
        pe = positional_encoding(x, icfg.multires).contiguous()
        entries, tile_ms = check_sdf_mlps(net.implicit, packed, x, pe,
                                          weight_bytes)
        rays = bench_rays(batch, tcfg)
        sec, sec_args, sec_gate = check_secant(
            icfg, tcfg, packed, rays, weight_bytes, tile_ms,
            entries[1]["max_abs_err"])
        entries.append(sec)
        entries.append(check_march(icfg, tcfg, packed, rays, weight_bytes,
                                   tile_ms))
        entries += check_count_entries(net.implicit, tcfg, packed, x, pe,
                                       sec_args, sec_gate, weight_bytes)
        check_conditional_nodes(net.implicit, x, rays)
        entries += check_softplus100(dev)
    plain_field = copy.deepcopy(net.implicit)
    plain_field.cfg = dataclasses.replace(icfg, bf16_activations=False)
    check_cascade(plain_field)
    check_cascade(net.implicit)
    del plain_field

    # 3-6. the main path in both trace configurations
    state, launches, stats = train("train", cfg, batch, gen, dev,
                                   every_step=act,
                                   some_step=("sdf_mlp",),
                                   never=("sdf_mlp_xyz", "secant",
                                          "sphere_march"))
    g_launches = graph_steps("train", cfg, batch, gen, dev, stats[0],
                             every=("sdf_mlp_count", *act))
    eval_render("eval", cfg, state, batch, must=("sdf_mlp",))
    state, f_launches, f_stats = train(
        "train_fused", fcfg, batch, gen, dev,
        every_step=("sphere_march", *f_act),
        some_step=("sdf_mlp_xyz", "secant"), never=("sdf_mlp",))
    fg_launches = graph_steps("train_fused", fcfg, batch, gen, dev,
                              f_stats[0], every=("sphere_march",
                                                 "sdf_mlp_xyz_count",
                                                 "secant_count", *f_act))
    eval_render("eval_fused", fcfg, state, batch, must=("sphere_march",))
    # the march's rows on the field the training steps left: rays take more
    # line searches on it than on the seed-0 sphere
    with torch.no_grad():
        march_rows(f"weights after {WARMUP + TIMED} bench_phaseB_fused steps",
                   tcfg, K.pack_sdf_weights(state.net.implicit),
                   icfg.multires, rays, tile_ms)
    for e in entries:
        name = e["name"]
        e["launches"] = (launches if name == "sdf_mlp" else g_launches
                         if name == "sdf_mlp_count" or name in act
                         else fg_launches if name.endswith("_count")
                         else f_launches)[name]

    # 7-8. the training CLI on a DTU-sized scene directory, then the eval
    # CLI on its checkpoint; 9-10. the same with camera optimisation, then
    # the trimming of phase 8's mesh
    with tempfile.TemporaryDirectory(prefix="mvsdf_cli_") as tmp:
        run = cli_phase(tmp)
        # the activation's entries that the bench steps do not launch:
        # their launches in the CLI's run (f32 activations, its default)
        for e in entries:
            if e["name"] in ACT_KERNEL + ACT_KERNEL_BF16 and \
                    e["name"] not in act:
                e["launches"] = run["launches"][e["name"]]
        mesh = eval_phase(tmp, run["exps"], dev)
        exps_cams = cams_phase(tmp, run["data_dir"], run["times"])
        eval_cams_phase(tmp, run["data_dir"], exps_cams, dev)
        trim_phase(tmp, os.path.join(
            tmp, "evals", "smoke",
            f"surface_world_coordinates_{CLI_EPOCHS}.obj"))
        # 12. the JPEG decoder, the converter on phase 7's scene, and
        # training on what it wrote
        convert_phase(tmp, run["data_dir"])
        # 13. data parallel; 14. the serving export; 15. the figures
        trainer = ddp_phase(tmp, run["data_dir"])
        export_phase(tmp, run["exps"], trainer, dev)
        figures_phase(tmp, mesh, trainer)
        del trainer
        # 16. the trained-quality validation; 17. the suite on two scans
        t0 = time.perf_counter()
        validation_phase(tmp)
        log(f"[validation] phase 16 {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        suite_phase(tmp)
        log(f"[suite] phase 17 {time.perf_counter() - t0:.1f} s")
    # 18. the bench, the driver's entry points, reproducibility
    torch.cuda.empty_cache()
    entries += bench_phase(batch, dev)

    log(f"[total] {time.perf_counter() - t_start:.1f} s from the start "
        f"of main")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["ddp_worker"]:
        sys.exit(ddp_worker(*sys.argv[2:]))
    sys.exit(main())
