"""Training CLI (port of ``mvsdf_tpu/train/cli.py``; same flags, same
experiment-folder layout).

    python -m mvsdf_tpu_torch.train.cli --data_dir DATA --batch_size 8 \\
        --nepoch 1800 --expname NAME [--pallas] [--is_continue]

Runs on the GPU unless ``--platform cpu`` is given; without a GPU and
without that flag it raises. ``setup`` builds the trainer (scene loaded,
features computed, state initialised) and ``main`` runs it.

Data parallel over N GPUs of a node, one process each, the rays of every
batch split over them (``parallel/``):

    python -m torch.distributed.run --nproc_per_node N \
        -m mvsdf_tpu_torch.train.cli --data_dir DATA ... [--pallas]

The processes join a NCCL group (gloo with ``--platform cpu``; a caller
that has already joined a group keeps it); ``--no_mesh`` runs one process
and refuses a launch of several.

The trainer runs the fused multi-epoch dispatch (chunks of up to
``--epochs_per_dispatch`` epochs, each phase's step captured once into a
CUDA graph and replayed; on the CPU the same chunks run eagerly), as the
JAX CLI runs its ``lax.scan`` chunks, with one process or several (each
rank then replays its own graph, with the gradient and loss-count
all-reduces inside it); ``--no_fused`` takes the per-epoch host loop
(``train/loop.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import init_distributed, rank, world_size


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="mvsdf per-scene training "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--nepoch", type=int, default=1800)
    ap.add_argument("--num_pixels", type=int, default=4096)
    ap.add_argument("--expname", default="mvsdf")
    ap.add_argument("--exps_folder", default="exps")
    ap.add_argument("--is_continue", action="store_true")
    ap.add_argument("--timestamp", default="latest")
    ap.add_argument("--checkpoint", default="latest",
                    help="epoch to resume from with --is_continue "
                         "(default: latest)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_mesh", action="store_true",
                    help="one process, no process group: refuses a launch "
                         "with WORLD_SIZE > 1")
    ap.add_argument("--train_cameras", action="store_true",
                    help="jointly optimize per-image camera poses, from the "
                         "scene's cameras_linear_init.npz (the ground-truth "
                         "poses without it)")
    ap.add_argument("--matmul_precision", default="default",
                    choices=["default", "tensorfloat32", "highest"],
                    help="f32 matmuls of the supervised path on the GPU: "
                         "'highest' = full f32, 'tensorfloat32' and "
                         "'default' = TF32 (torch.backends.cuda.matmul."
                         "allow_tf32; what XLA's default precision gives "
                         "on a GPU). The trace's SDF kernel and the frozen "
                         "features are unaffected")
    ap.add_argument("--conf", default="",
                    help="HOCON config (reference mvsdf_dtu.conf format); "
                         "defaults to the built-in full-size architecture")
    ap.add_argument("--platform", default="", choices=["", "cpu", "cuda",
                                                       "gpu"],
                    help="'cpu' runs on the CPU; the default is the GPU")
    ap.add_argument("--no_fused", action="store_true",
                    help="disable the fused multi-epoch dispatch (chunks of "
                         "epochs as CUDA-graph replays of a captured step, "
                         "the batches gathered from the device-resident "
                         "scene); falls back to the per-epoch host loop")
    ap.add_argument("--epochs_per_dispatch", type=int, default=16,
                    help="the most epochs one chunk of the fused dispatch "
                         "runs")
    ap.add_argument("--profile_dir", default="",
                    help="capture a torch.profiler trace (Chrome format) of "
                         "the first --profile_epochs epochs into this "
                         "directory")
    ap.add_argument("--profile_epochs", type=int, default=0)
    ap.add_argument("--trace_dir", default="",
                    help="trace the run and write DIR/spans.json at its end "
                         "(Chrome trace-event format, on the profiler's "
                         "clock): the trainer's host spans, each step's "
                         "device stage times from stamps the captured step "
                         "writes, and the trace's SDF rows a step. Off by "
                         "default; while off the captured graph is "
                         "unchanged")
    ap.add_argument("--pallas", action="store_true",
                    help="the no-grad trace through the hand-written SDF-MLP "
                         "kernel, with the JAX package's auto capacities "
                         "(which change no result here). The supervised "
                         "re-evaluation stays full-f32 either way")
    ap.add_argument("--bf16_acts", action="store_true",
                    help="bf16 activation storage in the supervised "
                         "implicit MLP (bf16 multiply / f32 accumulate)")
    ap.add_argument("--keep_fill", action="store_true",
                    help="keep the reference's training-mode min-SDF miss "
                         "fill (ref ray_tracing.py:86-94). Its outputs are "
                         "dead in the training step (see "
                         "TracerConfig.fill_misses), so it is skipped by "
                         "default")
    ap.add_argument("--no_supervised_compact", action="store_true",
                    help="force the supervised path dense even when the "
                         "sphere-intersect bound would engage "
                         "auto_supervised_cascade")
    ap.add_argument("--allow_random_features", action="store_true",
                    help="proceed with RANDOM FeatExt CNN weights when the "
                         "pretrained VisMVSNet checkpoint "
                         "(MVSDF_VISMVSNET_PT) is absent — synthetic "
                         "bring-up scenes only; on real imagery the "
                         "feature-consistency loss would supervise noise")
    return ap.parse_args(argv)


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def setup(argv=None):
    """(Trainer, args): the configuration, experiment folder, scene and
    trainer that ``main`` runs."""
    args = parse_args(argv)
    if args.platform != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --platform "
                           "cpu to run on the CPU")
    if args.no_mesh:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise ValueError("--no_mesh runs one process, and this launch "
                             f"has WORLD_SIZE={os.environ['WORLD_SIZE']}")
        device = torch.device("cpu" if args.platform == "cpu" else "cuda")
    else:
        # joins the launcher's process group, if there is one
        device = init_distributed(
            device="cpu" if args.platform == "cpu" else None)
    torch.backends.cuda.matmul.allow_tf32 = args.matmul_precision != "highest"

    from ..config import MVSDFConfig, TrainConfig
    from ..data.scene import SceneData
    from .loop import Trainer

    train_kw = dict(batch_size=args.batch_size, num_pixels=args.num_pixels,
                    nepochs=args.nepoch, seed=args.seed,
                    train_cameras=args.train_cameras,
                    fused_dispatch=not args.no_fused,
                    epochs_per_dispatch=args.epochs_per_dispatch)
    if args.conf:
        from ..hocon import config_from_hocon
        cfg = config_from_hocon(args.conf)
        cfg = _replace(cfg, train=_replace(cfg.train, **train_kw))
    else:
        cfg = MVSDFConfig(train=TrainConfig(**train_kw))

    exp_base = os.path.join(args.exps_folder, args.expname)
    if args.is_continue and args.timestamp == "latest" and \
            os.path.isdir(exp_base):
        stamps = sorted(os.listdir(exp_base))
        stamp = stamps[-1] if stamps else datetime.now().strftime(
            "%Y_%m_%d_%H_%M_%S")
    elif args.is_continue:
        stamp = args.timestamp
    else:
        stamp = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    if dist.is_initialized() and rank() == 0:
        print(f"process group: backend {dist.get_backend()}, world size "
              f"{world_size()}, rank 0 on {device}")
    if world_size() > 1:
        # every rank takes rank 0's experiment folder
        box = [stamp]
        dist.broadcast_object_list(box, src=0)
        stamp = box[0]
    exp_dir = os.path.join(exp_base, stamp)
    os.makedirs(exp_dir, exist_ok=True)

    scene = SceneData(args.data_dir,
                      allow_random_features=args.allow_random_features,
                      device=device)

    model = cfg.model
    if args.bf16_acts:
        model = _replace(model, implicit=_replace(model.implicit,
                                                  bf16_activations=True))
    if not args.keep_fill:
        # the training-mode min-SDF miss fill: its outputs are dead in the
        # training step (TracerConfig.fill_misses)
        model = _replace(model, tracer=_replace(model.tracer,
                                                fill_misses=False))
    if args.pallas:
        # the JAX package's capacities, sized from the scene's mask and
        # sphere-intersect statistics; carried with no effect here
        from ..tracing.sphere_trace import (auto_fallback_cascade,
                                            auto_march_schedule,
                                            auto_supervised_cascade,
                                            ray_intersect_fraction)
        obj_frac = float(np.mean(scene.masks))
        uv_all = np.broadcast_to(scene.uv[None], (scene.n_images,) +
                                 scene.uv.shape)
        isect = ray_intersect_fraction(uv_all, scene.intrinsics,
                                       scene.poses)
        cap = auto_fallback_cascade(obj_frac, intersect_frac=isect,
                                    fill_misses=args.keep_fill)
        march_sched = auto_march_schedule(obj_frac, intersect_frac=isect)
        # as in the JAX package, the supervised compaction is a
        # single-device optimisation: off when several ranks run
        sup = () if args.no_supervised_compact or world_size() > 1 else \
            auto_supervised_cascade(intersect_frac=isect)
        if rank() == 0:
            print(f"fallback capacity cascade: {cap}, march schedule "
                  f"{march_sched}, supervised cascade {sup} "
                  f"(object mask frac {obj_frac:.3f}, "
                  f"sphere-intersect frac {isect:.3f})")
        tr = _replace(model.tracer, sampler_capacity_frac=0.25,
                      fill_capacity_frac=0.5, fallback_capacity_frac=cap,
                      march_compact_schedule=march_sched)
        model = _replace(model, use_pallas_trace=True, shard_map_trace=True,
                         supervised_compact_frac=sup, tracer=tr)
    cfg = _replace(cfg, model=model)

    trainer = Trainer(cfg, scene, exp_dir, device=device,
                      profile_dir=args.profile_dir or None,
                      profile_epochs=args.profile_epochs,
                      trace_dir=args.trace_dir or None)
    return trainer, args


def main(argv=None):
    trainer, args = setup(argv)
    resume_step = (None if args.checkpoint == "latest"
                   else int(args.checkpoint))
    trainer.run(resume=args.is_continue, resume_step=resume_step)
    return trainer


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
