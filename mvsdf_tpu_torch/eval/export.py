"""Serving export of the trained renderer (port of
``mvsdf_tpu/eval/export.py``).

Captures the eval-mode render function (a fixed chunk of rays -> RGB) with
``torch.export`` and saves the ``ExportedProgram`` (``torch.export.save``):
a serving process loads and calls it without the model code, the config
system or the dataset layer (``load_renderer`` imports only the SDF
activation's operator, below). The parameters stay a call-time input (the
port's state dict, through ``torch.func.functional_call``), so one artifact
serves every checkpoint of the same architecture.

The export captures the plain field and the static formulation of the
trace (``trace_rays(mode=STATIC)``: fixed iteration counts, masks instead
of gathers), with the shading normals from the hand-derived value +
gradient: ``torch.export`` can capture neither the live trace's host-synced
loops and gathers nor ``torch.autograd.grad``. As in the JAX package, which
exports its pure-XLA path, the trace's hand-written kernels stay a runtime
optimisation of the live CLIs. The SDF network's activation is an operator
(``mvsdf::softplus100_bias``, ``tracing/kernels/softplus100.py``), which
the artifact records and calls: on the card it launches its kernel,
elsewhere it runs PyTorch's ops; ``load_renderer`` registers it. The
artifact is traced on the device the CLI runs on and moved to each device
it serves on by ``torch.export.passes.move_to_device_pass``.

CLI:
    python -m mvsdf_tpu_torch.eval.export --conf mvsdf_dtu.conf \\
        --out renderer.pt2 [--chunk 10000] [--platforms cpu,cuda]

Loading:
    from mvsdf_tpu_torch.eval.export import load_renderer
    fn = load_renderer("renderer.pt2")   # fn(params, uv, intr, pose, mask)
    rgb = fn(net.state_dict(), uv, intr, pose, mask)
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import time

import torch
from torch import nn

from ..device import resolve_device


class _RenderModule(nn.Module):
    """render_forward's eval-mode rgb in the static formulation, as a
    module, so that ``functional_call`` can swap its parameters."""

    def __init__(self, model, net):
        super().__init__()
        self.model, self.net = model, net

    def forward(self, uv, intrinsics, pose, object_mask):
        from ..rendering.renderer import render_forward
        from ..tracing.sphere_trace import STATIC
        inputs = {"uv": uv, "intrinsics": intrinsics, "pose": pose,
                  "object_mask": object_mask}
        return render_forward(self.model, self.net, inputs, training=False,
                              mode=STATIC).rgb_values


def make_render_fn(cfg):
    """The (params, uv, intrinsics, pose, object_mask) -> rgb eval-mode
    render the artifact captures, ``params`` a state dict of the port's
    ``MVSDFNetwork``. Shapes: uv (1, P, 2), intrinsics (1, 4, 4), pose
    (1, 4, 4), object_mask (1, P) bool -> rgb (1, P, 3). The module
    structure is built on the meta device: it holds no weights of its
    own."""
    from ..fields.network import MVSDFNetwork

    model = dataclasses.replace(cfg.model, use_pallas_trace=False)
    with torch.device("meta"):
        module = _RenderModule(model, MVSDFNetwork(model.implicit,
                                                   model.render))

    def render(params, uv, intrinsics, pose, object_mask):
        return torch.func.functional_call(
            module, {f"net.{k}": v for k, v in params.items()},
            (uv, intrinsics, pose, object_mask), strict=True)

    return render


class _Renderer(nn.Module):
    """The render function as the module ``torch.export`` captures."""

    def __init__(self, cfg):
        super().__init__()
        self.render = make_render_fn(cfg)

    def forward(self, params, uv, intrinsics, pose, object_mask):
        return self.render(params, uv, intrinsics, pose, object_mask)


def _example_inputs(params, chunk: int, device):
    """Zero-filled inputs of the artifact's shapes on ``device``."""
    dev = torch.device(device)
    p = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
         for k, v in params.items()}   # a plain dict, whatever params is
    return (p, torch.zeros((1, chunk, 2), device=dev),
            torch.eye(4, device=dev)[None], torch.eye(4, device=dev)[None],
            torch.zeros((1, chunk), dtype=torch.bool, device=dev))


def export_renderer(cfg, params, chunk: int = 10000,
                    platforms=("cpu", "cuda"), device=None) -> bytes:
    """Capture the render function for a fixed ray-chunk size, traced on
    ``device`` (the GPU unless the caller names another), and return the
    saved ``ExportedProgram``. ``params`` (a state dict) gives the
    parameters' shapes only: they stay a call-time input. The artifact is
    moved to each device in ``platforms`` and loaded there before it is
    returned."""
    from torch.export.passes import move_to_device_pass
    dev = resolve_device(device)
    targets = [resolve_device(p) for p in platforms]
    args = _example_inputs(params, chunk, dev)
    with torch.no_grad():
        ep = torch.export.export(_Renderer(cfg), args, strict=False)
    for target in targets:
        move_to_device_pass(ep, target).module()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_renderer(path_or_bytes, device=None):
    """Load an exported renderer onto ``device`` (the GPU unless the caller
    names another) -> callable (params, uv, intrinsics, pose, object_mask)
    -> rgb."""
    from torch.export.passes import move_to_device_pass

    from ..tracing.kernels import softplus100  # noqa: F401 (the operators)
    dev = resolve_device(device)
    src = io.BytesIO(bytes(path_or_bytes)) if isinstance(
        path_or_bytes, (bytes, bytearray)) else path_or_bytes
    module = move_to_device_pass(torch.export.load(src), dev).module()

    def render(params, uv, intrinsics, pose, object_mask):
        # the artifact's input spec is a plain dict (a state dict is an
        # OrderedDict)
        return module(dict(params), uv, intrinsics, pose, object_mask)

    return render


def main(argv=None):
    ap = argparse.ArgumentParser(description="export renderer for serving")
    ap.add_argument("--out", required=True)
    ap.add_argument("--conf", default="",
                    help="HOCON config of the architecture (default: the "
                         "full-size DTU architecture)")
    ap.add_argument("--chunk", type=int, default=10000)
    ap.add_argument("--platforms", default="cpu,cuda",
                    help="devices the artifact is checked to load on")
    ap.add_argument("--platform", default="", choices=["", "cpu", "cuda",
                                                       "gpu"],
                    help="device to trace on: 'cpu', or the GPU (default)")
    args = ap.parse_args(argv)

    from ..config import MVSDFConfig
    from ..train.step import init_params

    device = "cpu" if args.platform == "cpu" else "cuda"
    if args.conf:
        from ..hocon import config_from_hocon
        cfg = config_from_hocon(args.conf)
    else:
        cfg = MVSDFConfig()
    params = init_params(cfg, seed=0, device=device).state_dict()
    t0 = time.perf_counter()
    blob = export_renderer(cfg, params, chunk=args.chunk,
                           platforms=tuple(args.platforms.split(",")),
                           device=device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported renderer ({len(blob) / 1e6:.2f} MB, chunk "
          f"{args.chunk}, platforms {args.platforms}, traced on {device} in "
          f"{time.perf_counter() - t0:.1f} s) -> {args.out}")


if __name__ == "__main__":
    main()
