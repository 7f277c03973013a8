"""Training cells of the bf16 configuration (``--pallas --bf16_acts``): a
``train`` cell whose check holds the program to the reference in the
configuration's precision (``reference/bf16.py``), and whose traced run
also times the supervised SDF network's bf16 work at the step's rows.

The control (``reference(control=True)``) is that reference under bf16
autocast, lower than the configuration's precision everywhere;
``reference(backward_bf16=True)`` rounds the backward's f32 operands to
bf16 too (``calibrate_bf16.py`` reads it).

The traced run's readings (``kernel_timings``), where the program has the
bf16 operators and counts their rows (``bf16_gemm_rows``; the counts over
the window give the step's rows, and a ninth of them, the SDF network's
layer count, a layer's): ``act_bf16``, one launch of each of the
activation's bf16 entries as a layer launches them at a layer's rows x
512 (the forward, the VJP without and with the gradient it adds, the
VJP's VJP), by CUDA events; ``bf16_gemm``, the SDF network's nine bf16
products at a layer's rows and the model's layer shapes. Where the
program has none (no such operators, no rows counted) neither is read.
"""
from __future__ import annotations

import torch

from ..common import cuda_ms
from ..weights import implicit_shapes
from . import train


class Driver(train.Driver):
    def window(self, seconds: float) -> None:
        from mvsdf_tpu_torch.tracing.kernels import counts
        before = counts.snapshot()
        super().window(seconds)
        n = counts.since(before)
        steps = self.ctx["train_window"]["steps"]
        rows = n.get("bf16_gemm_rows")
        self.ctx["bf16_gemm_rows_per_step"] = rows / steps \
            if rows and steps else None

    def reference(self, control: bool = False, start: dict = None,
                  plan=None, backward_bf16: bool = False):
        """``train.Driver.reference`` through the bf16 configuration's
        reference."""
        from ..reference import bf16
        from ..reference import scene as ref_scene
        sc = ref_scene.Scene(self.root, self.device)
        params = {k: v.to(self.device).clone()
                  for k, v in self.weights0.items()}
        if plan is None:
            plan = self._plan(3 if start is None else 2)
        with train._no_tf32(), torch.autocast(self.device.type,
                                              dtype=torch.bfloat16,
                                              enabled=control):
            return bf16.train_steps(
                self.config, params, sc, plan, self.traffic["start_epoch"],
                self.seed, self.device, start and {1: start},
                backward_bf16=backward_bf16)

    def kernel_timings(self) -> None:
        super().kernel_timings()
        step_rows = self.ctx.get("bf16_gemm_rows_per_step")
        from mvsdf_tpu_torch.fields import mlp
        from mvsdf_tpu_torch.tracing.kernels import softplus100 as SP
        if not step_rows or not hasattr(SP.forward, "bf16") or \
                not hasattr(mlp, "bf16_linear"):
            return
        shapes = implicit_shapes(self.config["model"]["implicit"])
        rows = int(round(step_rows / len(shapes)))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        dev = self.device
        rand = lambda *s: torch.rand(s, generator=gen, device=dev) - 0.5
        cols = self.config["model"]["implicit"]["dims"][0]
        with torch.no_grad():
            y, b = rand(rows, cols), rand(cols) * 0.1
            z, _ = SP.forward(y, b, True, torch.bfloat16)
            g = rand(rows, cols).bfloat16()
            gg, a = rand(rows, cols), rand(rows, cols)
            self.ctx["act_bf16"] = {"rows": rows, "cols": cols, "ms": {
                "forward": cuda_ms(
                    lambda: SP.forward(y, b, True, torch.bfloat16), 50),
                "grad": cuda_ms(lambda: SP.grad(g, z), 50),
                "grad_a": cuda_ms(lambda: SP.grad(g, z, a), 50),
                "grad_grad": cuda_ms(lambda: SP.grad_grad(gg, g, z), 50)}}
            del y, z, g, gg, a
            ms = []
            for K, N in shapes:
                # the encoded input's rows padded to 16 bytes, as the
                # program lays them out (``fields/sdf.bf16_rows``)
                x = rand(rows, -(-K // 8) * 8).bfloat16()[:, :K]
                w16 = (rand(K, N) / K ** 0.5).bfloat16()
                w = w16.float()
                ms.append(cuda_ms(lambda: mlp.bf16_linear(x, w, w16), 50))
            self.ctx["bf16_gemm"] = {"rows": rows, "shapes": shapes,
                                     "ms": ms}
