"""What every kernel wrapper of this package uses to launch: the ctypes
argument types, the device test, the current stream and the check of a
launch's error code. Imports nothing of the fields, so a field can import
a kernel's wrapper."""
from __future__ import annotations

import ctypes

import torch

PTR, INT = ctypes.c_void_p, ctypes.c_int


def on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return False


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
