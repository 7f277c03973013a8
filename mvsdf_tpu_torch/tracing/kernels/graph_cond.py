"""Conditional nodes in a CUDA graph under capture (``csrc/graph_cond.cu``).

``ConditionalBodies`` is entered inside a ``torch.cuda.graph`` capture;
while it is active, ``compaction.run_if`` captures its body into an "if"
node of the graph (``if_node``) that every replay runs or skips by a bool
on the device. Bodies are captured on a side stream of their own, in the
main capture's mode (``capture_error_mode``), and what they allocate comes
from a memory pool of their own, kept until ``release()``: the graph's own
pool takes only its capture stream's allocations. Nothing here runs
outside a capture, and nothing here is imported by a CPU path.
"""
from __future__ import annotations

import contextlib

import torch

from . import build
from .launch import INT, PTR, raise_on_error

_ACTIVE = []
# torch.cuda.graph's capture_error_mode -> cudaStreamCaptureMode
CAPTURE_MODES = {"global": 0, "thread_local": 1, "relaxed": 2}


class ConditionalBodies:
    """The side stream and memory pool of a graph's conditional bodies.
    Enter inside the graph's capture, made with ``capture_error_mode``;
    call ``release()`` once the graph is gone (its bodies' memory goes back
    to the allocator)."""

    def __init__(self, device: torch.device,
                 capture_error_mode: str = "global"):
        self.mode = CAPTURE_MODES[capture_error_mode]
        self.device = torch.device(device)
        self.index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self._held = False

    def __enter__(self):
        if not torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ConditionalBodies is entered inside a CUDA "
                               "graph capture")
        # the bodies' stream alone allocates from the bodies' pool
        with torch.cuda.stream(self.stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(self.index,
                                                            self.pool)
        self._held = True
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        torch._C._cuda_endAllocateToPool(self.index, self.pool)
        return False

    def release(self):
        """Give the bodies' pool back (after the graph is destroyed)."""
        if self._held:
            self._held = False
            torch._C._cuda_releasePool(self.index, self.pool)


def active() -> ConditionalBodies:
    if not _ACTIVE:
        raise RuntimeError("a conditional node is captured inside "
                           "ConditionalBodies (tracing/kernels/graph_cond)")
    return _ACTIVE[-1]


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the block's work into an "if" node of the graph being
    captured on the current stream, run by each replay where the 0-d bool
    ``pred`` (on the device) holds then."""
    bodies = active()
    if pred.dtype != torch.bool or pred.dim() != 0 or not pred.is_cuda:
        raise ValueError("pred must be a 0-d bool CUDA tensor")
    begin = build.function("graph_if_begin", (PTR, PTR, PTR, INT))
    end = build.function("graph_if_end", (PTR,))
    main = torch.cuda.current_stream(bodies.device)
    raise_on_error(begin(main.cuda_stream, pred.data_ptr(),
                         bodies.stream.cuda_stream, bodies.mode),
                   "graph_if_begin")
    try:
        with torch.cuda.stream(bodies.stream):
            yield
    finally:
        raise_on_error(end(bodies.stream.cuda_stream), "graph_if_end")
