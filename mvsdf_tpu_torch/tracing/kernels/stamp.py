"""Stage stamps and row counters of the graph-replayed training step
(``csrc/stamp.cu``).

While a ``StepProbe`` is entered (``train/step.CapturableStep`` enters one
around its step when the trainer traces), ``mark(i)`` writes the time into
stamp slot i of the probe's int64 row and ``count_rows`` adds the rows a
count entry or an SDF tile computed to its two counters. With no probe
entered they launch nothing: the captured graph is the untraced one.

On a CUDA buffer ``stamp`` is a one-thread kernel that writes the device's
``%globaltimer`` (nanoseconds) when the stream reaches it, so a CUDA graph
that captured it stamps every replay, inside conditional bodies too; on a
CPU buffer it writes ``time.perf_counter_ns()``. ``count`` reads its row
count from the device in the same way. Each launch adds one to the
wrapper's ``.launches`` (``counts`` carries it through replays).

The row (``SLOTS`` int64): stamps s0-s5 (step start; before and after the
trace; after the loss; after the gradients; after the metrics write), then
ACTIVE, the rows the count entries and the SDF tiles were asked for, and
COMPUTED, the rows they ran (a plain-field tile runs whole). Beside the
row, ``allreduce``: one int64 stamp after the data-parallel step's
gradient all-reduce, which only a step of several ranks writes
(``mark_allreduce``; a step of one process has none, and launches
nothing more).
"""
from __future__ import annotations

import time

import torch

STAMPS = 6
ACTIVE, COMPUTED = STAMPS, STAMPS + 1
SLOTS = STAMPS + 2

_ACTIVE = []


def stamp(buf: torch.Tensor, slot: int) -> None:
    """Write the time (ns) into ``buf[slot]`` (int64, contiguous): the
    device's ``%globaltimer`` where the stream reaches this point on a CUDA
    buffer, ``time.perf_counter_ns()`` on a CPU one."""
    if buf.device.type == "cpu":
        buf[slot] = time.perf_counter_ns()
        return
    from . import build
    from .launch import INT, PTR, raise_on_error, stream
    fn = build.function("stage_stamp", (PTR, INT, PTR))
    raise_on_error(fn(buf.data_ptr(), slot, stream(buf.device)),
                   "stage_stamp")
    stamp.launches += 1


stamp.launches = 0


def count(buf: torch.Tensor, n: torch.Tensor, mult: int, hi: int,
          computed: int = -1) -> None:
    """``buf[ACTIVE] += min(max(n, 0), hi) * mult`` and ``buf[COMPUTED] +=``
    the same, or ``computed`` where it is not negative; ``n`` a 0-d int
    tensor on buf's device, read there (no host sync on a CUDA buffer)."""
    if buf.device.type == "cpu":
        a = min(max(int(n), 0), hi) * mult
        buf[ACTIVE] += a
        buf[COMPUTED] += a if computed < 0 else computed
        return
    import ctypes
    from . import build
    from .launch import INT, PTR, raise_on_error, stream
    n = n.to(torch.int32)
    i64 = ctypes.c_longlong
    fn = build.function("stage_count", (PTR, INT, PTR, i64, i64, i64, PTR))
    raise_on_error(fn(buf.data_ptr(), ACTIVE, n.data_ptr(), mult, hi,
                      computed, stream(buf.device)), "stage_count")
    count.launches += 1


count.launches = 0


class StepProbe:
    """One step's stamp and counter row, ``buf`` (SLOTS int64 on the step's
    device), and its stamp after the gradient all-reduce, ``allreduce``.
    Entering zeroes the counters and stamps s0; leaving stamps s5;
    ``mark``, ``mark_allreduce`` and ``count_rows`` write into the
    innermost probe entered."""

    def __init__(self, device):
        self.buf = torch.zeros(SLOTS, dtype=torch.int64, device=device)
        self.allreduce = torch.zeros(1, dtype=torch.int64, device=device)

    def __enter__(self):
        _ACTIVE.append(self)
        self.buf[ACTIVE:].zero_()
        stamp(self.buf, 0)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            stamp(self.buf, STAMPS - 1)
        _ACTIVE.remove(self)
        return False


def mark(slot: int) -> None:
    """Stamp ``slot`` of the entered probe; nothing without one."""
    if _ACTIVE:
        stamp(_ACTIVE[-1].buf, slot)


def mark_allreduce() -> None:
    """Stamp the entered probe's ``allreduce``; nothing without one."""
    if _ACTIVE:
        stamp(_ACTIVE[-1].allreduce, 0)


def count_rows(n: torch.Tensor, hi: int, mult: int = 1,
               computed: int = -1) -> None:
    """Add ``min(max(n, 0), hi) * mult`` rows to the entered probe's ACTIVE
    counter and that, or ``computed``, to its COMPUTED; nothing without a
    probe."""
    if _ACTIVE:
        count(_ACTIVE[-1].buf, n, mult, hi, computed)
