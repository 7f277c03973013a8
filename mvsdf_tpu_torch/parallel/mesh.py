"""The process group of a data-parallel run (port of
``mvsdf_tpu/parallel/mesh.py``).

The JAX package lays a 1-D ``data`` mesh over every device and lets XLA
insert the collectives. Here each GPU runs its own process, launched by
``python -m torch.distributed.run`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``); rank r holds the r-th
share of the ray axis, and the parameters are replicated. Without
``WORLD_SIZE`` in the environment nothing is initialised and the run is
one process: ``world_size()`` is then 1 and ``rank()`` 0.

The group's start, and every collective it runs outside a CUDA graph, is
bounded by ``COLLECTIVE_TIMEOUT``: a rank that is lost fails the others'
waits instead of hanging them. (A collective that a graph replays is not
watched by torch: whoever drives the replays bounds its own waits.)
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
# the longest a rank waits in the group's start or in one collective
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def world_size() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank; a no-op in one process."""
    if world_size() > 1:
        dist.barrier()


def init_distributed(backend: Optional[str] = None,
                     device: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device: ``cuda:LOCAL_RANK`` (made current), or the
    CPU when ``device`` is ``"cpu"``. ``backend`` defaults to NCCL on the
    GPU and gloo on the CPU. Without ``WORLD_SIZE`` it initialises nothing
    and returns the device alone (the counterpart of the JAX package's
    single-host ``initialize_multihost``)."""
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    world = int(os.environ["WORLD_SIZE"])
    r = int(os.environ["RANK"])
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=r,
                            timeout=COLLECTIVE_TIMEOUT, **kw)
    return dev
