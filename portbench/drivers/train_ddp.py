"""Data-parallel training cells: the training CLI's trainer as ``python -m
torch.distributed.run --nproc_per_node <ranks> -m mvsdf_tpu_torch.train.cli``
runs it, one process a card, each rank replaying its own captured step on
its share of every image's rays, the gradient and loss-count all-reduces
inside its graph.

Rank 0 is the benchmark's own process, on ``cuda:0``; it spawns ranks 1 to
n - 1 (this module run as a program, one a card) and joins a process group
with them (NCCL on the card, gloo on the CPU). Every rank then sets the
cell up as ``drivers/train.py`` does, from the same seed, weights, scene
and plan: each draws the whole batch's pixels and keeps its share. From
there rank 0 decides: before each chunk of the window, and before every
other step that runs on the device, it tells the others what to run by a
broadcast on a second, host-side group (gloo), outside any graph, so no
rank waits on the device to learn it. The window ends with a device sync
and a barrier of every rank; its rays are every rank's.

What the check reads is rank 0's (its loss and moments are the sums over
the ranks): the plain reference takes the whole batch, the union of the
ranks' pixels, as ``drivers/train.py`` gives it. Besides the train cell's
numbers, ``replica_gap``: the largest |w_r - w_0| over every parameter and
rank after the last chunk, whose limit is 0 (each rank applies the same
all-reduced gradient).

A traced run also reads, over ``traced_chunks`` chunks with the program's
tracing on every rank (``ctx["ddp"]``): rank 0's device time from the
stamp after ``autograd.grad`` to the one after the gradient all-reduce,
and each rank's time from the step's start to that first stamp (its
all-reduce's entry), whose spread over the ranks is the step's skew;
``step_counts`` is one rank's share (its rays, trace rows and hits).

Every wait is bounded: a worker that exits, or a run that makes no
progress for ``IDLE_S`` seconds, ends every process with an error. A
program that does not take its fused path under a process group
(``mvsdf_tpu_torch.train.loop.fuses``) is refused before anything is
spawned.

    python -m portbench.drivers.train_ddp SPEC.json

runs one worker rank (the spec rank 0 writes).
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from datetime import timedelta

import numpy as np

from .. import scene as scene_files
from ..common import ROOT
from . import train

# the longest a run may go without a step of progress: set-up (the scene,
# the kernels' build, the captures) fits it with room
IDLE_S = 600.0
# the host-side group's bound on one command's wait
CONTROL_TIMEOUT = timedelta(minutes=10)
JOIN_S = 120.0


def refuse_unless_fused() -> None:
    """Exit at once where the program's trainer does not take its fused
    chunk path under a process group."""
    from mvsdf_tpu_torch.config import MVSDFConfig
    from mvsdf_tpu_torch.train import loop
    fuses = getattr(loop, "fuses", None)
    if fuses is None or not fuses(MVSDFConfig()):
        print("portbench: the program's trainer does not fuse under a "
              "process group (mvsdf_tpu_torch.train.loop.fuses): no "
              "data-parallel cell on its chunk path", file=sys.stderr)
        sys.exit(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _environ(values: dict):
    """The process's environment with ``values`` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _die_with_parent() -> None:
    """In a worker before it runs: killed when rank 0's process ends."""
    import ctypes
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)   # PDEATHSIG


class Driver(train.Driver):
    def __init__(self, cell, seed: int, device, trace: bool,
                 cache: str = scene_files.CACHE, rank: int = 0):
        super().__init__(cell, seed, device, trace, cache)
        self.rank = rank
        self.world = self.config["ranks"]
        self.ctl = None        # the host-side group, after set-up
        self.procs = []        # rank 0: (rank, Popen, log path)
        self._nested = False
        self._beat = time.monotonic()
        self._stopping = False   # rank 0: the workers were told to stop
        self._done = threading.Event()

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        """The train cell's set-up on every rank, through the CLI as
        torchrun runs it: without ``--no_mesh``, so it joins the group.
        Rank 0 first writes the scene and spawns the others."""
        import torch.distributed as dist
        from mvsdf_tpu_torch.train import cli
        cli_setup = cli.setup
        cli.setup = lambda argv: cli_setup([a for a in argv
                                            if a != "--no_mesh"])
        try:
            if self.rank:
                super().setup()
            else:
                self._setup_rank0()
        finally:
            cli.setup = cli_setup
        self.ctl = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
        self._beat = time.monotonic()

    def _setup_rank0(self) -> None:
        refuse_unless_fused()
        t = time.perf_counter()
        # written once, before any other rank reads it
        scene_files.ensure_scene(self.cell.config_name,
                                 self.config["scene"], self.cache)
        scene_s = time.perf_counter() - t
        self._spawn()
        with _environ(self._rank_env(0)):
            super().setup()
        self.parts["scene_files"] += scene_s
        self.parts["spawn"] = self._spawn_s

    def _rank_env(self, r: int) -> dict:
        return {"WORLD_SIZE": str(self.world), "RANK": str(r),
                "LOCAL_RANK": str(r if self.device.type == "cuda" else 0),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(self._port)}

    def _spawn(self) -> None:
        """Ranks 1 to n - 1 as processes of this module, each with the
        cell, the seed and its rank in a spec file, its output in a log
        beside it; then the watch over them."""
        t = time.perf_counter()
        self._port = _free_port()
        self.work = os.path.join(self.cache, "ddp", self.cell.name)
        os.makedirs(self.work, exist_ok=True)
        cell = {k: getattr(self.cell, k) for k in
                ("name", "config_name", "config", "traffic", "kind")}
        for r in range(1, self.world):
            spec = os.path.join(self.work, f"rank{r}.json")
            with open(spec, "w") as f:
                json.dump({"rank": r, "cell": cell, "seed": self.seed,
                           "trace": self.trace, "cache": self.cache,
                           "device": self.device.type}, f)
            env = dict(os.environ, **self._rank_env(r))
            env["PYTHONPATH"] = os.pathsep.join(
                [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])
            if self.device.type == "cpu":
                env.setdefault("OMP_NUM_THREADS", "2")
            log = os.path.join(self.work, f"rank{r}.log")
            with open(log, "w") as out:
                p = subprocess.Popen(
                    [sys.executable, "-m", "portbench.drivers.train_ddp",
                     spec], cwd=ROOT, env=env, stdout=out,
                    stderr=subprocess.STDOUT, preexec_fn=_die_with_parent)
            self.procs.append((r, p, log))
        self._spawn_s = time.perf_counter() - t
        threading.Thread(target=self._watch, daemon=True,
                         name="ddp_watch").start()

    def _watch(self) -> None:
        """Rank 0's watch: a worker that exits before it is told to, or no
        progress for IDLE_S seconds, ends every process."""
        while not self._done.wait(0.5):
            dead = [(r, p.returncode) for r, p, _ in self.procs
                    if p.poll() is not None and
                    (p.returncode or not self._stopping)]
            idle = time.monotonic() - self._beat
            if dead or idle > IDLE_S:
                why = (f"worker ranks ended early (rank, exit code): {dead}"
                       if dead else f"no progress for {idle:.0f} s")
                self._abort(why)

    def _abort(self, why: str) -> None:
        print(f"portbench: data-parallel run failed: {why}", file=sys.stderr)
        for r, p, log in self.procs:
            with contextlib.suppress(OSError):
                with open(log) as f:
                    tail = f.read()[-3000:]
                print(f"--- rank {r}'s log (end) ---\n{tail}",
                      file=sys.stderr)
            with contextlib.suppress(OSError):
                p.kill()
        sys.stderr.flush()
        os._exit(3)

    # -- what every rank runs, told by rank 0 -----------------------------
    def _all(self, name: str, *args, gather: bool = False):
        """``_cmd_<name>(*args)`` on every rank: rank 0 broadcasts it on the
        host-side group (not from inside another command), then runs it.
        Returns this rank's result, or with ``gather`` (on rank 0) every
        rank's, in rank order."""
        import torch.distributed as dist
        self._beat = time.monotonic()
        if self.rank == 0 and self.ctl is not None and not self._nested:
            dist.broadcast_object_list([(name, args, gather)], src=0,
                                       group=self.ctl)
        return self._run(name, args, gather)

    def _run(self, name, args, gather):
        import torch.distributed as dist
        nested, self._nested = self._nested, True
        try:
            out = getattr(self, "_cmd_" + name)(*args)
        finally:
            self._nested = nested
        if not gather:
            return out
        got = [None] * self.world if self.rank == 0 else None
        dist.gather_object(out, got, dst=0, group=self.ctl)
        return got

    def serve(self) -> None:
        """A worker's loop: rank 0's commands until ``stop``."""
        import torch.distributed as dist
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.ctl)
            name, args, gather = box[0]
            self._run(name, args, gather)
            if name == "stop":
                return

    def _chunk(self):
        return self._all("chunk")

    def _cmd_chunk(self):
        return super()._chunk()

    def _sync(self):
        """A device sync; once set up, every rank's, then a barrier."""
        if self.ctl is None:
            return super()._sync()
        return self._all("sync")

    def _cmd_sync(self):
        import torch.distributed as dist
        super()._sync()
        dist.barrier(group=self.ctl)

    def _cmd_window_start(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def _cmd_peak(self):
        if self.device.type != "cuda":
            return None
        import torch
        return torch.cuda.max_memory_reserved(self.device)

    def _cmd_params(self):
        import torch
        return torch.cat([p.detach().reshape(-1).cpu() for p in
                          self.trainer.state.net.parameters()]).numpy()

    def _cmd_set_tracing(self, on: bool):
        self.trainer.set_tracing(on)

    def _cmd_traced_block(self, chunks: int):
        """Tracing on (a chunk captures the traced step), ``chunks`` traced
        chunks ending with a device sync, tracing off: this rank's
        per-step device ns from the step's start to the stamp after
        ``autograd.grad`` (s4) and from there to the one after the
        gradient all-reduce, and the tracer's summary of those chunks."""
        tr = self.trainer
        tr.set_tracing(True)
        self._cmd_chunk()
        first = self.epoch
        for _ in range(chunks):
            self._cmd_chunk()
        tr._flush_metrics()
        train.Driver._sync(self)
        picked = [c for c in tr.tracer.chunks if c["chunk"] >= first]
        rows = np.concatenate([c["rows"][c["replay"]] for c in picked])
        after = np.concatenate([c["allreduce"][c["replay"]] for c in picked])
        summary = tr.tracer.summary(chunks=[c["chunk"] for c in picked])
        tr.set_tracing(False)
        return {"to_allreduce_ns": rows[:, 4] - rows[:, 0],
                "allreduce_ns": after - rows[:, 4],
                "summary": {k: v for k, v in summary.items()
                            if k != "boundaries"}}

    def _cmd_write_spans(self, path: str):
        """This rank's tracer as ``path`` (rank 0) or ``path`` with
        ``.rank<r>`` before its extension."""
        if self.rank:
            head, ext = os.path.splitext(path)
            path = f"{head}.rank{self.rank}{ext}"
        self.trainer._flush_metrics()
        self.trainer.tracer.write(path)

    def _cmd_summaries(self, chunks):
        self.trainer._flush_metrics()
        return {k: v for k, v in
                self.trainer.tracer.summary(chunks=chunks).items()
                if k != "boundaries"}

    def _cmd_stop(self):
        import torch.distributed as dist
        if self.trainer is not None:
            self.trainer._release_fused_steps()
        dist.destroy_process_group()

    # what scripts and tools drive on every rank
    def set_tracing(self, on: bool) -> None:
        self._all("set_tracing", on)

    def write_spans(self, path: str) -> None:
        self._all("write_spans", path)

    def rank_summaries(self, chunks) -> list:
        """Each rank's ``Tracer.summary`` of the chunks, in rank order."""
        return self._all("summaries", chunks, gather=True)

    # -- the window and what only the traced run reads --------------------
    def window(self, seconds: float) -> None:
        self._all("window_start")
        super().window(seconds)

    def kernel_timings(self) -> None:
        """The train cell's readings, with one rank's share of the step's
        counts, then the traced block on every rank (module docstring)."""
        super().kernel_timings()
        got = self._all("traced_block", self.traffic["traced_chunks"],
                        gather=True)
        pre = np.stack([g["to_allreduce_ns"] for g in got])
        self.ctx["ddp"] = {
            "world": self.world, "model": self.config["model"],
            "allreduce_ms": float(np.median(got[0]["allreduce_ns"])) / 1e6,
            "rank_skew_ms": float(np.median(pre.max(0) - pre.min(0))) / 1e6,
            "steps": int(pre.shape[1]),
            "summaries": [g["summary"] for g in got]}
        d = self.ctx["ddp"]
        print(f"portbench: traced {d['steps']} steps on {self.world} ranks: "
              f"all-reduce {d['allreduce_ms']:.4f} ms (rank 0), skew "
              f"{d['rank_skew_ms']:.4f} ms a step; stages by rank: " +
              "; ".join(", ".join(f"{k.split('.')[-1]} {v:.3f}"
                                  for k, v in s.items()
                                  if k.startswith("step_stage_ms"))
                        for s in d["summaries"]), file=sys.stderr)

    def _reference_counts(self) -> dict:
        self._share = True
        try:
            return super()._reference_counts()
        finally:
            self._share = False

    def _plan(self, n: int):
        """The train cell's plan; inside ``_reference_counts`` rank 0's
        share of each subset, as ``host_ray_slice`` takes it."""
        plan = super()._plan(n)
        if getattr(self, "_share", False):
            per = len(plan[0][1]) // self.world
            plan = [(idx, sel[:per]) for idx, sel in plan]
        return plan

    # -- the check ------------------------------------------------------
    def release(self) -> None:
        """Every rank's weights against rank 0's, every rank's memory
        peak on standard error, the workers stopped and joined, then the
        train cell's release."""
        params = self._all("params", gather=True)
        self.replica_gap = max(float(np.abs(p - params[0]).max())
                               for p in params)
        peaks = self._all("peak", gather=True)
        if peaks[0] is not None:
            print("portbench: window's memory peak by rank (GiB): " +
                  ", ".join(f"{p / 2 ** 30:.3f}" for p in peaks),
                  file=sys.stderr)
        self._stopping = True
        self._all("stop")
        deadline = time.monotonic() + JOIN_S
        for r, p, _ in self.procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                self._abort(f"rank {r} did not end after stop")
        self._done.set()
        bad = [(r, p.returncode) for r, p, _ in self.procs if p.returncode]
        if bad:
            self._abort(f"worker ranks failed (rank, exit code): {bad}")
        super().release()
        import shutil
        shutil.rmtree(self.work, ignore_errors=True)

    def check(self):
        return super().check() + [("replica_gap", self.replica_gap,
                                   self.traffic["limits"]["replica_gap"])]


def main(argv=None) -> None:
    """One worker rank: set-up, then rank 0's commands."""
    import torch
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    r = spec["rank"]
    device = torch.device("cuda", r) if spec["device"] == "cuda" else \
        torch.device("cpu")
    cell = types.SimpleNamespace(**spec["cell"])
    drv = Driver(cell, spec["seed"], device, spec["trace"], spec["cache"],
                 rank=r)
    drv.setup()
    drv.serve()


if __name__ == "__main__":
    main()
