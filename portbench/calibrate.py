"""The readings a training cell's limits are set from, on the card, at the
cell's own size: for each seed the numbers the check compares (with the
gradient's gap by the worst and by the median leaf), of the program (a
run's set-up, which drives the steps the check reads) and of the control:
the plain reference computed in bfloat16 (autocast) put in the program's
place. ``--faults`` also reads a fault planted in the reference put in the
program's place: half of each batch left out (its images replaced by the
other half's, so the mean is over the rest).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control_seeds 1,2,3] [--faults] [--out readings.jsonl]

One JSON line per reading. The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control_seeds", type=seeds, default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from portbench.common import Cell, driver_module, load_benchmark, \
        power_limit
    if not torch.cuda.is_available():
        sys.exit("calibrate: needs a CUDA device")
    cell = Cell(load_benchmark(), args.workload)
    cell.traffic["chunk_epochs"] = 1   # the check's epoch alone
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    card = power_limit()

    def emit(rec):
        rec.update(workload=cell.name, card=card)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        drv = driver_module(cell.kind).Driver(cell, seed, dev, False)
        drv.setup()
        drv.release()
        ref = drv.reference()
        if seed in args.seeds:
            emit({"seed": seed, "arm": "program", "losses": drv.losses,
                  **drv.readings(drv.program(), ref)})
        if seed in args.control_seeds:
            emit({"seed": seed, "arm": "control",
                  **drv.readings(drv.in_place_of_program(
                      drv.reference(control=True)), ref)})
            if args.faults:
                emit({"seed": seed, "arm": "fault_half_batch",
                      **drv.readings(half_batch(drv), ref)})
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


def half_batch(drv):
    """The reference with each batch's second half of images replaced by
    its first half, in the program's place."""
    halved = [(list(idx[:len(idx) // 2]) * 2, sel)
              for idx, sel in drv._plan(3)]
    return drv.in_place_of_program(drv.reference(plan=halved))


if __name__ == "__main__":
    main()
