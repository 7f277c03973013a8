"""``calibrate.py``'s readings of a bf16 cell (``drivers/train_bf16.py``),
with one more control: the bf16 configuration's reference with the
backward's f32 operands rounded to bf16 too (``reference/bf16.py``,
``backward_bf16``), the shortcut the configuration's precision forbids,
put in the program's place. Arms: ``program`` on ``--seeds``; on
``--control_seeds`` ``control`` (bf16 autocast), ``fault_half_batch`` and
``control_backward_bf16``. The same for any ``train`` cell without the
last arm (``--no_backward_bf16``).

    python3 portbench/calibrate_bf16.py --workload <cell> --seeds 1,2,... \\
        [--control_seeds 1,2,3] [--out readings.jsonl]

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


def main(argv=None):
    from portbench.calibrate import half_batch, seeds
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control_seeds", type=seeds, default=[])
    ap.add_argument("--no_backward_bf16", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from portbench.common import Cell, driver_module, load_benchmark, \
        power_limit
    if not torch.cuda.is_available():
        sys.exit("calibrate_bf16: needs a CUDA device")
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
            emit({"seed": seed, "arm": "fault_half_batch",
                  **drv.readings(half_batch(drv), ref)})
            if not args.no_backward_bf16:
                emit({"seed": seed, "arm": "control_backward_bf16",
                      **drv.readings(drv.in_place_of_program(
                          drv.reference(backward_bf16=True)), ref)})
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
