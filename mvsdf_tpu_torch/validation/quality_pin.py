"""Fixed-seed trained-quality gate (counterpart of the JAX repo's
``scripts/quality_pin.py``): runs the 600-epoch capstone at seed 0
(``python -m mvsdf_tpu_torch.validation.full_training``, the production
stack through the ``sdf_mlp`` kernel) and holds its summary to two sets:

(a) ``REFERENCE_BARS``, the JAX package's quality measured on a TPU v5e,
    which the port must reach: its seed-0 pin's chamfer 0.00935 plus its
    0.003 tolerance; held-out PSNR at the cross-seed 22.0 less twice its
    1.5 spread (the port's in-step draws are not JAX's, so the run is
    another seed); indicator accuracy at the pin's 0.642 less its 0.2;
    no non-finite epoch. Set before the port's first run on the card and
    never widened after.
(b) ``PIN``, the port's own seed-0 values with the JAX pin's tolerances:
    a drift tripwire for changes that cost quality inside the seed bars.

Exits non-zero on a miss. Run it on the GPU (~2 min on an H100):

    python -m mvsdf_tpu_torch.validation.quality_pin [--epochs 600]

Re-pin after an intentional quality-affecting change with --print-pin.
``gate`` checks a summary the caller already has.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict, List, Tuple

# (a) key -> (direction, limit)
REFERENCE_BARS: Dict[str, Tuple[str, float]] = {
    "chamfer_overall": ("<=", 0.00935 + 0.003),
    "heldout_psnr": (">=", 22.0 - 2 * 1.5),
    "indicator_acc": (">=", 0.642 - 0.2),
    "nonfinite_epochs": ("<=", 0),
}
# (b) key -> (pinned, tolerance): the values --print-pin printed for the
# port's seed-0 600-epoch run on an "NVIDIA H100 80GB HBM3, 700.00 W"
# (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader), with
# the JAX pin's tolerances. Those runs were not bit-reproducible: their
# frozen features came from nondeterministic cuDNN convolutions (since
# computed on cuDNN's deterministic algorithms, scene.frozen_features), and
# an earlier run of the same code read 0.00878 / 22.46 / 0.65 / 0.338.
PIN: Dict[str, Tuple[float, float]] = {
    "chamfer_overall": (0.00845, 0.003),
    "heldout_psnr": (22.42, 1.0),
    "indicator_acc": (0.642, 0.2),
    "indicator_sigmoid_on_med": (0.337, 0.15),
}
NONFINITE_MAX = 0


def gate(summary: dict, bars: bool = True, pin: bool = True) -> List[str]:
    """The misses of ``summary`` (full_training's) against the reference
    bars (a) and the port's pin (b); empty when it passes."""
    failures = []
    if bars:
        for key, (op, limit) in REFERENCE_BARS.items():
            got = summary[key]
            ok = got <= limit if op == "<=" else got >= limit
            if not ok:
                failures.append(f"{key}: {got} not {op} {limit:g} "
                                f"(reference bar)")
    if pin:
        for key, (pinned, tol) in PIN.items():
            got = summary[key]
            if abs(got - pinned) > tol:
                failures.append(f"{key}: {got} vs pinned {pinned} ±{tol}")
        nf = summary["nonfinite_epochs"]
        if nf > NONFINITE_MAX:
            failures.append(f"nonfinite_epochs: {nf}")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description="fixed-seed trained-quality "
                                             "gate (PyTorch/CUDA port)")
    ap.add_argument("--print-pin", action="store_true",
                    help="run and print the measured values in PIN format "
                         "instead of gating")
    ap.add_argument("--epochs", type=int, default=600)
    args = ap.parse_args(argv)

    r = subprocess.run(
        [sys.executable, "-m", "mvsdf_tpu_torch.validation.full_training",
         "--seed", "0", "--epochs", str(args.epochs)],
        capture_output=True, text=True, timeout=5400)
    sys.stderr.write(r.stdout[-3000:] + r.stderr[-2000:])
    if r.returncode != 0:
        raise SystemExit(f"validation run failed: {r.returncode}")
    summary = json.loads(
        [l for l in r.stdout.strip().splitlines() if l.startswith("{")][-1])

    if args.print_pin:
        print(json.dumps({k: summary[k] for k in PIN}))
        return summary

    failures = gate(summary)
    if failures:
        print("QUALITY PIN FAILED:\n  " + "\n  ".join(failures))
        raise SystemExit(1)
    print("quality pin OK:",
          json.dumps({k: summary[k] for k in
                      dict.fromkeys(list(REFERENCE_BARS) + list(PIN))}))
    return summary


if __name__ == "__main__":
    main()
