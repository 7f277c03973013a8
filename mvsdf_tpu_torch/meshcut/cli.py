"""Mesh trimming CLI (port of ``mvsdf_tpu/meshcut/cli.py``; the same
arguments, printed lines and output file):

    python -m mvsdf_tpu_torch.meshcut.cli IN.obj OUT.obj \\
        [--thresh 15|auto] [--smooth 10]

Host code only (numpy and the native max-flow, built at first use): it
needs no GPU.
"""
from __future__ import annotations

import argparse

from ..eval.mesh import load_obj, save_obj
from .cut import auto_threshold, indicator_separation, trim_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description="max-flow mesh trimming")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--thresh", default="15",
                    help="0-255 confidence threshold, or 'auto' for the "
                         "Otsu split between the mesh's own surface and "
                         "junk confidence modes (robust to an indicator "
                         "calibrated below the reference's >0.94)")
    ap.add_argument("--smooth", type=int, default=10)
    args = ap.parse_args(argv)

    verts, faces, colors = load_obj(args.input)
    if colors is None:
        raise SystemExit("input OBJ has no vertex colors "
                         "(surface-indicator confidences required)")
    thresh = args.thresh if args.thresh == "auto" else float(args.thresh)
    if thresh == "auto":
        conf = colors[faces, 0].mean(axis=1)
        t = auto_threshold(conf)
        sep = indicator_separation(conf)
        print(f"auto threshold: {t:.1f}/255 (mode gap {sep:.3f})")
        if sep < 0.1:
            print("WARNING: indicator modes are not separated — the mesh's "
                  "surface indicator looks untrained; the cut will "
                  "partition noise (consider more training or an explicit "
                  "--thresh)")
        thresh = t
    v, f, c = trim_mesh(verts, faces, colors, thresh=thresh,
                        smooth=args.smooth)
    save_obj(args.output, v, f, c)
    print(f"trimmed {len(faces) - len(f)}/{len(faces)} faces -> "
          f"{args.output}")


if __name__ == "__main__":
    main()
