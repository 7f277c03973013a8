"""Point-cloud reading of the Vis-MVSNet converter (port of
``load_ply_points`` from ``mvsdf_tpu/data/convert.py``). The eval CLI reads
a DTU scan's ground-truth STL cloud with it (``--dtu_stl``); the converter
itself is not ported yet.
"""
from __future__ import annotations

import numpy as np


def load_ply_points(path: str) -> np.ndarray:
    """Minimal PLY reader (ascii or binary_little_endian, x/y/z floats)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header if l.startswith("format")).split()[1]
        n = int(next(l for l in header if l.startswith("element vertex"))
                .split()[-1])
        props = [l.split() for l in header if l.startswith("property")
                 and not l.startswith("property list")]
        names = [p[2] for p in props]
        type_map = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4",
                    "uint": "u4", "short": "i2", "ushort": "u2"}
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            xyz = data[:, [names.index("x"), names.index("y"),
                           names.index("z")]]
        else:
            dt = np.dtype([(nm, "<" + type_map[p[1]])
                           for nm, p in zip(names, props)])
            data = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            xyz = np.stack([data["x"], data["y"], data["z"]], -1)
    return np.asarray(xyz, np.float64)
