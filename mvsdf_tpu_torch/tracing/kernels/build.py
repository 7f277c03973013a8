"""Build and load the trace's CUDA kernels.

Every ``csrc/*.cu`` is compiled for sm_90a by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ctypes. The library lands in ``_build/``
beside this file, named by a hash of every file under ``csrc/`` (sources
and headers) and of the compiler flags, so an edit anywhere there, or to
the flags, builds a new one. The build runs at the first launch of any
kernel, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
_FNS = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found: the trace's kernels are built from "
                       f"{CSRC} with the CUDA toolkit")


def _files(csrc: str) -> List[str]:
    return sorted(f for f in os.listdir(csrc)
                  if os.path.isfile(os.path.join(csrc, f)))


def library_path(csrc: str = CSRC, build_dir: str = BUILD_DIR) -> str:
    """Path of the library built from ``csrc``: named by a hash of every
    file there (name and bytes) and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _files(csrc):
        h.update(b"\0" + name.encode() + b"\0")
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir,
                        f"libtrace_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False, csrc: str = CSRC,
          build_dir: str = BUILD_DIR) -> str:
    """Compile every ``csrc/*.cu`` (no-op when the library exists); returns
    the library path. ``verbose`` prints what ptxas says of each kernel
    (registers, shared memory, spills)."""
    path = library_path(csrc, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    sources = [f for f in _files(csrc) if f.endswith(".cu")]
    procs = []
    for src in sources:
        obj = os.path.join(build_dir, f"{src}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(csrc, src)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs, errors = [], []
    for src, obj, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {src} failed ({proc.returncode}):\n{err}")
        elif verbose:
            print(f"[nvcc {src}]\n{(out + err).strip()}")
        objs.append(obj)
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = f"{path}.{tag}"
        res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                              *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return path


def function(name: str, argtypes: Sequence):
    """The C entry point ``name`` of the library (built at first use),
    returning an int (a cudaError_t). Pointers and the stream are
    ``ctypes.c_void_p``: a bare Python int would be cut to 32 bits."""
    global _LIB
    with _LOCK:
        if name not in _FNS:
            if _LIB is None:
                _LIB = ctypes.CDLL(build())
            fn = getattr(_LIB, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        return _FNS[name]
