"""Build and load the trace's CUDA kernels and the host C++ libraries.

Every ``csrc/*.cu`` is compiled for sm_90a by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ctypes. The library lands in ``_build/``
beside this file, named by a hash of every CUDA file under ``csrc/``
(``*.cu`` sources and ``*.cuh`` headers) and of the compiler flags, so an
edit to any of them, or to the flags, builds a new one. The build runs at
the first launch of any kernel, never at import.

A ``csrc/*.cpp`` file is host code (the mesh triangulator, the mesh
trimming's max-flow): ``host_library`` compiles it alone with the system
C++ compiler into its own library in ``_build/``, named by a hash of the
source and the flags, at first use. It needs no CUDA toolkit, so it builds
wherever ``c++`` is.
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
# no fused multiply-adds: the triangulator's f32 arithmetic stays numpy's
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
CUDA_SUFFIXES = (".cu", ".cuh")

_LIB = None
_FNS = {}
_HOST_LIBS = {}
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
    """The CUDA files under ``csrc``: what the kernels' library is built
    from."""
    return sorted(f for f in os.listdir(csrc)
                  if os.path.isfile(os.path.join(csrc, f)) and
                  f.endswith(CUDA_SUFFIXES))


def library_path(csrc: str = CSRC, build_dir: str = BUILD_DIR) -> str:
    """Path of the library built from ``csrc``: named by a hash of every
    CUDA file there (name and bytes) and of the compiler flags."""
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


def host_library_path(source: str, csrc: str = CSRC,
                      build_dir: str = BUILD_DIR) -> str:
    """Path of the host library built from ``csrc/source``: named by a hash
    of the source's bytes and the compiler flags."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    with open(os.path.join(csrc, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_host(source: str, csrc: str = CSRC,
               build_dir: str = BUILD_DIR) -> str:
    """Compile the host C++ file ``csrc/source`` into a shared library with
    the system C++ compiler (no-op when it exists); returns its path."""
    path = host_library_path(source, csrc, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler found to build {source}")
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *HOST_FLAGS, os.path.join(csrc, source),
                          "-o", tmp], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cxx)} {source} failed "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return path


def host_library(source: str) -> ctypes.CDLL:
    """The host library of ``csrc/source``, built at first use; the caller
    sets its functions' argument and result types."""
    with _LOCK:
        if source not in _HOST_LIBS:
            _HOST_LIBS[source] = ctypes.CDLL(build_host(source))
        return _HOST_LIBS[source]
