"""Build the port's CUDA sources (`csrc/<name>.cu`) with nvcc and load them.

Each source is compiled on its own into a shared library with a plain C
interface, cached in the package's `_build/` directory under a hash of the
source and the flags, and loaded with ctypes. `build(*names)` starts one
nvcc per missing library, all at once, and waits for every one of them;
`library(name)` returns the loaded library, building it at first use;
`check_arg` validates a tensor before its pointer goes to a kernel.
Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_libs: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler ($CUDA_HOME/bin/nvcc, else on PATH)."""
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _paths(name: str):
    src = os.path.join(SRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build(*names: str) -> float:
    """Compile the named sources that are not built yet (one nvcc process
    each, run in parallel) and load them. Returns the seconds spent."""
    start = time.perf_counter()
    todo = [n for n in names if n not in _libs]
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for name in todo:
        src, so = _paths(name)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            running.append((src, so, tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, so, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        _libs[name] = ctypes.CDLL(_paths(name)[1])
    return time.perf_counter() - start


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    if name not in _libs:
        build(name)
    return _libs[name]


def check_arg(fn: str, name: str, x, dtype, shape, device) -> None:
    """Raise ValueError unless the kernel argument `name` of `fn` is a
    contiguous tensor of this dtype and shape on this device."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{fn}: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
