"""Build the port's CUDA sources (`csrc/<name>.cu`) with nvcc and load them;
the one boundary between the kernels' wrappers and their C entry points.

Each source is compiled on its own into a shared library with a plain C
interface, cached in the package's `_build/` directory under a hash of the
source and the flags, and loaded with ctypes. `build(*names)` starts one
nvcc per missing library, all at once, and waits for every one of them;
`library(name)` returns the loaded library, building it at first use.
Nothing is built when the module is imported.

Every wrapper crosses the boundary the same way: `on_card` applies the
device rule (a CPU tensor runs the plain version, a CUDA tensor the kernel,
any other device raises); `check_arg` validates a tensor before its pointer
goes to a kernel; `entry` gives an exported C function with its argument
types; `launch` calls it on the device's current stream (a device other
than CUDA raises, as `card` says), raises on a nonzero CUDA error code and
counts the launch in `launch_counts` under `kernel.<kernel>.launches` (and
`kernel.<kernel>.launches.<arm>` for a specialisation), the names the
program's tracing records.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_libs: dict = {}
_entries: dict = {}

# the kernels' launches in this process, by recording name
launch_counts: collections.Counter = collections.Counter()


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


def card(fn: str, device) -> torch.device:
    """`device` as a torch.device when it is a CUDA device, the one where
    `fn` has its kernel; any other device raises ValueError."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    return dev


def on_card(fn: str, device) -> bool:
    """The device rule of every kernel wrapper `fn`: False on a CPU device
    (it runs the plain version), True on a CUDA device (it launches the
    kernel); any other device raises ValueError."""
    if torch.device(device).type == "cpu":
        return False
    card(fn, device)
    return True


def entry(source: str, name: str, argtypes=()):
    """The C function `name` exported by csrc/<source>.cu, with these
    argument types and an int result; loaded (and built) at first use and
    kept."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(source), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def launch(kernel: str, fn, device, *args, arm: Optional[str] = None,
           check: bool = True) -> int:
    """Call the C entry `fn` with `args` and the current CUDA stream of
    `device` (its last argument), and count the launch once it returns 0.
    A device other than CUDA raises ValueError; a nonzero CUDA error code
    raises RuntimeError, or with check=False is returned, uncounted."""
    stream = torch.cuda.current_stream(card(kernel, device))
    err = fn(*args, stream.cuda_stream)
    if err == 0:
        launch_counts[f"kernel.{kernel}.launches"] += 1
        if arm is not None:
            launch_counts[f"kernel.{kernel}.launches.{arm}"] += 1
    elif check:
        raise RuntimeError(f"{kernel} kernel launch failed (CUDA error {err})")
    return err
