"""Shared-memory capacity probe: the CUDA kernel `csrc/probe_smem.cu` and its
plain version.

Counterpart of the VMEM capacity probe in `tools/probe_traversal.py`
(`try_mb`, whose kernel writes ones to the first and last 8x128 floats of a
scratch and returns their sum). `probe_smem(device)` binary-searches, in
KiB, the largest dynamic shared memory a launch of the kernel accepts and
returns (out f32[8, 128], bytes). On the CPU it returns the plain version
`probe_smem_ref`: the expected array, and the card's opt-in limit per block
when the device is a CUDA card (None on the CPU). On a CUDA device it
launches the kernel or raises; it never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import csrc_build

LO_KIB, HI_KIB = 8, 1024    # search range: 8 KiB holds both 4 KiB ends

# number of kernel launches, counted by `launch` where it launches
launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = csrc_build.library("probe_smem")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.probe_smem_launch.argtypes = [vp, ci, vp]
        lib.probe_smem_launch.restype = ci
        lib.probe_smem_optin_limit.argtypes = [ci, ctypes.POINTER(ci)]
        lib.probe_smem_optin_limit.restype = ci
        _lib = lib
    return _lib


def optin_limit(device) -> int:
    """cudaDevAttrMaxSharedMemoryPerBlockOptin of a CUDA device, bytes."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    value = ctypes.c_int(0)
    err = _library().probe_smem_optin_limit(index, ctypes.byref(value))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed (CUDA error {err})")
    return value.value


def probe_smem_ref(device="cpu"):
    """Plain version: (f32[8, 128] of 2.0 on `device`, the opt-in limit in
    bytes for a CUDA device, else None)."""
    dev = torch.device(device)
    out = torch.full((8, 128), 2.0, dtype=torch.float32, device=dev)
    return out, optin_limit(dev) if dev.type == "cuda" else None


def launch(nbytes: int, device="cuda"):
    """One launch with nbytes of dynamic shared memory: (CUDA error code,
    out); out holds the kernel's result when the code is 0."""
    global launches
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"probe_smem: no kernel for device {dev}")
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    err = _library().probe_smem_launch(
        out.data_ptr(), int(nbytes), torch.cuda.current_stream(dev).cuda_stream)
    if err == 0:
        launches += 1
    return err, out


def probe_smem(device="cuda"):
    """Largest dynamic shared memory (bytes, a whole number of KiB) that a
    launch accepts, and that launch's output f32[8, 128]."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return probe_smem_ref(dev)
    err, best = launch(LO_KIB * 1024, dev)
    if err != 0:
        raise RuntimeError(f"probe_smem: a {LO_KIB} KiB launch failed (CUDA "
                           f"error {err})")
    lo, hi = LO_KIB, HI_KIB
    while lo < hi:
        mid = (lo + hi + 1) // 2
        err, out = launch(mid * 1024, dev)
        if err == 0:
            lo, best = mid, out
        else:
            hi = mid - 1
    return best, lo * 1024
