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


def optin_limit(device) -> int:
    """cudaDevAttrMaxSharedMemoryPerBlockOptin of a CUDA device, bytes."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    value = ctypes.c_int(0)
    query = csrc_build.entry("probe_smem", "probe_smem_optin_limit",
                             (ctypes.c_int, ctypes.POINTER(ctypes.c_int)))
    err = query(index, ctypes.byref(value))
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
    out); out holds the kernel's result when the code is 0, and only such
    a launch is counted."""
    dev = csrc_build.card("probe_smem", device)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    fn = csrc_build.entry("probe_smem", "probe_smem_launch",
                          (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
    return csrc_build.launch("probe_smem", fn, dev, out.data_ptr(),
                             int(nbytes), check=False), out


def probe_smem(device="cuda"):
    """Largest dynamic shared memory (bytes, a whole number of KiB) that a
    launch accepts, and that launch's output f32[8, 128]."""
    dev = torch.device(device)
    if not csrc_build.on_card("probe_smem", dev):
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
