"""The yardstick of the kernels' roofline shares: the card's published
peaks and the bytes that any implementation of a ray query must move.

NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit: 80
GB of HBM3 at 3.35 TB/s; 67 TFLOP/s in float32 outside the tensor cores.

A ray query's least time is taken from bytes alone: each ray's record
read once (origin, direction, t_min and t_max: 8 float32) and each answer
written once (a closest hit's t, prim, u and v: 16 bytes; an any-hit
query's hit flag: 1 byte). No operation bound is used: the tests a query
needs depend on the accelerator that answers it (brute force, blocks or
the LBVH), so an operation count would measure the algorithm and could
read over 100% after a change of algorithm. The byte count is the same
whatever answers the query, so the share cannot pass 100% unless the time
leaves out part of the work.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

RAY_BYTES = 32
CLOSEST_HIT_BYTES = 16
ANY_HIT_BYTES = 1

# the kernels' names in the device trace, and the wrapper whose rays
# `spans.counting` records for each
KERNELS = {"mt_closest": "mt_closest_kernel",
           "tile_walk": "tiles_traverse_kernel",
           "lbvh_traverse": "lbvh_traverse_kernel"}


def query_bytes(rays: int, any_hit: bool) -> int:
    """The bytes a query of `rays` rays must move at the least."""
    return rays * (RAY_BYTES + (ANY_HIT_BYTES if any_hit else
                                CLOSEST_HIT_BYTES))


def kernel_seconds(trace, kernel: str) -> float:
    """Device seconds of the kernel `kernel` (a key of KERNELS) in the
    traced window, whatever template arguments its name carries."""
    name = KERNELS[kernel]
    return sum(s for n, s in trace.device_s_by_name.items() if name in n)


def roofline_pct(trace, kernel: str):
    """100 x (least time of the window's queries) / (the kernel's device
    time), or None where the window ran no such query or kernel."""
    queries = (trace.queries or {}).get(kernel) or []
    seconds = kernel_seconds(trace, kernel)
    if not queries or seconds <= 0:
        return None
    least = sum(query_bytes(r, a) for r, a in queries) / HBM_BYTES_PER_S
    return 100.0 * least / seconds
