"""Closest hit of rays against a packed triangle table: the CUDA kernel
`csrc/mt_intersect.cu` and its plain PyTorch version.

Counterpart of `libyafaray_tpu/accel/pallas_intersect.py`. The table layout
is the JAX package's: f32[C, 16] with columns 0-8 the vertices v0|v1|v2,
9 the camera-visibility bit, 10 the shadow-visibility bit (as 0/1 floats),
11 the prim id (padding rows: id -2, visibility 0). C is `table_rows(F)`.
The JAX kernel takes tables of up to 16,384 rows (its VMEM budget; the JAX
package scans larger ones in chunks); this kernel streams the table through
shared memory and takes any row count: every brute-force query of a mesh
scene comes here.

`mt_closest` takes tensors on one device. On the CPU it runs the plain
version `mt_closest_ref`; on a CUDA device it launches the kernel (built
from the package's sources with nvcc at first use by `csrc_build`, loaded
with ctypes) or raises. It never falls back from the kernel to the plain version.
"""
from __future__ import annotations

from ctypes import c_int as CI, c_void_p as VP
from typing import Optional

import torch

from .. import csrc_build
from ..utils import profiling as PF

Tensor = torch.Tensor

TRI_CHUNK = 128     # table rows are padded to multiples of this above 128
EPS_DET = 1e-10
# ray-triangle pairs per step of the plain version (bounds its memory)
_REF_PAIRS = 1 << 22
# mt_closest_launch's arguments, the stream last
C_ARGS = (VP,) * 3 + (CI,) * 3 + (VP,) * 6 + (CI,) + (VP,) * 5


def table_rows(f: int) -> int:
    """Padded row count for an f-triangle table: small scenes pad to a
    32-row multiple, larger ones to TRI_CHUNK rows."""
    if f <= TRI_CHUNK:
        return max(32, -(-f // 32) * 32)
    return -(-f // TRI_CHUNK) * TRI_CHUNK


def pack_tris(v0: Tensor, v1: Tensor, v2: Tensor, face_vis: Tensor) -> Tensor:
    """Build the f32[C, 16] triangle table (done once at scene compile)."""
    f = v0.shape[0]
    tab = torch.zeros((table_rows(f), 16), dtype=torch.float32,
                      device=v0.device)
    tab[:f, 0:3] = v0
    tab[:f, 3:6] = v1
    tab[:f, 6:9] = v2
    tab[:f, 9] = ((face_vis & 1) != 0).float()
    tab[:f, 10] = ((face_vis & 2) != 0).float()
    tab[:f, 11] = torch.arange(f, dtype=torch.float32, device=v0.device)
    tab[f:, 11] = -2.0
    return tab


def _motion(time, tris_t1, tris_t2) -> int:
    if time is None or tris_t1 is None:
        return 0
    return 2 if tris_t2 is not None else 1


def mt_closest_ref(tris: Tensor, o: Tensor, d: Tensor, t_min: Tensor,
                   t_max: Tensor, exclude: Tensor, time: Optional[Tensor] = None,
                   tris_t1: Optional[Tensor] = None,
                   tris_t2: Optional[Tensor] = None, shadow: bool = False):
    """Plain PyTorch version of the kernel, with the same arithmetic in the
    same order (no fused cross or dot helpers), one ray-triangle pair per
    element. Returns (t f32[N], prim i32[N] (-1 = miss), u, v)."""
    motion = _motion(time, tris_t1, tris_t2)
    n, c = o.shape[0], tris.shape[0]
    dev = o.device
    out_t = t_max.clone()
    out_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    vis = tris[:, 10 if shadow else 9] > 0.5
    pid = tris[:, 11].to(torch.int32)
    rows = torch.arange(c, device=dev)
    step = max(1, _REF_PAIRS // max(c, 1))
    for s in range(0, n, step):
        e = min(n, s + step)
        ox, oy, oz = o[s:e, 0:1], o[s:e, 1:2], o[s:e, 2:3]
        dx, dy, dz = d[s:e, 0:1], d[s:e, 1:2], d[s:e, 2:3]
        if motion:
            tt = time[s:e, None]

        def col(j):
            c0 = tris[None, :, j]
            if motion == 2:
                tc = 1.0 - tt
                return (c0 * (tc * tc) + tris_t1[None, :, j] * (2.0 * tt * tc)
                        + tris_t2[None, :, j] * (tt * tt))
            if motion == 1:
                return c0 * (1.0 - tt) + tris_t1[None, :, j] * tt
            return c0

        ax, ay, az = col(0), col(1), col(2)
        bx, by, bz = col(3), col(4), col(5)
        cx, cy, cz = col(6), col(7), col(8)
        e1x, e1y, e1z = bx - ax, by - ay, bz - az
        e2x, e2y, e2z = cx - ax, cy - ay, cz - az
        # pvec = d x e2
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        ok = torch.abs(det) > EPS_DET
        inv_det = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
        # tvec = o - v0
        tvx, tvy, tvz = ox - ax, oy - ay, oz - az
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        # qvec = tvec x e1
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_min[s:e, None]) & (t < t_max[s:e, None])
               & vis[None, :] & (pid[None, :] != exclude[s:e, None]))
        t = torch.where(hit, t, torch.inf)
        tc = t.amin(dim=1)
        # lowest row (= lowest prim id) among the rows at the minimum t
        first = torch.where(t == tc[:, None], rows, c).amin(dim=1, keepdim=True)
        first = torch.clamp_max(first, c - 1)
        found = hit.any(dim=1)
        out_t[s:e] = torch.where(found, tc, out_t[s:e])
        out_p[s:e] = torch.where(found, pid[first[:, 0]], -1)
        out_u[s:e] = torch.where(found, u.gather(1, first)[:, 0], 0.0)
        out_v[s:e] = torch.where(found, v.gather(1, first)[:, 0], 0.0)
    return out_t, out_p, out_u, out_v


@PF.span("accel.walk")
def mt_closest(tris: Tensor, o: Tensor, d: Tensor, t_min: Tensor,
               t_max: Tensor, exclude: Tensor, time: Optional[Tensor] = None,
               tris_t1: Optional[Tensor] = None,
               tris_t2: Optional[Tensor] = None, shadow: bool = False):
    """Closest hit of rays against a packed triangle table.

    tris f32[C,16] (pack_tris); o, d f32[N,3]; t_min, t_max f32[N];
    exclude i32[N]; optional time f32[N] with tris_t1 (linear motion blur)
    and tris_t2 (quadratic b-spline motion blur). All contiguous, on one
    device. Returns (t f32[N] (t_max on a miss), prim i32[N] (-1 on a
    miss), u f32[N], v f32[N])."""
    dev = o.device
    n, c = o.shape[0], tris.shape[0]
    motion = _motion(time, tris_t1, tris_t2)
    check = lambda *a: csrc_build.check_arg("mt_closest", *a, dev)
    check("tris", tris, torch.float32, (c, 16))
    if c % 32 != 0 or (c > TRI_CHUNK and c % TRI_CHUNK != 0):
        raise ValueError(f"triangle table rows ({c}) must be a multiple of 32 "
                         f"and, above {TRI_CHUNK}, of {TRI_CHUNK}; "
                         "use pack_tris to build the table")
    check("o", o, torch.float32, (n, 3))
    check("d", d, torch.float32, (n, 3))
    check("t_min", t_min, torch.float32, (n,))
    check("t_max", t_max, torch.float32, (n,))
    check("exclude", exclude, torch.int32, (n,))
    if motion:
        check("time", time, torch.float32, (n,))
        check("tris_t1", tris_t1, torch.float32, (c, 16))
        if motion == 2:
            check("tris_t2", tris_t2, torch.float32, (c, 16))
    if not csrc_build.on_card("mt_closest", dev):
        return mt_closest_ref(tris, o, d, t_min, t_max, exclude, time,
                              tris_t1, tris_t2, shadow)
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_p = torch.empty((n,), dtype=torch.int32, device=dev)
    out_u = torch.empty((n,), dtype=torch.float32, device=dev)
    out_v = torch.empty((n,), dtype=torch.float32, device=dev)
    ptr = lambda x: x.data_ptr() if x is not None else None
    csrc_build.launch(
        "mt_closest", csrc_build.entry("mt_intersect", "mt_closest_launch",
                                       C_ARGS), dev,
        ptr(tris), ptr(tris_t1) if motion else None,
        ptr(tris_t2) if motion == 2 else None, c, int(bool(shadow)), motion,
        ptr(o), ptr(d), ptr(t_min), ptr(t_max), ptr(exclude),
        ptr(time) if motion else None, n, ptr(out_t), ptr(out_p), ptr(out_u),
        ptr(out_v))
    # a shadow query's callers read hit or miss alone
    PF.count("kernel.mt_closest.rays", n)
    if shadow:
        PF.count("kernel.mt_closest.any_hit_rays", n)
    return out_t, out_p, out_u, out_v
