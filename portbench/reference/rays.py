"""Ray-triangle queries of the reference: the closest hit and the shadow
test, by the Moller-Trumbore test (Moller and Trumbore, "Fast, Minimum
Storage Ray/Triangle Intersection", JGT 2(1), 1997) of every triangle a
ray may reach.

A ray meets a triangle at t when t_min < t < t_max, the barycentrics
(u, v) lie in the triangle (u, v >= 0, u + v <= 1) and the triangle is not
the one the ray leaves (`exclude`). The closest hit is the least t; among
triangles at the same t, the first staged.

To keep the tests few on a large mesh, the triangles are ordered along a
Morton curve of their centroids and cut into clusters of 32, clusters
into groups of 32; a ray tests the clusters of the groups whose boxes it
crosses, and the triangles of the clusters whose boxes it crosses. The
boxes are widened a little, so that no rounding drops a triangle a ray
meets: culling changes how many triangles are tested, never the answer.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

CLUSTER = 32
# rays a batch tests at once
RAY_BATCH = 1 << 16


def _morton(c: Tensor) -> Tensor:
    """30-bit Morton codes of points normalised to [0, 1]^3."""
    q = torch.clamp((c * 1023.0).long(), 0, 1023)
    code = torch.zeros_like(q[:, 0])
    for b in range(10):
        for a in range(3):
            code = code | (((q[:, a] >> b) & 1) << (3 * b + (2 - a)))
    return code


class Triangles:
    """The scene's triangles, ordered and boxed for the queries."""

    def __init__(self, tri: Tensor, shadow: Tensor):
        dev = tri.device
        self.n = tri.shape[0]
        cen = tri.mean(dim=1)
        lo, hi = cen.amin(0), cen.amax(0)
        order = torch.argsort(_morton((cen - lo) / torch.clamp_min(
            hi - lo, 1e-12)), stable=True)
        pad = (-self.n) % (CLUSTER * CLUSTER)
        self.order = torch.cat([order, order.new_full((pad,), -1)])
        t = tri[self.order.clamp_min(0)]
        self.v0 = t[:, 0]
        self.e1 = t[:, 1] - t[:, 0]
        self.e2 = t[:, 2] - t[:, 0]
        self.real = self.order >= 0
        self.shadow = self.real & shadow[self.order.clamp_min(0)]
        # each triangle's slot in that order
        self.slot_of = torch.empty(self.n, dtype=torch.int64, device=dev)
        self.slot_of[order] = torch.arange(self.n, device=dev)
        big = torch.finfo(torch.float32).max
        tlo = torch.where(self.real[:, None], t.amin(1), big)
        thi = torch.where(self.real[:, None], t.amax(1), -big)
        eps = 1e-4 * float((tri.amax((0, 1)) - tri.amin((0, 1))).amax()) + 1e-6
        self.c_lo = tlo.reshape(-1, CLUSTER, 3).amin(1) - eps
        self.c_hi = thi.reshape(-1, CLUSTER, 3).amax(1) + eps
        self.g_lo = self.c_lo.reshape(-1, CLUSTER, 3).amin(1)
        self.g_hi = self.c_hi.reshape(-1, CLUSTER, 3).amax(1)
        self.device = dev


def _crosses(o, inv, lo, hi, t0, t1):
    """Whether rays (o, 1/d) cross boxes [lo, hi] within [t0, t1]."""
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    near = torch.minimum(ta, tb).amax(-1)
    far = torch.maximum(ta, tb).amin(-1)
    return (near <= far) & (far >= t0) & (near <= t1)


def _candidates(tr: Triangles, o, d, t0, t1):
    """(ray, triangle slot) pairs whose cluster box the ray crosses."""
    safe = torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
    inv = 1.0 / safe
    g = _crosses(o[:, None], inv[:, None], tr.g_lo[None], tr.g_hi[None],
                 t0[:, None], t1[:, None])
    r, gi = torch.nonzero(g, as_tuple=True)
    ci = (gi[:, None] * CLUSTER + torch.arange(CLUSTER, device=o.device)
          ).reshape(-1)
    r = r.repeat_interleave(CLUSTER)
    keep = _crosses(o[r], inv[r], tr.c_lo[ci], tr.c_hi[ci], t0[r], t1[r])
    r, ci = r[keep], ci[keep]
    slot = (ci[:, None] * CLUSTER + torch.arange(CLUSTER, device=o.device)
            ).reshape(-1)
    return r.repeat_interleave(CLUSTER), slot


def _test(tr: Triangles, o, d, slot):
    """Moller-Trumbore of rays (o, d) against triangle slots, written out
    by components (each product rounded, the sums left to right): (det
    ok, t, u, v)."""
    e1x, e1y, e1z = tr.e1[slot].unbind(-1)
    e2x, e2y, e2z = tr.e2[slot].unbind(-1)
    ax, ay, az = tr.v0[slot].unbind(-1)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    # p = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() > 1e-10
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    # s = o - v0; q = s x e1
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    return ok, t, u, v


def _query(tr: Triangles, o, d, t_min, t_max, exclude, shadow: bool):
    """Per ray: (found, t, triangle, u, v) of the closest hit."""
    n = o.shape[0]
    dev = o.device
    key = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                     device=dev)
    for s in range(0, n, RAY_BATCH):
        e = min(n, s + RAY_BATCH)
        ob, db = o[s:e], d[s:e]
        r, slot = _candidates(tr, ob, db, t_min[s:e], t_max[s:e])
        ok, t, u, v = _test(tr, ob[r], db[r], slot)
        prim = tr.order[slot]
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_min[s:e][r]) & (t < t_max[s:e][r])
               & (tr.shadow[slot] if shadow else tr.real[slot])
               & (prim != exclude[s:e][r]))
        # the least t, then the first staged triangle: t > 0, so its
        # float bits order as t does
        k = (t.view(torch.int32).long() << 32) | prim
        key[s:e] = key[s:e].scatter_reduce(
            0, r[hit], k[hit], reduce="amin", include_self=True)
    found = key != torch.iinfo(torch.int64).max
    prim = torch.where(found, key & 0xFFFFFFFF, 0)
    slot = tr.slot_of[prim]
    ok, t, u, v = _test(tr, o, d, slot)
    return found, t, prim, u, v


def closest(tr: Triangles, o, d, t_min, t_max, exclude):
    """The closest hit among the triangles rays see: (found, t, triangle,
    u, v); t, u, v are meaningful where found."""
    return _query(tr, o, d, t_min, t_max, exclude, shadow=False)


def blocked(tr: Triangles, o, d, t_max, exclude) -> Tensor:
    """Whether a shadow-casting triangle lies within (0, t_max)."""
    return _query(tr, o, d, torch.zeros_like(t_max), t_max, exclude,
                  shadow=True)[0]
