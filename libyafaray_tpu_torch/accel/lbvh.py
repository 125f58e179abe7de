"""The linear BVH: Karras's build on the scene's device, and the per-ray
stack walk as the CUDA kernel `csrc/lbvh_traverse.cu` and its plain PyTorch
version.

Counterpart of `libyafaray_tpu/accel/lbvh.py` (the `scene_accelerator:
"bvh"` choice). The build sorts the primitives' morton codes (faces, then
the spheres as leaves), emits the binary radix tree in one vectorised pass
(31 doubling steps, 32 binary-search steps for each range end and 32 for
each split, all masked) and refits the boxes bottom up in a fixed number of
passes, `refit_passes(P)`. Every step equals the JAX package's: the node
tables and `prim_order` are the same arrays.

The walk keeps a MAX_STACK-slot stack per ray: it pops a node, tests its
box, and at a leaf tests the primitive (a strict `t < best_t` replaces the
best hit); at an internal node it pushes the far child and then the near
one (near by the children's entry distances, `ltn <= rtn`). An any-hit
query stops at its first hit. As in the JAX package, a push past the last
slot is dropped while the stack pointer still grows, and a pop past it
reads the last slot (XLA drops an out-of-bounds scatter and clamps a
gather): both versions here do the same, so a tree deeper than the stack
walks as it does there.

`lbvh_traverse` on CPU tensors runs the plain version `lbvh_traverse_ref`;
on a CUDA device it launches the kernel (built at first use by
`csrc_build`) or raises. It never falls back from the kernel to the plain
version. The kernel reads the tree and the geometry in its own layout,
`pack_lbvh`'s child-pair node records and leaf-ordered primitive records,
made once per tree and geometry and kept on the tree (`packed`), whether
the tree came from `build_lbvh` or was made outside it; `prepare` binds one
query's launch, so that timing loops run the kernel without the wrapper.
"""
from __future__ import annotations

import math
from ctypes import c_int as CI, c_void_p as VP
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import csrc_build
from ..scene_types import BVH, Geometry
from ..utils import profiling as PF
from .morton import morton3d
from .spheres import intersect_sphere

Tensor = torch.Tensor

MAX_STACK = 48   # stack slots per ray, as the JAX package's walk
# lbvh_packed_launch's arguments, the stream last
C_ARGS = (VP,) * 3 + (CI,) * 5 + (VP,) * 6 + (CI,) + (VP,) * 5


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _clz32(x: Tensor) -> Tensor:
    """Leading zeros of 32-bit values held in int64 (32 for 0), by bit
    tests: exact for every value, as XLA's clz."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_zero = x < (1 << (32 - s))
        n = n + torch.where(top_zero, s, 0)
        x = torch.where(top_zero, x << s, x)
    return n + (x == 0).to(n.dtype)


def _delta(codes: Tensor, i: Tensor, j: Tensor, n: int) -> Tensor:
    """Common prefix length of the 64-bit keys (morton code, then the sorted
    slot) at slots i and j; -1 where j is out of range."""
    valid = (j >= 0) & (j < n)
    jc = torch.clamp(j, 0, n - 1)
    x = codes[i] ^ codes[jc]
    clz = torch.where(x != 0, _clz32(x), 32 + _clz32(i ^ jc))
    return torch.where(valid, clz, -1)


def _ceil_div_pow2(l: Tensor) -> Tensor:
    """Smallest power of two >= l/2: the split search's first step."""
    h = torch.clamp_min(torch.div(l + 1, 2, rounding_mode="floor"), 1)
    e = 32 - _clz32(torch.clamp_min(h - 1, 0))
    return torch.clamp_min(1 << torch.clamp(e, 0, 30), 1)


def refit_passes(p: int) -> int:
    """Bottom-up refit passes for p primitives: 2 ceil(log2 p) + 4, at
    least 8 and at most 64. The log is taken as the JAX package takes it,
    of p in float32 with the result rounded to float32."""
    lg = math.ceil(np.float32(math.log2(float(np.float32(max(p, 2))))))
    return min(max(2 * lg + 4, 8), 64)


def _prim_bounds(geom: Geometry):
    """Each primitive's box: the faces' (the union over every motion
    keyframe), then the spheres'."""
    dev = geom.vertices.device
    if geom.num_faces > 0:
        fc = geom.faces.long()

        def corners(v):
            a, b, c = v[fc[:, 0]], v[fc[:, 1]], v[fc[:, 2]]
            return (torch.minimum(torch.minimum(a, b), c),
                    torch.maximum(torch.maximum(a, b), c))

        pmin, pmax = corners(geom.vertices)
        for vb in (geom.vertices_t1, geom.vertices_t2):
            if vb is not None:
                bmin, bmax = corners(vb)
                pmin = torch.minimum(pmin, bmin)
                pmax = torch.maximum(pmax, bmax)
    else:
        pmin = pmax = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    if geom.num_spheres > 0:
        r = geom.sph_radius[:, None]
        pmin = torch.cat([pmin, geom.sph_center - r])
        pmax = torch.cat([pmax, geom.sph_center + r])
    return pmin, pmax


def build_lbvh(geom: Geometry) -> BVH:
    """The LBVH over the scene's faces and spheres, on the geometry's
    device (Karras 2012, as the JAX package builds it)."""
    if geom.inst_mat is not None:
        raise ValueError("the LBVH is built over baked geometry; compile "
                         "true instances with the block accelerator")
    p = geom.num_faces + geom.num_spheres
    if p == 0:
        raise ValueError("empty scene")
    dev = geom.vertices.device
    pmin, pmax = _prim_bounds(geom)
    centroid = 0.5 * (pmin + pmax)
    scene_min = pmin.amin(dim=0)
    extent = torch.clamp_min(pmax.amax(dim=0) - scene_min, 1e-12)
    codes30 = morton3d((centroid - scene_min) / extent)
    order = torch.sort(codes30, stable=True).indices
    codes = codes30[order]   # equal codes tie-break by sorted slot
    i32 = lambda x: x.to(torch.int32)
    if p == 1:
        one = torch.zeros((1,), dtype=torch.int32, device=dev)
        return BVH(node_min=pmin, node_max=pmax, node_left=one,
                   node_right=one.clone(),
                   node_is_leaf=torch.ones((1,), dtype=torch.bool, device=dev),
                   prim_order=i32(order), num_nodes=1)

    n_int = p - 1
    i = torch.arange(n_int, dtype=torch.int64, device=dev)
    # each internal node's direction and the prefix its range exceeds
    d_right = _delta(codes, i, i + 1, p)
    d_left = _delta(codes, i, i - 1, p)
    d = torch.where(d_right > d_left, 1, -1)
    delta_min = torch.minimum(d_right, d_left)
    # the range's length: doublings, then a binary search (masked steps)
    lmax = torch.full((n_int,), 2, dtype=torch.int64, device=dev)
    for _ in range(31):
        ok = _delta(codes, i, i + lmax * d, p) > delta_min
        lmax = torch.where(ok, lmax * 2, lmax)
    l = torch.zeros_like(lmax)
    t = lmax // 2
    for _ in range(32):
        ok = _delta(codes, i, i + (l + t) * d, p) > delta_min
        l = torch.where((t > 0) & ok, l + t, l)
        t = t // 2
    j = i + l * d
    # the split: a binary search on the prefix length
    delta_node = _delta(codes, i, j, p)
    sstep = torch.zeros_like(l)
    t = _ceil_div_pow2(l)
    for _ in range(32):
        ok = _delta(codes, i, i + (sstep + t) * d, p) > delta_node
        sstep = torch.where((t > 0) & ok, sstep + t, sstep)
        t = t // 2
    gamma = i + sstep * d + torch.clamp_max(d, 0)
    # a child covering one primitive is a leaf
    left = torch.where(torch.minimum(i, j) == gamma, n_int + gamma, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, n_int + gamma + 1,
                        gamma + 1)
    slots = torch.arange(p, dtype=torch.int64, device=dev)
    node_left = torch.cat([left, slots])
    node_right = torch.cat([right, slots])
    node_is_leaf = torch.cat([torch.zeros((n_int,), dtype=torch.bool,
                                          device=dev),
                              torch.ones((p,), dtype=torch.bool, device=dev)])
    zeros = torch.zeros((n_int, 3), dtype=torch.float32, device=dev)
    nmin = torch.cat([zeros, pmin[order]])
    nmax = torch.cat([zeros, pmax[order]])
    # the refit: every internal box becomes its children's union at once,
    # a fixed number of times (a node is final once its subtree's height is
    # at most the passes made)
    for _ in range(refit_passes(p)):
        nmin = torch.cat([torch.minimum(nmin[left], nmin[right]),
                          nmin[n_int:]])
        nmax = torch.cat([torch.maximum(nmax[left], nmax[right]),
                          nmax[n_int:]])
    return BVH(node_min=nmin, node_max=nmax, node_left=i32(node_left),
               node_right=i32(node_right), node_is_leaf=node_is_leaf,
               prim_order=i32(order), num_nodes=n_int + p)


def tree_depth(bvh: BVH) -> int:
    """Edges from the root to the deepest leaf (0 for a one-leaf tree): the
    refit gives every box its full union only when this is at most
    `refit_passes(P)`."""
    frontier = torch.zeros((1,), dtype=torch.int64,
                           device=bvh.node_left.device)
    depth = 0
    while True:
        inner = frontier[~bvh.node_is_leaf[frontier]]
        if inner.numel() == 0:
            return depth
        frontier = torch.cat([bvh.node_left[inner],
                              bvh.node_right[inner]]).long()
        depth += 1


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def _motion(geom: Geometry, time: Optional[Tensor]) -> int:
    """0 static, 1 two keyframes (linear), 2 three (the b-spline)."""
    if time is None or geom.vertices_t1 is None:
        return 0
    return 2 if geom.vertices_t2 is not None else 1


def _inv_dir(d: Tensor) -> Tensor:
    """1/d with each component held at least 1e-12 away from 0."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0, -1e-12, 1e-12), d)


def _slab(bvh: BVH, node: Tensor, o: Tensor, inv_d: Tensor):
    """Entry and exit distances of rays [A, 3] through node boxes [A]."""
    t0 = (bvh.node_min[node] - o) * inv_d
    t1 = (bvh.node_max[node] - o) * inv_d
    return (torch.minimum(t0, t1).amax(dim=-1),
            torch.maximum(t0, t1).amin(dim=-1))


def _prim_hit(geom: Geometry, prim: Tensor, o: Tensor, d: Tensor,
              t_min: Tensor, t_max: Tensor, vis_bit: int, exclude: Tensor,
              motion: int, tm: Optional[Tensor]):
    """One primitive per ray (the JAX `_prim_intersect`): the port's
    Möller-Trumbore on a face, its sphere test on a sphere, with the
    visibility bit and the excluded id. Returns (hit, t, u, v)."""
    from ..ops.intersect import moller_trumbore   # it imports this module
    f = geom.num_faces
    is_tri = prim < f
    hit = torch.zeros_like(is_tri)
    t = torch.zeros_like(t_min)
    u = torch.zeros_like(t_min)
    v = torch.zeros_like(t_min)
    if f > 0:
        tri = torch.where(is_tri, prim, 0).long()
        fidx = geom.faces[tri].long()

        def verts(vx):
            return vx[fidx[:, 0]], vx[fidx[:, 1]], vx[fidx[:, 2]]

        v0, v1, v2 = verts(geom.vertices)
        if motion:
            w = tm[:, None]
            b0, b1, b2 = verts(geom.vertices_t1)
            if motion == 2:
                c0, c1, c2 = verts(geom.vertices_t2)
                w0 = (1.0 - w) * (1.0 - w)
                w1 = 2.0 * w * (1.0 - w)
                w2 = w * w
                v0 = v0 * w0 + b0 * w1 + c0 * w2
                v1 = v1 * w0 + b1 * w1 + c1 * w2
                v2 = v2 * w0 + b2 * w1 + c2 * w2
            else:
                v0 = v0 * (1.0 - w) + b0 * w
                v1 = v1 * (1.0 - w) + b1 * w
                v2 = v2 * (1.0 - w) + b2 * w
        hit, t, u, v = moller_trumbore(o, d, v0, v1, v2, t_min, t_max)
        hit = hit & ((geom.face_vis[tri] & vis_bit) != 0) & is_tri
    if geom.num_spheres > 0:
        sp = torch.where(is_tri, 0, prim - f).long()
        hs, ts = intersect_sphere(o, d, geom.sph_center[sp],
                                  geom.sph_radius[sp], t_min, t_max)
        hs = hs & ((geom.sph_vis[sp] & vis_bit) != 0) & ~is_tri
        t = torch.where(hit, t, ts)
        u = torch.where(hit, u, 0.0)
        v = torch.where(hit, v, 0.0)
        hit = hit | hs
    else:
        u = torch.where(hit, u, 0.0)
        v = torch.where(hit, v, 0.0)
    return hit & (prim != exclude), t, u, v


def lbvh_traverse_ref(bvh: BVH, geom: Geometry, o: Tensor, d: Tensor,
                      t_min: Tensor, t_max: Tensor, exclude: Tensor,
                      time: Optional[Tensor] = None, shadow: bool = False,
                      any_hit: bool = False, stats: Optional[dict] = None):
    """Plain PyTorch version of the kernel: the per-ray walk, one node per
    ray and step, vectorised over the rays still walking (as the JAX
    package's vmapped while loop). Returns (t f32[N] (t_max on a miss),
    prim i32[N] (-1 on a miss), u, v). A `stats` dict gets the work the
    walk needed: "boxes" (the popped nodes' box tests and the two child
    tests of every internal node entered), "faces" and "spheres" (the
    leaf tests)."""
    motion = _motion(geom, time)
    n = o.shape[0]
    dev = o.device
    vis_bit = 2 if shadow else 1
    inv_d = _inv_dir(d)
    best_t = t_max.clone()
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    stack = torch.zeros((n, MAX_STACK), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)   # the root, node 0
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    last = bvh.prim_order.shape[0] - 1
    exclude = exclude.long()
    work = torch.zeros((3,), dtype=torch.int64, device=dev)
    while True:
        a = ((sp > 0) & ~done).nonzero()[:, 0]
        if a.numel() == 0:
            break
        oa, da, ia = o[a], d[a], inv_d[a]
        t0a, bta = t_min[a], best_t[a]
        # pop; a pointer past the last slot reads the last slot
        spa = sp[a] - 1
        node = stack[a, torch.clamp_max(spa, MAX_STACK - 1)]
        tn, tf = _slab(bvh, node, oa, ia)
        hit_box = (tn <= tf) & (tf >= t0a) & (tn <= bta)
        is_leaf = bvh.node_is_leaf[node]
        lc = bvh.node_left[node].long()
        rc = bvh.node_right[node].long()
        # a leaf: its primitive, taken on a strictly nearer hit
        prim = bvh.prim_order[torch.clamp(lc, 0, last)].long()
        ph, pt, pu, pv = _prim_hit(
            geom, prim, oa, da, t0a, bta, vis_bit, exclude[a], motion,
            time[a] if motion else None)
        better = hit_box & is_leaf & ph & (pt < bta)
        best_t[a] = torch.where(better, pt, bta)
        best_p[a] = torch.where(better, prim, best_p[a])
        best_u[a] = torch.where(better, pu, best_u[a])
        best_v[a] = torch.where(better, pv, best_v[a])
        if any_hit:
            done[a] = done[a] | better
        # an internal node: push the far child, then the near one; a push
        # past the last slot is dropped, the pointer grows all the same
        push = hit_box & ~is_leaf
        ltn, _ = _slab(bvh, lc, oa, ia)
        rtn, _ = _slab(bvh, rc, oa, ia)
        first = ltn <= rtn
        near = torch.where(first, lc, rc)
        far = torch.where(first, rc, lc)
        sp1 = spa + push.long()
        for slot, child in ((spa, far), (sp1, near)):
            w = push & (slot < MAX_STACK)
            stack[a[w], slot[w]] = child[w]
        sp[a] = sp1 + push.long()
        if stats is not None:
            leaf = hit_box & is_leaf
            work += torch.stack([a.numel() + 2 * push.sum(),
                                 (leaf & (prim < geom.num_faces)).sum(),
                                 (leaf & (prim >= geom.num_faces)).sum()])
    if stats is not None:
        stats.update(zip(("boxes", "faces", "spheres"), work.tolist()))
    return best_t, best_p.to(torch.int32), best_u, best_v




# ---------------------------------------------------------------------------
# The kernel's records
# ---------------------------------------------------------------------------

@dataclass
class PackedLBVH:
    """One tree over one geometry in the kernel's layout (`pack_lbvh`).
    Every table is int32, a float held as its bits, so that each record is
    read with 16-byte loads:

    nodes i32[max(N_int, 1), 16]: internal node k's row holds both of its
        children, (lmin xyz, lcode), (lmax xyz, rcode), (rmin xyz, 0),
        (rmax xyz, 0). A child's code is its own row for an internal node
        and ~slot for a leaf, slot being the leaf's node_left clamped to
        [0, P - 1] as the walk clamps it;
    root i32[8]: the root's box and code, (min xyz, code), (max xyz,
        finite), finite 1 when every node box is finite; the root is
        nobody's child, and in a one-primitive tree a leaf;
    leaves i32[P, 12]: leaf slot s holds primitive prim_order[s]: a face
        as (v0 xyz, prim), (v1 - v0, face_vis), (v2 - v0, 0), a sphere as
        (centre xyz, prim), (radius, 0, 0, sph_vis), (0, 0, 0, 0);
    keyframes i32[P, 12 K] or None: a moving geometry's K = 2 or 3 vertex
        keyframes in leaf order, each as (v0, prim), (v1, face_vis), (v2,
        0), unsubtracted (the kernel blends before it subtracts and reads
        prim and face_vis from the first); spheres as in `leaves`.

    The boxes are copies of node_min / node_max and the edges the same one
    IEEE subtraction the plain walk makes, so the kernel's walk on these
    records is the plain walk bit for bit."""
    nodes: Tensor
    root: Tensor
    leaves: Tensor
    keyframes: Optional[Tensor] = None


def _bits(*cols: Tensor) -> Tensor:
    """Float columns [..., k] and int columns, side by side as int32."""
    return torch.cat([c.view(torch.int32) if c.dtype == torch.float32
                      else c.to(torch.int32) for c in cols], dim=-1)


def _leaf_rows(geom: Geometry, prim: Tensor, vertices: Tensor,
               edges: bool) -> Tensor:
    """i32[P, 12]: the leaf records of primitives `prim` (int64) with the
    face corners from `vertices`: v0 and the two edges, or the three
    corners."""
    f = geom.num_faces
    dev = prim.device
    zero = torch.zeros((prim.shape[0], 1), dtype=torch.int32, device=dev)
    rows = torch.zeros((prim.shape[0], 12), dtype=torch.int32, device=dev)
    is_tri = (prim >= 0) & (prim < f)
    if f > 0:
        fidx = geom.faces[torch.where(is_tri, prim, 0)].long()
        a, b, c = (vertices[fidx[:, k]] for k in range(3))
        if edges:
            b, c = b - a, c - a
        vis = geom.face_vis[torch.where(is_tri, prim, 0)][:, None]
        rows = torch.where(is_tri[:, None], _bits(a, prim[:, None], b, vis,
                                                  c, zero), rows)
    s = geom.num_spheres
    is_sph = (prim >= f) & (prim < f + s)
    if s > 0:
        k = torch.where(is_sph, prim - f, 0)
        r = geom.sph_radius[k][:, None]
        rows = torch.where(is_sph[:, None], _bits(
            geom.sph_center[k], prim[:, None], r, zero, zero,
            geom.sph_vis[k][:, None], zero.expand(-1, 4)), rows)
    return rows


def pack_lbvh(bvh: BVH, geom: Geometry) -> PackedLBVH:
    """The kernel's records of `bvh` over `geom`, on the tree's device
    (see PackedLBVH). A tree made outside `build_lbvh` packs the same way:
    internal nodes take rows in the order of their ids."""
    p = bvh.prim_order.shape[0]
    dev = bvh.node_min.device
    leaf = bvh.node_is_leaf
    row = torch.cumsum((~leaf).long(), 0) - 1
    code = torch.where(leaf, -1 - torch.clamp(bvh.node_left.long(), 0, p - 1),
                       row)[:, None]
    with PF.host_sync("lbvh.pack_inner"):
        inner = (~leaf).nonzero()[:, 0]
    lc, rc = bvh.node_left[inner].long(), bvh.node_right[inner].long()
    zero = torch.zeros((inner.shape[0], 1), dtype=torch.int32, device=dev)
    nmin, nmax = bvh.node_min, bvh.node_max
    nodes = _bits(nmin[lc], code[lc], nmax[lc], code[rc], nmin[rc], zero,
                  nmax[rc], zero)
    if nodes.shape[0] == 0:          # a one-primitive tree: the root alone
        nodes = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    finite = (torch.isfinite(nmin).all() & torch.isfinite(nmax).all())
    root = _bits(nmin[0], code[0], nmax[0], finite.to(torch.int32)[None])
    prim = bvh.prim_order.long()
    leaves = _leaf_rows(geom, prim, geom.vertices, edges=True)
    keyframes = None
    if geom.vertices_t1 is not None:
        keys = [geom.vertices, geom.vertices_t1] + (
            [geom.vertices_t2] if geom.vertices_t2 is not None else [])
        keyframes = torch.cat([_leaf_rows(geom, prim, v, edges=False)
                               for v in keys], dim=1)
    return PackedLBVH(nodes=nodes.contiguous(), root=root.contiguous(),
                      leaves=leaves.contiguous(), keyframes=keyframes)


def _sources(bvh: BVH, geom: Geometry) -> tuple:
    """The tensors a PackedLBVH is made from."""
    return (bvh.node_min, bvh.node_max, bvh.node_left, bvh.node_right,
            bvh.node_is_leaf, bvh.prim_order, geom.vertices,
            geom.vertices_t1, geom.vertices_t2, geom.faces, geom.face_vis,
            geom.sph_center, geom.sph_radius, geom.sph_vis)


def _check_tables(bvh: BVH, geom: Geometry, dev) -> None:
    nn, p = bvh.node_left.shape[0], bvh.prim_order.shape[0]
    nv, f, s = geom.vertices.shape[0], geom.num_faces, geom.num_spheres
    check = lambda *a: csrc_build.check_arg("lbvh_traverse", *a, dev)
    check("node_min", bvh.node_min, torch.float32, (nn, 3))
    check("node_max", bvh.node_max, torch.float32, (nn, 3))
    check("node_left", bvh.node_left, torch.int32, (nn,))
    check("node_right", bvh.node_right, torch.int32, (nn,))
    check("node_is_leaf", bvh.node_is_leaf, torch.bool, (nn,))
    check("prim_order", bvh.prim_order, torch.int32, (p,))
    check("vertices", geom.vertices, torch.float32, (nv, 3))
    check("faces", geom.faces, torch.int32, (f, 3))
    check("face_vis", geom.face_vis, torch.int32, (f,))
    if s:
        check("sph_center", geom.sph_center, torch.float32, (s, 3))
        check("sph_radius", geom.sph_radius, torch.float32, (s,))
        check("sph_vis", geom.sph_vis, torch.int32, (s,))
    for name in ("vertices_t1", "vertices_t2"):
        if getattr(geom, name) is not None:
            check(name, getattr(geom, name), torch.float32, (nv, 3))


def packed(bvh: BVH, geom: Geometry) -> PackedLBVH:
    """`pack_lbvh(bvh, geom)`, made once and kept on the tree beside the
    tensors it was made from: while the tree's and the geometry's tensors
    are the same ones, unchanged in place, every query reuses it; another
    geometry, the tree moved to another device or a table written in place
    packs anew. The tables are checked when they are packed."""
    src = _sources(bvh, geom)
    versions = tuple(-1 if x is None else x._version for x in src)
    kept = bvh.__dict__.get("_packed")
    if (kept is not None and kept[1] == versions
            and all(a is b for a, b in zip(kept[0], src))):
        return kept[2]
    with PF.span("accel.pack"):
        _check_tables(bvh, geom, bvh.node_min.device)
        rec = pack_lbvh(bvh, geom)
    PF.count("table_builds.pack_lbvh")
    bvh.__dict__["_packed"] = (src, versions, rec)
    return rec


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

def _check_query(bvh: BVH, geom: Geometry, o: Tensor, d: Tensor,
                 t_min: Tensor, t_max: Tensor, exclude: Tensor,
                 time: Optional[Tensor], motion: int) -> None:
    if (bvh.prim_order.shape[0] != geom.num_faces + geom.num_spheres
            or geom.faces.shape[0] != geom.num_faces):
        raise ValueError("lbvh_traverse: the BVH was not built over this "
                         "geometry")
    n, dev = o.shape[0], o.device
    check = lambda *a: csrc_build.check_arg("lbvh_traverse", *a, dev)
    check("o", o, torch.float32, (n, 3))
    check("d", d, torch.float32, (n, 3))
    check("t_min", t_min, torch.float32, (n,))
    check("t_max", t_max, torch.float32, (n,))
    check("exclude", exclude, torch.int32, (n,))
    if motion:
        check("time", time, torch.float32, (n,))


def prepare(bvh: BVH, geom: Geometry, o: Tensor, d: Tensor, t_min: Tensor,
            t_max: Tensor, exclude: Tensor, time: Optional[Tensor] = None,
            shadow: bool = False, any_hit: bool = False):
    """The kernel's launch for one query on CUDA tensors, checked and bound
    to its outputs: returns `launch`, and `launch()` runs the kernel on the
    current stream and returns (t, prim, u, v). `lbvh_traverse` calls it
    once; timing loops call it alone, without the wrapper's host work."""
    motion = _motion(geom, time)
    _check_query(bvh, geom, o, d, t_min, t_max, exclude, time, motion)
    dev = csrc_build.card("lbvh_traverse", o.device)
    rec = packed(bvh, geom)
    if rec.nodes.device != dev:
        raise ValueError(f"lbvh_traverse: the tree is on {rec.nodes.device},"
                         f" the rays on {dev}")
    n = o.shape[0]
    out = (torch.empty((n,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev),
           torch.empty((n,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.float32, device=dev))
    leaves = rec.keyframes if motion else rec.leaves
    args = (rec.nodes.data_ptr(), rec.root.data_ptr(), leaves.data_ptr(),
            geom.num_faces, geom.num_spheres, 2 if shadow else 1,
            int(bool(any_hit)), motion, o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), exclude.data_ptr(),
            time.data_ptr() if motion else None, n,
            *(x.data_ptr() for x in out))
    fn = csrc_build.entry("lbvh_traverse", "lbvh_packed_launch", C_ARGS)

    def launch():
        csrc_build.launch("lbvh_traverse", fn, dev, *args)
        return out
    return launch


@PF.span("accel.walk")
def lbvh_traverse(bvh: BVH, geom: Geometry, o: Tensor, d: Tensor,
                  t_min: Tensor, t_max: Tensor, exclude: Tensor,
                  time: Optional[Tensor] = None, shadow: bool = False,
                  any_hit: bool = False):
    """Walk the LBVH with a wavefront of rays (the kernel's wrapper).

    bvh from `build_lbvh(geom)` or any tree of its layout; o, d f32[N, 3];
    t_min, t_max f32[N]; exclude i32[N]; optional time f32[N] (the shutter
    times of a motion-blurred scene: linear with vertices_t1, the
    quadratic b-spline with vertices_t2 too). `shadow` tests the
    shadow-visibility bit instead of the camera's; `any_hit` stops each
    ray at its first hit. All contiguous, on one device. Returns (t f32[N]
    (t_max on a miss), prim i32[N] (-1 on a miss), u f32[N], v f32[N]); for
    an any-hit query only hit or miss is asked for, and both versions
    report the same first hit. On the card the tree and geometry are
    packed once (`packed`) and kept for later queries."""
    dev = o.device
    if csrc_build.on_card("lbvh_traverse", dev):
        out = prepare(bvh, geom, o, d, t_min, t_max, exclude, time, shadow,
                      any_hit)()
        PF.count("kernel.lbvh_traverse.rays", o.shape[0])
        if any_hit:
            PF.count("kernel.lbvh_traverse.any_hit_rays", o.shape[0])
        return out
    motion = _motion(geom, time)
    _check_query(bvh, geom, o, d, t_min, t_max, exclude, time, motion)
    _check_tables(bvh, geom, dev)
    return lbvh_traverse_ref(bvh, geom, o, d, t_min, t_max, exclude,
                             time if motion else None, shadow, any_hit)
