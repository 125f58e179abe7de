"""Block accelerator: morton-sorted triangle blocks, traversed in ray tiles.

Counterpart of `libyafaray_tpu/accel/blocks.py`. The build sorts the
triangles by the morton code of their centroids and cuts them into
contiguous blocks of B triangles, packed as component-major (16, B) slabs
with one AABB per block (`build_blocks`). Motion blur adds keyframe slabs
(`tab_t1`, `tab_t2`) whose block AABBs are unions over the control points.
True instancing keeps one physical copy of each instanced base range and
adds one virtual block per base block and instance, with a world AABB and
the instance's object<-world matrix (`_build_blocks_instanced`). A query
sorts the rays for coherence (dead rays last), walks them through the
blocks in tiles (`accel/tiles.py`) and restores the original ray order.

The JAX package sends motion-blur queries whose tables exceed its TPU
kernel's 96 MiB VMEM budget to `_query_chunk`, its per-ray block loop. The
port does not: its tile kernel stages each candidate slab through shared
memory and serves tables of any size, with or without motion.

Analytic spheres are not in the blocks: a dense pass over them follows the
walk, in sorted ray order (`query`). Not carried yet: the `geo` / `meta`
tables and `_query_chunk`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..scene_types import BlockAccel, Geometry, SceneData
from ..utils import profiling as PF
from . import tiles
from .spheres import sphere_pass
from .morton import morton3d

Tensor = torch.Tensor

MAX_BLOCKS = 4096      # cap on the block count C (the block size B grows)
MIN_BLOCK = 128        # minimum triangles per block
SORT_MIN_RAYS = 256    # queries of more rays are sorted for coherence


def _pick_block_size(f: int) -> int:
    b = MIN_BLOCK
    while (f + b - 1) // b > MAX_BLOCKS:
        b *= 2
    return b


def build_blocks(geom: Geometry) -> BlockAccel:
    """Morton-sort the triangles and cut them into contiguous blocks (on the
    device of the geometry's tensors)."""
    if geom.inst_mat is not None:
        return _build_blocks_instanced(geom)
    f = geom.num_faces
    if f == 0:
        raise ValueError("block accel needs triangles")
    b = _pick_block_size(f)
    t = _tables_for(geom, b)
    return BlockAccel(tab=t["tab"], bmin=t["bmin"], bmax=t["bmax"],
                      tab_t1=t["tab_t1"], tab_t2=t["tab_t2"], block_size=b,
                      num_blocks=t["tab"].shape[0])


def _tables_for(geom: Geometry, b: int, face_ids: Optional[Tensor] = None,
                vis_value: Optional[int] = None) -> dict:
    """Block tables of a face subset (None: every physical face) at block
    size b: tab f32[C, 16, B], bmin / bmax f32[C, 3], and tab_t1 / tab_t2
    (None when static). Prim ids in the table are the global physical face
    ids; `vis_value` replaces the faces' visibility (the instance tables of
    an is_base_object base, whose own faces are invisible)."""
    dev = geom.faces.device
    if face_ids is None:
        ids = torch.arange(geom.faces.shape[0], dtype=torch.int32, device=dev)
        vis_all = geom.face_vis
    else:
        ids = face_ids.to(torch.int32)
        vis_all = (geom.face_vis[ids.long()] if vis_value is None else
                   torch.full(ids.shape, vis_value, dtype=geom.face_vis.dtype,
                              device=dev))
    faces = geom.faces[ids.long()].to(torch.int64)
    f = faces.shape[0]
    c = (f + b - 1) // b
    v = geom.vertices
    v0, v1, v2 = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)
    smin = tmin.amin(dim=0)
    smax = tmax.amax(dim=0)
    rel = (centroid - smin) / torch.clamp_min(smax - smin, 1e-12)
    order = torch.sort(morton3d(rel), stable=True).indices

    pad = c * b - f

    def padded(x, fill):
        x = x[order]
        if not pad:
            return x
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=dev)])

    prim = padded(ids, -1)
    vis = padded(vis_all, 0)
    valid = (prim >= 0).reshape(c, b, 1)
    vis_cb = vis.reshape(c, b)
    prim_cb = prim.reshape(c, b)

    def keyframe(verts):
        """(tab f32[C, 16, B], bmin, bmax) of one vertex keyframe."""
        k0, k1, k2 = (padded(verts[faces[:, j]], torch.inf) for j in range(3))
        lo = torch.minimum(torch.minimum(k0, k1), k2).reshape(c, b, 3)
        hi = torch.maximum(torch.maximum(k0, k1), k2).reshape(c, b, 3)
        geo = torch.cat([k0, k1, k2], dim=-1).reshape(c, b, 9)
        geo = torch.where(torch.isfinite(geo), geo, 0.0)  # padding: degenerate
        tab = torch.zeros((c, 16, b), dtype=torch.float32, device=dev)
        tab[:, 0:9, :] = geo.transpose(1, 2)
        tab[:, 9, :] = ((vis_cb & 1) != 0).to(torch.float32)
        tab[:, 10, :] = ((vis_cb & 2) != 0).to(torch.float32)
        tab[:, 11, :] = torch.where(prim_cb >= 0, prim_cb.to(torch.float32),
                                    -2.0)
        return (tab, torch.where(valid, lo, torch.inf).amin(dim=1),
                torch.where(valid, hi, -torch.inf).amax(dim=1))

    tab, bmin, bmax = keyframe(v)
    out = dict(tab=tab, tab_t1=None, tab_t2=None)
    if geom.has_motion and geom.vertices_t1 is not None:
        for key, verts in (("tab_t1", geom.vertices_t1),
                           ("tab_t2", geom.vertices_t2)):
            if verts is not None:
                out[key], lo, hi = keyframe(verts)
                bmin = torch.minimum(bmin, lo)
                bmax = torch.maximum(bmax, hi)
    out.update(bmin=bmin, bmax=bmax)
    return out


def _build_blocks_instanced(geom: Geometry) -> BlockAccel:
    """Physical tables: every physical face, plus one blocked copy (in
    object space) of each distinct instanced base range. Virtual blocks:
    the static blocks, then each instance's replica of its base's blocks,
    with world AABBs from the transformed corners of the base block AABBs
    (numpy on the host, as in the JAX package) and the instance's
    object<-world matrix for the ray transform."""
    dev = geom.faces.device
    k_inst = geom.inst_face_base.shape[0]
    b = _pick_block_size(geom.num_faces)
    parts = [_tables_for(geom, b)] if geom.num_base_faces > 0 else []
    c_static = parts[0]["tab"].shape[0] if parts else 0
    base_np = geom.inst_face_base.cpu().numpy()
    off_np = geom.inst_face_off.cpu().numpy()
    vis_np = geom.inst_vis.cpu().numpy()
    mats = geom.inst_mat.cpu().numpy()                   # [K, 3, 4]
    counts = np.diff(off_np)
    ranges = {}
    phys_at = c_static
    for kk in range(k_inst):
        key = (int(base_np[kk]), int(counts[kk]))
        if key not in ranges:
            sub = _tables_for(
                geom, b, torch.arange(key[0], key[0] + key[1], device=dev),
                vis_value=int(vis_np[kk]))
            sub["bmin_np"] = sub["bmin"].cpu().numpy()
            sub["bmax_np"] = sub["bmax"].cpu().numpy()
            ranges[key] = (phys_at, sub)
            phys_at += sub["tab"].shape[0]
            parts.append(sub)

    def cat(name):
        vals = [p[name] for p in parts]
        return None if any(x is None for x in vals) else torch.cat(vals)

    blk_base = [np.arange(c_static, dtype=np.int32)]
    blk_minv = [np.zeros(c_static, np.int32)]
    id_delta = [np.zeros(c_static, np.int32)]
    v_bmin = [parts[0]["bmin"].cpu().numpy()] if c_static else []
    v_bmax = [parts[0]["bmax"].cpu().numpy()] if c_static else []
    for kk in range(k_inst):
        key = (int(base_np[kk]), int(counts[kk]))
        p_at, sub = ranges[key]
        bo, bx = sub["bmin_np"], sub["bmax_np"]
        cb = bo.shape[0]
        blk_base.append(np.arange(p_at, p_at + cb, dtype=np.int32))
        blk_minv.append(np.full(cb, kk + 1, np.int32))
        id_delta.append(np.full(cb, int(off_np[kk]) - key[0], np.int32))
        # world AABB of each block: the 8 transformed object-space corners
        corners = np.stack([
            np.stack([np.where(m & 1, bx[:, 0], bo[:, 0]),
                      np.where(m & 2, bx[:, 1], bo[:, 1]),
                      np.where(m & 4, bx[:, 2], bo[:, 2])], axis=-1)
            for m in range(8)], axis=1)                  # [cb, 8, 3]
        wc = corners @ mats[kk, :, :3].T + mats[kk, :, 3]
        v_bmin.append(wc.min(axis=1).astype(np.float32))
        v_bmax.append(wc.max(axis=1).astype(np.float32))
    inv_rows = np.concatenate(
        [np.eye(3, 4, dtype=np.float32).reshape(1, 12),
         geom.inst_inv.cpu().numpy().reshape(k_inst, 12)])
    dev_t = lambda parts_np: torch.from_numpy(np.concatenate(parts_np)).to(dev)
    return BlockAccel(
        tab=cat("tab"), tab_t1=cat("tab_t1"), tab_t2=cat("tab_t2"),
        bmin=dev_t(v_bmin), bmax=dev_t(v_bmax), blk_base=dev_t(blk_base),
        blk_minv=dev_t(blk_minv), id_delta=dev_t(id_delta),
        inv_rows=torch.from_numpy(inv_rows).to(dev), block_size=b,
        num_blocks=int(sum(len(x) for x in blk_base)))


def sort_key(acc: BlockAccel, o: Tensor, d: Tensor, t_min: Tensor,
             t_max: Tensor) -> Tensor:
    """Coherence key of each ray: dead rays (empty t-range) last, then the
    direction octant, 12 bits of origin morton code, 15 bits of direction
    morton code (the JAX package's key, int64 holding the uint32)."""
    smin = acc.bmin.amin(dim=0)
    sinv = 1.0 / torch.clamp_min(acc.bmax.amax(dim=0) - smin, 1e-12)
    rel = torch.clamp((o - smin) * sinv, 0.0, 1.0)
    okey = morton3d(rel) >> 18
    dkey = morton3d(0.5 * (d + 1.0)) >> 15
    octant = ((d[:, 0] >= 0).to(torch.int64)
              | ((d[:, 1] >= 0).to(torch.int64) << 1)
              | ((d[:, 2] >= 0).to(torch.int64) << 2))
    dead = (t_max < t_min).to(torch.int64)
    return (dead << 30) | (octant << 27) | (okey << 15) | dkey


def query(acc: BlockAccel, geom: Geometry, o: Tensor, d: Tensor,
          t_min: Tensor, t_max: Tensor, exclude: Tensor, vis_bit: int,
          any_hit: bool, time: Optional[Tensor] = None):
    """Full-wavefront query. Queries of more than SORT_MIN_RAYS rays are
    sorted by `sort_key` (a stable sort, as the JAX package's; the ray's
    shutter `time` rides along), traversed, and put back in their order
    through the inverse permutation; the scene's analytic spheres are tested
    after the walk (`spheres.sphere_pass`). Returns (t f32[N], prim
    i32[N] (-1 on a miss), uv f32[N, 2])."""
    n = o.shape[0]
    t_min = t_min.expand(n)
    t_max = t_max.expand(n)
    perm = None
    if n > SORT_MIN_RAYS:
        with PF.span("accel.sort"):
            perm = torch.sort(sort_key(acc, o, d, t_min, t_max),
                              stable=True).indices
            o, d, t_min, t_max, exclude = (x[perm] for x in
                                           (o, d, t_min, t_max, exclude))
            if time is not None:
                time = time[perm]
    bt, bp, bu, bv = tiles.tiles_traverse(
        acc.tab, acc.bmin, acc.bmax, o, d, t_min, t_max, exclude,
        shadow=vis_bit == 2, any_hit=any_hit, blk_base=acc.blk_base,
        blk_minv=acc.blk_minv, id_delta=acc.id_delta, inv_rows=acc.inv_rows,
        tab_t1=acc.tab_t1 if time is not None else None,
        tab_t2=acc.tab_t2 if time is not None else None, time=time)
    # the analytic spheres, in sorted order (the pass is order-independent),
    # before the rays go back to their order
    bt, bp, buv = sphere_pass(geom, o, d, t_min, t_max, exclude, vis_bit, bt,
                              bp, torch.stack([bu, bv], dim=-1))
    if perm is None:
        return bt, bp, buv

    def unsort(x):
        out = torch.empty_like(x)
        out[perm] = x
        return out

    return unsort(bt), unsort(bp), unsort(buv)


def _exclude(o: Tensor, exclude_prim: Optional[Tensor]) -> Tensor:
    if exclude_prim is not None:
        return exclude_prim.to(torch.int32)
    return torch.full((o.shape[0],), -1, dtype=torch.int32, device=o.device)


def blocks_closest(scene: SceneData, o: Tensor, d: Tensor, t_min: Tensor,
                   t_max: Tensor, exclude_prim: Optional[Tensor] = None,
                   shadow: bool = False, time: Optional[Tensor] = None):
    from ..ops.intersect import Hit
    bt, bp, buv = query(scene.blocks, scene.geom, o, d, t_min, t_max,
                        _exclude(o, exclude_prim), 2 if shadow else 1, False,
                        time)
    valid = bp >= 0
    return Hit(valid=valid, t=torch.where(valid, bt, t_max),
               prim=torch.clamp_min(bp, 0), uv=buv)


def blocks_any(scene: SceneData, o: Tensor, d: Tensor, t_min: Tensor,
               t_max: Tensor, exclude_prim: Optional[Tensor] = None,
               time: Optional[Tensor] = None) -> Tensor:
    _, bp, _ = query(scene.blocks, scene.geom, o, d, t_min, t_max,
                     _exclude(o, exclude_prim), 2, True, time)
    return bp >= 0
