"""Block accelerator: morton-sorted triangle blocks, traversed in ray tiles.

Counterpart of `libyafaray_tpu/accel/blocks.py` for static scenes without
instancing. The build sorts the triangles by the morton code of their
centroids and cuts them into contiguous blocks of B triangles, packed as
component-major (16, B) slabs with one AABB per block (`build_blocks`). A
query sorts the rays for coherence (dead rays last), walks them through the
blocks in tiles (`accel/tiles.py`) and restores the original ray order.

Not carried yet: the `geo` / `meta` tables and `_query_chunk` (the JAX
package's ray-chunk loop, used there for motion blur over the VMEM budget
and off the TPU), the motion-blur and instanced builds, and spheres.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..scene_types import BlockAccel, Geometry, SceneData
from . import tiles
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
    f = geom.num_faces
    if f == 0:
        raise ValueError("block accel needs triangles")
    b = _pick_block_size(f)
    tab, bmin, bmax = _tables_for(geom, b)
    return BlockAccel(tab=tab, bmin=bmin, bmax=bmax, block_size=b,
                      num_blocks=tab.shape[0])


def _tables_for(geom: Geometry, b: int):
    """(tab f32[C, 16, B], bmin f32[C, 3], bmax f32[C, 3]) for all faces at
    block size b. Prim ids in the table are the face ids."""
    faces = geom.faces.to(torch.int64)
    f = faces.shape[0]
    dev = faces.device
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

    v0s, v1s, v2s = (padded(x, torch.inf) for x in (v0, v1, v2))
    prim = padded(torch.arange(f, dtype=torch.int32, device=dev), -1)
    vis = padded(geom.face_vis, 0)
    valid = (prim >= 0).reshape(c, b, 1)
    lo = torch.minimum(torch.minimum(v0s, v1s), v2s).reshape(c, b, 3)
    hi = torch.maximum(torch.maximum(v0s, v1s), v2s).reshape(c, b, 3)
    bmin = torch.where(valid, lo, torch.inf).amin(dim=1)
    bmax = torch.where(valid, hi, -torch.inf).amax(dim=1)

    geo = torch.cat([v0s, v1s, v2s], dim=-1).reshape(c, b, 9)
    geo = torch.where(torch.isfinite(geo), geo, 0.0)   # padding: degenerate
    vis_cb = vis.reshape(c, b)
    prim_cb = prim.reshape(c, b)
    tab = torch.zeros((c, 16, b), dtype=torch.float32, device=dev)
    tab[:, 0:9, :] = geo.transpose(1, 2)
    tab[:, 9, :] = ((vis_cb & 1) != 0).to(torch.float32)
    tab[:, 10, :] = ((vis_cb & 2) != 0).to(torch.float32)
    tab[:, 11, :] = torch.where(prim_cb >= 0, prim_cb.to(torch.float32), -2.0)
    return tab, bmin, bmax


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
          any_hit: bool):
    """Full-wavefront query. Queries of more than SORT_MIN_RAYS rays are
    sorted by `sort_key` (a stable sort, as the JAX package's), traversed,
    and put back in their order through the inverse permutation. Returns
    (t f32[N], prim i32[N] (-1 on a miss), uv f32[N, 2])."""
    if geom.num_spheres > 0:
        raise NotImplementedError(
            "sphere primitives are not ported to libyafaray_tpu_torch yet")
    n = o.shape[0]
    t_min = t_min.expand(n)
    t_max = t_max.expand(n)
    perm = None
    if n > SORT_MIN_RAYS:
        perm = torch.sort(sort_key(acc, o, d, t_min, t_max),
                          stable=True).indices
        o, d, t_min, t_max, exclude = (x[perm] for x in
                                       (o, d, t_min, t_max, exclude))
    bt, bp, bu, bv = tiles.tiles_traverse(
        acc.tab, acc.bmin, acc.bmax, o, d, t_min, t_max, exclude,
        shadow=vis_bit == 2, any_hit=any_hit)
    buv = torch.stack([bu, bv], dim=-1)
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
                   shadow: bool = False):
    from ..ops.intersect import Hit
    bt, bp, buv = query(scene.blocks, scene.geom, o, d, t_min, t_max,
                        _exclude(o, exclude_prim), 2 if shadow else 1, False)
    valid = bp >= 0
    return Hit(valid=valid, t=torch.where(valid, bt, t_max),
               prim=torch.clamp_min(bp, 0), uv=buv)


def blocks_any(scene: SceneData, o: Tensor, d: Tensor, t_min: Tensor,
               t_max: Tensor, exclude_prim: Optional[Tensor] = None) -> Tensor:
    _, bp, _ = query(scene.blocks, scene.geom, o, d, t_min, t_max,
                     _exclude(o, exclude_prim), 2, True)
    return bp >= 0
