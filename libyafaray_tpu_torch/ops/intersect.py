"""Ray-scene intersection over the brute-force, block and LBVH
accelerators.

Counterpart of `libyafaray_tpu/ops/intersect.py`. On the brute-force path
every triangle query goes through `accel.mt_intersect.mt_closest`, whatever
the face count; on the block accelerator (`accel_kind == "blocks"`, scenes
of 2048+ faces by default) through `accel.blocks`, whose traversal is
`accel.tiles`; on the LBVH (`accel_kind == "bvh"`, by name) through
`accel.lbvh.lbvh_traverse`, which tests the spheres among its leaves. Each
is a CUDA kernel for tensors on the card and its plain PyTorch version for
tensors on the CPU. On the other two paths the scene's analytic spheres
follow the triangles (`accel.spheres`). Intersections carry no gradient,
so the queries run under `torch.no_grad()` on detached inputs.
Motion-blurred scenes (`geom.has_motion`) take each ray's shutter `time`;
the queries pass it on only for such scenes, as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..accel import blocks as BL
from ..accel import lbvh as LB
from ..accel import mt_intersect as MT
from ..accel.spheres import sphere_pass
from ..math import vec
from ..scene_types import Geometry, SceneData
from ..utils import profiling as PF

Tensor = torch.Tensor


@dataclass
class Hit:
    """Wavefront hit record (SoA)."""
    valid: Tensor   # bool[N]
    t: Tensor       # f32[N]
    prim: Tensor    # i32[N] face index (0 on a miss)
    uv: Tensor      # f32[N, 2] barycentrics


def moller_trumbore(o: Tensor, d: Tensor, v0: Tensor, v1: Tensor, v2: Tensor,
                    t_min, t_max, eps: float = 1e-10):
    """Batched MT over broadcast shapes (o, d [N,1,3]; v* [1,C,3]).
    Returns (hit_mask, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = vec.cross(d, e2)
    det = vec.dot(e1, pvec)
    ok = torch.abs(det) > eps
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = o - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(d, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t <= t_max)
    return hit, t, u, v


def _brute_closest(geom: Geometry, o: Tensor, d: Tensor, t_min: Tensor,
                   t_max: Tensor, exclude_prim: Optional[Tensor] = None,
                   shadow: bool = False, time: Optional[Tensor] = None) -> Hit:
    if geom.inst_mat is not None:
        raise NotImplementedError(
            "brute-force intersection does not expand true instances; "
            "instanced scenes compile with the block accelerator (set "
            "instancing: 'baked' to force geometry duplication)")
    n = o.shape[0]
    best_t = t_max
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_uv = torch.zeros((n, 2), dtype=torch.float32, device=o.device)
    if geom.num_faces > 0:
        excl = (exclude_prim.to(torch.int32).contiguous()
                if exclude_prim is not None else best_prim)
        motion = {}
        if geom.has_motion and time is not None:
            motion = dict(time=time.to(torch.float32).contiguous(),
                          tris_t1=geom.tri_table_t1,
                          tris_t2=geom.tri_table_t2)
        bt, bp, bu, bv = MT.mt_closest(
            geom.tri_table, o.contiguous(), d.contiguous(),
            t_min.contiguous(), t_max.contiguous(), excl, shadow=shadow,
            **motion)
        best_t = torch.where(bp >= 0, bt, best_t)
        best_prim = bp
        best_uv = torch.stack([bu, bv], dim=-1)
    best_t, best_prim, best_uv = sphere_pass(
        geom, o, d, t_min, best_t, exclude_prim, 2 if shadow else 1, best_t,
        best_prim, best_uv)
    return Hit(valid=best_prim >= 0, t=best_t,
               prim=torch.clamp_min(best_prim, 0), uv=best_uv)


def _brute_any(geom: Geometry, o: Tensor, d: Tensor, t_min: Tensor,
               t_max: Tensor, exclude_prim: Optional[Tensor] = None,
               time: Optional[Tensor] = None) -> Tensor:
    """Boolean shadow query: the closest-hit scan over shadow casters."""
    return _brute_closest(geom, o, d, t_min, t_max, exclude_prim,
                          shadow=True, time=time).valid


def _query(o: Tensor, t_min, t_max):
    """Ray extents as f32[N] tensors on the rays' device (a Python number
    is copied there: a copy that waits for the device)."""
    shape = o.shape[:-1]

    def as_t(x):
        if isinstance(x, Tensor):
            x = torch.as_tensor(x, dtype=torch.float32, device=o.device)
        else:
            with PF.host_sync("intersect.t_range"):
                x = torch.as_tensor(x, dtype=torch.float32, device=o.device)
        return x.expand(shape)

    return as_t(t_min), as_t(t_max)


def _count_lanes(t_min: Tensor, t_max: Tensor) -> None:
    """With tracing on, a query's lanes and its live lanes (a t-range that
    is not empty)."""
    if PF.recording():
        PF.count("lanes.total", t_min.numel())
        PF.count("lanes.live", (t_max >= t_min).sum())


def _accel(scene: SceneData) -> str:
    """The accelerator a query takes: "blocks" or "bvh" where the scene
    carries its tables, else brute force (as the JAX package picks)."""
    if scene.accel_kind == "blocks" and scene.blocks is not None:
        return "blocks"
    if scene.accel_kind == "bvh" and scene.bvh is not None:
        return "bvh"
    return "brute"


def _lbvh_closest(scene: SceneData, o: Tensor, d: Tensor, t_min: Tensor,
                  t_max: Tensor, exclude_prim: Optional[Tensor] = None,
                  shadow: bool = False, time: Optional[Tensor] = None,
                  any_hit: bool = False) -> Hit:
    """A query through the LBVH walk (the JAX `lbvh.traverse_closest` /
    `traverse_any`)."""
    n = o.shape[0]
    excl = (exclude_prim.to(torch.int32).contiguous()
            if exclude_prim is not None
            else torch.full((n,), -1, dtype=torch.int32, device=o.device))
    bt, bp, bu, bv = LB.lbvh_traverse(
        scene.bvh, scene.geom, o.contiguous(), d.contiguous(),
        t_min.contiguous(), t_max.contiguous(), excl,
        time=None if time is None else time.to(torch.float32).contiguous(),
        shadow=shadow, any_hit=any_hit)
    return Hit(valid=bp >= 0, t=bt, prim=torch.clamp_min(bp, 0),
               uv=torch.stack([bu, bv], dim=-1))


def _time(scene: SceneData, time: Optional[Tensor]) -> Optional[Tensor]:
    """The rays' shutter times, for motion-blurred scenes only."""
    return time.detach() if time is not None and scene.geom.has_motion \
        else None


@PF.span("intersect.closest")
@torch.no_grad()
def closest_hit(scene: SceneData, o: Tensor, d: Tensor, t_min, t_max,
                exclude_prim: Optional[Tensor] = None,
                time: Optional[Tensor] = None) -> Hit:
    """Closest-hit query over the whole scene (Accelerator::intersect)."""
    t_min, t_max = _query(o, t_min, t_max)
    _count_lanes(t_min, t_max)
    args = (o.detach(), d.detach(), t_min.detach(), t_max.detach(),
            exclude_prim)
    accel = _accel(scene)
    if accel == "blocks":
        return BL.blocks_closest(scene, *args, time=_time(scene, time))
    if accel == "bvh":
        return _lbvh_closest(scene, *args, time=_time(scene, time))
    return _brute_closest(scene.geom, *args, time=_time(scene, time))


@torch.no_grad()
def camera_hit(scene: SceneData, o: Tensor, d: Tensor, t_min, t_max,
               time: Optional[Tensor] = None) -> Hit:
    """First intersection of camera rays. Identical to closest_hit unless the
    scene has primitives invisible to the camera (area lights with
    visibility='invisible'): lanes whose first hit is such a primitive are
    traced again past it; the other lanes get an empty t-range."""
    hit = closest_hit(scene, o, d, t_min, t_max, time=time)
    if not scene.has_cam_invisible:
        return hit
    nf = scene.geom.num_faces
    is_tri = hit.prim < nf
    # a virtual (instance) prim id lies past the physical face arrays: the
    # JAX package's gather clamps it to the last physical face
    last = max(scene.geom.face_vis.shape[0] - 1, 0)
    fv = scene.geom.face_vis[torch.clamp_max(hit.prim, last)]
    inv = hit.valid & is_tri & ((fv & 4) != 0)
    excl = torch.where(inv, hit.prim, -1)
    _, t_max = _query(o, t_min, t_max)
    hit2 = closest_hit(scene, o, d, t_min, torch.where(inv, t_max, -1.0),
                       exclude_prim=excl, time=time)
    return Hit(valid=torch.where(inv, hit2.valid, hit.valid),
               t=torch.where(inv, hit2.t, hit.t),
               prim=torch.where(inv, hit2.prim, hit.prim),
               uv=torch.where(inv[..., None], hit2.uv, hit.uv))


@PF.span("intersect.any")
@torch.no_grad()
def any_hit(scene: SceneData, o: Tensor, d: Tensor, t_min, t_max,
            exclude_prim: Optional[Tensor] = None,
            time: Optional[Tensor] = None) -> Tensor:
    """Binary shadow query (Accelerator::intersectS)."""
    t_min, t_max = _query(o, t_min, t_max)
    _count_lanes(t_min, t_max)
    args = (o.detach(), d.detach(), t_min.detach(), t_max.detach(),
            exclude_prim)
    accel = _accel(scene)
    if accel == "blocks":
        return BL.blocks_any(scene, *args, time=_time(scene, time))
    if accel == "bvh":
        return _lbvh_closest(scene, *args, shadow=True,
                             time=_time(scene, time), any_hit=True).valid
    return _brute_any(scene.geom, *args, time=_time(scene, time))


@PF.span("intersect.shadow_surface")
@torch.no_grad()
def shadow_hit_surface(scene: SceneData, o: Tensor, d: Tensor, t_min, t_max,
                       exclude_prim: Optional[Tensor] = None) -> Hit:
    """Closest hit over the shadow casters (the visibility bit of shadow
    rays): a step of the transparent-shadow walk (Accelerator::intersectTs
    analogue). The JAX package traces it at the shutter-open geometry, and
    so does the port (ROADMAP section 3)."""
    t_min, t_max = _query(o, t_min, t_max)
    _count_lanes(t_min, t_max)
    args = (o.detach(), d.detach(), t_min.detach(), t_max.detach(),
            exclude_prim)
    accel = _accel(scene)
    if accel == "blocks":
        return BL.blocks_closest(scene, *args, shadow=True)
    if accel == "bvh":
        return _lbvh_closest(scene, *args, shadow=True)
    return _brute_closest(scene.geom, *args, shadow=True)
