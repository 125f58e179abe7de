"""SurfacePoint construction: gather and interpolate the shading context.

Counterpart of `libyafaray_tpu/ops/surface.py` for triangle meshes (sphere
primitives are not ported yet and are rejected at compile). A true
instance's virtual face id resolves to its base face and instance: the
vertices move world<-object and the normals by the inverse transpose. A
moving triangle takes its frame from its shutter-open vertices, as in the
JAX package (the hit point itself is o + t d).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..math import vec
from ..scene_types import (SceneData, inst_transform_normal,
                           inst_transform_point, resolve_prim)
from .intersect import Hit

Tensor = torch.Tensor


@dataclass
class SurfacePoint:
    valid: Tensor     # bool[N]
    p: Tensor         # f32[N,3] hit position
    n: Tensor         # f32[N,3] shading normal
    ng: Tensor        # f32[N,3] geometric normal
    nu: Tensor        # f32[N,3] shading-frame tangent
    nv: Tensor        # f32[N,3] shading-frame bitangent
    uv: Tensor        # f32[N,2] texture coords
    dp_du: Tensor     # f32[N,3]
    dp_dv: Tensor     # f32[N,3]
    mat_id: Tensor    # i32[N]
    obj_id: Tensor    # i32[N]
    light_id: Tensor  # i32[N] area light covering this prim, or -1
    prim: Tensor      # i32[N] primitive id (-1 on a miss)
    t: Tensor         # f32[N] ray parameter of the hit
    bary: Tensor      # f32[N,2] triangle barycentrics (u, v) of the hit


def make_surface(scene: SceneData, hit: Hit, ray_o: Tensor, ray_d: Tensor
                 ) -> SurfacePoint:
    g = scene.geom
    if g.num_spheres > 0:
        raise NotImplementedError(
            "sphere primitives are not ported to libyafaray_tpu_torch yet")
    tri = torch.where(hit.prim < g.num_faces, hit.prim, 0)
    # invalid lanes carry t = t_max (possibly 1e30): clamp before forming
    # positions so no huge values enter downstream math
    t_safe = torch.where(hit.valid, hit.t, 1.0)
    p = ray_o + ray_d * t_safe[..., None]

    tri, inst = resolve_prim(g, tri)
    tri = tri.long()
    fidx = g.faces[tri].long()                  # [N,3]
    v0 = g.vertices[fidx[:, 0]]
    v1 = g.vertices[fidx[:, 1]]
    v2 = g.vertices[fidx[:, 2]]
    if inst is not None:
        v0, v1, v2 = (inst_transform_point(g, inst, x) for x in (v0, v1, v2))
    e1 = v1 - v0
    e2 = v2 - v0
    ng = vec.normalize(vec.cross(e1, e2))
    u = hit.uv[:, 0]
    v = hit.uv[:, 1]
    w = 1.0 - u - v
    # smooth vertex-normal interpolation
    n0 = g.normals[fidx[:, 0]]
    n1 = g.normals[fidx[:, 1]]
    n2 = g.normals[fidx[:, 2]]
    if inst is not None:
        n0, n1, n2 = (inst_transform_normal(g, inst, x) for x in (n0, n1, n2))
    n_smooth = vec.normalize(w[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2)
    n = torch.where(g.face_smooth[tri][:, None], n_smooth, ng)
    # texture uv interpolation
    fuv = g.face_uvs[tri].long()
    uv0 = g.uvs[fuv[:, 0]]
    uv1 = g.uvs[fuv[:, 1]]
    uv2 = g.uvs[fuv[:, 2]]
    uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    # dp/du, dp/dv from the uv parametrization; an arbitrary frame when the
    # uv mapping is degenerate
    du1 = uv1[:, 0] - uv0[:, 0]
    du2 = uv2[:, 0] - uv0[:, 0]
    dv1 = uv1[:, 1] - uv0[:, 1]
    dv2 = uv2[:, 1] - uv0[:, 1]
    det = du1 * dv2 - dv1 * du2
    degen = torch.abs(det) <= 1e-12
    inv_det = torch.where(~degen, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    dp_du = (dv2 * inv_det)[:, None] * e1 + (-dv1 * inv_det)[:, None] * e2
    dp_dv = (-du2 * inv_det)[:, None] * e1 + (du1 * inv_det)[:, None] * e2
    fb_u, fb_v = vec.orthonormal_basis(ng)
    dp_du = torch.where(degen[:, None], fb_u, dp_du)
    dp_dv = torch.where(degen[:, None], fb_v, dp_dv)

    # shading frame: Gram-Schmidt dp_du against n
    nu = vec.normalize(dp_du - n * vec.dot(dp_du, n, keepdim=True))
    nv = vec.cross(n, nu)
    valid = hit.valid
    obj = g.face_obj[tri]
    if inst is not None:
        obj = torch.where(inst >= 0,
                          g.inst_obj[torch.clamp_min(inst, 0).long()], obj)
    return SurfacePoint(
        valid=valid, p=p, n=n, ng=ng, nu=nu, nv=nv, uv=uv,
        dp_du=dp_du, dp_dv=dp_dv,
        mat_id=torch.where(valid, g.face_mat[tri], 0),
        obj_id=torch.where(valid, obj, 0),
        light_id=torch.where(valid, g.face_light[tri], -1),
        prim=torch.where(valid, hit.prim, -1),
        t=hit.t, bary=hit.uv)
