"""SurfacePoint construction: gather and interpolate the shading context.

Counterpart of `libyafaray_tpu/ops/surface.py`: triangles, and analytic
spheres (prim ids from num_faces on) by their own branch. Each hit carries
its orco point: the face's orco coordinates interpolated by its
barycentrics when the scene has any, else (and on spheres) the hit point
itself. A true
instance's virtual face id resolves to its base face and instance: the
vertices move world<-object and the normals by the inverse transpose. A
moving triangle takes its frame from its shutter-open vertices, as in the
JAX package (the hit point itself is o + t d). `compute_differentials`
gives the primary hits their one-pixel footprint for texture filtering.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..math import vec
from ..scene_types import (SceneData, inst_transform_normal,
                           inst_transform_point, resolve_prim)
from ..utils import profiling as PF
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
    # the screen-space footprint of primary hits (the reference's
    # SurfacePoint differentials, surface.h:70,123-133): the world-space
    # pixel axes and their uv-space derivatives, for mipmap / EWA filtering
    dp_dx: Optional[Tensor] = None   # f32[N,3]
    dp_dy: Optional[Tensor] = None   # f32[N,3]
    duv_dx: Optional[Tensor] = None  # f32[N,2]
    duv_dy: Optional[Tensor] = None  # f32[N,2]
    # object-space original coordinates; make_surface always sets them (p
    # when the scene has none), None reads as p
    orco: Optional[Tensor] = None    # f32[N,3]


def make_surface(scene: SceneData, hit: Hit, ray_o: Tensor, ray_d: Tensor
                 ) -> SurfacePoint:
    g = scene.geom
    is_tri = hit.prim < g.num_faces
    tri = torch.where(is_tri, hit.prim, 0)
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
    # orco: the streamed (or untransformed) object-space coordinates by
    # barycentrics; the hit point when no object streamed orcos. The
    # area-light quads appended at compile have no orco rows: their
    # indices clamp to the last row, as XLA clamps an out-of-range gather
    if g.orcos is not None:
        oi = torch.clamp_max(fidx, g.orcos.shape[0] - 1)
        orco = (w[:, None] * g.orcos[oi[:, 0]] + u[:, None] * g.orcos[oi[:, 1]]
                + v[:, None] * g.orcos[oi[:, 2]])
    else:
        orco = p
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

    mat_id = g.face_mat[tri]
    obj_id = g.face_obj[tri]
    if inst is not None:
        obj_id = torch.where(inst >= 0,
                             g.inst_obj[torch.clamp_min(inst, 0).long()],
                             obj_id)
    light_id = g.face_light[tri]

    if g.num_spheres > 0:
        # the sphere branch: the normal from the centre, uv from the
        # spherical angles (primitive_sphere.cc)
        sph = torch.clamp(hit.prim - g.num_faces, 0, g.num_spheres - 1).long()
        n_sph = vec.normalize(p - g.sph_center[sph])
        theta = torch.acos(torch.clamp(n_sph[:, 2], -1.0, 1.0))
        phi = torch.atan2(n_sph[:, 1], n_sph[:, 0])
        uv_sph = torch.stack([(phi / (2 * math.pi)) + 0.5, theta / math.pi],
                             dim=-1)
        su, sv = vec.orthonormal_basis(n_sph)
        t3 = is_tri[:, None]
        ng = torch.where(t3, ng, n_sph)
        n = torch.where(t3, n, n_sph)
        uv = torch.where(t3, uv, uv_sph)
        dp_du = torch.where(t3, dp_du, su)
        dp_dv = torch.where(t3, dp_dv, sv)
        mat_id = torch.where(is_tri, mat_id, g.sph_mat[sph])
        obj_id = torch.where(is_tri, obj_id, g.sph_obj[sph])
        light_id = torch.where(is_tri, light_id, -1)
        orco = torch.where(t3, orco, p)

    # shading frame: Gram-Schmidt dp_du against n
    nu = vec.normalize(dp_du - n * vec.dot(dp_du, n, keepdim=True))
    nv = vec.cross(n, nu)
    valid = hit.valid
    return SurfacePoint(
        valid=valid, p=p, n=n, ng=ng, nu=nu, nv=nv, uv=uv,
        dp_du=dp_du, dp_dv=dp_dv,
        mat_id=torch.where(valid, mat_id, 0),
        obj_id=torch.where(valid, obj_id, 0),
        light_id=torch.where(valid, light_id, -1),
        prim=torch.where(valid, hit.prim, -1),
        t=hit.t, bary=hit.uv, orco=orco)


def compute_differentials(scene: SceneData, sp: SurfacePoint,
                          d: Tensor) -> SurfacePoint:
    """sp with the one-pixel footprint of primary hits (the JAX package's
    analytic form of the reference's uv differentials): radius
    r = t * pixel_spread along the two directions perpendicular to the ray,
    projected onto the tangent plane along the ray, then into uv by the
    2x2 normal equations against dp_du / dp_dv. Zero on lanes without a
    hit; sp as it is when the scene has no pixel_spread."""
    if scene.pixel_spread is None:
        return sp
    r = sp.t * scene.pixel_spread
    # an orthonormal frame perpendicular to the ray
    with PF.host_sync("surface.axes"):
        z_axis = torch.tensor([0.0, 0.0, 1.0], device=d.device)
    with PF.host_sync("surface.axes"):
        x_axis = torch.tensor([1.0, 0.0, 0.0], device=d.device)
    e1 = vec.normalize(vec.cross(d, torch.where(
        torch.abs(d[..., 2:3]) < 0.9, z_axis, x_axis)))
    e2 = vec.cross(d, e1)
    # the offsets projected onto the tangent plane along the ray
    dn = vec.dot(d, sp.ng, keepdim=True)
    dn = torch.where(torch.abs(dn) < 1e-6,
                     torch.where(dn < 0, -1e-6, 1e-6), dn)
    ax = (e1 - d * (vec.dot(e1, sp.ng, keepdim=True) / dn)) * r[..., None]
    ay = (e2 - d * (vec.dot(e2, sp.ng, keepdim=True) / dn)) * r[..., None]
    # [dp_du dp_dv] [du dv]^T = axis, by the 2x2 normal equations
    a11 = vec.dot(sp.dp_du, sp.dp_du)
    a12 = vec.dot(sp.dp_du, sp.dp_dv)
    a22 = vec.dot(sp.dp_dv, sp.dp_dv)
    det = a11 * a22 - a12 * a12
    inv_det = torch.where(torch.abs(det) > 1e-18,
                          1.0 / torch.where(det == 0, 1.0, det), 0.0)

    def solve(axis):
        b1 = vec.dot(axis, sp.dp_du)
        b2 = vec.dot(axis, sp.dp_dv)
        du = (a22 * b1 - a12 * b2) * inv_det
        dv = (a11 * b2 - a12 * b1) * inv_det
        return torch.stack([du, dv], -1)

    v = sp.valid[..., None]
    return dataclasses.replace(
        sp, dp_dx=torch.where(v, ax, 0.0), dp_dy=torch.where(v, ay, 0.0),
        duv_dx=torch.where(v, solve(ax), 0.0),
        duv_dy=torch.where(v, solve(ay), 0.0))
