"""Light table sampling and pdfs: every light type of the JAX package.

Counterpart of `libyafaray_tpu/lights/__init__.py`: point, IES and spot
lights (Dirac points, the IES light by its candela profile, the spot by a
smooth edge between its cones), directional and sun lights, area lights,
sphere lights (solid-angle cone sampling), mesh lights and background
portals (an area-CDF face pick; a portal lets the background in from its
front) and the background light (an environment map importance-sampled
through its alias tables, any other background uniformly over the
sphere). Every present type is evaluated for the whole wavefront and
selected per lane by its type, as in the JAX package. `sample_light`
returns solid-angle pdfs (1 for Dirac lights, whose radiance is already
divided by the squared distance); the `color` column holds the emitted
radiance, or a Dirac light's intensity, or a portal's power.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..backgrounds import eval_background
from ..math import vec
from ..scene_types import (LIGHT_AREA, LIGHT_BACKGROUND, LIGHT_BGPORTAL,
                           LIGHT_DIRECTIONAL, LIGHT_IES, LIGHT_MESH,
                           LIGHT_POINT, LIGHT_SPHERE, LIGHT_SPOT, LIGHT_SUN,
                           LightTable, SceneData)
from ..textures import env_alias_sample, env_pdf_dir

Tensor = torch.Tensor

FLAG_CAST_SHADOWS = 1
FLAG_ENABLED = 2
FLAG_PHOTON_ONLY = 4
FLAG_DOUBLE_SIDED = 8


@dataclass
class LightSample:
    wi: Tensor        # f32[N,3] direction to the light
    dist: Tensor      # f32[N] distance to the light sample (inf: infinite)
    pdf: Tensor       # f32[N] solid-angle pdf (1 for Dirac lights)
    radiance: Tensor  # f32[N,3] incident radiance
    is_dirac: Tensor  # bool[N] (point, IES, spot and directional lights)
    valid: Tensor     # bool[N]


def _has(lt, ty: int) -> bool:
    """Light families absent from the scene are not evaluated (an empty
    present_types means unknown)."""
    return not lt.present_types or ty in lt.present_types


def _spot_falloff(cos_a: Tensor, cos_start: Tensor, cos_end: Tensor,
                  falloff: Tensor) -> Tensor:
    """The spot's smooth edge (light_spot.cc): 1 inside the inner cone, a
    smoothstep to the power `falloff` across the blend band, 0 outside."""
    t = (cos_a - cos_end) / torch.clamp_min(cos_start - cos_end, 1e-9)
    t = torch.clamp(t, 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    return torch.where(cos_a >= cos_start, 1.0,
                       torch.pow(smooth, torch.clamp_min(falloff, 1e-6)))


def _ies_factor(lt: LightTable, li: Tensor, cos_a: Tensor,
                wdir: Tensor = None) -> Tensor:
    """The IES profile's candela multiplier for each lane's emission angle
    (light_ies.cc getAngles, light_ies_data.h getRadiance): a bilinear
    fetch from the light's [H, V] grid, vertical by the angle from the
    light's axis, horizontal by the azimuth of the world direction `wdir`
    (u = acos(dir.z), mirrored to [180, 360) where dir.y < 0; None looks up
    h = 0). 1 for lights without a profile."""
    ies_id = lt.ies_id[li]
    pool = lt.ies_pool
    res_h, res_v = pool.shape[-2], pool.shape[-1]
    pid = torch.clamp_min(ies_id, 0).long()
    xv = torch.acos(torch.clamp(cos_a, -1.0, 1.0)) / math.pi * (res_v - 1)
    v0 = torch.clamp(xv.to(torch.int32), 0, res_v - 2)
    fv = xv - v0
    if res_h == 1 or wdir is None:
        h0 = h1 = torch.zeros_like(v0)
        fh = torch.zeros_like(fv)
    else:
        u = torch.acos(torch.clamp(wdir[..., 2], -1.0, 1.0))
        u = torch.where(wdir[..., 1] < 0.0, 2.0 * math.pi - u, u)
        xh = u / (2.0 * math.pi) * res_h
        h0 = torch.remainder(xh.to(torch.int32), res_h)
        h1 = torch.remainder(h0 + 1, res_h)
        fh = xh - torch.floor(xh)
    h0, h1, v0 = h0.long(), h1.long(), v0.long()
    p00 = pool[pid, h0, v0]
    p01 = pool[pid, h0, v0 + 1]
    p10 = pool[pid, h1, v0]
    p11 = pool[pid, h1, v0 + 1]
    val = ((p00 * (1 - fv) + p01 * fv) * (1 - fh)
           + (p10 * (1 - fv) + p11 * fv) * fh)
    return torch.where(ies_id >= 0, val, torch.ones_like(cos_a))


def sample_light_tri(lt: LightTable, num_faces: int, li: Tensor,
                     u1: Tensor):
    """Area-CDF triangle pick within mesh light li's faces [tri_start,
    tri_start + tri_count) (light_object_light.cc's Pdf1D): a bisection
    over the faces' normalised cumulative areas, so the density over the
    light's surface is uniform, 1 / total area. Returns (face index, u1
    rescaled to the picked face's share)."""
    start = lt.tri_start[li]
    cnt = torch.clamp_min(lt.tri_count[li], 1)
    if lt.tri_cdf is None:   # no mesh light found its object: uniform pick
        x = u1 * cnt.to(torch.float32)
        tri = start + torch.minimum(torch.clamp_min(x.to(torch.int32), 0),
                                    cnt - 1)
        return tri, x - torch.floor(x)
    lo = torch.zeros_like(start)
    hi = cnt - 1
    for _ in range(max(1, math.ceil(math.log2(max(2, num_faces))))):
        mid = (lo + hi) // 2
        go_hi = u1 > lt.tri_cdf[(start + mid).long()]
        lo = torch.where(go_hi, mid + 1, lo)
        hi = torch.where(go_hi, hi, mid)
    idx = torch.minimum(torch.clamp_min(lo, 0), cnt - 1)
    tri = start + idx
    c1 = lt.tri_cdf[tri.long()]
    c0 = torch.where(idx > 0,
                     lt.tri_cdf[torch.clamp_min(tri - 1, 0).long()], 0.0)
    u1r = torch.clamp((u1 - c0) / torch.clamp_min(c1 - c0, 1e-12), 0.0, 1.0)
    return tri, u1r


def sample_light(scene: SceneData, li: Tensor, p: Tensor, ns: Tensor,
                 u1: Tensor, u2: Tensor) -> LightSample:
    """Light::illumSample for a per-lane light index `li` at shading points
    `p`."""
    lt = scene.lights
    li = li.long()
    ty = lt.light_type[li]
    ldir = lt.direction[li]
    col = lt.color[li]
    n = p.shape[0]
    f32 = dict(dtype=torch.float32, device=p.device)
    wi = torch.zeros_like(p)
    dist = torch.full((n,), torch.inf, **f32)
    pdf = torch.ones((n,), **f32)
    rad = torch.zeros_like(p)
    valid = torch.ones((n,), dtype=torch.bool, device=p.device)
    dirac = torch.zeros((n,), dtype=torch.bool, device=p.device)

    # the lights at a position: the direction and distance to it
    if any(_has(lt, t) for t in (LIGHT_POINT, LIGHT_IES, LIGHT_SPOT,
                                 LIGHT_SPHERE)):
        to_l = lt.position[li] - p
        d2 = torch.clamp_min(vec.dot(to_l, to_l), 1e-12)
        dist_pt = torch.sqrt(d2)
        wi_pt = to_l / dist_pt[..., None]

    # point light: a Dirac delta at its position (light_point.cc)
    if _has(lt, LIGHT_POINT):
        m = ty == LIGHT_POINT
        wi = torch.where(m[..., None], wi_pt, wi)
        dist = torch.where(m, dist_pt, dist)
        rad = torch.where(m[..., None], col / d2[..., None], rad)
        dirac = dirac | m

    # IES light: a point weighted by its profile about its axis
    if _has(lt, LIGHT_IES):
        m = ty == LIGHT_IES
        ies_f = _ies_factor(lt, li, vec.dot(-wi_pt, ldir), wi_pt)
        wi = torch.where(m[..., None], wi_pt, wi)
        dist = torch.where(m, dist_pt, dist)
        rad = torch.where(m[..., None], col * (ies_f / d2)[..., None], rad)
        dirac = dirac | m

    # spot light (light_spot.cc)
    if _has(lt, LIGHT_SPOT):
        m = ty == LIGHT_SPOT
        fall = _spot_falloff(vec.dot(-wi_pt, ldir), lt.cos_start[li],
                             lt.cos_end[li], lt.falloff[li])
        wi = torch.where(m[..., None], wi_pt, wi)
        dist = torch.where(m, dist_pt, dist)
        rad = torch.where(m[..., None], col * (fall / d2)[..., None], rad)
        dirac = dirac | m
        valid = valid & torch.where(m, fall > 0.0, True)

    # directional light: parallel along its direction (light_directional.cc)
    if _has(lt, LIGHT_DIRECTIONAL):
        m = ty == LIGHT_DIRECTIONAL
        wi = torch.where(m[..., None], -ldir, wi)
        rad = torch.where(m[..., None], col, rad)
        dirac = dirac | m

    # sun: a cone around -direction (light_sun.cc)
    if _has(lt, LIGHT_SUN):
        m = ty == LIGHT_SUN
        cos_max = lt.cos_start[li]
        u_ax, v_ax = vec.orthonormal_basis(-ldir)
        cone = vec.uniform_sample_cone(u1, u2, cos_max)
        wi_sun = (u_ax * cone[..., 0:1] + v_ax * cone[..., 1:2]
                  + (-ldir) * cone[..., 2:3])
        pdf_sun = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cos_max), 1e-9)
        wi = torch.where(m[..., None], wi_sun, wi)
        pdf = torch.where(m, pdf_sun, pdf)
        rad = torch.where(m[..., None], col, rad)

    # area light: parallelogram corner + u1*e1 + u2*e2 (light_area.cc)
    if _has(lt, LIGHT_AREA):
        m = ty == LIGHT_AREA
        lp = (lt.position[li] + lt.edge1[li] * u1[..., None]
              + lt.edge2[li] * u2[..., None])
        to_a = lp - p
        d2a = torch.clamp_min(vec.dot(to_a, to_a), 1e-12)
        dist_a = torch.sqrt(d2a)
        wi_a = to_a / dist_a[..., None]
        cos_l = vec.dot(-wi_a, ldir)
        dbl = (lt.flags[li] & FLAG_DOUBLE_SIDED) != 0
        cos_l = torch.where(dbl, torch.abs(cos_l), cos_l)
        pdf_a = d2a / torch.clamp_min(
            lt.area[li] * torch.clamp_min(cos_l, 1e-9), 1e-12)
        wi = torch.where(m[..., None], wi_a, wi)
        dist = torch.where(m, dist_a, dist)
        pdf = torch.where(m, pdf_a, pdf)
        rad = torch.where(m[..., None], col, rad)
        valid = valid & torch.where(m, cos_l > 1e-6, True)

    # sphere light: a uniform direction in the cone the sphere subtends
    # (light_sphere.cc); the shadow ray ends at the sphere's surface
    if _has(lt, LIGHT_SPHERE):
        m = ty == LIGHT_SPHERE
        r = lt.radius[li]
        sin2_max = torch.clamp(r * r / d2, 0.0, 1.0)
        cos_max_s = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
        u_s, v_s = vec.orthonormal_basis(wi_pt)
        cone_s = vec.uniform_sample_cone(u1, u2, cos_max_s)
        wi_s = (u_s * cone_s[..., 0:1] + v_s * cone_s[..., 1:2]
                + wi_pt * cone_s[..., 2:3])
        pdf_s = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cos_max_s),
                                      1e-9)
        # the nearer root of |o + t wi - c| = r
        mm = vec.dot(to_l, wi_s)
        disc = r * r - (d2 - mm * mm)
        dist_s = mm - torch.sqrt(torch.clamp_min(disc, 0.0))
        wi = torch.where(m[..., None], wi_s, wi)
        dist = torch.where(m, torch.clamp_min(dist_s, 1e-6), dist)
        pdf = torch.where(m, pdf_s, pdf)
        rad = torch.where(m[..., None], col, rad)
        valid = valid & torch.where(m, ~(d2 <= r * r), True)

    # mesh light and background portal: an area-CDF face pick, then a
    # uniform point on the face (light_object_light.cc,
    # light_background_portal.cc); a mesh light emits from both sides, a
    # portal lets the background in from its front
    has_mesh = scene.geom.num_faces > 0 and _has(lt, LIGHT_MESH)
    has_portal = scene.geom.num_faces > 0 and _has(lt, LIGHT_BGPORTAL)
    if has_mesh or has_portal:
        m_port = ty == LIGHT_BGPORTAL
        if has_mesh and has_portal:
            m = (ty == LIGHT_MESH) | m_port
        else:
            m = ty == LIGHT_MESH if has_mesh else m_port
        g = scene.geom
        tri, u1r = sample_light_tri(lt, g.num_faces, li, u1)
        fidx = g.faces[tri.long()].long()
        v0 = g.vertices[fidx[:, 0]]
        v1 = g.vertices[fidx[:, 1]]
        v2 = g.vertices[fidx[:, 2]]
        b0, b1 = vec.sample_triangle_uniform(u1r, u2)
        lp = (v0 * b0[..., None] + v1 * b1[..., None]
              + v2 * (1 - b0 - b1)[..., None])
        nrm = vec.cross(v1 - v0, v2 - v0)
        n_l = nrm / torch.clamp_min(vec.length(nrm), 1e-12)[..., None]
        to_m = lp - p
        d2m = torch.clamp_min(vec.dot(to_m, to_m), 1e-12)
        dist_m = torch.sqrt(d2m)
        wi_m = to_m / dist_m[..., None]
        cos_m = vec.dot(-wi_m, n_l)
        cos_m = (torch.where(m_port, cos_m, torch.abs(cos_m)) if has_portal
                 else torch.abs(cos_m))
        # the area-CDF pick has the uniform density 1 / total area
        pdf_m = d2m / torch.clamp_min(
            lt.area[li] * torch.clamp_min(cos_m, 1e-9), 1e-12)
        rad_m = col
        if has_portal:
            rad_m = torch.where(m_port[..., None],
                                eval_background(scene, wi_m) * col, col)
        wi = torch.where(m[..., None], wi_m, wi)
        dist = torch.where(m, dist_m, dist)
        pdf = torch.where(m, pdf_m, pdf)
        rad = torch.where(m[..., None], rad_m, rad)
        valid = valid & torch.where(m, cos_m > 1e-6, True)

    # background light (light_background.cc): an environment map by its
    # importance tables, any other background uniformly over the sphere
    if lt.bg_light_idx >= 0:
        m = ty == LIGHT_BACKGROUND
        if _has_env_tables(scene):
            wi_b, pdf_b = env_alias_sample(scene, u1, u2)
        else:
            wi_b = vec.uniform_sample_sphere(u1, u2)
            pdf_b = 1.0 / (4.0 * math.pi)
        wi = torch.where(m[..., None], wi_b, wi)
        pdf = torch.where(m, pdf_b, pdf)
        rad = torch.where(m[..., None], eval_background(scene, wi_b), rad)

    flags = lt.flags[li]
    enabled = (flags & FLAG_ENABLED) != 0
    photon_only = (flags & FLAG_PHOTON_ONLY) != 0
    valid = valid & enabled & ~photon_only & (vec.dot(rad, rad) > 0)
    return LightSample(wi=wi, dist=dist, pdf=torch.clamp_min(pdf, 1e-12),
                       radiance=rad, is_dirac=dirac, valid=valid)


def light_pdf_hit(scene: SceneData, light_id: Tensor, p_hit: Tensor,
                  n_hit: Tensor, p_from: Tensor) -> Tensor:
    """Solid-angle pdf with which `sample_light` would pick the direction
    from p_from to p_hit on intersectable light `light_id` (Light::illumPdf),
    for BSDF-sample MIS; 0 for lights that cannot be hit."""
    lt = scene.lights
    light_id = light_id.long()
    ty = lt.light_type[light_id]
    to_h = p_hit - p_from
    d2 = torch.clamp_min(vec.dot(to_h, to_h), 1e-12)
    wi = to_h * torch.rsqrt(d2)[..., None]
    cos_l = torch.abs(vec.dot(-wi, n_hit))
    pdf = torch.zeros(p_from.shape[:-1], dtype=torch.float32,
                      device=p_from.device)
    # area and mesh lights: uniform density over the light's surface
    for t in (LIGHT_AREA, LIGHT_MESH):
        if _has(lt, t):
            pdf = torch.where(ty == t, d2 / torch.clamp_min(
                lt.area[light_id] * torch.clamp_min(cos_l, 1e-9), 1e-12),
                pdf)
    if _has(lt, LIGHT_BGPORTAL):
        # one-sided: 0 from behind
        cos_sp = vec.dot(-wi, n_hit)
        pdf = torch.where(ty == LIGHT_BGPORTAL, torch.where(
            cos_sp > 1e-9, d2 / torch.clamp_min(
                lt.area[light_id] * torch.clamp_min(cos_sp, 1e-9), 1e-12),
            0.0), pdf)
    if _has(lt, LIGHT_SPHERE):
        c = lt.position[light_id]
        r = lt.radius[light_id]
        dc = c - p_from
        dc2 = torch.clamp_min(vec.dot(dc, dc), 1e-12)
        sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0)
        cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
        pdf = torch.where(ty == LIGHT_SPHERE, 1.0 / torch.clamp_min(
            2.0 * math.pi * (1.0 - cos_max), 1e-9), pdf)
    return pdf


def background_pdf(scene: SceneData, d: Tensor) -> Tensor:
    """pdf of the background light generating direction d (env MIS)."""
    f32 = dict(dtype=torch.float32, device=d.device)
    if scene.lights.bg_light_idx < 0:
        return torch.zeros(d.shape[:-1], **f32)
    if _has_env_tables(scene):
        return env_pdf_dir(scene, d)
    return torch.full(d.shape[:-1], 1.0 / (4.0 * math.pi), **f32)


def _has_env_tables(scene: SceneData) -> bool:
    bg = scene.background
    return bg.env_alias_prob is not None and bg.env_shape[0] > 0
