"""Wavefront bidirectional path tracer (BDPT).

Counterpart of `libyafaray_tpu/integrators/bidir.py` (libYafaRay's
BidirectionalIntegrator, integrator_bidirectional.cc): whole wavefronts of
eye and light subpaths are generated in two masked walks, every (s, t)
pair is connected by a batched shadow ray, and each contribution is
weighted by the power heuristic over the stored forward and reverse area
pdfs (the vectorized counterpart of the reference's pathWeight).

The strategies, each per lane:
  - (s = 0, t): the eye path hits an intersectable light (its emission);
  - (s = 1, t): eye vertex z_t connected to the light subpath's origin y_0
    (area-measure NEE on the shared light sample);
  - (s >= 2, t): z_t connected to light vertex y_{s-1};
  - t = 0: light tracing (the reference's connectPathE): light-subpath
    vertices projected through `cameras.project_lens` (pinhole and thin
    lens) and returned as splats (pixel, rgb) for `film.add_splats`, under
    perspective cameras; under the others the strategy is not generated
    and the MIS denominators leave it out. The port always splats, as the
    JAX package does by default; its environment switch that turns the
    splats off has no counterpart here.

Light subpaths start from positional lights (point, spot, IES, area,
sphere, mesh). Directional and sun lights, and the background light, take
classic NEE at every eye vertex (no competing strategy: weight 1); an
escaped eye ray takes the background with the forward tracer's MIS.
The background is added at every depth (the JAX package's
transp_background is never set). MIS divides long products of pdfs,
guarded by _EPS_PDF and the zero remap, in the JAX package's order of
operations; a NaN or inf that a lane's unused branch makes (a pdf of 0 in
a strategy the lane does not take) stays in that branch: every
contribution is selected by torch.where, never multiplied by a 0 mask, and
a splat the lane does not make carries 0 at a pixel clamped into the film.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .. import lights as L
from .. import sampler
from ..backgrounds import eval_background
from ..cameras import project_lens, raster_jacobian
from ..materials import bsdf as B
from ..materials.nodes import bump_normal
from ..math import vec
from ..ops import intersect as I
from ..ops import surface as S
from ..scene_types import (LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_IES,
                           LIGHT_MESH, LIGHT_POINT, LIGHT_SPHERE, LIGHT_SPOT,
                           LIGHT_SUN, SceneData)
from . import common

Tensor = torch.Tensor

_EPS_PDF = 1e-12


def _remap0(p: Tensor) -> Tensor:
    """Zero pdfs count as 1 in the MIS ratio products (their strategies
    are left out through the connectible flags)."""
    return torch.where(p > 0.0, p, 1.0)


def _to_area(pdf_sa: Tensor, d2: Tensor, cos_t: Tensor) -> Tensor:
    """A solid-angle pdf at the source as an area pdf at the target."""
    return pdf_sa * torch.abs(cos_t) / torch.clamp_min(d2, _EPS_PDF)


def _len2(v: Tensor) -> Tensor:
    return vec.dot(v, v)


class _Vertex:
    """One subpath vertex per lane (a record of tensors; the depths are
    Python loops, so a list of these is the path)."""

    def __init__(self, sp, wo, beta, pdf_fwd, pdf_rev, connectible, valid,
                 d2_prev, cos_prev):
        self.sp = sp                    # SurfacePoint [N]
        self.wo = wo                    # f32[N,3] toward the previous vertex
        self.beta = beta                # f32[N,3] throughput up to here
        self.pdf_fwd = pdf_fwd          # f32[N] area pdf from its own side
        self.pdf_rev = pdf_rev          # f32[N] area pdf from the other side
        self.connectible = connectible  # bool[N] has non-delta lobes
        self.valid = valid              # bool[N]
        self.d2_prev = d2_prev          # f32[N] |x - prev|^2
        self.cos_prev = cos_prev        # f32[N] |cos| here toward prev


def _connectible(scene: SceneData, sp) -> Tensor:
    mp = B.resolve_mp(scene, sp)
    _, _, w_mf, w_di, w_tl = B.lobe_weights(mp, torch.ones_like(sp.t))
    return (w_mf + w_di + w_tl) > 1e-6


class _LightOrigin:
    def __init__(self, li, p, nrm, has_normal, pdf_pos, pdf_dir, d0,
                 delta_pos, valid):
        self.li = li                  # i64[N] light index
        self.p = p                    # f32[N,3]
        self.nrm = nrm                # f32[N,3] emission normal (0 if none)
        self.has_normal = has_normal  # bool[N]
        self.pdf_pos = pdf_pos        # f32[N] area pdf (1: delta position)
        self.pdf_dir = pdf_dir        # f32[N] solid-angle pdf of d0
        self.d0 = d0                  # f32[N,3] first emission direction
        self.delta_pos = delta_pos    # bool[N]
        self.valid = valid            # bool[N]
        self.pdf_rev = None           # f32[N] area pdf of y_0 from y_1
                                      # (set by the light walk)


def _emit_origin(scene: SceneData, pid: Tensor, sid) -> _LightOrigin:
    """y_0 and the first direction on a uniformly picked positional light,
    with their pdfs (Light::emitSample). Each light family runs only when
    the scene has it (its lanes would be masked out otherwise)."""
    lt = scene.lights
    nl = max(lt.num_lights, 1)
    n = pid.shape[0]
    dev = pid.device
    u = sampler.rand4(pid, sid, 0, 3000)
    ul, u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    u4 = sampler.rand1(pid, sid, 0, 3001)
    li = torch.clamp((ul * nl).to(torch.int32), 0, nl - 1).long()
    ty = lt.light_type[li]
    pos = lt.position[li]
    f32 = dict(dtype=torch.float32, device=dev)
    st = dict(p=torch.zeros((n, 3), **f32), nrm=torch.zeros((n, 3), **f32),
              has_n=torch.zeros((n,), dtype=torch.bool, device=dev),
              pdf_pos=torch.ones((n,), **f32),
              pdf_dir=torch.ones((n,), **f32),
              d0=torch.zeros((n, 3), **f32),
              delta_pos=torch.zeros((n,), dtype=torch.bool, device=dev),
              valid=torch.zeros((n,), dtype=torch.bool, device=dev))

    def put(m, flag, **vals):
        # the lanes m of one family: its values, and its flag set
        for k, v in vals.items():
            st[k] = torch.where(m[..., None] if st[k].dim() == 2 else m, v,
                                st[k])
        st[flag] = st[flag] | m
        st["valid"] = st["valid"] | m

    if L._has(lt, LIGHT_POINT) or L._has(lt, LIGHT_IES):
        # point / IES: a delta position, a uniform sphere of directions
        put((ty == LIGHT_POINT) | (ty == LIGHT_IES), "delta_pos", p=pos,
            d0=vec.uniform_sample_sphere(u1, u2),
            pdf_dir=torch.full((n,), 1.0 / (4.0 * math.pi), **f32))
    if L._has(lt, LIGHT_SPOT):
        # spot: a delta position, a uniform cone
        axis = lt.direction[li]
        au, av = vec.orthonormal_basis(axis)
        cone = vec.uniform_sample_cone(u1, u2, lt.cos_end[li])
        d_sp = (au * cone[..., 0:1] + av * cone[..., 1:2]
                + axis * cone[..., 2:3])
        omega = torch.clamp_min(2.0 * math.pi * (1.0 - lt.cos_end[li]),
                                1e-9)
        put(ty == LIGHT_SPOT, "delta_pos", p=pos, d0=d_sp,
            pdf_dir=1.0 / omega)
    if L._has(lt, LIGHT_AREA):
        # area: a uniform point on the parallelogram, a cosine direction
        lp = pos + lt.edge1[li] * u1[..., None] + lt.edge2[li] * u2[..., None]
        a_n = lt.direction[li]
        nu, nv = vec.orthonormal_basis(a_n)
        dl = vec.cosine_sample_hemisphere(u3, u4)
        d_ar = nu * dl[..., 0:1] + nv * dl[..., 1:2] + a_n * dl[..., 2:3]
        put(ty == LIGHT_AREA, "has_n", p=lp, nrm=a_n, d0=d_ar,
            pdf_pos=1.0 / torch.clamp_min(lt.area[li], _EPS_PDF),
            pdf_dir=torch.clamp_min(dl[..., 2], 1e-9) / math.pi)
    if L._has(lt, LIGHT_SPHERE):
        # sphere: a uniform surface point, a cosine direction about it
        sn = vec.uniform_sample_sphere(u1, u2)
        r = lt.radius[li]
        sp_p = pos + sn * r[..., None]
        su, sv = vec.orthonormal_basis(sn)
        dl2 = vec.cosine_sample_hemisphere(u3, u4)
        d_sl = su * dl2[..., 0:1] + sv * dl2[..., 1:2] + sn * dl2[..., 2:3]
        area_s = torch.clamp_min(4.0 * math.pi * r * r, _EPS_PDF)
        put(ty == LIGHT_SPHERE, "has_n", p=sp_p, nrm=sn, d0=d_sl,
            pdf_pos=1.0 / area_s,
            pdf_dir=torch.clamp_min(dl2[..., 2], 1e-9) / math.pi)
    if scene.geom.num_faces > 0 and L._has(lt, LIGHT_MESH):
        # mesh light: an area-CDF face pick, a cosine direction
        g = scene.geom
        tri_i, u1r = L.sample_light_tri(lt, g.num_faces, li, u1)
        fidx = g.faces[tri_i.long()].long()
        v0, v1, v2 = (g.vertices[fidx[:, k]] for k in range(3))
        b0, b1 = vec.sample_triangle_uniform(u1r, u2)
        lp_m = (v0 * b0[..., None] + v1 * b1[..., None]
                + v2 * (1 - b0 - b1)[..., None])
        cr = vec.cross(v1 - v0, v2 - v0)
        n_m = cr / torch.clamp_min(vec.length(cr), _EPS_PDF)[..., None]
        mu, mv = vec.orthonormal_basis(n_m)
        dl3 = vec.cosine_sample_hemisphere(u3, u4)
        d_m = mu * dl3[..., 0:1] + mv * dl3[..., 1:2] + n_m * dl3[..., 2:3]
        # the density of equal-area faces (as light_pdf_hit assumes)
        put(ty == LIGHT_MESH, "has_n", p=lp_m, nrm=n_m, d0=d_m,
            pdf_pos=1.0 / torch.clamp_min(lt.area[li], _EPS_PDF),
            pdf_dir=torch.clamp_min(dl3[..., 2], 1e-9) / math.pi)
    enabled = (lt.flags[li] & L.FLAG_ENABLED) != 0
    return _LightOrigin(li=li, p=st["p"], nrm=st["nrm"],
                        has_normal=st["has_n"], pdf_pos=st["pdf_pos"],
                        pdf_dir=st["pdf_dir"], d0=st["d0"],
                        delta_pos=st["delta_pos"],
                        valid=st["valid"] & enabled)


def _emit_radiance_toward(scene: SceneData, org: _LightOrigin, wo: Tensor
                          ) -> Tensor:
    """The radiance (a delta-position light's intensity) that y_0 emits
    toward the unit direction wo."""
    lt = scene.lights
    li = org.li
    ty = lt.light_type[li]
    col = lt.color[li]
    rad = torch.where((ty == LIGHT_POINT)[..., None], col,
                      torch.zeros_like(col))
    if L._has(lt, LIGHT_IES):
        cos_ax = vec.dot(wo, lt.direction[li])
        rad = torch.where((ty == LIGHT_IES)[..., None],
                          col * L._ies_factor(lt, li, cos_ax, wo)[..., None],
                          rad)
    if L._has(lt, LIGHT_SPOT):
        fall = L._spot_falloff(vec.dot(wo, lt.direction[li]),
                               lt.cos_start[li], lt.cos_end[li],
                               lt.falloff[li])
        rad = torch.where((ty == LIGHT_SPOT)[..., None],
                          col * fall[..., None], rad)
    area_like = (ty == LIGHT_AREA) | (ty == LIGHT_SPHERE) | (ty == LIGHT_MESH)
    dbl = (lt.flags[li] & L.FLAG_DOUBLE_SIDED) != 0
    front = (vec.dot(wo, org.nrm) > 0.0) | dbl
    return torch.where((area_like & front)[..., None], col, rad)


def _light_pdf_pos_hit(scene: SceneData, light_id: Tensor) -> Tensor:
    """The area pdf with which _emit_origin samples the point where an eye
    path hits a light (the s' = 0 term of the MIS walks)."""
    lt = scene.lights
    light_id = light_id.long()
    ty = lt.light_type[light_id]
    area = torch.clamp_min(lt.area[light_id], _EPS_PDF)
    r = lt.radius[light_id]
    pdf = torch.where((ty == LIGHT_AREA) | (ty == LIGHT_MESH), 1.0 / area,
                      torch.zeros_like(area))
    return torch.where(
        ty == LIGHT_SPHERE,
        1.0 / torch.clamp_min(4.0 * math.pi * r * r, _EPS_PDF), pdf)


# ---------------------------------------------------------------------------
# Subpath generation
# ---------------------------------------------------------------------------

def _walk_eye(scene: SceneData, cfg, o: Tensor, d: Tensor, valid: Tensor,
              pid: Tensor, sid, max_t: int):
    """The eye subpath's vertices z_1 .. z_max_t. Returns (vertices, per
    depth (escaped, beta, dir, prev_pdf_sa, prev_delta) for the background
    strategies, alpha, first-hit t, the first hit's surface points)."""
    n = o.shape[0]
    dev = o.device
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = valid
    prev_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    prev_pdf_sa = torch.zeros((n,), dtype=torch.float32, device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    verts: List[_Vertex] = []
    escapes = []
    perspective = scene.camera.kind == "perspective"
    for depth in range(max_t):
        t_far = torch.where(alive, 1e30, -1.0)
        if depth == 0:
            hit = I.camera_hit(scene, o, d, scene.ray_min_dist, t_far)
        else:
            hit = I.closest_hit(scene, o, d, scene.ray_min_dist, t_far,
                                exclude_prim=prev_prim)
        hit.valid = hit.valid & alive
        sp = bump_normal(scene, S.make_surface(scene, hit, o, d))
        escapes.append((alive & ~hit.valid, beta, d, prev_pdf_sa,
                        prev_delta))
        if depth == 0:
            alpha = hit.valid.to(torch.float32)
            first_hit_t = torch.where(hit.valid, hit.t, 1e30)
            first_sp = sp
        alive = alive & hit.valid
        wo = -d
        d2p = torch.clamp_min(_len2(sp.p - o), _EPS_PDF)
        cos_here = torch.abs(vec.dot(wo, sp.n))
        if depth == 0:
            # the camera's area pdf of z_1 (one sample per unit of raster
            # area; the Jacobian converts to solid angle): the forward pdf
            # that the t' = 0 light-tracing strategy competes against
            pdf_fwd = (_to_area(raster_jacobian(scene.camera, d), d2p,
                                cos_here) if perspective
                       else torch.ones((n,), dtype=torch.float32, device=dev))
        else:
            pdf_fwd = torch.where(prev_delta, 0.0,
                                  _to_area(prev_pdf_sa, d2p, cos_here))
        verts.append(_Vertex(
            sp=sp, wo=wo, beta=beta, pdf_fwd=pdf_fwd,
            pdf_rev=torch.zeros((n,), dtype=torch.float32, device=dev),
            connectible=_connectible(scene, sp) & alive, valid=alive,
            d2_prev=d2p, cos_prev=cos_here))
        # area-light quads end the path (pure emitters)
        alive = alive & ~((sp.light_id >= 0) & (sp.obj_id < 0))
        if depth == max_t - 1:
            break
        r = sampler.rand4(pid, sid, depth, 3100)
        ms = B.sample_bsdf(scene, sp, wo, r[..., 0], r[..., 1], r[..., 2])
        cont = alive & ms.valid
        new_beta = beta * ms.weight
        if depth >= cfg.russian_roulette_min_bounces:
            p_surv = torch.clamp(torch.amax(new_beta, dim=-1), 0.05, 1.0)
            kill = r[..., 3] > p_surv
            new_beta = new_beta / p_surv[..., None]
            cont = cont & ~kill
        if depth > 0:
            # the reverse pdf of z_{depth-1} given the new direction
            _, rev_sa = B.eval_bsdf(scene, sp, ms.wi, wo)
            pv = verts[depth - 1]
            rev_area = _to_area(rev_sa, d2p, torch.abs(vec.dot(wo, pv.sp.n)))
            pv.pdf_rev = torch.where(cont, rev_area, pv.pdf_rev)
        beta = torch.where(cont[..., None], new_beta, beta)
        alive = cont
        prev_prim = sp.prim
        prev_pdf_sa = ms.pdf
        prev_delta = ms.is_delta
        o = sp.p + ms.wi * scene.shadow_bias
        d = ms.wi
    return verts, escapes, alpha, first_hit_t, first_sp


def _walk_light(scene: SceneData, cfg, pid: Tensor, sid, max_s: int,
                lane_valid: Tensor):
    """The light subpath: its origin y_0 and surface vertices y_1 ..
    y_max_s. Lanes not in `lane_valid` (masked lanes of a wavefront) trace
    none: they would splat duplicates of another lane's path."""
    nl = max(scene.lights.num_lights, 1)
    org = _emit_origin(scene, pid, sid)
    n = org.p.shape[0]
    dev = org.p.device
    org.valid = org.valid & lane_valid
    org.pdf_rev = torch.zeros((n,), dtype=torch.float32, device=dev)
    pick = 1.0 / nl
    le0 = _emit_radiance_toward(scene, org, org.d0)
    cos0 = torch.where(org.has_normal, torch.abs(vec.dot(org.d0, org.nrm)),
                       1.0)
    beta = le0 * (cos0 / torch.clamp_min(
        org.pdf_pos * pick * org.pdf_dir, _EPS_PDF))[..., None]
    alive = org.valid & (torch.amax(le0, dim=-1) > 0.0)
    o = org.p + org.d0 * scene.shadow_bias
    d = org.d0
    prev_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    prev_pdf_sa = org.pdf_dir
    prev_delta = torch.zeros((n,), dtype=torch.bool, device=dev)
    verts: List[_Vertex] = []
    prev_p = org.p
    for depth in range(max_s):
        hit = I.closest_hit(scene, o, d, scene.ray_min_dist,
                            torch.where(alive, 1e30, -1.0),
                            exclude_prim=prev_prim)
        hit.valid = hit.valid & alive
        sp = bump_normal(scene, S.make_surface(scene, hit, o, d))
        alive = alive & hit.valid
        wo = -d
        d2p = torch.clamp_min(_len2(sp.p - prev_p), _EPS_PDF)
        cos_here = torch.abs(vec.dot(wo, sp.n))
        pdf_fwd = torch.where(prev_delta, 0.0,
                              _to_area(prev_pdf_sa, d2p, cos_here))
        verts.append(_Vertex(
            sp=sp, wo=wo, beta=beta, pdf_fwd=pdf_fwd,
            pdf_rev=torch.zeros((n,), dtype=torch.float32, device=dev),
            connectible=_connectible(scene, sp) & alive, valid=alive,
            d2_prev=d2p, cos_prev=cos_here))
        if depth == max_s - 1:
            break
        r = sampler.rand4(pid, sid, depth, 3200)
        ms = B.sample_bsdf(scene, sp, wo, r[..., 0], r[..., 1], r[..., 2])
        cont = alive & ms.valid
        new_beta = beta * ms.weight
        if depth >= 1:
            p_surv = torch.clamp(
                torch.amax(new_beta, dim=-1)
                / torch.clamp_min(torch.amax(beta, dim=-1), _EPS_PDF),
                0.05, 1.0)
            kill = r[..., 3] > p_surv
            new_beta = new_beta / p_surv[..., None]
            cont = cont & ~kill
        _, rev_sa = B.eval_bsdf(scene, sp, ms.wi, wo)
        if depth > 0:
            pv = verts[depth - 1]
            rev_area = _to_area(rev_sa, d2p, torch.abs(vec.dot(wo, pv.sp.n)))
            pv.pdf_rev = torch.where(cont, rev_area, pv.pdf_rev)
        else:
            # the reverse pdf of the origin y_0 from y_1 (the light-side
            # MIS walk reads it for s >= 3)
            cos_y0 = torch.where(org.has_normal,
                                 torch.abs(vec.dot(wo, org.nrm)), 1.0)
            org.pdf_rev = torch.where(cont, _to_area(rev_sa, d2p, cos_y0),
                                      0.0)
        beta = torch.where(cont[..., None], new_beta, beta)
        alive = cont
        prev_p = sp.p
        prev_prim = sp.prim
        prev_pdf_sa = ms.pdf
        prev_delta = ms.is_delta
        o = sp.p + ms.wi * scene.shadow_bias
        d = ms.wi
    return org, verts


# ---------------------------------------------------------------------------
# MIS weight (the power heuristic over the strategies generated)
# ---------------------------------------------------------------------------

def _mis_weight(eye: List[_Vertex], lv: List[_Vertex], org: _LightOrigin,
                pick: float, t: int, s: int, rev_zt: Tensor,
                rev_ztm1: Tensor, rev_ys: Tensor, rev_ysm1: Tensor,
                t0_ok=None, conn_zt=None) -> Tensor:
    """The power-heuristic (beta = 2) weight of strategy (s, t), given the
    connection's endpoint reverse pdfs:
      rev_zt    area pdf of z_t generated from the light side
      rev_ztm1  area pdf of z_{t-1} generated from z_t
      rev_ys    area pdf of y_{s-1} generated from z_t (s >= 1; for t = 0
                the camera's area pdf of y_{s-1})
      rev_ysm1  area pdf of y_{s-2} generated from y_{s-1} (s >= 2)
      t0_ok     lanes where the light-tracing strategy t' = 0 exists (None:
                it is not generated, and eye[0].pdf_fwd is not read)
      conn_zt   for s = 0, whether the light point z_t can be sampled on
                the light's surface (it is an endpoint of the alternatives)
    z_k = eye[k - 1] (1-based), y_0 = org, y_k = lv[k - 1]."""
    n = rev_ys.shape[0]
    dev = rev_ys.device
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    sum_ri = torch.zeros((n,), dtype=torch.float32, device=dev)

    def conn_eye(i):
        if i == t and conn_zt is not None:
            return conn_zt
        return eye[i - 1].connectible if i >= 1 else no

    def conn_light(i):
        # y_0 is an endpoint even for delta-position lights (NEE toward a
        # point light is a strategy); the s' = 0 strategy is gated apart
        return org.valid if i == 0 else lv[i - 1].connectible

    # the eye side: strategies t' = t - 1 .. 0 (t' = 0 through the camera,
    # eye[0].pdf_fwd being the camera's area pdf of z_1, where t0_ok)
    ri = torch.ones((n,), dtype=torch.float32, device=dev)
    last_i = 1 if t0_ok is not None else 2
    for i in range(t, last_i - 1, -1):
        rev = rev_zt if i == t else (
            rev_ztm1 if i == t - 1 else eye[i - 1].pdf_rev)
        ri = ri * _remap0(rev) / _remap0(eye[i - 1].pdf_fwd)
        ok = (t0_ok & conn_eye(1)) if i == 1 else \
            (conn_eye(i - 1) & conn_eye(i))
        sum_ri = sum_ri + torch.where(ok, ri * ri, 0.0)

    # the light side: strategies s' = s - 1 .. 0
    ri = torch.ones((n,), dtype=torch.float32, device=dev)
    for i in range(s - 1, -1, -1):
        if i == s - 1:
            rev = rev_ys
        elif i == s - 2:
            rev = rev_ysm1
        elif i >= 1:
            rev = lv[i - 1].pdf_rev
        else:
            rev = org.pdf_rev
        fwd = (torch.where(org.delta_pos, 0.0, org.pdf_pos * pick) if i == 0
               else lv[i - 1].pdf_fwd)
        ri = ri * _remap0(rev) / _remap0(fwd)
        # s' = 0: the eye path must hit the light (not a delta position)
        ok = (~org.delta_pos & org.valid) if i == 0 else \
            (conn_light(i - 1) & conn_light(i))
        sum_ri = sum_ri + torch.where(ok, ri * ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


# ---------------------------------------------------------------------------
# The integrator
# ---------------------------------------------------------------------------

def integrate_bidir(scene: SceneData, cfg, ray_o: Tensor, ray_d: Tensor,
                    ray_valid: Tensor, pixel_id: Tensor, sample_idx
                    ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """The BDPT estimate of one wavefront of camera rays: (rgb, alpha,
    aux), aux holding the first-hit AOV layers and the light-tracing
    splats (splat_px, splat_py f32[N * max_s], splat_rgb f32[N * max_s,
    3]) under a perspective camera."""
    n = ray_o.shape[0]
    dev = ray_o.device
    lt = scene.lights
    nl = max(lt.num_lights, 1)
    pick = 1.0 / nl
    max_t = cfg.bounces + 1
    max_s = max(cfg.bounces, 1)
    zeros = lambda: torch.zeros((n,), dtype=torch.float32, device=dev)

    eye, escapes, alpha, first_hit_t, first_sp = _walk_eye(
        scene, cfg, ray_o, ray_d, ray_valid, pixel_id, sample_idx, max_t)
    org, lverts = None, []
    if lt.num_lights > 0:
        org, lverts = _walk_light(scene, cfg, pixel_id, sample_idx, max_s,
                                  ray_valid)
    # light tracing through perspective cameras, pinhole and thin lens
    # (connectPathE, integrator_bidirectional.h:57-58)
    do_splat = org is not None and scene.camera.kind == "perspective"
    t0_ok = torch.ones((n,), dtype=torch.bool, device=dev) if do_splat \
        else None
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    # the background strategies (the forward tracer's two-way MIS), at
    # every depth
    for escaped, beta_e, d_e, prev_pdf_sa, prev_delta in escapes:
        add = beta_e * eval_background(scene, d_e)
        if lt.bg_light_idx >= 0:
            bg_mis = torch.where(prev_delta, 1.0, vec.power_heuristic(
                prev_pdf_sa, L.background_pdf(scene, d_e)))
            add = add * bg_mis[..., None]
        radiance = radiance + torch.where(escaped[..., None], add, 0.0)

    # s = 0: the eye path hits an intersectable light
    for t in range(1, len(eye) + 1):
        z = eye[t - 1]
        sp = z.sp
        li = torch.clamp_min(sp.light_id, 0)
        emit = common.emitted_radiance(scene, sp, z.wo)
        if org is None or (t == 1 and t0_ok is None):
            # the emission hit is this path's only generator
            w = torch.ones((n,), dtype=torch.float32, device=dev)
        else:
            pdf_pos_l = _light_pdf_pos_hit(scene, li)
            sampleable = (sp.light_id >= 0) & (pdf_pos_l > 0.0)
            rev_zt = pdf_pos_l * pick
            if t >= 2:
                # the emission pdf from the light point toward z_{t-1}
                cos_l = torch.abs(vec.dot(z.wo, sp.ng))
                pdf_dir_l = torch.clamp_min(cos_l, 1e-9) / math.pi
                rev_ztm1 = _to_area(pdf_dir_l, z.d2_prev, torch.abs(
                    vec.dot(z.wo, eye[t - 2].sp.n)))
            else:
                rev_ztm1 = zeros()
            w = _mis_weight(eye, lverts, org, pick, t, 0, rev_zt, rev_ztm1,
                            zeros(), zeros(), t0_ok=t0_ok,
                            conn_zt=sampleable)
        # material emission (no light id) keeps weight 1
        w = torch.where(sp.light_id >= 0, w, 1.0)
        has_emit = z.valid & (torch.amax(emit, dim=-1) > 0)
        radiance = radiance + torch.where(has_emit[..., None],
                                          z.beta * emit * w[..., None], 0.0)

    # NEE toward the lights that start no subpath (directional, sun) and
    # the background light: weight 1. A positional light's NEE would be
    # masked out whole, so it is not traced
    types = lt.light_type.tolist()
    nonpos = [i for i in range(lt.num_lights)
              if types[i] in (LIGHT_SUN, LIGHT_DIRECTIONAL)]
    for t in range(1, len(eye) + 1):
        z = eye[t - 1]
        m = (z.valid & z.connectible)[..., None]
        for li_s in nonpos:
            u1, u2 = sampler.rand2(pixel_id, sample_idx, t, 3300 + 2 * li_s)
            li_a = torch.full((n,), li_s, dtype=torch.int32, device=dev)
            c = common.estimate_one_light(scene, z.sp, z.wo, li_a, u1, u2,
                                          cfg.transparent_shadows)
            radiance = radiance + torch.where(m, z.beta * c, 0.0)
        if lt.bg_light_idx >= 0:
            u1, u2 = sampler.rand2(pixel_id, sample_idx, t, 3400)
            li_a = torch.full((n,), lt.bg_light_idx, dtype=torch.int32,
                              device=dev)
            c = common.estimate_one_light(scene, z.sp, z.wo, li_a, u1, u2,
                                          cfg.transparent_shadows)
            radiance = radiance + torch.where(m, z.beta * c, 0.0)

    if org is not None:
        radiance = radiance + _connections(scene, cfg, eye, lverts, org,
                                           pick, max_s, t0_ok)
    splats = None
    if do_splat:
        splats = _splats(scene, cfg, eye, lverts, org, pick, max_s, t0_ok,
                         pixel_id, sample_idx)

    from .mc import _first_hit_layers
    aux = _first_hit_layers(scene, cfg, first_sp, ray_d)
    if splats is not None:
        aux["splat_px"], aux["splat_py"], aux["splat_rgb"] = splats
    if (scene.volumes is not None or cfg.vol_kind == "sky") \
            and cfg.vol_kind != "none":
        from .volume import apply_volumetric
        radiance = apply_volumetric(scene, cfg, radiance, ray_o, ray_d,
                                    first_hit_t, pixel_id, sample_idx)
    return radiance, torch.clamp(alpha, 0.0, 1.0), aux


def _rev_ysm1(scene: SceneData, y: _Vertex, s: int, org: _LightOrigin,
              lverts: List[_Vertex], wi_y: Tensor) -> Tensor:
    """The area pdf of y_{s-2} regenerated from y_{s-1} = y, whose
    incoming direction is now wi_y (s >= 2)."""
    _, rev_sa_y = B.eval_bsdf(scene, y.sp, wi_y, y.wo)
    if s == 2:
        cos = torch.where(org.has_normal, torch.abs(vec.dot(y.wo, org.nrm)),
                          1.0)
    else:
        cos = torch.abs(vec.dot(y.wo, lverts[s - 3].sp.n))
    return _to_area(rev_sa_y, y.d2_prev, cos)


def _connections(scene: SceneData, cfg, eye, lverts, org, pick: float,
                 max_s: int, t0_ok) -> Tensor:
    """The (s >= 1, t >= 1) strategies: each eye vertex connected to each
    light vertex through one shadow query."""
    lt = scene.lights
    n = org.p.shape[0]
    dev = org.p.device
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    for t in range(1, len(eye) + 1):
        z = eye[t - 1]
        for s in range(1, max_s + 1):
            if s == 1:
                y_p, y_valid = org.p, org.valid
            else:
                y = lverts[s - 2]
                y_p, y_valid = y.sp.p, y.valid
            to_y = y_p - z.sp.p
            d2 = torch.clamp_min(_len2(to_y), _EPS_PDF)
            dist = torch.sqrt(d2)
            wi = to_y / dist[..., None]
            cos_z = torch.abs(vec.dot(wi, z.sp.n))
            f_z, pdf_z_sa = B.eval_bsdf(scene, z.sp, z.wo, wi)
            if s == 1:
                le = _emit_radiance_toward(scene, org, -wi)
                cos_y = torch.where(org.has_normal,
                                    torch.abs(vec.dot(-wi, org.nrm)), 1.0)
                fy_beta = le / torch.clamp_min(org.pdf_pos * pick,
                                               _EPS_PDF)[..., None]
                # y_0 sampled from z_t by its BSDF
                rev_ys = torch.where(org.delta_pos, 0.0,
                                     _to_area(pdf_z_sa, d2, cos_y))
                # z_t from y_0: the light's emission pdf
                spot = lt.light_type[org.li] == LIGHT_SPOT
                pdf_emit_dir = torch.where(
                    org.has_normal, torch.clamp_min(cos_y, 1e-9) / math.pi,
                    torch.where(spot, 1.0 / torch.clamp_min(
                        2.0 * math.pi * (1.0 - lt.cos_end[org.li]), 1e-9),
                        1.0 / (4.0 * math.pi)))
                rev_zt = _to_area(pdf_emit_dir, d2, cos_z)
                rev_ysm1 = zeros
                y_conn = torch.ones((n,), dtype=torch.bool, device=dev)
                one_sided = org.has_normal & ~(
                    (lt.flags[org.li] & L.FLAG_DOUBLE_SIDED) != 0)
                y_n_ok = torch.where(one_sided,
                                     vec.dot(-wi, org.nrm) > 1e-6, True)
            else:
                f_y, pdf_y_sa = B.eval_bsdf(scene, y.sp, y.wo, -wi)
                fy_beta = y.beta * f_y
                cos_y = torch.abs(vec.dot(-wi, y.sp.n))
                rev_ys = _to_area(pdf_z_sa, d2, cos_y)
                rev_zt = _to_area(pdf_y_sa, d2, cos_z)
                rev_ysm1 = _rev_ysm1(scene, y, s, org, lverts, -wi)
                y_conn = y.connectible
                y_n_ok = torch.ones((n,), dtype=torch.bool, device=dev)
            # z_{t-1} regenerated from z_t through the connection
            _, rev_sa_z = B.eval_bsdf(scene, z.sp, wi, z.wo)
            rev_ztm1 = (_to_area(rev_sa_z, z.d2_prev,
                                 torch.abs(vec.dot(z.wo, eye[t - 2].sp.n)))
                        if t >= 2 else zeros)
            partial = z.beta * f_z * fy_beta * (cos_z * cos_y / d2)[..., None]
            potential = (z.valid & z.connectible & y_valid & y_conn & y_n_ok
                         & (torch.amax(partial, dim=-1) > 0.0))
            tr = common.trace_shadow(scene, z.sp.p, z.sp.prim, wi, dist,
                                     cfg.transparent_shadows,
                                     needed=potential)
            w = _mis_weight(eye, lverts, org, pick, t, s, rev_zt, rev_ztm1,
                            rev_ys, rev_ysm1, t0_ok=t0_ok)
            out = out + torch.where(potential[..., None],
                                    partial * tr * w[..., None], 0.0)
    return out


def _splats(scene: SceneData, cfg, eye, lverts, org, pick: float,
            max_s: int, t0_ok, pixel_id: Tensor, sample_idx):
    """The t = 0 strategies: each light vertex projected through a fresh
    lens sample and connected to the camera by one shadow query. Returns
    (px, py, rgb) of N * max_s splats, s-major."""
    lt = scene.lights
    cam = scene.camera
    n = org.p.shape[0]
    dev = org.p.device
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    px_all, py_all, rgb_all = [], [], []
    for s in range(1, max_s + 1):
        if s == 1:
            y_p = org.p
            y_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
            # light -> camera directly: sampled-surface lights only
            y_ok = org.valid & ~org.delta_pos & org.has_normal
        else:
            y = lverts[s - 2]
            y_p, y_prim = y.sp.p, y.sp.prim
            y_ok = y.valid & y.connectible
        # the pinhole case degenerates to the camera origin in project_lens
        lu, lv = sampler.rand2(pixel_id, sample_idx, s, 3500)
        pxs, pys, vis, lpt = project_lens(cam, y_p, lu, lv)
        to_c = lpt - y_p
        d2 = torch.clamp_min(_len2(to_c), _EPS_PDF)
        dist = torch.sqrt(d2)
        wi = to_c / dist[..., None]
        jac = raster_jacobian(cam, -wi)
        if s == 1:
            cos_y = vec.dot(wi, org.nrm)
            dbl = (lt.flags[org.li] & L.FLAG_DOUBLE_SIDED) != 0
            y_ok = y_ok & ((cos_y > 1e-6) | dbl)
            cos_y = torch.abs(cos_y)
            le = _emit_radiance_toward(scene, org, wi)
            beta_f = le / torch.clamp_min(org.pdf_pos * pick,
                                          _EPS_PDF)[..., None]
            rev_ysm1 = zeros
        else:
            f_y, _ = B.eval_bsdf(scene, y.sp, y.wo, wi)
            beta_f = y.beta * f_y
            cos_y = torch.abs(vec.dot(wi, y.sp.n))
            rev_ysm1 = _rev_ysm1(scene, y, s, org, lverts, wi)
        # the camera's area pdf of y_{s-1} (the forward strategy's)
        rev_ys = _to_area(jac, d2, cos_y)
        contrib = beta_f * (cos_y / d2 * jac)[..., None]
        potential = (y_ok & vis & t0_ok
                     & (torch.amax(contrib, dim=-1) > 0.0))
        tr = common.trace_shadow(scene, y_p, y_prim, wi, dist,
                                 cfg.transparent_shadows, needed=potential)
        w = _mis_weight(eye, lverts, org, pick, 0, s, zeros, zeros, rev_ys,
                        rev_ysm1, t0_ok=t0_ok)
        rgb_all.append(torch.where(potential[..., None],
                                   contrib * tr * w[..., None], 0.0))
        # a splat the lane does not make adds 0; its pixel (NaN or far off
        # the film where the projection failed) is clamped into the film
        px_all.append(torch.where(potential, pxs, 0.0))
        py_all.append(torch.where(potential, pys, 0.0))
    return torch.cat(px_all), torch.cat(py_all), torch.cat(rgb_all)
