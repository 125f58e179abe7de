"""Shared integrator machinery: shadow rays and direct-light MIS estimation.

Counterpart of `libyafaray_tpu/integrators/common.py`: light-sample and
BSDF-sample MIS with the power-2 heuristic, Dirac lights, and
transparent shadows (the walk through up to `transparent_depth`
transparent surfaces, multiplying their filter colours; the
Accelerator::intersectTs analogue).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import lights as L
from ..backgrounds import eval_background
from ..materials import bsdf as B
from ..math import vec
from ..ops import intersect as I
from ..ops import surface as S
from ..scene_types import LIGHT_BGPORTAL, SceneData

Tensor = torch.Tensor


def trace_shadow(scene: SceneData, p: Tensor, prim: Tensor, wi: Tensor,
                 dist: Tensor, transparent_depth: int = 0,
                 needed: Optional[Tensor] = None,
                 time: Optional[Tensor] = None) -> Tensor:
    """Shadow transmittance along p -> p + wi*dist at the rays' shutter
    `time`. transparent_depth 0: binary visibility [N,1] (intersectS
    analogue). transparent_depth > 0: up to that many transparent surfaces
    are passed, each multiplying the filter colour [N,3] by its
    `transparency`; an opaque hit ends it at 0. Rays where the result is
    not `needed` get an empty t-range. The walk asks
    `transparent_depth + 1` closest-hit queries over the shadow casters,
    each over the rays still walking: a ray that is not needed, has met an
    opaque surface or found none drops out (its result can no longer
    change), so the later steps query and shade few rays, and a step
    whose query meets nothing shades none."""
    bias = scene.shadow_bias
    o = p + wi * bias
    t_max = torch.where(torch.isinf(dist), 1e30, dist - 2.0 * bias)
    if needed is not None:
        t_max = torch.where(needed, t_max, -1.0)
    if transparent_depth == 0:
        blocked = I.any_hit(scene, o, wi, 0.0, t_max, exclude_prim=prim,
                            time=time)
        return torch.where(blocked[..., None], 0.0, 1.0)
    filt = torch.ones_like(p)
    cur_o, cur_prim, cur_tmax = o, prim, t_max
    for _ in range(transparent_depth + 1):
        # the step runs on the rays still walking: a ray whose range is
        # empty can meet nothing, and its filter stays as it is. One ray
        # is kept when none walks, so that every step launches its query
        act = torch.nonzero(cur_tmax > 0.0).squeeze(1)
        if act.numel() == 0:
            act = act.new_zeros((1,))
        a_o, a_wi, a_tmax = cur_o[act], wi[act], cur_tmax[act]
        hit = I.shadow_hit_surface(scene, a_o, a_wi, 0.0, a_tmax,
                                   exclude_prim=cur_prim[act])
        if not bool(hit.valid.any()):
            # every walking ray got through: their walks end here, their
            # filters as they are (no surface to shade)
            cur_tmax = cur_tmax.index_fill(0, act, -1.0)
            continue
        sp = S.make_surface(scene, hit, a_o, a_wi)
        tr = B.transparency(scene, sp, -a_wi)
        opaque = hit.valid & (torch.amax(tr, dim=-1) <= 0.0)
        a_filt = filt[act]
        a_filt = torch.where(opaque[..., None], 0.0, torch.where(
            hit.valid[..., None], a_filt * tr, a_filt))
        # advance past the transparent hit
        adv = hit.t + 2.0 * bias
        filt = filt.index_put((act,), a_filt)
        cur_o = cur_o.index_put((act,), torch.where(
            hit.valid[..., None], a_o + a_wi * adv[..., None], a_o))
        cur_tmax = cur_tmax.index_put((act,), torch.where(
            hit.valid & ~opaque, a_tmax - adv, -1.0))
        cur_prim = cur_prim.index_put((act,), torch.where(
            hit.valid, hit.prim, cur_prim[act]))
    return filt


def estimate_one_light(scene: SceneData, sp, wo: Tensor, li: Tensor,
                       u1: Tensor, u2: Tensor, transparent_shadows: int = 0,
                       time: Optional[Tensor] = None,
                       with_shadow_info: bool = False,
                       with_family_split: bool = False):
    """One-sample NEE toward light index `li` with MIS against BSDF sampling
    (areaLightSampleLight analogue), its shadow ray through up to
    `transparent_shadows` transparent surfaces. Returns the contribution
    [N,3]; with_shadow_info also the unshadowed contribution (the shadow
    layer accumulates unoccluded - occluded), with_family_split also a dict
    of the per-BSDF-family and per-technique contributions of the adv-* and
    debug-light-estimation-* layers: (contrib[, unshadowed][, families])."""
    ls = L.sample_light(scene, li, sp.p, sp.n, u1, u2)
    cos_s = vec.dot(ls.wi, sp.n)
    ev = B.eval_bsdf(scene, sp, wo, ls.wi, split=with_family_split)
    f, bsdf_pdf = ev[:2]
    potential = ls.valid & sp.valid & (torch.amax(f, dim=-1) > 0.0)
    casts = (scene.lights.flags[li.long()] & L.FLAG_CAST_SHADOWS) != 0
    shadow_needed = potential & casts
    tr = trace_shadow(scene, sp.p, sp.prim, ls.wi, ls.dist,
                      transparent_shadows, needed=shadow_needed, time=time)
    tr = torch.where((potential & ~shadow_needed)[..., None], 1.0, tr)
    mis_w = torch.where(ls.is_dirac, 1.0,
                        vec.power_heuristic(ls.pdf, bsdf_pdf))
    k = ls.radiance * (torch.abs(cos_s) * mis_w / ls.pdf)[..., None]
    base = f * k
    pot = potential[..., None]
    contrib = torch.where(pot, base * tr, 0.0)
    if not (with_shadow_info or with_family_split):
        return contrib
    out = (contrib,)
    if with_shadow_info:
        out += (torch.where(pot, base, 0.0),)
    if with_family_split:
        fam = {name: torch.where(pot, fam_f * k * tr, 0.0)
               for name, fam_f in ev[2].items()}
        fam["diffuse-noshadow"] = torch.where(pot, ev[2]["diffuse"] * k, 0.0)
        dirac = ls.is_dirac[..., None]
        fam["light-dirac"] = torch.where(dirac, contrib, 0.0)
        fam["light-sampling"] = torch.where(dirac, 0.0, contrib)
        out += (fam,)
    return out


def emitted_radiance(scene: SceneData, sp, wo: Tensor) -> Tensor:
    """Radiance emitted toward wo at a hit: the light table's radiance when
    the primitive belongs to an intersectable light (a portal: the
    background behind it times its power, front side only), else the
    material emission."""
    from_light = sp.light_id >= 0
    li = torch.clamp_min(sp.light_id, 0).long()
    lt = scene.lights
    front = vec.dot(wo, sp.ng) > 0.0
    dbl = (lt.flags[li] & L.FLAG_DOUBLE_SIDED) != 0
    light_rad = torch.where((front | dbl)[..., None], lt.color[li], 0.0)
    if L._has(lt, LIGHT_BGPORTAL):
        m_port = lt.light_type[li] == LIGHT_BGPORTAL
        bg_rad = eval_background(scene, -wo) * lt.color[li]
        light_rad = torch.where(m_port[..., None], torch.where(
            front[..., None], bg_rad, 0.0), light_rad)
    return torch.where(from_light[..., None], light_rad,
                       B.emit(scene, sp, wo))


def hit_light_mis_weight(scene: SceneData, sp, prev_p: Tensor,
                         bsdf_pdf: Tensor, prev_delta: Tensor) -> Tensor:
    """MIS weight for BSDF-sampled rays that hit an intersectable light
    (areaLightSampleMaterial analogue); delta bounces get weight 1."""
    from_light = sp.light_id >= 0
    li = torch.clamp_min(sp.light_id, 0)
    lpdf = L.light_pdf_hit(scene, li, sp.p, sp.ng, prev_p)
    w = vec.power_heuristic(bsdf_pdf, lpdf)
    w = torch.where(prev_delta, 1.0, w)
    return torch.where(from_light, w, 1.0)
