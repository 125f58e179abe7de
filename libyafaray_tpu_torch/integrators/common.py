"""Shared integrator machinery: shadow rays and direct-light MIS estimation.

Counterpart of `libyafaray_tpu/integrators/common.py` (light-sample and
BSDF-sample MIS with the power-2 heuristic) for opaque shadows
(`transparent_depth` 0).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import lights as L
from ..materials import bsdf as B
from ..math import vec
from ..ops import intersect as I
from ..scene_types import SceneData

Tensor = torch.Tensor


def trace_shadow(scene: SceneData, p: Tensor, prim: Tensor, wi: Tensor,
                 dist: Tensor, needed: Optional[Tensor] = None,
                 time: Optional[Tensor] = None) -> Tensor:
    """Binary shadow transmittance [N,1] along p -> p + wi*dist
    (intersectS analogue) at the rays' shutter `time`. Rays where the
    result is not `needed` get an empty t-range."""
    bias = scene.shadow_bias
    o = p + wi * bias
    t_max = torch.where(torch.isinf(dist), 1e30, dist - 2.0 * bias)
    if needed is not None:
        t_max = torch.where(needed, t_max, -1.0)
    blocked = I.any_hit(scene, o, wi, 0.0, t_max, exclude_prim=prim,
                        time=time)
    return torch.where(blocked[..., None], 0.0, 1.0)


def estimate_one_light(scene: SceneData, sp, wo: Tensor, li: Tensor,
                       u1: Tensor, u2: Tensor,
                       time: Optional[Tensor] = None) -> Tensor:
    """One-sample NEE toward light index `li` with MIS against BSDF sampling
    (areaLightSampleLight analogue). Returns the contribution [N,3]."""
    ls = L.sample_light(scene, li, sp.p, sp.n, u1, u2)
    cos_s = vec.dot(ls.wi, sp.n)
    f, bsdf_pdf = B.eval_bsdf(scene, sp, wo, ls.wi)
    potential = ls.valid & sp.valid & (torch.amax(f, dim=-1) > 0.0)
    casts = (scene.lights.flags[li.long()] & L.FLAG_CAST_SHADOWS) != 0
    shadow_needed = potential & casts
    tr = trace_shadow(scene, sp.p, sp.prim, ls.wi, ls.dist,
                      needed=shadow_needed, time=time)
    tr = torch.where((potential & ~shadow_needed)[..., None], 1.0, tr)
    mis_w = torch.where(ls.is_dirac, 1.0,
                        vec.power_heuristic(ls.pdf, bsdf_pdf))
    k = ls.radiance * (torch.abs(cos_s) * mis_w / ls.pdf)[..., None]
    return torch.where(potential[..., None], f * k * tr, 0.0)


def emitted_radiance(scene: SceneData, sp, wo: Tensor) -> Tensor:
    """Radiance emitted toward wo at a hit: the light table's radiance when
    the primitive belongs to an area light, else the material emission."""
    from_light = sp.light_id >= 0
    li = torch.clamp_min(sp.light_id, 0).long()
    lt = scene.lights
    front = vec.dot(wo, sp.ng) > 0.0
    dbl = (lt.flags[li] & L.FLAG_DOUBLE_SIDED) != 0
    light_rad = torch.where((front | dbl)[..., None], lt.color[li], 0.0)
    return torch.where(from_light[..., None], light_rad,
                       B.emit(scene, sp, wo))


def hit_light_mis_weight(scene: SceneData, sp, prev_p: Tensor,
                         bsdf_pdf: Tensor, prev_delta: Tensor) -> Tensor:
    """MIS weight for BSDF-sampled rays that hit an area light
    (areaLightSampleMaterial analogue); delta bounces get weight 1."""
    from_light = sp.light_id >= 0
    li = torch.clamp_min(sp.light_id, 0)
    lpdf = L.light_pdf_hit(scene, li, sp.p, sp.ng, prev_p)
    w = vec.power_heuristic(bsdf_pdf, lpdf)
    w = torch.where(prev_delta, 1.0, w)
    return torch.where(from_light, w, 1.0)
