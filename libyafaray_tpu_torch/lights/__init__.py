"""Light table sampling and pdfs, for area lights.

Counterpart of `libyafaray_tpu/lights/__init__.py` with the `LIGHT_AREA`
arm, the only light type the port compiles so far. `sample_light` returns
solid-angle pdfs; the `color` column holds the emitted radiance.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..math import vec
from ..scene_types import LIGHT_AREA, SceneData

Tensor = torch.Tensor

FLAG_CAST_SHADOWS = 1
FLAG_ENABLED = 2
FLAG_PHOTON_ONLY = 4
FLAG_DOUBLE_SIDED = 8


@dataclass
class LightSample:
    wi: Tensor        # f32[N,3] direction to the light
    dist: Tensor      # f32[N] distance to the light sample
    pdf: Tensor       # f32[N] solid-angle pdf
    radiance: Tensor  # f32[N,3] incident radiance
    is_dirac: Tensor  # bool[N] (false for area lights)
    valid: Tensor     # bool[N]


def _check_types(lt) -> None:
    if any(t != LIGHT_AREA for t in lt.present_types):
        raise NotImplementedError(
            f"light types {lt.present_types} include types other than area "
            "lights, which are not ported to libyafaray_tpu_torch yet")


def sample_light(scene: SceneData, li: Tensor, p: Tensor, ns: Tensor,
                 u1: Tensor, u2: Tensor) -> LightSample:
    """Light::illumSample for a per-lane light index `li` at shading points
    `p`: a uniform point on the parallelogram corner + u1*e1 + u2*e2."""
    lt = scene.lights
    _check_types(lt)
    li = li.long()
    flags = lt.flags[li]
    lp = (lt.position[li] + lt.edge1[li] * u1[..., None]
          + lt.edge2[li] * u2[..., None])
    to_a = lp - p
    d2 = torch.clamp_min(vec.dot(to_a, to_a), 1e-12)
    dist = torch.sqrt(d2)
    wi = to_a / dist[..., None]
    cos_l = vec.dot(-wi, lt.direction[li])
    dbl = (flags & FLAG_DOUBLE_SIDED) != 0
    cos_l = torch.where(dbl, torch.abs(cos_l), cos_l)
    pdf = d2 / torch.clamp_min(lt.area[li] * torch.clamp_min(cos_l, 1e-9),
                               1e-12)
    rad = lt.color[li]
    enabled = (flags & FLAG_ENABLED) != 0
    photon_only = (flags & FLAG_PHOTON_ONLY) != 0
    valid = (cos_l > 1e-6) & enabled & ~photon_only & (vec.dot(rad, rad) > 0)
    return LightSample(wi=wi, dist=dist, pdf=torch.clamp_min(pdf, 1e-12),
                       radiance=rad, is_dirac=torch.zeros_like(valid),
                       valid=valid)


def light_pdf_hit(scene: SceneData, light_id: Tensor, p_hit: Tensor,
                  n_hit: Tensor, p_from: Tensor) -> Tensor:
    """Solid-angle pdf with which `sample_light` would pick the direction
    from p_from to p_hit on area light `light_id` (Light::illumPdf), for
    BSDF-sample MIS."""
    lt = scene.lights
    _check_types(lt)
    to_h = p_hit - p_from
    d2 = torch.clamp_min(vec.dot(to_h, to_h), 1e-12)
    wi = to_h * torch.rsqrt(d2)[..., None]
    cos_l = torch.abs(vec.dot(-wi, n_hit))
    return d2 / torch.clamp_min(
        lt.area[light_id.long()] * torch.clamp_min(cos_l, 1e-9), 1e-12)
