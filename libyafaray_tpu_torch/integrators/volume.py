"""The single-scatter volume integrator over the camera segment.

Counterpart of `libyafaray_tpu/integrators/volume.py` for the
SingleScatterIntegrator (integrator_single_scatter.cc) with a fixed step
count: each camera ray's segment inside the volume regions is marched in
`steps` equal steps; at each step's midpoint one light, picked uniformly,
is sampled, its shadow ray traced through the scene from that point and
attenuated by a 16-step march of the medium toward the light. The surface
integrator then applies the segment as the reference's
applyVolumetricEffects does:

    L = transmittance(segment) * L_surface + L_in-scatter(segment).

The emission and sky integrators, the attenuation grid ("optimize") and
adaptive marching raise NotImplementedError where the JAX package would
take them.
"""
from __future__ import annotations

import math

import torch

from .. import lights as L
from .. import sampler
from ..math import vec
from ..scene_types import SceneData
from ..volumes import ray_aabb_span, sigma_st

Tensor = torch.Tensor

DEFAULT_STEPS = 16
ATTEN_MARCH_STEPS = 16   # the march toward the light


def _segment(scene: SceneData, o: Tensor, d: Tensor, t_hit: Tensor):
    """[0, t_hit] clipped to the union box of the volume regions."""
    hit, t0, t1 = ray_aabb_span(scene, o, d, t_hit)
    t0 = torch.where(hit, t0, 0.0)
    t1 = torch.where(hit, t1, 0.0)
    return t0, torch.maximum(t1, t0)


def transmittance(scene: SceneData, o: Tensor, d: Tensor, t_hit: Tensor,
                  steps: int = DEFAULT_STEPS) -> Tensor:
    """exp(-tau) [N,3] over each ray's volume segment, tau integrated at
    the steps' midpoints (DensityVolumeRegion::tau)."""
    t0, t1 = _segment(scene, o, d, t_hit)
    dt = (t1 - t0) / steps
    tau = torch.zeros_like(o)
    for s in range(steps):
        p = o + d * (t0 + (s + 0.5) * dt)[..., None]
        _, st, _ = sigma_st(scene, p)
        tau = tau + st * dt[..., None]
    return torch.exp(-tau)


def _hg_phase(cos_t: Tensor, g: Tensor) -> Tensor:
    """Henyey-Greenstein phase function."""
    g2 = g * g
    denom = torch.pow(torch.clamp_min(1.0 + g2 - 2.0 * g * cos_t, 1e-6), 1.5)
    return (1.0 - g2) / (4.0 * math.pi * denom)


def light_tau(scene: SceneData, p: Tensor, light_pos: Tensor,
              steps: int = ATTEN_MARCH_STEPS) -> Tensor:
    """Optical depth [N,3] of the medium from points p toward light_pos,
    within the volume regions' box."""
    delta = light_pos - p
    dist = vec.length(delta)
    d = delta / torch.clamp_min(dist, 1e-9)[..., None]
    _, t0, t1 = ray_aabb_span(scene, p, d, dist)
    dt = torch.clamp_min(t1 - t0, 0.0) / steps
    tau = torch.zeros_like(p)
    for s in range(steps):
        q = p + d * (t0 + (s + 0.5) * dt)[..., None]
        _, st, _ = sigma_st(scene, q)
        tau = tau + st * dt[..., None]
    return tau


def in_scatter(scene: SceneData, o: Tensor, d: Tensor, t_hit: Tensor,
               pixel_id: Tensor, sample_idx,
               steps: int = DEFAULT_STEPS,
               transparent_shadows: int = 0) -> Tensor:
    """Single scattering plus emission [N,3] along each camera segment
    (SingleScatterIntegrator::integrate): one light sample a step, from
    rand4(pixel, sample, 40 + step, 5), shadowed through the scene geometry
    and attenuated by the medium toward the light."""
    from . import common
    num_lights = scene.lights.num_lights
    t0, t1 = _segment(scene, o, d, t_hit)
    dt = (t1 - t0) / steps
    acc = torch.zeros_like(o)
    tau = torch.zeros_like(o)
    n = o.shape[0]
    g_mean = scene.volumes.g.mean()
    up = torch.zeros_like(o)
    up[:, 2] = 1.0
    no_prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for s in range(steps):
        p = o + d * (t0 + (s + 0.5) * dt)[..., None]
        ss, st, em = sigma_st(scene, p)
        tr = torch.exp(-tau)
        acc = acc + tr * em * dt[..., None]   # EmissionIntegrator's share
        if num_lights > 0:
            r = sampler.rand4(pixel_id, sample_idx, 40 + s, 5)
            ul, u1, u2 = r[..., 0], r[..., 1], r[..., 2]
            li = torch.clamp((ul * num_lights).to(torch.int32), 0,
                             num_lights - 1)
            ls = L.sample_light(scene, li, p, up, u1, u2)
            vis = common.trace_shadow(scene, p, no_prim, ls.wi, ls.dist,
                                      transparent_shadows)
            lp = p + ls.wi * torch.clamp_max(ls.dist, 1e6)[..., None]
            vis = vis * torch.exp(-light_tau(scene, p, lp))
            phase = _hg_phase(vec.dot(d, ls.wi), g_mean)
            contrib = (ss * ls.radiance * vis
                       * (phase / torch.clamp_min(ls.pdf, 1e-9)
                          * num_lights)[..., None])
            acc = acc + tr * torch.where(ls.valid[..., None], contrib,
                                         0.0) * dt[..., None]
        tau = tau + st * dt[..., None]
    return acc


def apply_volumetric(scene: SceneData, cfg, radiance: Tensor, o: Tensor,
                     d: Tensor, t_hit: Tensor, pixel_id: Tensor,
                     sample_idx) -> Tensor:
    """The camera segment's share (applyVolumetricEffects,
    integrator_tiled.cc): transmittance times the surface radiance, plus
    the in-scattered radiance, each marched in cfg.vol_steps steps."""
    for on, feature in ((cfg.vol_kind == "emission",
                         "the emission volume integrator"),
                        (cfg.vol_optimize, "the single-scatter attenuation "
                                           "grid (optimize)"),
                        (cfg.vol_adaptive, "adaptive volume marching")):
        if on:
            raise NotImplementedError(
                f"{feature} is not ported to libyafaray_tpu_torch yet")
    tr = transmittance(scene, o, d, t_hit, cfg.vol_steps)
    return tr * radiance + in_scatter(scene, o, d, t_hit, pixel_id,
                                      sample_idx, cfg.vol_steps,
                                      cfg.transparent_shadows)
