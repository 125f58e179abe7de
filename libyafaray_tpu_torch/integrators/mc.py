"""Wavefront Monte Carlo surface integrators: direct lighting and path tracing.

Counterpart of `libyafaray_tpu/integrators/mc.py` for the `combined` layer:
the whole batch of camera rays marches through the bounce loop with masked
lanes; dead lanes carry zero throughput and an empty t-range. NEE with MIS
every bounce, BSDF sampling and Russian roulette after a minimum bounce
count, drawn from the same counter-based samples as the JAX package. In a
motion-blurred scene every path carries one shutter time, drawn per sample,
which its camera, bounce and shadow queries share. Primary hits carry their
pixel footprint (`compute_differentials`) and every hit its bump-mapped
normal (`bump_normal`), where the JAX package computes them. Shadow rays
pass through transparent surfaces with `transpShad` (up to `shadowDepth`
of them); a path through dispersive glass carries a wavelength; a path
inside glass with Beer absorption or an sss interior is attenuated, and
scattered, along its segments there. In a scene with volume regions the
camera segment ends with the volume integrator (`integrators/volume.py`:
single scatter, with the attenuation grid and adaptive marching, or
emission), and under the sky integrator with the atmosphere, regions or
not. Ambient occlusion (`do_AO`) and the photon, SPPM, bidirectional and
debug integrators still raise NotImplementedError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from .. import lights as L
from .. import params as P
from .. import sampler
from ..backgrounds import eval_background
from ..color import wl_to_rgb
from ..materials import bsdf as B
from ..materials.nodes import bump_normal
from ..math import vec
from ..ops import intersect as I
from ..ops import surface as S
from ..ops.fast_grad import take
from ..scene_types import SceneData
from . import common

Tensor = torch.Tensor

_KINDS = ("directlighting", "pathtracing")
# integrator types of the JAX package that are not ported yet
_KINDS_JAX = ("DebugIntegrator", "debug", "photonmapping", "SPPM",
              "bidirectional")


@dataclass(frozen=True)
class IntegratorConfig:
    """Integrator settings (ParamMap-parsed; names follow the reference)."""
    kind: str = "pathtracing"
    bounces: int = 4
    russian_roulette_min_bounces: int = 2
    no_recursive: bool = False
    clamp_indirect: float = 0.0
    # transparent shadows ("transpShad"): the walk's depth ("shadowDepth",
    # 4 by default), 0 when off
    transparent_shadows: int = 0
    # the volume integrator (the reference's separate VolumeIntegrator
    # entity): "single_scatter", "emission", "sky" or "none"; its step
    # count, the attenuation-grid cache ("optimize") and adaptive marching
    # with its density substeps per step
    vol_kind: str = "single_scatter"
    vol_steps: int = 16
    vol_optimize: bool = False
    vol_adaptive: bool = False
    vol_substeps: int = 8
    # the sky integrator (SkyIntegrator::factory, integrator_sky.cc:198):
    # "alpha", "turbidity" and the scale "sigma_t"
    sky_alpha: float = 0.5
    sky_turbidity: float = 3.0
    sky_scale: float = 0.1


_VOL_KINDS = {"EmissionIntegrator": "emission",
              "SingleScatterIntegrator": "single_scatter",
              "SkyIntegrator": "sky", "none": "none"}


def _unsupported(feature: str):
    return NotImplementedError(
        f"{feature} is not ported to libyafaray_tpu_torch yet")


def make_integrator(pm: dict) -> IntegratorConfig:
    """Factory mirroring the reference's integrator type strings."""
    pm = P.ParamMap(pm)
    kind = pm.get_string("type", "pathtracing")
    if kind in _KINDS_JAX:
        raise _unsupported(f"integrator type {kind!r}")
    if kind not in _KINDS:
        raise KeyError(f"integrator: unknown type {kind!r}")
    if pm.get_bool("do_AO", False):
        raise _unsupported("ambient occlusion (do_AO)")
    return IntegratorConfig(
        kind=kind,
        bounces=pm.get_int("bounces", pm.get_int("raydepth", 4)),
        russian_roulette_min_bounces=pm.get_int(
            "russian_roulette_min_bounces", 2),
        no_recursive=pm.get_bool("no_recursive", False),
        clamp_indirect=pm.get_float("clamp_indirect", 0.0),
        transparent_shadows=(pm.get_int("shadowDepth", 4)
                             if pm.get_bool("transpShad", False) else 0),
        vol_kind=_VOL_KINDS.get(
            pm.get_string("volume_integrator", "SingleScatterIntegrator"),
            "single_scatter"),
        vol_steps=pm.get_int("volume_steps", 16),
        vol_optimize=pm.get_bool("optimize", False),
        vol_adaptive=pm.get_bool("adaptive", False),
        vol_substeps=pm.get_int("adaptive_substeps", 8),
        sky_alpha=pm.get_float("alpha", 0.5),
        sky_turbidity=pm.get_float("turbidity", 3.0),
        sky_scale=pm.get_float("sigma_t", 0.1))


def integrate(scene: SceneData, cfg: IntegratorConfig,
              ray_o: Tensor, ray_d: Tensor, ray_valid: Tensor,
              pixel_id: Tensor, sample_idx) -> Tuple[Tensor, Tensor]:
    """Trace one wavefront of camera rays to completion.

    Returns (rgb f32[N,3], alpha f32[N])."""
    n = ray_o.shape[0]
    dev = ray_o.device
    mats = scene.materials
    num_lights = scene.lights.num_lights
    direct_only = cfg.kind == "directlighting"
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = ray_valid
    alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    first_hit_t = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
    o, d = ray_o, ray_d
    prev_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    prev_pdf = torch.zeros((n,), dtype=torch.float32, device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)  # camera rays
    prev_p = ray_o
    # per-sample shutter time for motion blur
    ray_time = (sampler.rand1(pixel_id, sample_idx, 0, 556)
                if scene.geom.has_motion else None)
    # chromatic dispersion (integrator_montecarlo.cc's dispersive branch):
    # each path carries a wavelength; its first dispersive refraction tints
    # the throughput by 3 * wl_to_rgb(wavelength)
    path_wl = chromatic = None
    if mats.has_dispersion:
        path_wl = sampler.rand1(pixel_id, sample_idx, 0, 555)
        chromatic = torch.zeros((n,), dtype=torch.bool, device=dev)
    # the glass interiors (the reference's 'beer' and 'sss' volume
    # handlers, integrator_path_tracer.cc): the material whose interior
    # each path is in, or -1
    track_medium = (mats.has_beer or mats.has_sss) and not direct_only
    if track_medium:
        medium_mat = torch.full((n,), -1, dtype=torch.int32, device=dev)

    max_depth = cfg.bounces + 1
    for depth in range(max_depth):
        # dead paths get an empty t-range
        t_far = torch.where(alive, 1e30, -1.0)
        if depth == 0:
            hit = I.camera_hit(scene, o, d, scene.ray_min_dist, t_far,
                               time=ray_time)
        else:
            hit = I.closest_hit(scene, o, d, scene.ray_min_dist, t_far,
                                exclude_prim=prev_prim, time=ray_time)
        hit.valid = hit.valid & alive
        scat = None
        if track_medium:
            in_med = (medium_mat >= 0) & alive
            mm = torch.clamp_min(medium_mat, 0).long()
            t_seg = torch.where(hit.valid & in_med, hit.t, 0.0)
            if mats.has_sss:
                # an exponential free path of mean sss_dist
                # (volumehandler_sss.cc): where it ends before the surface
                # the lane scatters isotropically there instead, tinted by
                # scatter_col
                r = sampler.rand4(pixel_id, sample_idx, depth, 61)
                u_sc, u_s1, u_s2 = r[..., 0], r[..., 1], r[..., 2]
                sdist = take(mats.sss_dist, mm)
                sc_dist = -sdist * torch.log(torch.clamp_min(u_sc, 1e-12))
                scat = (in_med & (sdist > 0.0) & hit.valid
                        & (sc_dist < hit.t))
                t_seg = torch.where(scat, sc_dist, t_seg)
                scat_p = o + d * t_seg[..., None]
                cz = 1.0 - 2.0 * u_s1
                szr = torch.sqrt(torch.clamp_min(1.0 - cz * cz, 0.0))
                phi_s = 2.0 * math.pi * u_s2
                scat_d = torch.stack([szr * torch.cos(phi_s),
                                      szr * torch.sin(phi_s), cz], -1)
                throughput = torch.where(
                    scat[..., None],
                    throughput * take(mats.sss_scatter_col, mm), throughput)
            if mats.has_beer:
                # Beer-law transmittance of the interior, e^(-sigma_a t)
                beer_tr = torch.exp(-take(mats.absorption, mm)
                                    * t_seg[..., None])
                throughput = torch.where(in_med[..., None],
                                         throughput * beer_tr, throughput)
            if scat is not None:
                hit.valid = hit.valid & ~scat
        sp = S.make_surface(scene, hit, o, d)
        if depth == 0:
            # primary hits carry their footprint for texture filtering
            sp = S.compute_differentials(scene, sp, d)
        sp = bump_normal(scene, sp)
        wo = -d

        # escaped rays: background, MIS-weighted against the background
        # light's samples when the background lights the scene (every light
        # is sampled at each bounce, so the pick probability is 1)
        escaped = alive & ~hit.valid
        if scat is not None:
            escaped = escaped & ~scat
        bg_add = throughput * eval_background(scene, d)
        if scene.lights.bg_light_idx >= 0:
            bg_mis = torch.where(prev_delta, 1.0, vec.power_heuristic(
                prev_pdf, L.background_pdf(scene, d)))
            bg_add = bg_add * bg_mis[..., None]
        radiance = radiance + torch.where(escaped[..., None], bg_add, 0.0)
        if depth == 0:
            first_hit_t = torch.where(hit.valid, hit.t, first_hit_t)
        alpha = torch.where(hit.valid & (depth == 0), 1.0, alpha)
        # lanes that bounced at least once keep alpha 1 when they escape
        if depth > 0:
            alpha = torch.where(alive, torch.clamp_min(alpha, 1.0), alpha)
        alive = alive & hit.valid

        # emission at the hit, MIS-weighted against NEE
        mis_w = common.hit_light_mis_weight(scene, sp, prev_p, prev_pdf,
                                            prev_delta)
        emit = common.emitted_radiance(scene, sp, wo)
        radiance = radiance + torch.where(
            alive[..., None], throughput * emit * mis_w[..., None], 0.0)
        # area-light quads (face_obj == -1) are pure emitters
        alive = alive & ~((sp.light_id >= 0) & (sp.obj_id < 0))

        # next-event estimation: every light, every bounce (the JAX
        # package's default); direct lighting honours each light's sample
        # count, the path tracer takes one sample per light
        for li_static in range(num_lights):
            ns = 1
            if direct_only and scene.lights.samples_static:
                ns = scene.lights.samples_static[li_static]
            li = torch.full((n,), li_static, dtype=torch.int32, device=dev)
            for k in range(ns):
                u1, u2 = sampler.rand2(pixel_id, sample_idx, depth,
                                       10 + 2 * li_static + 100 * k)
                c = common.estimate_one_light(
                    scene, sp, wo, li, u1, u2, cfg.transparent_shadows,
                    time=ray_time)
                radiance = radiance + torch.where(
                    alive[..., None], throughput * c * (1.0 / ns), 0.0)

        if depth == max_depth - 1:
            break

        # BSDF sampling / continuation
        r = sampler.rand4(pixel_id, sample_idx, depth, 2)
        u1, u2, u3, u_rr = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
        ms = B.sample_bsdf(scene, sp, wo, u1, u2, u3, wl=path_wl)
        cont = alive & ms.valid
        if direct_only or cfg.no_recursive:
            # only delta continuation (recursiveRaytrace analogue)
            cont = cont & ms.is_delta
        new_thr = throughput * ms.weight
        if chromatic is not None:
            first = ms.dispersed & ~chromatic
            new_thr = torch.where(first[..., None],
                                  new_thr * wl_to_rgb(path_wl) * 3.0, new_thr)
            chromatic = chromatic | ms.dispersed
        if cfg.clamp_indirect > 0.0 and depth > 0:
            mx = torch.amax(new_thr, dim=-1, keepdim=True)
            new_thr = torch.where(
                mx > cfg.clamp_indirect,
                new_thr * cfg.clamp_indirect / torch.clamp_min(mx, 1e-9),
                new_thr)
        # Russian roulette on the throughput maximum
        if depth >= cfg.russian_roulette_min_bounces and not direct_only:
            p_survive = torch.clamp(torch.amax(new_thr, dim=-1), 0.05, 1.0)
            kill = u_rr > p_survive
            new_thr = new_thr / p_survive[..., None]
            cont = cont & ~kill
        throughput = torch.where(cont[..., None], new_thr, throughput)
        if track_medium:
            # a transmission across the geometric normal enters or leaves
            # the dielectric's interior
            cos_in = vec.dot(ms.wi, sp.ng)
            crossed = cont & (cos_in * vec.dot(wo, sp.ng) < 0.0)
            going_in = cos_in < 0.0
            medium_mat = torch.where(
                crossed & going_in, sp.mat_id,
                torch.where(crossed & ~going_in, -1, medium_mat))
        alive = cont
        prev_p = sp.p
        prev_prim = sp.prim
        prev_pdf = ms.pdf
        prev_delta = ms.is_delta
        o = sp.p + ms.wi * scene.shadow_bias
        d = ms.wi
        if scat is not None:
            # scattered lanes go on inside the medium along their new ray
            alive = alive | scat
            o = torch.where(scat[..., None], scat_p, o)
            d = torch.where(scat[..., None], scat_d, d)
            prev_prim = torch.where(scat, -1, prev_prim)
            prev_delta = prev_delta | scat

    if (scene.volumes is not None or cfg.vol_kind == "sky") \
            and cfg.vol_kind != "none":
        # the camera segment through the volume regions or the atmosphere
        # (applyVolumetricEffects, integrator_tiled.cc)
        from .volume import apply_volumetric
        radiance = apply_volumetric(scene, cfg, radiance, ray_o, ray_d,
                                    first_hit_t, pixel_id, sample_idx)
    return radiance, torch.clamp(alpha, 0.0, 1.0)
