"""SPPM: stochastic progressive photon mapping.

Counterpart of `libyafaray_tpu/integrators/sppm.py` (libYafaRay's
SppmIntegrator, integrator_sppm.cc): each pass shoots a fresh photon map
and traces one eye sample per pixel through its specular chain to the
first non-specular hit; the per-pixel statistics (radius^2, the reduced
flux, the photon count) shrink with ALPHA = 0.7 (integrator_sppm.cc:
243-249), and the radiance is flux / (pi r^2 N_emitted) (:256) plus the
mean of the passes' direct light (emission and NEE along the eye walk).
The reference's hash grid is the dense grid of `photon.py`, rebuilt each
pass with its cell following the largest radius. PM_IRE estimates each
pixel's initial radius from the local photon density. `render_sppm` runs
on the CUDA card unless the caller names another device.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from .. import photon as PH
from .. import sampler
from ..cameras import shoot_rays
from ..materials import bsdf as B
from ..math import vec
from ..ops import intersect as I
from ..ops import surface as S
from ..scene_types import SceneData
from . import common
from .mc import IntegratorConfig

Tensor = torch.Tensor

ALPHA = 0.7  # the radius-shrink parameter (integrator_sppm.cc)


@dataclass
class SppmState:
    radius2: Tensor    # f32[N] per-pixel gather radius^2
    flux: Tensor       # f32[N,3] accumulated (reduced) flux * f
    n_photons: Tensor  # f32[N] accumulated photon count (after alpha)
    direct: Tensor     # f32[N,3] accumulated direct + emitted radiance
    n_passes: Tensor   # i32[] completed passes
    n_emitted: Tensor  # f32[] photons emitted so far


def init_state(n_pixels: int, initial_radius: float,
               device="cuda") -> SppmState:
    f32 = dict(dtype=torch.float32, device=device)
    return SppmState(
        radius2=torch.full((n_pixels,), initial_radius ** 2, **f32),
        flux=torch.zeros((n_pixels, 3), **f32),
        n_photons=torch.zeros((n_pixels,), **f32),
        direct=torch.zeros((n_pixels, 3), **f32),
        n_passes=torch.zeros((), dtype=torch.int32, device=device),
        n_emitted=torch.zeros((), **f32))


def _eye_walk(scene: SceneData, cfg: IntegratorConfig, o: Tensor, d: Tensor,
              valid: Tensor, pixel_id: Tensor, sample_idx):
    """Trace camera rays through their specular chains to the first
    non-specular hit, adding emission and NEE along the way (the eye pass,
    integrator_sppm.cc:174-258). Returns (the settled surface points, their
    wo, the throughput there, direct f32[N,3], settled bool[N]). The walk
    stops early once no lane goes on: the depths left would add nothing."""
    n = o.shape[0]
    dev = o.device
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    direct = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = valid
    settled = torch.zeros((n,), dtype=torch.bool, device=dev)
    prev_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sp_out = wo_out = settled_thr = None
    num_lights = scene.lights.num_lights
    for depth in range(cfg.bounces + 1):
        t_far = torch.where(alive, 1e30, -1.0)
        if depth == 0:
            hit = I.camera_hit(scene, o, d, scene.ray_min_dist, t_far)
        else:
            hit = I.closest_hit(scene, o, d, scene.ray_min_dist, t_far,
                                exclude_prim=prev_prim)
        hit.valid = hit.valid & alive
        sp = S.make_surface(scene, hit, o, d)
        wo = -d
        here = (alive & hit.valid)[..., None]
        direct = direct + torch.where(
            here, throughput * common.emitted_radiance(scene, sp, wo), 0.0)
        # NEE toward every light at every surface
        for li_static in range(num_lights):
            li = torch.full((n,), li_static, dtype=torch.int32, device=dev)
            u1, u2 = sampler.rand2(pixel_id, sample_idx, depth,
                                   60 + 2 * li_static)
            c = common.estimate_one_light(scene, sp, wo, li, u1, u2, 0)
            direct = direct + torch.where(here, throughput * c, 0.0)
        alive = alive & hit.valid
        # area-light quads never scatter
        alive = alive & ~((sp.light_id >= 0) & (sp.obj_id < 0))
        mp = B.resolve_mp(scene, sp)
        _, _, w_mf, w_di, w_tl = B.lobe_weights(
            mp, torch.abs(vec.dot(wo, sp.n)))
        settle_now = alive & ((w_di + w_tl + w_mf) > 1e-5) & ~settled
        if sp_out is None:
            sp_out, wo_out = sp, wo
            settled_thr = torch.where(settle_now[..., None], throughput, 0.0)
        else:
            sp_out = _where_sp(settle_now, sp, sp_out)
            wo_out = torch.where(settle_now[..., None], wo, wo_out)
            settled_thr = torch.where(settle_now[..., None], throughput,
                                      settled_thr)
        settled = settled | settle_now
        alive = alive & ~settle_now
        if depth == cfg.bounces or not bool(alive.any()):
            break
        r = sampler.rand4(pixel_id, sample_idx, depth, 70)
        ms = B.sample_bsdf(scene, sp, wo, r[..., 0], r[..., 1], r[..., 2])
        cont = alive & ms.valid & ms.is_delta
        throughput = torch.where(cont[..., None], throughput * ms.weight,
                                 throughput)
        alive = cont
        prev_prim = sp.prim
        o = sp.p + ms.wi * scene.shadow_bias
        d = ms.wi
    return sp_out, wo_out, settled_thr, direct, settled


def _where_sp(m: Tensor, new, old):
    """Per lane, the surface point `new` where m, else `old`."""
    out = {}
    for f in dataclasses.fields(new):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if isinstance(a, Tensor) and isinstance(b, Tensor):
            out[f.name] = torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)),
                                      a, b)
    return dataclasses.replace(old, **out)


def sppm_pass(scene: SceneData, cfg: IntegratorConfig, state: SppmState,
              height: int, width: int, pass_idx: int,
              photons_per_pass: int) -> SppmState:
    """One pass: a fresh photon map, the eye pass and the statistics'
    update (integrator_sppm.cc:485 onward)."""
    from ..render import camera_rays
    pixel_id = torch.arange(height * width, device=state.radius2.device)
    s_idx = int(pass_idx) & sampler.M32
    _, _, o, d, valid = camera_rays(scene.camera, pixel_id, s_idx, width)

    # the pass's own photons (seeded by the pass index), the indirect
    # deposits only: the eye pass takes direct light by NEE. The cell
    # follows the largest radius, so the 27 cells cover every pixel's
    # gather sphere and shrink with the radii
    smin, smax = PH.scene_bounds(scene)
    pos, dir_, pw, _, indirect, pvalid, _, _ = PH.shoot_photons(
        scene, photons_per_pass, cfg.pm_bounces, seed=s_idx)
    pmap = PH.build_photon_map(pos, dir_, pw, pvalid & indirect,
                               torch.sqrt(torch.amax(state.radius2)),
                               smin, smax)
    sp, _, thr, direct, settled = _eye_walk(scene, cfg, o, d, valid,
                                            pixel_id, s_idx)
    flux_new, m_new = PH.gather_flux(pmap, sp.p, sp.n, r2=state.radius2)
    f_diff = B.resolve_mp(scene, sp).diffuse_color / math.pi
    contrib = torch.where(settled[..., None], thr * f_diff * flux_new, 0.0)
    m_new = torch.where(settled, m_new, 0.0)
    n_old = state.n_photons
    ratio = torch.where(n_old + m_new > 0,
                        (n_old + ALPHA * m_new)
                        / torch.clamp_min(n_old + m_new, 1.0), 1.0)
    return SppmState(
        radius2=state.radius2 * ratio,
        flux=(state.flux + contrib) * ratio[..., None],
        n_photons=n_old + ALPHA * m_new,
        direct=state.direct + direct,
        n_passes=state.n_passes + 1,
        n_emitted=state.n_emitted + photons_per_pass)


def estimate_initial_radius(scene: SceneData, cfg: IntegratorConfig,
                            height: int, width: int, photons_per_pass: int,
                            r0: float, n_search: int = 64) -> Tensor:
    """PM_IRE (integrator_sppm.cc:635-649): each pixel's initial radius^2
    from the local photon density, r^2 = r0^2 * n_search / count, clamped
    to [(r0/32)^2, r0^2]; pixels that gather nothing keep r0^2. One
    throwaway photon map and eye walk through the pixel centres."""
    dev = scene.geom.vertices.device
    pixel_id = torch.arange(height * width, device=dev)
    zero = torch.zeros((height * width,), dtype=torch.float32, device=dev)
    o, d, valid = shoot_rays(scene.camera,
                             (pixel_id % width).to(torch.float32) + 0.5,
                             (pixel_id // width).to(torch.float32) + 0.5,
                             zero, zero)
    smin, smax = PH.scene_bounds(scene)
    pos, dir_, pw, _, indirect, pvalid, _, _ = PH.shoot_photons(
        scene, photons_per_pass, cfg.pm_bounces, seed=0xA11CE)
    pmap = PH.build_photon_map(pos, dir_, pw, pvalid & indirect, r0, smin,
                               smax)
    sp, _, _, _, settled = _eye_walk(scene, cfg, o, d, valid, pixel_id, 0)
    _, cnt = PH.gather_flux(pmap, sp.p, sp.n)
    return torch.where(
        settled & (cnt > 0),
        torch.clamp(r0 * r0 * n_search / torch.clamp_min(cnt, 1.0),
                    (r0 / 32.0) ** 2, r0 * r0),
        r0 * r0)


def resolve_sppm(state: SppmState, height: int, width: int) -> Tensor:
    """The image: the passes' mean direct light + flux / (pi r^2
    N_emitted) (integrator_sppm.cc:256), f32[H, W, 3]."""
    np_ = torch.clamp_min(state.n_passes.to(torch.float32), 1.0)
    indirect = state.flux / (math.pi * state.radius2[..., None]
                             * torch.clamp_min(state.n_emitted, 1.0))
    return (state.direct / np_ + indirect).reshape(height, width, 3)


def render_sppm(scene: SceneData, cfg: IntegratorConfig, width: int = None,
                height: int = None, passes: int = 8,
                photons_per_pass: int = 50_000, initial_radius: float = 0.05,
                pm_ire: bool = False, *, device="cuda") -> Tensor:
    """SppmIntegrator::render on `device` (the CUDA card unless the caller
    names another device): `passes` passes of `photons_per_pass` photons.
    Returns the image f32[H, W, 3]. With pm_ire the initial radii come
    from the local photon density instead of the uniform initial_radius."""
    width = scene.camera.resx if width is None else width
    height = scene.camera.resy if height is None else height
    scene = scene.to(device)
    cfg = dataclasses.replace(cfg, pm_radius=initial_radius)
    state = init_state(width * height, initial_radius, device)
    if pm_ire:
        state = dataclasses.replace(state, radius2=estimate_initial_radius(
            scene, cfg, height, width, photons_per_pass, initial_radius))
    for p in range(passes):
        state = sppm_pass(scene, cfg, state, height, width, p,
                          photons_per_pass)
    return resolve_sppm(state, height, width)
