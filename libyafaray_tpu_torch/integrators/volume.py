"""The volume integrators over the camera segment: emission, single scatter
and sky.

Counterpart of `libyafaray_tpu/integrators/volume.py` (the reference's
EmissionIntegrator integrator_emission.cc, SingleScatterIntegrator
integrator_single_scatter.cc and SkyIntegrator integrator_sky.cc). Each
camera ray's segment inside the volume regions is marched in `steps`
equal steps. The single-scatter march samples one light, picked uniformly,
at each step: its shadow ray is traced through the scene from that point
and attenuated by the medium toward the light, by a 16-step march or, with
"optimize", by a lookup into the attenuation grid that `render` builds
once (`build_attenuation_grid`). With "adaptive" each step integrates the
density at `substeps` points and puts its light sample at the
scattering-weighted centroid. The emission integrator sums the emission
alone; the sky integrator marches the analytic Rayleigh + Mie atmosphere
lit by the background (it needs no region). The surface integrator then
applies the segment as the reference's applyVolumetricEffects does:

    L = transmittance(segment) * L_surface + L_volume(segment).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import lights as L
from .. import sampler
from ..math import vec
from ..scene_types import SceneData, VolAtten
from ..volumes import ray_aabb_span, sigma_st

Tensor = torch.Tensor

DEFAULT_STEPS = 16
ATTEN_GRID = 36          # the reference's attenuation grid (att_grid_*)
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


def emission(scene: SceneData, o: Tensor, d: Tensor, t_hit: Tensor,
             steps: int = DEFAULT_STEPS) -> Tensor:
    """The emitted radiance [N,3] along each segment, attenuated by the
    medium in front of it (EmissionIntegrator::integrate)."""
    t0, t1 = _segment(scene, o, d, t_hit)
    dt = (t1 - t0) / steps
    em = torch.zeros_like(o)
    tau = torch.zeros_like(o)
    for s in range(steps):
        p = o + d * (t0 + (s + 0.5) * dt)[..., None]
        _, st, e = sigma_st(scene, p)
        em = em + torch.exp(-tau) * e * dt[..., None]
        tau = tau + st * dt[..., None]
    return em


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


def _fine_step(scene, o, d, t0, dt, s, substeps, tau):
    """One coarse step of the adaptive march: (emission, the step's
    transmittance-weighted sigma_s and its sigma_t, each as a density over
    dt, and the scattering-weighted centroid t) from `substeps` density
    probes (integrator_single_scatter.cc:303-334, shaped as the JAX
    package's: exact density integration, one light sample a step)."""
    fdt = (dt / substeps)[..., None]
    n = o.shape[0]
    st_acc = torch.zeros_like(o)
    em_acc = torch.zeros_like(o)
    ssw_acc = torch.zeros_like(o)
    w_sum = torch.zeros((n,), dtype=torch.float32, device=o.device)
    tw_sum = torch.zeros_like(w_sum)
    tau_rel = torch.zeros_like(o)     # tau within the step so far
    for k in range(substeps):
        tk = t0 + (s + (k + 0.5) / substeps) * dt
        ssk, stk, emk = sigma_st(scene, o + d * tk[..., None])
        em_acc = em_acc + torch.exp(-(tau + tau_rel)) * emk * fdt
        ssw_acc = ssw_acc + torch.exp(-tau_rel) * ssk * fdt
        tau_rel = tau_rel + stk * fdt
        st_acc = st_acc + stk * fdt
        wk = torch.amax(ssk, dim=-1)
        w_sum = w_sum + wk
        tw_sum = tw_sum + wk * tk
    tm = torch.where(w_sum > 0, tw_sum / torch.clamp_min(w_sum, 1e-12),
                     t0 + (s + 0.5) * dt)
    # the step's contribution tr * ss * dt must equal tr(start) * ssw_acc,
    # and its tau increment the fine integral
    dt_safe = torch.clamp_min(dt, 1e-12)[..., None]
    return em_acc, ssw_acc / dt_safe, st_acc / dt_safe, tm


def in_scatter(scene: SceneData, o: Tensor, d: Tensor, t_hit: Tensor,
               pixel_id: Tensor, sample_idx,
               steps: int = DEFAULT_STEPS,
               transparent_shadows: int = 0,
               substeps: int = 1) -> Tensor:
    """Single scattering plus emission [N,3] along each camera segment
    (SingleScatterIntegrator::integrate): one light sample a step, from
    rand4(pixel, sample, 40 + step, 5), shadowed through the scene geometry
    and attenuated by the medium toward the light (the attenuation grid
    when the scene carries one). substeps > 1 is the adaptive march."""
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
        tr = torch.exp(-tau)
        if substeps > 1:
            em_acc, ss, st, tm = _fine_step(scene, o, d, t0, dt, s,
                                            substeps, tau)
            p = o + d * tm[..., None]
            acc = acc + em_acc
        else:
            p = o + d * (t0 + (s + 0.5) * dt)[..., None]
            ss, st, em = sigma_st(scene, p)
            acc = acc + tr * em * dt[..., None]   # EmissionIntegrator's share
        if num_lights > 0:
            r = sampler.rand4(pixel_id, sample_idx, 40 + s, 5)
            ul, u1, u2 = r[..., 0], r[..., 1], r[..., 2]
            li = torch.clamp((ul * num_lights).to(torch.int32), 0,
                             num_lights - 1)
            ls = L.sample_light(scene, li, p, up, u1, u2)
            vis = common.trace_shadow(scene, p, no_prim, ls.wi, ls.dist,
                                      transparent_shadows)
            if scene.vol_atten is not None:
                vis = vis * lookup_attenuation(scene.vol_atten, p, li)
            else:
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


# ---------------------------------------------------------------------------
# The attenuation grid ("optimize", integrator_single_scatter.cc:35-108):
# exp(-tau) from each cell centre of a G^3 grid over the regions' box toward
# each light, looked up trilinearly in place of the march toward the light.
# ---------------------------------------------------------------------------

def _linspace(start: float, stop: float, num: int, device) -> Tensor:
    """jnp.linspace in float32: start (1 - s) + stop s, s = k / (num - 1),
    and the end point itself last."""
    start = torch.tensor(start, dtype=torch.float32, device=device)
    stop = torch.tensor(stop, dtype=torch.float32, device=device)
    step = torch.arange(num - 1, dtype=torch.float32,
                        device=device) / float(num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


def build_attenuation_grid(scene: SceneData,
                           grid: int = ATTEN_GRID) -> VolAtten:
    """exp(-tau) [L, G, G, G, 3] from every cell centre toward every light's
    `position` column, over all lights (as the JAX package's vmap)."""
    vt = scene.volumes
    bmin = torch.amin(vt.bmin, dim=0)
    bmax = torch.amax(vt.bmax, dim=0)
    cs = _linspace(0.5 / grid, 1.0 - 0.5 / grid, grid, bmin.device)
    zz, yy, xx = torch.meshgrid(cs, cs, cs, indexing="ij")
    pts = bmin + torch.stack([xx, yy, zz], -1).reshape(-1, 3) * (bmax - bmin)
    atten = torch.stack([
        torch.exp(-light_tau(scene, pts, lpos.expand(pts.shape)))
        .reshape(grid, grid, grid, 3) for lpos in scene.lights.position])
    return VolAtten(atten=atten, bmin=bmin, bmax=bmax)


def lookup_attenuation(vol_atten: VolAtten, p: Tensor, li: Tensor) -> Tensor:
    """Trilinear fetch [N,3] of light li's attenuation at points p."""
    atten = vol_atten.atten
    g = atten.shape[1]
    rel = torch.clamp((p - vol_atten.bmin) / torch.clamp_min(
        vol_atten.bmax - vol_atten.bmin, 1e-9), 0.0, 1.0)
    f = rel * g - 0.5
    i0 = torch.clamp(torch.floor(f).to(torch.int32), 0, g - 1)
    i1 = torch.clamp_max(i0 + 1, g - 1)
    w = torch.clamp(f - i0, 0.0, 1.0)
    li = li.long()
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = (i1 if dx else i0)[..., 0].long()
                iy = (i1 if dy else i0)[..., 1].long()
                iz = (i1 if dz else i0)[..., 2].long()
                wx = w[..., 0] if dx else 1.0 - w[..., 0]
                wy = w[..., 1] if dy else 1.0 - w[..., 1]
                wz = w[..., 2] if dz else 1.0 - w[..., 2]
                out = out + (wx * wy * wz)[..., None] * atten[li, iz, iy, ix]
    return out


# ---------------------------------------------------------------------------
# The sky integrator: Rayleigh + Mie scattering along the camera ray
# (integrator_sky.cc:30-196). The medium is the analytic exponential
# atmosphere, lit by the background over 24 fixed directions.
# ---------------------------------------------------------------------------

# the Mie angular table (integrator_sky.cc:175-196), degrees -> value
_MIE_DEG = np.array([0.0, 1.0, 4.0, 7.0, 10.0, 30.0, 60.0, 80.0, 180.0],
                    np.float32)
_MIE_VAL = np.array([4.192, 4.192, 3.311, 2.860, 2.518, 1.122, 0.3324,
                     0.1644, 0.1], np.float32)


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """jnp.interp in float32 for increasing knots xp: the segment by a
    right-sided search, fp[i-1] + (x - xp[i-1]) / dx * df inside (one
    rounding after the product, as XLA's fused multiply-add), the end
    values outside. At a knot the search lands past it, so the value there
    is fp at the knot plus zero; at the last knot it is the last segment's
    end, computed."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    # jnp.interp is jitted: XLA fuses fp[i-1] + q * df into one fused
    # multiply-add, evaluated here exactly in float64
    q = delta / torch.where(dx0, 1.0, dx)
    f = torch.where(dx0, fp[i - 1], (q.double() * df.double()
                                     + fp[i - 1].double()).float())
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def sky_coeffs(alpha: float, turbidity: float):
    """(alpha_r, alpha_m, beta_r, beta_m): the Rayleigh and Mie extinction
    coefficients (integrator_sky.cc:38-58), in Python floats."""
    alpha_r = 0.1136 * alpha
    alpha_m = 0.8333 * alpha
    n_mol, n_ref, p_n, lam = 2.545e25, 1.0003, 0.035, 500e-9
    b_r = (8 * math.pi ** 3 * (n_ref ** 2 - 1) ** 2
           / (3 * n_mol * lam ** 4) * (6 + 3 * p_n) / (6 - 7 * p_n))
    c = (0.6544 * turbidity - 0.651) * 1e-16
    v, k = 4.0, 0.67
    b_m = 0.434 * c * math.pi * (2 * math.pi / lam) ** (v - 2) * k * 0.01
    return alpha_r, alpha_m, b_r, b_m


def _sky_tau(beta: float, alpha: float, scale: float, o: Tensor, d: Tensor,
             t: Tensor) -> Tensor:
    """Closed-form optical depth of the exponential atmosphere over [0, t]
    (SkyIntegrator::skyTau, integrator_sky.cc:96-104)."""
    s = t * scale
    cos_t = d[..., 2]
    h0 = o[..., 2] * scale
    ac = alpha * cos_t
    denom = torch.where(torch.abs(ac) < 1e-9, 1e-9, ac)
    tau = beta * torch.exp(-alpha * h0) * (1.0 - torch.exp(
        -alpha * cos_t * s)) / denom
    return torch.where(t > 0, torch.clamp_min(tau, 0.0), 0.0)


def sky_transmittance(cfg, o: Tensor, d: Tensor, t_hit: Tensor) -> Tensor:
    """exp(-tau) [N,3] of the atmosphere over each camera segment (1000
    units for rays that hit nothing)."""
    alpha_r, alpha_m, b_r, b_m = sky_coeffs(cfg.sky_alpha, cfg.sky_turbidity)
    sc = cfg.sky_scale
    t = torch.where(t_hit > 0, t_hit, 1000.0)
    tau = _sky_tau(b_m, alpha_m, sc, o, d, t) \
        + _sky_tau(b_r, alpha_r, sc, o, d, t)
    return torch.exp(-tau)[..., None].expand(-1, 3)


def sky_in_scatter(scene: SceneData, cfg, o: Tensor, d: Tensor,
                   t_hit: Tensor, pixel_id: Tensor, sample_idx,
                   steps: int = DEFAULT_STEPS) -> Tensor:
    """Rayleigh + Mie single scattering [N,3] (integrator_sky.cc:115-173):
    the source term from 24 fixed background directions weighted by the
    Rayleigh phase and the Mie table, then a transmittance-weighted march
    of the exponential density, jittered by rand1(pixel, sample, 39, 11)."""
    from ..backgrounds import eval_background
    alpha_r, alpha_m, b_r, b_m = sky_coeffs(cfg.sky_alpha, cfg.sky_turbidity)
    sc = cfg.sky_scale
    dev = o.device
    s = torch.where(t_hit > 0, t_hit, 1000.0) * sc
    # the source term: 3 zenith rings x 8 azimuths
    vs = torch.arange(3, dtype=torch.float32, device=dev)
    us = torch.arange(8, dtype=torch.float32, device=dev)
    theta = (vs * 0.3 + 0.2)[:, None] * 0.5 * math.pi
    phi = us[None, :] * (2.0 * math.pi / 8.0)
    w = torch.stack([torch.sin(theta) * torch.cos(phi),
                     torch.sin(theta) * torch.sin(phi),
                     torch.cos(theta) * torch.ones_like(phi)],
                    -1).reshape(-1, 3)
    l_s = eval_background(scene, w)                        # [24, 3]
    cos_wd = d @ w.T                                       # [n, 24]
    b_r_ang = b_r * 3.0 / (2.0 * math.pi * 8.0) * (1.0 + cos_wd * cos_wd)
    ang_deg = torch.acos(torch.clamp(cos_wd, -1.0, 1.0)) * (180.0 / math.pi)
    mie = interp(ang_deg, torch.from_numpy(_MIE_DEG).to(dev),
                 torch.from_numpy(_MIE_VAL).to(dev))
    b_m_ang = b_m / (2.0 * 0.67 * math.pi) * mie
    s0_r = b_r_ang @ l_s / 24.0                            # [n, 3]
    s0_m = b_m_ang @ l_s / 24.0

    cos_t = d[..., 2]
    h0 = o[..., 2] * sc
    step = s / steps
    jit0 = sampler.rand1(pixel_id, sample_idx, 39, 11)
    i_r = torch.zeros_like(s)
    i_m = torch.zeros_like(s)
    for k in range(steps):
        pos = (k + jit0) * step
        u_r = torch.exp(-alpha_r * (h0 + pos * cos_t))
        u_m = torch.exp(-alpha_m * (h0 + pos * cos_t))
        tr_r = torch.exp(-_sky_tau(b_r, alpha_r, sc, o, d, pos / sc))
        tr_m = torch.exp(-_sky_tau(b_m, alpha_m, sc, o, d, pos / sc))
        i_r = i_r + tr_r * u_r * step
        i_m = i_m + tr_m * u_m * step
    return s0_r * i_r[..., None] + s0_m * i_m[..., None]


def apply_volumetric(scene: SceneData, cfg, radiance: Tensor, o: Tensor,
                     d: Tensor, t_hit: Tensor, pixel_id: Tensor,
                     sample_idx, return_parts: bool = False):
    """The camera segment's share (applyVolumetricEffects,
    integrator_tiled.cc): transmittance times the surface radiance, plus
    the radiance the segment adds (cfg.vol_kind: the sky's, the regions'
    emission, or their single scattering), each marched in cfg.vol_steps
    steps. return_parts=True returns (transmittance, added radiance)
    instead, for the adv-volume-* AOV layers."""
    if cfg.vol_kind == "sky":
        tr = sky_transmittance(cfg, o, d, t_hit)
        vol = sky_in_scatter(scene, cfg, o, d, t_hit, pixel_id, sample_idx,
                             cfg.vol_steps)
    elif scene.volumes is None or scene.volumes.num_volumes == 0:
        if return_parts:
            return torch.ones_like(radiance), torch.zeros_like(radiance)
        return radiance
    else:
        tr = transmittance(scene, o, d, t_hit, cfg.vol_steps)
        if cfg.vol_kind == "emission":
            vol = emission(scene, o, d, t_hit, cfg.vol_steps)
        else:
            vol = in_scatter(scene, o, d, t_hit, pixel_id, sample_idx,
                             cfg.vol_steps, cfg.transparent_shadows,
                             substeps=cfg.vol_substeps if cfg.vol_adaptive
                             else 1)
    if return_parts:
        return tr, vol
    return tr * radiance + vol
