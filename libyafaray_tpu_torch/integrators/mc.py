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
not. Ambient occlusion (`do_AO`) adds its term at the first hit under
every integrator kind, as in the JAX package, and the debug integrator
renders the shading normal. `integrate` returns the AOV layers that
`cfg.aov_layers` names beside the radiance: the first-hit layers, and the
accumulated ones (env, shadow, indirect and its first-lobe splits, the
per-family direct splits, reflect and refract, the index-mask composites,
the volume parts). Every accumulator is gated on `cfg.aov_layers`, so a
render of `combined` alone runs what it ran without them. Photon mapping
is direct lighting with the photon maps' estimates at the hits (the
diffuse map's, or the final gather over the radiance cache, and the
caustic map's), on the lanes still alive; its final-gather estimate at
the first hit is the adv-radiance layer. The bidirectional integrator is
`integrators/bidir.py`; SPPM runs through `integrators/sppm.render_sppm`
(`integrate` traces type "SPPM" as the path tracer, as the JAX package
does).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Tuple

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
from ..textures.eval import mean_rgb
from . import common

Tensor = torch.Tensor

_KINDS = ("directlighting", "pathtracing", "DebugIntegrator", "debug",
          "photonmapping", "SPPM", "bidirectional")


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
    # ambient occlusion ("do_AO", TiledIntegrator::sampleAmbientOcclusion):
    # its samples, ray length and colour
    use_ao: bool = False
    ao_samples: int = 8
    ao_distance: float = 1.0
    ao_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # the AOV layers to return beside combined (`render` sets them from its
    # layer_names), and the index-mask layers' material / object index
    aov_layers: Tuple[str, ...] = ()
    mask_mat_index: int = 0
    mask_obj_index: int = 0
    mask_invert: bool = False
    # photon mapping (integrator_photon_mapping.cc's params): photons shot,
    # the gather radius ("diffuseRadius") and the photons' bounces
    n_photons: int = 100_000
    pm_radius: float = 0.05
    pm_bounces: int = 5
    # final gathering ("finalGather", on by default as in the reference):
    # gather rays per hit, their bounces, and the distance under which a
    # gather hit takes a direct-light estimate and bounces on instead of
    # reading the radiance cache ("fg_min_pathlen")
    final_gather: bool = True
    fg_samples: int = 16
    fg_bounces: int = 3
    fg_min_pathlen: float = 0.0
    # the path tracer's caustic mode ("none", "path", "photon", "both"):
    # parsed, and read nowhere, as in the JAX package (ROADMAP section 3)
    caustic_type: str = "path"


_VOL_KINDS = {"EmissionIntegrator": "emission",
              "SingleScatterIntegrator": "single_scatter",
              "SkyIntegrator": "sky", "none": "none"}


def make_integrator(pm: dict) -> IntegratorConfig:
    """Factory mirroring the reference's integrator type strings."""
    pm = P.ParamMap(pm)
    kind = pm.get_string("type", "pathtracing")
    if kind not in _KINDS:
        raise KeyError(f"integrator: unknown type {kind!r}")
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
        sky_scale=pm.get_float("sigma_t", 0.1),
        use_ao=pm.get_bool("do_AO", False),
        ao_samples=pm.get_int("AO_samples", 8),
        ao_distance=pm.get_float("AO_distance", 1.0),
        ao_color=tuple(pm.get_color("AO_color", (1, 1, 1))[:3].tolist()),
        mask_mat_index=pm.get_int("layer_mask_mat_index", 0),
        mask_obj_index=pm.get_int("layer_mask_obj_index", 0),
        mask_invert=pm.get_bool("layer_mask_invert", False),
        n_photons=pm.get_int("photons", 100_000),
        # diffuseRadius falls back to causticRadius, then to 0.05
        pm_radius=pm.get_float("diffuseRadius",
                               pm.get_float("causticRadius", 0.05)),
        pm_bounces=(pm.get_int("bounces", 5) if kind == "photonmapping"
                    else 5),
        caustic_type=pm.get_string("caustic_type", "path"),
        final_gather=pm.get_bool("finalGather", True),
        fg_samples=pm.get_int("fg_samples", 16),
        fg_bounces=pm.get_int("fg_bounces", 3),
        # fg_min_pathlen falls back to diffuseRadius (not to causticRadius)
        fg_min_pathlen=pm.get_float("fg_min_pathlen",
                                    pm.get_float("diffuseRadius", 0.05)))


def _sample_ambient_occlusion(scene: SceneData, cfg: IntegratorConfig, sp,
                              pixel_id: Tensor, sample_idx) -> Tensor:
    """The AO estimate at the hits (TiledIntegrator::sampleAmbientOcclusion,
    integrator_tiled.cc:644): `ao_samples` cosine-distributed shadow rays
    of length `ao_distance`, each a query of its own."""
    col = torch.zeros_like(sp.p)
    ao_col = torch.tensor(cfg.ao_color, dtype=torch.float32,
                          device=sp.p.device)
    dist = torch.full(sp.t.shape, cfg.ao_distance, dtype=torch.float32,
                      device=sp.p.device)
    for s in range(cfg.ao_samples):
        u1, u2 = sampler.rand2(pixel_id, sample_idx, 900 + s, 0)
        wi = vec.from_local(vec.cosine_sample_hemisphere(u1, u2), sp.nu,
                            sp.nv, sp.n)
        tr = common.trace_shadow(scene, sp.p, sp.prim, wi, dist,
                                 cfg.transparent_shadows, needed=sp.valid)
        col = col + ao_col * tr / cfg.ao_samples
    return torch.where(sp.valid[..., None], col, 0.0)


def _lanes(sp, idx: Tensor):
    """The surface points of lanes `idx` (every tensor field indexed)."""
    return dataclasses.replace(sp, **{
        f.name: getattr(sp, f.name)[idx] for f in dataclasses.fields(sp)
        if isinstance(getattr(sp, f.name), Tensor)})


def _photon_estimates(scene: SceneData, cfg: IntegratorConfig, sp,
                      alive: Tensor, pixel_id: Tensor, sample_idx, depth):
    """The photon-map estimates at the hits of the lanes still alive (the
    others are zero): (diffuse or final-gather, caustic), each f32[N,3].
    The JAX package estimates every lane and masks the dead ones after;
    each lane's value is its own, so the compacted batch gives the same
    values at a fraction of the gathers (under photon mapping a path goes
    on past a diffuse hit only through delta bounces)."""
    from .. import photon as PH
    ph = scene.photons
    ind = torch.zeros_like(sp.p)
    cau = torch.zeros_like(sp.p)
    idx = torch.nonzero(alive).squeeze(1)
    if idx.numel() == 0:
        return ind, cau
    spa = _lanes(sp, idx)
    if cfg.final_gather and ph.radiance is not None:
        ind_a = _final_gather(scene, cfg, spa, pixel_id[idx], sample_idx,
                              depth)
    else:
        ind_a = PH.estimate_radiance(ph.diffuse, scene, spa, None,
                                     ph.n_emitted)
    cau_a = PH.estimate_radiance(ph.caustic, scene, spa, None, ph.n_emitted)
    return ind.index_put((idx,), ind_a), cau.index_put((idx,), cau_a)


def _final_gather(scene: SceneData, cfg: IntegratorConfig, sp,
                  pixel_id: Tensor, sample_idx, depth) -> Tensor:
    """Final gathering over the radiance cache (PhotonIntegrator::
    finalGathering, integrator_photon_mapping.cc:643-765, with fg_bounces
    and fg_min_pathlen): `fg_samples` cosine-distributed gather rays per
    hit. A gather hit farther than fg_min_pathlen (or at the last bounce)
    reads the cached outgoing radiance, and its lane is done; a nearer hit
    does not trust the blurry cache: it takes a one-light direct estimate
    there and bounces diffusely on, up to fg_bounces. With fg_min_pathlen
    0 every lane ends at its first hit. The estimator is
    albedo * mean(L) (the cosine and the pdf cancel). Each bounce after
    the first runs on the near lanes only, compacted."""
    from .. import photon as PH
    n = sp.p.shape[0]
    dev = sp.p.device
    cache = scene.photons.radiance
    nl_real = scene.lights.num_lights
    nl = max(nl_real, 1)
    bias = scene.shadow_bias
    acc = torch.zeros_like(sp.p)
    n_bounce = max(int(cfg.fg_bounces), 1) if cfg.fg_min_pathlen > 0 else 1
    for k in range(cfg.fg_samples):
        u1, u2 = sampler.rand2(pixel_id, sample_idx, depth, 9500 + 2 * k)
        wi = vec.from_local(vec.cosine_sample_hemisphere(u1, u2), sp.nu,
                            sp.nv, sp.n)
        o = sp.p + wi * bias
        thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
        lanes = torch.arange(n, device=dev)
        t_far = torch.where(sp.valid, 1e30, -1.0)
        prim = sp.prim
        for b in range(n_bounce):
            hit = I.closest_hit(scene, o, wi, scene.ray_min_dist, t_far,
                                exclude_prim=prim)
            hit.valid = hit.valid & (t_far > 0.0)
            gsp = S.make_surface(scene, hit, o, wi)
            last = b == n_bounce - 1
            close = hit.valid & (hit.t < cfg.fg_min_pathlen)
            if last:
                close = torch.zeros_like(close)
            # far (or last-bounce) hits read the cache
            far = torch.nonzero(hit.valid & ~close).squeeze(1)
            if far.numel():
                rad = PH.lookup_radiance(cache, gsp.p[far], gsp.n[far])
                acc = acc.index_add(0, lanes[far], thr[far] * rad)
            if cfg.fg_min_pathlen <= 0 or last:
                break
            near = torch.nonzero(close).squeeze(1)
            if near.numel() == 0:
                break
            # near hits: a one-light direct estimate, then a diffuse bounce
            lanes, gsp, wi, thr = lanes[near], _lanes(gsp, near), wi[near], \
                thr[near]
            pid = pixel_id[lanes]
            r = sampler.rand4(pid, sample_idx, depth, 9700 + 8 * k + 2 * b)
            if nl_real > 0:
                li = torch.clamp((r[..., 0] * nl).to(torch.int32), 0, nl - 1)
                c = common.estimate_one_light(scene, gsp, -wi, li, r[..., 1],
                                              r[..., 2],
                                              cfg.transparent_shadows)
                acc = acc.index_add(0, lanes, thr * c * nl)
            u5, u6 = sampler.rand2(pid, sample_idx, depth,
                                   9800 + 8 * k + 2 * b)
            thr = thr * B.resolve_mp(scene, gsp).diffuse_color
            wi = vec.from_local(vec.cosine_sample_hemisphere(u5, u6), gsp.nu,
                                gsp.nv, gsp.n)
            o = gsp.p + wi * bias
            prim = gsp.prim
            t_far = torch.full((lanes.numel(),), 1e30, device=dev)
    return B.resolve_mp(scene, sp).diffuse_color * acc / cfg.fg_samples


# the AOV layers of each accumulator (JAX integrators/mc.py:277-309)
_IND_LAYERS = ("indirect", "diffuse-indirect", "glossy-indirect",
               "adv-indirect", "adv-diffuse-indirect", "adv-glossy-indirect",
               "adv-trans-indirect", "adv-subsurface-indirect")
_SHADOW_LAYERS = ("shadow", "mat-index-mask-shadow", "obj-index-mask-shadow")
_FAMILY_LAYERS = ("diffuse", "diffuse-noshadow", "adv-glossy", "adv-trans",
                  "adv-subsurface", "debug-light-estimation-light-dirac",
                  "debug-light-estimation-light-sampling")
_FAMILIES = ("diffuse", "glossy", "trans", "subsurface", "diffuse-noshadow",
             "light-dirac", "light-sampling")
# first-bounce lobe splits of indirect; lobe ids: 0 delta reflect, 1 delta
# transmit, 2 microfacet, 3 diffuse, 4 translucent
_LOBE_SPLITS = (("diffuse-indirect", (3,)), ("adv-diffuse-indirect", (3,)),
                ("glossy-indirect", (2,)), ("adv-glossy-indirect", (2,)),
                ("adv-trans-indirect", (1,)),
                ("adv-subsurface-indirect", (4,)),
                # light arriving through a first specular / delta bounce
                ("adv-indirect", (0, 1)))
_FAMILY_NAMES = (("diffuse", "diffuse"),
                 ("diffuse-noshadow", "diffuse-noshadow"),
                 ("glossy", "adv-glossy"), ("trans", "adv-trans"),
                 ("subsurface", "adv-subsurface"),
                 ("light-dirac", "debug-light-estimation-light-dirac"),
                 ("light-sampling", "debug-light-estimation-light-sampling"))
_VOLPART_LAYERS = ("adv-surface-integration", "adv-volume-integration",
                   "adv-volume-transmittance")


def integrate(scene: SceneData, cfg: IntegratorConfig,
              ray_o: Tensor, ray_d: Tensor, ray_valid: Tensor,
              pixel_id: Tensor, sample_idx
              ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """Trace one wavefront of camera rays to completion.

    Returns (rgb f32[N,3], alpha f32[N], {AOV layer: f32[N,C]})."""
    if cfg.kind in ("debug", "DebugIntegrator"):
        return _integrate_debug(scene, ray_o, ray_d, ray_valid)
    if cfg.kind == "bidirectional":
        from .bidir import integrate_bidir
        return integrate_bidir(scene, cfg, ray_o, ray_d, ray_valid, pixel_id,
                               sample_idx)
    n = ray_o.shape[0]
    dev = ray_o.device
    mats = scene.materials
    num_lights = scene.lights.num_lights
    # photon mapping is direct lighting (specular continuation only) plus
    # the photon-map estimates at the hits; "SPPM" runs the path tracer
    # here, as in the JAX package (only render_sppm runs SPPM)
    photon_mode = cfg.kind == "photonmapping" and scene.photons is not None
    direct_only = cfg.kind in ("directlighting", "photonmapping")
    zeros3 = lambda: torch.zeros((n, 3), dtype=torch.float32, device=dev)
    radiance = zeros3()
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
        if scene.fixed_wavelength is not None:
            # a spectral render view (RenderView::getWaveLength): every
            # path takes the view's wavelength
            path_wl = torch.where(scene.fixed_wavelength > 0.0,
                                  scene.fixed_wavelength, path_wl)
        chromatic = torch.zeros((n,), dtype=torch.bool, device=dev)
    # the glass interiors (the reference's 'beer' and 'sss' volume
    # handlers, integrator_path_tracer.cc): the material whose interior
    # each path is in, or -1
    track_medium = (mats.has_beer or mats.has_sss) and not direct_only
    if track_medium:
        medium_mat = torch.full((n,), -1, dtype=torch.int32, device=dev)

    # the accumulated AOV layers, each only when a layer of it is asked
    # for: env, shadow and indirect with its first-lobe splits accumulate
    # during the walk (the reference's layer_definitions.h:36-111)
    layers = cfg.aov_layers
    want_env = "env" in layers
    want_ind = any(x in layers for x in _IND_LAYERS)
    want_shadow = any(x in layers for x in _SHADOW_LAYERS)
    # per-BSDF-family and per-technique direct-light splits at the first
    # hit (ColorLayerAccum in doLightEstimation, integrator_montecarlo.cc)
    want_family = any(x in layers for x in _FAMILY_LAYERS)
    want_matsamp = "debug-light-estimation-mat-sampling" in layers
    aux: Dict[str, Tensor] = {}
    env_acc = zeros3() if (want_env or want_ind) else None
    shadow_acc = zeros3() if want_shadow else None
    fam_acc = {k: zeros3() for k in _FAMILIES} if want_family else None
    matsamp_acc = zeros3() if want_matsamp else None
    env_d0 = None
    # the first bounce's lobe, read by the indirect lobe splits (set at
    # depth 0; -1 where no bounce was taken)
    first_lobe = (torch.full((n,), -1, dtype=torch.int32, device=dev)
                  if want_ind else None)

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
        bg_add = torch.where(escaped[..., None], bg_add, 0.0)
        radiance = radiance + bg_add
        if env_acc is not None:
            env_acc = env_acc + bg_add
        if depth == 0:
            aux = _first_hit_layers(scene, cfg, sp, d)
            first_hit_t = torch.where(hit.valid, hit.t, first_hit_t)
            first_mat_id, first_obj_id = sp.mat_id, sp.obj_id
            first_valid = sp.valid
        alpha = torch.where(hit.valid & (depth == 0), 1.0, alpha)
        # lanes that bounced at least once keep alpha 1 when they escape
        if depth > 0:
            alpha = torch.where(alive, torch.clamp_min(alpha, 1.0), alpha)
        alive = alive & hit.valid

        # emission at the hit, MIS-weighted against NEE
        mis_w = common.hit_light_mis_weight(scene, sp, prev_p, prev_pdf,
                                            prev_delta)
        emit = common.emitted_radiance(scene, sp, wo)
        emit_add = torch.where(
            alive[..., None], throughput * emit * mis_w[..., None], 0.0)
        radiance = radiance + emit_add
        if want_matsamp and depth > 0:
            # the material-sampling share of the light estimate: emission
            # reached by a sampled non-delta bounce, MIS-weighted
            matsamp_acc = matsamp_acc + torch.where(
                (~prev_delta)[..., None], emit_add, 0.0)
        # area-light quads (face_obj == -1) are pure emitters
        alive = alive & ~((sp.light_id >= 0) & (sp.obj_id < 0))

        # next-event estimation: every light, every bounce (the JAX
        # package's default); direct lighting honours each light's sample
        # count, the path tracer takes one sample per light
        want_si = want_shadow and depth == 0
        want_fs = want_family and depth == 0
        for li_static in range(num_lights):
            ns = 1
            if direct_only and scene.lights.samples_static:
                ns = scene.lights.samples_static[li_static]
            li = torch.full((n,), li_static, dtype=torch.int32, device=dev)
            for k in range(ns):
                u1, u2 = sampler.rand2(pixel_id, sample_idx, depth,
                                       10 + 2 * li_static + 100 * k)
                res = common.estimate_one_light(
                    scene, sp, wo, li, u1, u2, cfg.transparent_shadows,
                    time=ray_time, with_shadow_info=want_si,
                    with_family_split=want_fs)
                c = res[0] if (want_si or want_fs) else res
                wt = 1.0 / ns
                radiance = radiance + torch.where(
                    alive[..., None], throughput * c * wt, 0.0)
                if want_si:
                    shadow_acc = shadow_acc + torch.where(
                        alive[..., None], (res[1] - c) * wt, 0.0)
                if want_fs:
                    for k_ in fam_acc:
                        fam_acc[k_] = fam_acc[k_] + torch.where(
                            alive[..., None], throughput * res[-1][k_] * wt,
                            0.0)

        if photon_mode:
            # the diffuse (or final-gather) and caustic estimates at the
            # hits; the final gather's radiance estimate at the primary hit
            # is the adv-radiance layer
            ind, cau = _photon_estimates(scene, cfg, sp, alive, pixel_id,
                                         sample_idx, depth)
            radiance = radiance + torch.where(
                alive[..., None], throughput * (ind + cau), 0.0)
            if "adv-radiance" in layers and depth == 0:
                aux["adv-radiance"] = torch.where(alive[..., None], ind, 0.0)

        if cfg.use_ao and depth == 0:
            # ambient occlusion at the first hit, under every integrator
            # kind as in the JAX package (the reference's direct-light
            # option)
            ao = _sample_ambient_occlusion(scene, cfg, sp, pixel_id,
                                           sample_idx)
            mp = B.resolve_mp(scene, sp)
            radiance = radiance + torch.where(
                alive[..., None],
                throughput * ao * mp.diffuse_color / math.pi, 0.0)
            for name in ("ao", "ao-clay"):
                if name in layers:
                    aux[name] = torch.where(alive[..., None], ao, 0.0)

        if depth == 0:
            # what arrives after the first hit is the first bounce's: the
            # snapshot for indirect, reflect and refract
            radiance_d0 = radiance
            env_d0 = env_acc

        if depth == max_depth - 1:
            break

        # BSDF sampling / continuation
        r = sampler.rand4(pixel_id, sample_idx, depth, 2)
        u1, u2, u3, u_rr = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
        ms = B.sample_bsdf(scene, sp, wo, u1, u2, u3, wl=path_wl)
        if depth == 0 and layers:
            transmitted = vec.dot(ms.wi, sp.ng) * vec.dot(wo, sp.ng) < 0.0
            side = torch.where(transmitted, 2, 1)
            path_kind = torch.where(alive & ms.valid & ms.is_delta, side, 0)
            if want_ind:
                first_lobe = torch.where(alive & ms.valid, ms.lobe, -1)
            # ReflectAll / RefractAll: any non-diffuse first bounce (delta
            # or microfacet), split by side
            nondiff = alive & ms.valid & (ms.lobe != 3) & (ms.lobe != 4)
            path_kind_all = torch.where(nondiff, side, 0)
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

    if want_env:
        aux["env"] = env_acc
    if want_shadow:
        aux["shadow"] = shadow_acc
    if want_ind:
        # indirect: everything added after the first hit but the
        # background's share, so combined == radiance_d0 + env_after_d0 +
        # indirect (the closure tests/test_render.py pins for JAX)
        indirect = radiance - radiance_d0 - (env_acc - env_d0)
        if "indirect" in layers:
            aux["indirect"] = indirect
        for name, lobes in _LOBE_SPLITS:
            if name in layers:
                m = torch.zeros_like(first_lobe, dtype=torch.bool)
                for lb in lobes:
                    m = m | (first_lobe == lb)
                aux[name] = torch.where(m[..., None], indirect, 0.0)
    if max_depth > 1 and any(x in layers for x in (
            "reflect", "refract", "adv-reflect", "adv-refract")):
        # reflect / refract: any non-diffuse first bounce (ReflectAll /
        # RefractAll); adv-reflect / adv-refract: the delta-only pair
        extra = radiance - radiance_d0
        for name, kind, which in (("reflect", path_kind_all, 1),
                                  ("refract", path_kind_all, 2),
                                  ("adv-reflect", path_kind, 1),
                                  ("adv-refract", path_kind, 2)):
            if name in layers:
                aux[name] = torch.where((kind == which)[..., None], extra,
                                        0.0)
    if want_family:
        for src, name in _FAMILY_NAMES:
            if name in layers:
                aux[name] = fam_acc[src]
    if want_matsamp:
        aux["debug-light-estimation-mat-sampling"] = matsamp_acc
    # the index-mask composites (MatIndexMaskAll / Shadow)
    for prefix, ids, want_idx in (("mat", first_mat_id, cfg.mask_mat_index),
                                  ("obj", first_obj_id, cfg.mask_obj_index)):
        m_all = f"{prefix}-index-mask-all"
        m_sh = f"{prefix}-index-mask-shadow"
        if m_all in layers or m_sh in layers:
            msk = first_valid & (ids == want_idx)
            if cfg.mask_invert:
                msk = first_valid & ~msk
            if m_all in layers:
                aux[m_all] = torch.where(msk[..., None], radiance, 0.0)
            if m_sh in layers:
                aux[m_sh] = torch.where(msk[..., None], shadow_acc, 0.0)

    # the camera segment through the volume regions or the atmosphere
    # (applyVolumetricEffects, integrator_tiled.cc):
    # L = T(segment) * L_surface + L_volume(segment)
    want_volparts = any(x in layers for x in _VOLPART_LAYERS)
    if want_volparts:
        aux["adv-surface-integration"] = radiance
    if (scene.volumes is not None or cfg.vol_kind == "sky") \
            and cfg.vol_kind != "none":
        from .volume import apply_volumetric
        if want_volparts:
            tr_seg, vol_add = apply_volumetric(
                scene, cfg, radiance, ray_o, ray_d, first_hit_t, pixel_id,
                sample_idx, return_parts=True)
            radiance = tr_seg * radiance + vol_add
            aux["adv-volume-integration"] = vol_add
            aux["adv-volume-transmittance"] = mean_rgb(
                tr_seg * torch.ones((n, 3), device=dev))[..., None]
        else:
            radiance = apply_volumetric(scene, cfg, radiance, ray_o, ray_d,
                                        first_hit_t, pixel_id, sample_idx)
    elif want_volparts:
        aux["adv-volume-integration"] = zeros3()
        aux["adv-volume-transmittance"] = torch.ones(
            (n, 1), dtype=torch.float32, device=dev)
    return radiance, torch.clamp(alpha, 0.0, 1.0), aux


def _first_hit_layers(scene: SceneData, cfg: IntegratorConfig, sp,
                      d: Tensor) -> Dict[str, Tensor]:
    """The AOV layers read at the primary hit (generateCommonLayers,
    integrator_tiled.cc:410)."""
    out: Dict[str, Tensor] = {}
    if not cfg.aov_layers:
        return out
    v = sp.valid[..., None]
    zero = lambda x: torch.zeros_like(x[..., :1])
    mp = None

    def params():
        nonlocal mp
        if mp is None:
            mp = B.resolve_mp(scene, sp)
        return mp

    def unit(x):        # a direction mapped to [0, 1]
        return x * 0.5 + 0.5

    for name in cfg.aov_layers:
        val = None
        if name in ("normal-smooth", "debug-normal-smooth"):
            val = unit(sp.n)
        elif name in ("normal-geom", "debug-normal-geom"):
            val = unit(sp.ng)
        elif name in ("z-depth-abs", "z-depth-norm", "mist"):
            val = sp.t[..., None]          # z-depth-norm is normalized later
        elif name in ("uv", "debug-uv"):
            val = torch.cat([sp.uv, zero(sp.uv)], -1)
        elif name in ("albedo", "adv-diffuse-color"):
            val = params().diffuse_color
        elif name == "mat-index-abs":
            val = sp.mat_id[..., None].to(torch.float32)
        elif name == "obj-index-abs":
            val = sp.obj_id[..., None].to(torch.float32)
        elif name == "emit":
            val = common.emitted_radiance(scene, sp, -d)
        elif name in ("debug-nu", "debug-dsdu"):
            # the shading-space tangents dSdU / dSdV are the bump-mapped
            # frame's nu / nv
            val = unit(sp.nu)
        elif name in ("debug-nv", "debug-dsdv"):
            val = unit(sp.nv)
        elif name == "debug-dpdu":
            val = unit(vec.normalize(sp.dp_du))
        elif name == "debug-dpdv":
            val = unit(vec.normalize(sp.dp_dv))
        elif name == "debug-dpdx" and sp.dp_dx is not None:
            val = unit(vec.normalize(sp.dp_dx))
        elif name == "debug-dpdy" and sp.dp_dy is not None:
            val = unit(vec.normalize(sp.dp_dy))
        elif name == "debug-dpdxy" and sp.dp_dx is not None:
            val = unit(vec.normalize(sp.dp_dx + sp.dp_dy))
        elif name == "debug-barycentric-uvw":
            u_, v_ = sp.bary[..., 0], sp.bary[..., 1]
            val = torch.stack([1.0 - u_ - v_, u_, v_], -1)
        elif name == "debug-wireframe":
            u_, v_ = sp.bary[..., 0], sp.bary[..., 1]
            edge = torch.minimum(torch.minimum(u_, v_), 1.0 - u_ - v_)
            wire = torch.clamp(1.0 - edge / 0.02, 0.0, 1.0)[..., None]
            val = wire * torch.ones(3, device=wire.device)
        elif name == "mat-index-norm":
            m = max(scene.materials.mat_type.shape[0], 1)
            val = sp.mat_id[..., None].to(torch.float32) / m
        elif name == "obj-index-norm":
            m = torch.clamp_min(scene.geom.face_obj.max(), 1).to(
                torch.float32)
            val = sp.obj_id[..., None].to(torch.float32) / m
        elif name in ("mat-index-auto", "mat-index-auto-abs",
                      "obj-index-auto", "obj-index-auto-abs"):
            val = _auto_index_color(sp.mat_id if name.startswith("mat")
                                    else sp.obj_id)
        elif name in ("mat-index-mask", "obj-index-mask"):
            idx, want = ((sp.mat_id, cfg.mask_mat_index)
                         if name.startswith("mat")
                         else (sp.obj_id, cfg.mask_obj_index))
            m = idx == want
            if cfg.mask_invert:
                m = ~m
            out[name] = torch.where(v & m[..., None], 1.0,
                                    torch.zeros_like(sp.p))
            continue
        elif name == "adv-glossy-color":
            val = params().glossy_color
        elif name == "adv-trans-color":
            val = params().filter_color
        elif name == "adv-subsurface-color":
            val = params().translucency[..., None] * params().diffuse_color
        elif name == "debug-sampling-factor":
            # the JAX compile sets every material's sampling factor to 1
            # (JAX scene.py:417); the port's table has no such column
            val = torch.ones_like(sp.t)[..., None]
        elif name == "debug-dp-lengths":
            val = torch.stack([vec.length(sp.dp_du), vec.length(sp.dp_dv),
                               torch.zeros_like(sp.t)], -1)
        elif name == "debug-dudx-dvdx" and sp.duv_dx is not None:
            val = torch.cat([sp.duv_dx, zero(sp.duv_dx)], -1)
        elif name == "debug-dudy-dvdy" and sp.duv_dy is not None:
            val = torch.cat([sp.duv_dy, zero(sp.duv_dy)], -1)
        elif name == "debug-dudxy-dvdxy" and sp.duv_dx is not None:
            duv = sp.duv_dx + sp.duv_dy
            val = torch.cat([duv, zero(duv)], -1)
        if val is not None:
            out[name] = torch.where(v, val, 0.0)
    return out


def _auto_index_color(idx: Tensor) -> Tensor:
    """A hash colour per index (the *-index-auto layers). The JAX package
    multiplies in uint32: held here in int64 through the sampler's
    `_mul32`, which keeps the low 32 bits exact."""
    h = sampler._mul32(idx.to(torch.int64) & sampler.M32, 0x9E3779B9)
    return torch.stack([((h >> s) & 0x3FF).to(torch.float32) / 1023.0
                        for s in (0, 10, 20)], -1)


def _integrate_debug(scene: SceneData, ray_o: Tensor, ray_d: Tensor,
                     ray_valid: Tensor):
    """The debug integrator (integrator_debug.cc): the shading normal as a
    colour at the camera hits, alpha 1 where a ray hits."""
    hit = I.camera_hit(scene, ray_o, ray_d, scene.ray_min_dist, 1e30)
    hit.valid = hit.valid & ray_valid
    sp = S.make_surface(scene, hit, ray_o, ray_d)
    rgb = torch.where(sp.valid[..., None], sp.n * 0.5 + 0.5, 0.0)
    return rgb, sp.valid.to(torch.float32), {}
