"""Vectorized BSDF table: eval / sample / emit for the whole wavefront.

Counterpart of `libyafaray_tpu/materials/bsdf.py` with the shiny-diffuse
material (`MAT_SHINY_DIFFUSE`), the only family the port compiles so far.
Its lobes, in the JAX package's numbering:

    lobe 0  delta reflect   (specular_reflect, optionally Fresnel-weighted)
    lobe 1  delta transmit  (transparency: passes straight through)
    lobe 3  diffuse reflect (Lambert)
    lobe 4  diffuse transmit (translucency)

The microfacet lobe 2 belongs to glossy and glass materials, which are not
ported yet; its weight is zero for every shiny-diffuse row. All math runs in
the local shading frame (z = n).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..math import vec
from ..scene_types import MaterialTable, SceneData

Tensor = torch.Tensor

# mat_flags bits
FLAG_FRESNEL = 1

_INV_PI = 1.0 / math.pi


@dataclass
class MP:
    """Per-lane material parameters."""
    diffuse_color: Tensor
    mirror_color: Tensor
    emit_color: Tensor
    specular_refl: Tensor
    transparency: Tensor
    translucency: Tensor
    diffuse_reflect: Tensor
    ior: Tensor
    mat_flags: Tensor
    # any row with fresnel_effect set (static hint, as in the JAX package)
    has_fresnel: bool = True


def gather_mp(mats: MaterialTable, mat_id: Tensor) -> MP:
    idx = mat_id.long()
    return MP(
        has_fresnel=mats.has_fresnel,
        diffuse_color=mats.diffuse_color[idx],
        mirror_color=mats.mirror_color[idx],
        emit_color=mats.emit_color[idx],
        specular_refl=mats.specular_refl[idx],
        transparency=mats.transparency[idx],
        translucency=mats.translucency[idx],
        diffuse_reflect=mats.diffuse_reflect[idx],
        ior=mats.ior[idx],
        mat_flags=mats.mat_flags[idx])


def lobe_weights(mp: MP, cos_wo: Tensor):
    """Per-lane weights of the delta-reflect, delta-transmit,
    diffuse-reflect and diffuse-transmit lobes, summing to <= 1: ShinyDiffuse's
    cumulative component accumulation (material_shiny_diffuse.cc)."""
    if mp.has_fresnel:
        kr_ior = vec.fresnel_dielectric(cos_wo, mp.ior)
        use_fresnel = (mp.mat_flags & FLAG_FRESNEL) != 0
        m = mp.specular_refl * torch.where(use_fresnel, kr_ior, 1.0)
    else:
        m = mp.specular_refl
    acc = 1.0 - m
    t = mp.transparency * acc
    acc = acc * (1.0 - mp.transparency)
    tl = mp.translucency * acc
    acc = acc * (1.0 - mp.translucency)
    di = mp.diffuse_reflect * acc
    return m, t, di, tl


def _eval_single(mp: MP, wo_l: Tensor, wi_l: Tensor):
    """Non-delta f and solid-angle pdf for one parameter row per lane."""
    cos_wo = torch.abs(wo_l[..., 2])
    w_dr, w_dt, w_di, w_tl = lobe_weights(mp, cos_wo)
    same_hemi = (wo_l[..., 2] * wi_l[..., 2]) > 0.0
    cos_wi = torch.abs(wi_l[..., 2])
    # diffuse reflect (Lambert)
    f_di = (w_di * _INV_PI)[..., None] * mp.diffuse_color
    f_di = torch.where(same_hemi[..., None], f_di, 0.0)
    pdf_di = torch.where(same_hemi, cos_wi * _INV_PI, 0.0)
    # diffuse transmit (translucency)
    f_tl = (w_tl * _INV_PI)[..., None] * mp.diffuse_color
    f_tl = torch.where(same_hemi[..., None], 0.0, f_tl)
    pdf_tl = torch.where(same_hemi, 0.0, cos_wi * _INV_PI)
    f = f_di + f_tl
    w_sum = w_dr + w_dt + w_di + w_tl
    pdf = (w_di * pdf_di + w_tl * pdf_tl) / torch.clamp_min(w_sum, 1e-6)
    return f, pdf


def _to_local(sp, w):
    return vec.to_local(w, sp.nu, sp.nv, sp.n)


def _from_local(sp, l):
    return vec.from_local(l, sp.nu, sp.nv, sp.n)


def eval_bsdf(scene: SceneData, sp, wo: Tensor, wi: Tensor):
    """f(wo, wi) of the non-delta lobes and the solid-angle pdf
    (Material::eval / pdf)."""
    mp = gather_mp(scene.materials, sp.mat_id)
    return _eval_single(mp, _to_local(sp, wo), _to_local(sp, wi))


@dataclass
class MatSample:
    wi: Tensor           # f32[N,3] sampled direction (world after sample_bsdf)
    weight: Tensor       # f32[N,3] throughput multiplier f*|cos|/pdf
    pdf: Tensor          # f32[N] solid-angle pdf (0 for delta lobes)
    is_delta: Tensor     # bool[N]
    is_transmit: Tensor  # bool[N] crossed to the other side of the surface
    valid: Tensor        # bool[N] sample produced any contribution
    lobe: Tensor         # i32[N] 0 delta-reflect, 1 delta-transmit,
                         # 3 diffuse, 4 translucent


def _sample_single(mp: MP, wo_l: Tensor, u1: Tensor, u2: Tensor, u3: Tensor
                   ) -> MatSample:
    cos_wo = torch.abs(wo_l[..., 2])
    w_dr, w_dt, w_di, w_tl = lobe_weights(mp, cos_wo)
    w_sum = w_dr + w_dt + w_di + w_tl
    valid = w_sum > 1e-6
    inv_sum = 1.0 / torch.clamp_min(w_sum, 1e-6)
    p_dr = w_dr * inv_sum
    p_dt = w_dt * inv_sum
    p_di = w_di * inv_sum
    c0 = p_dr
    c1 = c0 + p_dt
    c3 = c1 + p_di
    pick_dr = u3 < c0
    pick_dt = ~pick_dr & (u3 < c1)
    pick_di = ~pick_dr & ~pick_dt & (u3 < c3)

    sgn_wo = torch.sign(wo_l[..., 2:3])
    sgn_wo = torch.where(sgn_wo == 0, 1.0, sgn_wo)
    # delta reflect: mirror about local z
    wi_dr = torch.stack([-wo_l[..., 0], -wo_l[..., 1], wo_l[..., 2]], dim=-1)
    # delta transmit: shiny-diffuse transparency passes straight through
    wi_dt = -wo_l
    # diffuse lobes
    d_loc = vec.cosine_sample_hemisphere(u1, u2)
    wi_di = d_loc * sgn_wo     # same hemisphere as wo
    wi_tl = -d_loc * sgn_wo    # opposite hemisphere
    wi_l = torch.where(pick_dr[..., None], wi_dr,
                       torch.where(pick_dt[..., None], wi_dt,
                                   torch.where(pick_di[..., None], wi_di,
                                               wi_tl)))

    # combined eval at the sampled wi for an MIS-correct weight and pdf
    f, pdf_nd = _eval_single(mp, wo_l, wi_l)
    cos_wi = torch.abs(wi_l[..., 2])
    picked_delta = pick_dr | pick_dt
    # delta weights: color * lobe_weight / p_lobe (cos cancels)
    p_lobe_delta = torch.where(pick_dr, p_dr, p_dt)
    w_lobe_delta = torch.where(pick_dr, w_dr, w_dt)
    col_delta = torch.where(pick_dr[..., None], mp.mirror_color, 1.0)
    weight_delta = col_delta * (w_lobe_delta / torch.clamp_min(
        p_lobe_delta, 1e-9))[..., None]
    # non-delta weight: f * cos / pdf with the combined-estimator pdf
    pdf_safe = torch.clamp_min(pdf_nd, 1e-9)
    weight_nd = f * (cos_wi / pdf_safe)[..., None]
    weight = torch.where(picked_delta[..., None], weight_delta, weight_nd)
    pdf_out = torch.where(picked_delta, 0.0, pdf_nd)
    valid = valid & (picked_delta | (pdf_nd > 1e-9))
    is_transmit = (wi_l[..., 2] * wo_l[..., 2]) < 0.0
    lobe = torch.where(pick_dr, 0, torch.where(pick_dt, 1, torch.where(
        pick_di, 3, 4))).to(torch.int32)
    return MatSample(wi=wi_l, weight=weight, pdf=pdf_out,
                     is_delta=picked_delta, is_transmit=is_transmit,
                     valid=valid, lobe=lobe)


def sample_bsdf(scene: SceneData, sp, wo: Tensor, u1, u2, u3) -> MatSample:
    """Material::sample for the whole wavefront; `wi` comes back in world
    space."""
    mp = gather_mp(scene.materials, sp.mat_id)
    s = _sample_single(mp, _to_local(sp, wo), u1, u2, u3)
    s.wi = _from_local(sp, s.wi)
    return s


def emit(scene: SceneData, sp, wo: Tensor) -> Tensor:
    """Material emission toward wo (one-sided: front face, ng . wo > 0)."""
    mp = gather_mp(scene.materials, sp.mat_id)
    front = vec.dot(wo, sp.ng) > 0.0
    return torch.where((front & sp.valid)[..., None], mp.emit_color, 0.0)
