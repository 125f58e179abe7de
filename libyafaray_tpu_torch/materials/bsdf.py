"""Vectorized BSDF table: eval / sample / emit / transparency for the whole
wavefront.

Counterpart of `libyafaray_tpu/materials/bsdf.py` with every material type:
shiny-diffuse, glossy and coated glossy (with the Lambert or the Oren-Nayar
diffuse BRDF), glass (with chromatic dispersion) and rough glass, mirror,
null, light (emission only), blend and mask. Their lobes, in the JAX
package's numbering:

    lobe 0  delta reflect   (specular_reflect, optionally Fresnel-weighted;
                             mirror; glass reflection; the coated-glossy
                             coat)
    lobe 1  delta transmit  (transparency: passes straight through; glass
                             refraction, a reflection under total internal
                             reflection)
    lobe 2  microfacet      (glossy and coated glossy: Blinn or
                             Ashikhmin-Shirley reflection; rough glass: GGX
                             reflection and refraction)
    lobe 3  diffuse reflect (Lambert or Oren-Nayar)
    lobe 4  diffuse transmit (translucency)

Each family's lobe weights are evaluated for the whole wavefront and picked
per lane by its material type; the lobe math of a family absent from the
scene (`MaterialTable.present_types`, `has_oren`, `has_aniso`,
`has_fresnel`) is not evaluated, and the blend and mask indirections run
only in scenes with such materials (`has_blend`, `has_mask`). All math runs
in the local shading frame (z = n), and every float parameter is
differentiable: `gather_mp` gathers the columns through `ops.fast_grad.take`,
whose backward reduces onto the table with one-hot products, as the JAX
package's does. `resolve_mp` picks a mask material's sub-material by its
factor against its threshold, then applies the shader-node overrides
(`materials/nodes.py`) of the channels a material binds to nodes;
`eval_bsdf`, `sample_bsdf`, `emit` and `transparency` go through it, as in
the JAX package. A blend material lerps its two sub-materials' f and pdf
in `eval_bsdf` and picks one of them by the blend factor in `sample_bsdf`
(material_blend.cc).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..math import vec
from ..ops.fast_grad import take
from ..scene_types import (MAT_BLEND, MAT_COATED_GLOSSY, MAT_GLASS,
                           MAT_GLOSSY, MAT_MASK, MAT_MIRROR, MAT_NULL,
                           MAT_ROUGH_GLASS, MAT_SHINY_DIFFUSE, MaterialTable,
                           SceneData)
from . import microfacet as mf

Tensor = torch.Tensor

# mat_flags bits
FLAG_FRESNEL = 1
FLAG_ANISOTROPIC = 2
FLAG_AS_DIFFUSE = 4
FLAG_FAKE_SHADOWS = 8

_INV_PI = 1.0 / math.pi

# the float columns of the material table, gathered per lane
_COLUMNS = ("diffuse_color", "glossy_color", "mirror_color", "filter_color",
            "emit_color", "specular_refl", "transparency", "translucency",
            "diffuse_reflect", "glossy_reflect", "exponent", "exp_u", "exp_v",
            "ior")


@dataclass
class MP:
    """Per-lane material parameters."""
    mat_type: Tensor
    diffuse_color: Tensor
    glossy_color: Tensor
    mirror_color: Tensor
    filter_color: Tensor
    emit_color: Tensor
    specular_refl: Tensor
    transparency: Tensor
    translucency: Tensor
    diffuse_reflect: Tensor
    glossy_reflect: Tensor
    exponent: Tensor
    exp_u: Tensor
    exp_v: Tensor
    ior: Tensor
    mat_flags: Tensor
    # Oren-Nayar sigma (gathered when some row has one) and the GGX
    # roughness (when rough glass is present)
    sigma: Optional[Tensor] = None
    alpha: Optional[Tensor] = None
    # static hints copied from the table, as in the JAX package: the
    # material families present, and whether any row uses Fresnel
    # weighting, an anisotropic lobe or the Oren-Nayar BRDF
    present: tuple = ()
    has_fresnel: bool = True
    has_aniso: bool = True
    has_oren: bool = False

    def has(self, ty: int) -> bool:
        return not self.present or ty in self.present


def gather_mp(mats: MaterialTable, mat_id: Tensor) -> MP:
    idx = mat_id.long()
    present = mats.present_types
    rough = not present or MAT_ROUGH_GLASS in present
    return MP(present=present, has_fresnel=mats.has_fresnel,
              has_aniso=mats.has_aniso, has_oren=mats.has_oren,
              mat_type=mats.mat_type[idx], mat_flags=mats.mat_flags[idx],
              sigma=(take(mats.sigma, idx, "sigma") if mats.has_oren
                     else None),
              alpha=take(mats.alpha, idx, "alpha") if rough else None,
              **{f: take(getattr(mats, f), idx, f) for f in _COLUMNS})


def blend_factor(scene: SceneData, sp) -> Tensor:
    """The blend factor of each lane's material (a blend's weight of its
    second material, a mask's value against its threshold): its constant,
    or the node it binds."""
    mats = scene.materials
    idx = sp.mat_id.long()
    val = take(mats.blend_value, idx, "blend_value")
    if scene.nodes is not None and "node_blend" in scene.nodes.bound:
        from . import nodes as node_mod
        node_id = mats.node_blend[idx]
        val = torch.where(node_id >= 0,
                          node_mod.eval_scalar_slot(scene, sp, node_id), val)
    return val


def _mask_id(scene: SceneData, sp, mat_id: Tensor) -> Tensor:
    """mat_id with each mask material replaced by the sub-material its
    factor picks: material 2 above the threshold (material_mask.cc)."""
    mats = scene.materials
    idx = mat_id.long()
    is_mask = mats.mat_type[idx] == MAT_MASK
    above = blend_factor(scene, sp) > mats.blend_value[idx]
    eff = torch.where(above, mats.blend_b[idx], mats.blend_a[idx])
    return torch.where(is_mask, eff, mat_id)


def resolve_mp(scene: SceneData, sp, mat_id: Optional[Tensor] = None) -> MP:
    """gather_mp after the mask indirection, then the shader-node
    overrides."""
    if mat_id is None:
        mat_id = sp.mat_id
    if scene.materials.has_mask:
        mat_id = _mask_id(scene, sp, mat_id)
    mp = gather_mp(scene.materials, mat_id)
    if scene.nodes is not None and scene.nodes.num_nodes > 0:
        from . import nodes as node_mod
        mp = node_mod.apply_overrides(scene, sp, mat_id, mp)
    return mp


def _flag(flags: Tensor, bit: int) -> Tensor:
    return (flags & bit) != 0


def lobe_weights(mp: MP, cos_wo: Tensor):
    """Per-lane weights of the five lobes, summing to <= 1: ShinyDiffuse's
    cumulative component accumulation (material_shiny_diffuse.cc), each
    other material's own split."""
    zero = torch.zeros_like(cos_wo)
    w_dr = w_dt = w_mf = w_di = w_tl = zero
    need_kr = (mp.has_fresnel or mp.has(MAT_COATED_GLOSSY)
               or mp.has(MAT_GLASS))
    kr_ior = vec.fresnel_dielectric(cos_wo, mp.ior) if need_kr else None
    ty = mp.mat_type
    if mp.has(MAT_SHINY_DIFFUSE):
        if mp.has_fresnel:
            use_fresnel = _flag(mp.mat_flags, FLAG_FRESNEL)
            m = mp.specular_refl * torch.where(use_fresnel, kr_ior, 1.0)
        else:
            m = mp.specular_refl
        acc = 1.0 - m
        t = mp.transparency * acc
        acc = acc * (1.0 - mp.transparency)
        tl = mp.translucency * acc
        acc = acc * (1.0 - mp.translucency)
        di = mp.diffuse_reflect * acc
        is_sd = ty == MAT_SHINY_DIFFUSE
        w_dr = torch.where(is_sd, m, w_dr)
        w_dt = torch.where(is_sd, t, w_dt)
        w_tl = torch.where(is_sd, tl, w_tl)
        w_di = torch.where(is_sd, di, w_di)
    if mp.has(MAT_GLOSSY):
        is_gl = ty == MAT_GLOSSY
        w_mf = torch.where(is_gl, mp.glossy_reflect, w_mf)
        w_di = torch.where(is_gl, mp.diffuse_reflect
                           * (1.0 - mp.glossy_reflect), w_di)
    if mp.has(MAT_COATED_GLOSSY):
        # a delta coat by the dielectric Fresnel over glossy + diffuse
        is_cg = ty == MAT_COATED_GLOSSY
        w_dr = torch.where(is_cg, kr_ior, w_dr)
        w_mf = torch.where(is_cg, (1.0 - kr_ior) * mp.glossy_reflect, w_mf)
        w_di = torch.where(is_cg, (1.0 - kr_ior) * mp.diffuse_reflect
                           * (1.0 - mp.glossy_reflect), w_di)
    if mp.has(MAT_GLASS):
        # Fresnel split between delta reflect and delta transmit
        is_gs = ty == MAT_GLASS
        w_dr = torch.where(is_gs, kr_ior, w_dr)
        w_dt = torch.where(is_gs, 1.0 - kr_ior, w_dt)
    if mp.has(MAT_ROUGH_GLASS):
        # one microfacet lobe that reflects and refracts
        w_mf = torch.where(ty == MAT_ROUGH_GLASS, 1.0, w_mf)
    if mp.has(MAT_MIRROR):
        w_dr = torch.where(ty == MAT_MIRROR, mp.specular_refl, w_dr)
    # null, light, blend and mask rows scatter nothing themselves
    return w_dr, w_dt, w_mf, w_di, w_tl


def _oren_nayar_factor(sigma: Tensor, wo_l: Tensor, wi_l: Tensor) -> Tensor:
    """The Oren-Nayar correction of the Lambert term (material_glossy.cc's
    OrenNayar)."""
    s2 = sigma * sigma
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    cos_to = torch.clamp(torch.abs(wo_l[..., 2]), 0.0, 1.0)
    cos_ti = torch.clamp(torch.abs(wi_l[..., 2]), 0.0, 1.0)
    sin_to = torch.sqrt(torch.clamp_min(1.0 - cos_to * cos_to, 1e-12))
    sin_ti = torch.sqrt(torch.clamp_min(1.0 - cos_ti * cos_ti, 1e-12))
    # cos(phi_i - phi_o) from the projected directions
    po = wo_l[..., :2] * torch.rsqrt(torch.clamp_min(
        torch.sum(wo_l[..., :2] ** 2, -1, keepdim=True), 1e-12))
    pi_ = wi_l[..., :2] * torch.rsqrt(torch.clamp_min(
        torch.sum(wi_l[..., :2] ** 2, -1, keepdim=True), 1e-12))
    cos_dphi = torch.clamp_min(torch.sum(po * pi_, -1), 0.0)
    sin_alpha = torch.maximum(sin_to, sin_ti)
    tan_beta = torch.minimum(sin_to / torch.clamp_min(cos_to, 1e-6),
                             sin_ti / torch.clamp_min(cos_ti, 1e-6))
    return a + b * cos_dphi * sin_alpha * tan_beta


def _glossy_f(mp: MP, wo_l: Tensor, wi_l: Tensor):
    """Microfacet reflection f and solid-angle pdf of the glossy lobe
    (Ashikhmin-Shirley normalisation, material_glossy.cc)."""
    h = vec.normalize(wo_l + wi_l)
    cos_wo_h = torch.abs(vec.dot(wo_l, h))
    cos_no = torch.abs(wo_l[..., 2])
    cos_ni = torch.abs(wi_l[..., 2])
    aniso = _flag(mp.mat_flags, FLAG_ANISOTROPIC)
    d = torch.where(aniso, mf.as_aniso_d(h, mp.exp_u, mp.exp_v),
                    mf.blinn_d(h[..., 2], mp.exponent))
    pdf_h = torch.where(aniso, mf.as_aniso_pdf_h(h, mp.exp_u, mp.exp_v),
                        mf.blinn_pdf_h(h[..., 2], mp.exponent))
    fres = vec.schlick_fresnel(cos_wo_h, mp.glossy_reflect)
    denom = 4.0 * torch.clamp_min(cos_wo_h, 1e-6) * torch.clamp_min(
        torch.maximum(cos_no, cos_ni), 1e-6)
    f = (d * fres / denom)[..., None] * mp.glossy_color
    # pdf of wi when sampling h then reflecting: pdf_h / (4 |wo.h|)
    pdf_wi = pdf_h / torch.clamp_min(4.0 * cos_wo_h, 1e-6)
    same_hemi = (wo_l[..., 2] * wi_l[..., 2]) > 0.0
    f = torch.where(same_hemi[..., None], f, 0.0)
    pdf_wi = torch.where(same_hemi, pdf_wi, 0.0)
    return f, pdf_wi


def _rough_glass_f(mp: MP, wo_l: Tensor, wi_l: Tensor):
    """Walter et al. 2007 GGX rough dielectric: f and solid-angle pdf of
    reflection and refraction (material_rough_glass.cc)."""
    a2 = mp.alpha * mp.alpha
    eta = torch.where(wo_l[..., 2] > 0, mp.ior, 1.0 / mp.ior)
    reflecting = (wo_l[..., 2] * wi_l[..., 2]) > 0.0
    h_r = vec.normalize(torch.sign(wo_l[..., 2:3]) * (wo_l + wi_l))
    h_t = vec.normalize(-(wo_l + wi_l * eta[..., None]))
    h_t = h_t * torch.sign(h_t[..., 2:3])
    h = torch.where(reflecting[..., None], h_r, h_t)
    cos_wo_h = vec.dot(wo_l, h)
    cos_wi_h = vec.dot(wi_l, h)
    d = mf.ggx_d(h[..., 2], a2)
    g = mf.ggx_g(wi_l[..., 2], wo_l[..., 2], a2)
    fres = vec.fresnel_dielectric(cos_wo_h, torch.where(
        wo_l[..., 2] > 0, mp.ior, 1.0 / mp.ior))
    cos_no = torch.abs(wo_l[..., 2])
    cos_ni = torch.abs(wi_l[..., 2])
    f_r = fres * d * g / torch.clamp_min(4.0 * cos_no * cos_ni, 1e-7)
    pdf_r = mf.ggx_pdf_h(h[..., 2], a2) / torch.clamp_min(
        4.0 * torch.abs(cos_wo_h), 1e-7) * fres
    # transmission (Walter eq. 21)
    sqrt_denom = cos_wo_h + eta * cos_wi_h
    ft_num = (torch.abs(cos_wo_h) * torch.abs(cos_wi_h) * eta * eta
              * d * g * (1.0 - fres))
    f_t = ft_num / torch.clamp_min(
        cos_no * cos_ni * sqrt_denom * sqrt_denom, 1e-7)
    dwh_dwi = eta * eta * torch.abs(cos_wi_h) / torch.clamp_min(
        sqrt_denom * sqrt_denom, 1e-7)
    pdf_t = mf.ggx_pdf_h(h[..., 2], a2) * dwh_dwi * (1.0 - fres)
    f_scalar = torch.where(reflecting, f_r, f_t)
    pdf = torch.where(reflecting, pdf_r, pdf_t)
    col = torch.where(reflecting[..., None], mp.mirror_color,
                      mp.filter_color)
    return f_scalar[..., None] * col, pdf


def _eval_single(mp: MP, wo_l: Tensor, wi_l: Tensor, split: bool = False):
    """Non-delta f and solid-angle pdf for one parameter row per lane;
    split=True adds the per-family components (see eval_bsdf)."""
    cos_wo = torch.abs(wo_l[..., 2])
    w_dr, w_dt, w_mf, w_di, w_tl = lobe_weights(mp, cos_wo)
    same_hemi = (wo_l[..., 2] * wi_l[..., 2]) > 0.0
    cos_wi = torch.abs(wi_l[..., 2])
    # diffuse reflect (Lambert, or Oren-Nayar where sigma > 0)
    w = w_di
    if mp.has_oren:
        w = w * torch.where(mp.sigma > 0.0,
                            _oren_nayar_factor(mp.sigma, wo_l, wi_l), 1.0)
    f_di = (w * _INV_PI)[..., None] * mp.diffuse_color
    f_di = torch.where(same_hemi[..., None], f_di, 0.0)
    pdf_di = torch.where(same_hemi, cos_wi * _INV_PI, 0.0)
    # diffuse transmit (translucency)
    f_tl = (w_tl * _INV_PI)[..., None] * mp.diffuse_color
    f_tl = torch.where(same_hemi[..., None], 0.0, f_tl)
    pdf_tl = torch.where(same_hemi, 0.0, cos_wi * _INV_PI)
    # microfacet: only the families present in the scene are evaluated
    has_gl = mp.has(MAT_GLOSSY) or mp.has(MAT_COATED_GLOSSY)
    has_rg = mp.has(MAT_ROUGH_GLASS)
    if has_gl and has_rg:
        is_rg = mp.mat_type == MAT_ROUGH_GLASS
        f_gl, pdf_gl = _glossy_f(mp, wo_l, wi_l)
        f_rg, pdf_rg = _rough_glass_f(mp, wo_l, wi_l)
        f_mf = torch.where(is_rg[..., None], f_rg, f_gl)
        pdf_mf = torch.where(is_rg, pdf_rg, pdf_gl)
    elif has_rg:
        f_mf, pdf_mf = _rough_glass_f(mp, wo_l, wi_l)
    elif has_gl:
        f_mf, pdf_mf = _glossy_f(mp, wo_l, wi_l)
    else:
        f_mf = torch.zeros_like(mp.diffuse_color)
        pdf_mf = torch.zeros_like(cos_wi)
    f_mf = w_mf[..., None] * f_mf
    f = f_di + f_tl + f_mf
    w_sum = w_dr + w_dt + w_mf + w_di + w_tl
    pdf = (w_di * pdf_di + w_tl * pdf_tl + w_mf * pdf_mf) / torch.clamp_min(
        w_sum, 1e-6)
    if split:
        # the per-BSDF-family components of the adv-* AOV layers
        # (doLightEstimation's ColorLayerAccum splits)
        is_rg = ((mp.mat_type == MAT_ROUGH_GLASS)[..., None] if has_rg
                 else torch.zeros_like(f[..., :1], dtype=torch.bool))
        fam = {"diffuse": f_di,
               "glossy": torch.where(is_rg, 0.0, f_mf),
               "trans": torch.where(is_rg, f_mf, 0.0),
               "subsurface": f_tl}
        return f, pdf, fam
    return f, pdf


def _to_local(sp, w):
    return vec.to_local(w, sp.nu, sp.nv, sp.n)


def _from_local(sp, l):
    return vec.from_local(l, sp.nu, sp.nv, sp.n)


def _blend_ids(scene: SceneData, sp):
    """(is a blend row, its material 1, its material 2) per lane."""
    mats = scene.materials
    idx = sp.mat_id.long()
    return (mats.mat_type[idx] == MAT_BLEND, mats.blend_a[idx],
            mats.blend_b[idx])


def eval_bsdf(scene: SceneData, sp, wo: Tensor, wi: Tensor,
              split: bool = False):
    """f(wo, wi) of the non-delta lobes and the solid-angle pdf
    (Material::eval / pdf); a blend lerps its sub-materials' by the blend
    factor. split=True also returns the per-family components (diffuse,
    glossy, trans, subsurface) of the adv-* AOV layers."""
    mp = resolve_mp(scene, sp)
    wo_l = _to_local(sp, wo)
    wi_l = _to_local(sp, wi)
    out = _eval_single(mp, wo_l, wi_l, split)
    f, pdf = out[:2]
    if scene.materials.has_blend:
        bl = blend_factor(scene, sp)
        is_blend, mat_a, mat_b = _blend_ids(scene, sp)
        out_a = _eval_single(resolve_mp(scene, sp, mat_a), wo_l, wi_l, split)
        out_b = _eval_single(resolve_mp(scene, sp, mat_b), wo_l, wi_l, split)
        lerp = lambda a, b, x: torch.where(
            is_blend[..., None], a * (1.0 - bl[..., None]) + b * bl[..., None],
            x)
        if split:
            out[2].update({k: lerp(out_a[2][k], out_b[2][k], x)
                           for k, x in out[2].items()})
        f = lerp(out_a[0], out_b[0], f)
        pdf = torch.where(is_blend, out_a[1] * (1.0 - bl) + out_b[1] * bl,
                          pdf)
    return (f, pdf, out[2]) if split else (f, pdf)


@dataclass
class MatSample:
    wi: Tensor           # f32[N,3] sampled direction (world after sample_bsdf)
    weight: Tensor       # f32[N,3] throughput multiplier f*|cos|/pdf
    pdf: Tensor          # f32[N] solid-angle pdf (0 for delta lobes)
    is_delta: Tensor     # bool[N]
    is_transmit: Tensor  # bool[N] crossed to the other side of the surface
    valid: Tensor        # bool[N] sample produced any contribution
    lobe: Tensor         # i32[N] 0 delta-reflect, 1 delta-transmit,
                         # 2 microfacet, 3 diffuse, 4 translucent
    # a chromatic refraction (glass with dispersion_power > 0): the
    # integrator tints the path by wl_to_rgb on its first one
    dispersed: Optional[Tensor] = None


def _sample_single(mp: MP, wo_l: Tensor, u1: Tensor, u2: Tensor, u3: Tensor
                   ) -> MatSample:
    cos_wo = torch.abs(wo_l[..., 2])
    w_dr, w_dt, w_mf, w_di, w_tl = lobe_weights(mp, cos_wo)
    w_sum = w_dr + w_dt + w_mf + w_di + w_tl
    valid = w_sum > 1e-6
    inv_sum = 1.0 / torch.clamp_min(w_sum, 1e-6)
    p_dr = w_dr * inv_sum
    p_dt = w_dt * inv_sum
    p_di = w_di * inv_sum
    c0 = p_dr
    c1 = c0 + p_dt
    pick_dr = u3 < c0
    pick_dt = ~pick_dr & (u3 < c1)
    c2 = c1 + w_mf * inv_sum
    c3 = c2 + p_di
    pick_mf = ~pick_dr & ~pick_dt & (u3 < c2)
    pick_di = ~pick_dr & ~pick_dt & ~pick_mf & (u3 < c3)

    ty = mp.mat_type
    has_glass = mp.has(MAT_GLASS)
    has_rg = mp.has(MAT_ROUGH_GLASS)
    has_gl = mp.has(MAT_GLOSSY) or mp.has(MAT_COATED_GLOSSY)
    sgn_wo = torch.sign(wo_l[..., 2:3])
    sgn_wo = torch.where(sgn_wo == 0, 1.0, sgn_wo)
    # delta reflect: mirror about local z
    wi_dr = torch.stack([-wo_l[..., 0], -wo_l[..., 1], wo_l[..., 2]], dim=-1)
    eta_rel = (torch.where(wo_l[..., 2] > 0, mp.ior, 1.0 / mp.ior)
               if has_glass or has_rg else None)
    # delta transmit: shiny-diffuse transparency and null pass straight
    # through, unfiltered; glass refracts through the local normal on wo's
    # side by the relative IOR and transmits its filter colour, or reflects
    # with its mirror colour under total internal reflection
    wi_dt = -wo_l
    col_dt = torch.ones_like(mp.filter_color)
    if has_glass:
        n_l = torch.cat([torch.zeros_like(wo_l[..., :2]), sgn_wo], dim=-1)
        wt, tir = vec.refract(wo_l, n_l, eta_rel)
        is_gs = ty == MAT_GLASS
        wi_dt = torch.where(is_gs[..., None], wt, wi_dt)
        wi_dt = torch.where((is_gs & tir)[..., None], wi_dr, wi_dt)
        col_dt = torch.where(is_gs[..., None], mp.filter_color, col_dt)
        col_dt = torch.where((is_gs & tir)[..., None], mp.mirror_color,
                             col_dt)
    # microfacet: a half vector on wo's side (only the families present in
    # the scene are traced); wo reflected about it, or for rough glass
    # refracted through it where a Fresnel pick says so
    if has_gl or has_rg:
        if has_gl:
            if mp.has_aniso:
                aniso = _flag(mp.mat_flags, FLAG_ANISOTROPIC)
                h_gl = torch.where(
                    aniso[..., None],
                    mf.as_aniso_sample_h(u1, u2, mp.exp_u, mp.exp_v),
                    mf.blinn_sample_h(u1, u2, mp.exponent))
            else:
                h_gl = mf.blinn_sample_h(u1, u2, mp.exponent)
        if has_rg:
            h_ggx = mf.ggx_sample_h(u1, u2, mp.alpha)
        if has_gl and has_rg:
            h = torch.where((ty == MAT_ROUGH_GLASS)[..., None], h_ggx, h_gl)
        else:
            h = h_ggx if has_rg else h_gl
        h = h * sgn_wo
        cos_wo_h = vec.dot(wo_l, h)
        wi_refl = vec.normalize(2.0 * cos_wo_h[..., None] * h - wo_l)
        if has_rg:
            # the reflect / refract pick takes a fresh uniform made from
            # u1 and u2 (u3 picked the lobe), as in the JAX package
            fres_h = vec.fresnel_dielectric(cos_wo_h, eta_rel)
            u4 = torch.remainder(u1 * 7919.0 + u2 * 104729.0, 1.0)
            wt_h, tir_h = vec.refract(wo_l, h, eta_rel)
            choose_refl = (u4 < fres_h) | tir_h
            wi_mf = torch.where(choose_refl[..., None], wi_refl, wt_h)
            if has_gl:
                wi_mf = torch.where((ty == MAT_ROUGH_GLASS)[..., None],
                                    wi_mf, wi_refl)
        else:
            wi_mf = wi_refl
    else:
        wi_mf = wi_dr
    # diffuse lobes
    d_loc = vec.cosine_sample_hemisphere(u1, u2)
    wi_di = d_loc * sgn_wo     # same hemisphere as wo
    wi_tl = -d_loc * sgn_wo    # opposite hemisphere
    wi_l = torch.where(pick_dr[..., None], wi_dr,
                       torch.where(pick_dt[..., None], wi_dt,
                                   torch.where(pick_mf[..., None], wi_mf,
                                               torch.where(pick_di[..., None],
                                                           wi_di, wi_tl))))

    # combined eval at the sampled wi for an MIS-correct weight and pdf
    f, pdf_nd = _eval_single(mp, wo_l, wi_l)
    cos_wi = torch.abs(wi_l[..., 2])
    picked_delta = pick_dr | pick_dt
    # delta weights: color * lobe_weight / p_lobe (cos cancels)
    p_lobe_delta = torch.where(pick_dr, p_dr, p_dt)
    w_lobe_delta = torch.where(pick_dr, w_dr, w_dt)
    col_delta = torch.where(pick_dr[..., None], mp.mirror_color, col_dt)
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
        pick_mf, 2, torch.where(pick_di, 3, 4)))).to(torch.int32)
    return MatSample(wi=wi_l, weight=weight, pdf=pdf_out,
                     is_delta=picked_delta, is_transmit=is_transmit,
                     valid=valid, lobe=lobe)


def sample_bsdf(scene: SceneData, sp, wo: Tensor, u1, u2, u3,
                wl: Optional[Tensor] = None) -> MatSample:
    """Material::sample for the whole wavefront; `wi` comes back in world
    space. A blend samples the sub-material that u3 picks by the blend
    factor (u3 stretched back over [0, 1) within the pick). `wl` (per lane,
    in [0, 1]) is the path's wavelength: dispersive glass shifts its IOR by
    (wl - 0.5) * dispersion_power, the JAX package's linearised Cauchy
    model; `dispersed` marks its refractions."""
    mats = scene.materials
    idx = sp.mat_id.long()
    disp = mats.dispersion[idx] if mats.has_dispersion else None
    wo_l = _to_local(sp, wo)
    if mats.has_blend:
        # every lane re-resolves its row here, so the wavelength's IOR
        # shift is not applied in such scenes, as in the JAX package
        # (ROADMAP section 3)
        bl = blend_factor(scene, sp)
        is_blend, mat_a, mat_b = _blend_ids(scene, sp)
        second = u3 < bl
        eff_id = torch.where(is_blend, torch.where(second, mat_b, mat_a),
                             sp.mat_id)
        u3 = torch.where(is_blend, torch.where(
            second, u3 / torch.clamp_min(bl, 1e-9),
            (u3 - bl) / torch.clamp_min(1 - bl, 1e-9)), u3)
        mp = resolve_mp(scene, sp, eff_id)
    else:
        mp = resolve_mp(scene, sp)
        if wl is not None and disp is not None:
            mp = replace(mp, ior=mp.ior + disp * (wl - 0.5))
    s = _sample_single(mp, wo_l, u1, u2, u3)
    s.wi = _from_local(sp, s.wi)
    s.dispersed = (s.is_delta & s.is_transmit & (disp > 0.0)
                   if disp is not None else None)
    return s


def emit(scene: SceneData, sp, wo: Tensor) -> Tensor:
    """Material emission toward wo (one-sided: front face, ng . wo > 0); a
    mask emits its picked sub-material's."""
    mat_id = sp.mat_id
    if scene.materials.has_mask:
        mat_id = _mask_id(scene, sp, mat_id)
    emit_color = take(scene.materials.emit_color, mat_id.long(),
                      "emit_color")
    front = vec.dot(wo, sp.ng) > 0.0
    return torch.where((front & sp.valid)[..., None], emit_color, 0.0)


def transparency(scene: SceneData, sp, wo: Tensor) -> Tensor:
    """Filter colour for transparent-shadow rays (Material::getTransparency):
    shiny-diffuse, its transparency times its filter colour (white where
    that is black); glass with fake_shadows, its filter colour; null, fully
    transparent; every other material opaque."""
    mp = resolve_mp(scene, sp)
    ty = mp.mat_type
    sd = mp.transparency[..., None] * torch.where(
        torch.any(mp.filter_color > 0, -1, keepdim=True), mp.filter_color,
        torch.ones_like(mp.filter_color))
    out = torch.where((ty == MAT_SHINY_DIFFUSE)[..., None], sd,
                      torch.zeros_like(mp.diffuse_color))
    fake = _flag(mp.mat_flags, FLAG_FAKE_SHADOWS)
    out = torch.where(((ty == MAT_GLASS) & fake)[..., None], mp.filter_color,
                      out)
    return torch.where((ty == MAT_NULL)[..., None], torch.ones_like(out), out)
