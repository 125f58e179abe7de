"""Vectorized BSDF table: eval / sample / emit for the whole wavefront.

Counterpart of `libyafaray_tpu/materials/bsdf.py` with the shiny-diffuse
(`MAT_SHINY_DIFFUSE`), glossy (`MAT_GLOSSY`), clear glass (`MAT_GLASS`) and
light (`MAT_LIGHT`: emission only, no lobe) materials, the families the port
compiles so far. Their lobes, in the JAX package's numbering:

    lobe 0  delta reflect   (specular_reflect, optionally Fresnel-weighted;
                             glass reflection)
    lobe 1  delta transmit  (transparency: passes straight through; glass
                             refraction, a reflection under total internal
                             reflection)
    lobe 2  microfacet      (glossy: Blinn or Ashikhmin-Shirley reflection)
    lobe 3  diffuse reflect (Lambert)
    lobe 4  diffuse transmit (translucency)

Each family's lobe weights are evaluated for the whole wavefront and picked
per lane by its material type; the lobe math of a family absent from the
scene (`MaterialTable.present_types`) is not evaluated. All math runs in
the local shading frame (z = n), and every float parameter is
differentiable: `gather_mp` gathers the columns through `ops.fast_grad.take`,
whose backward reduces onto the table with one-hot products, as the JAX
package's does. `resolve_mp` then applies the shader-node overrides
(`materials/nodes.py`) of the channels a material binds to nodes, such as a
texture's colour in place of the diffuse colour; `eval_bsdf` and
`sample_bsdf` go through it, as in the JAX package (`emit_color` is not a
node channel).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..math import vec
from ..ops.fast_grad import take
from ..scene_types import (MAT_GLASS, MAT_GLOSSY, MAT_SHINY_DIFFUSE,
                           MaterialTable, SceneData)
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
    # static hints copied from the table, as in the JAX package: the
    # material families present, and whether any row uses Fresnel
    # weighting or an anisotropic lobe
    present: tuple = ()
    has_fresnel: bool = True
    has_aniso: bool = True

    def has(self, ty: int) -> bool:
        return not self.present or ty in self.present


def gather_mp(mats: MaterialTable, mat_id: Tensor) -> MP:
    idx = mat_id.long()
    return MP(present=mats.present_types, has_fresnel=mats.has_fresnel,
              has_aniso=mats.has_aniso, mat_type=mats.mat_type[idx],
              mat_flags=mats.mat_flags[idx],
              **{f: take(getattr(mats, f), idx) for f in _COLUMNS})


def resolve_mp(scene: SceneData, sp, mat_id: Optional[Tensor] = None) -> MP:
    """gather_mp, then the shader-node overrides."""
    if mat_id is None:
        mat_id = sp.mat_id
    mp = gather_mp(scene.materials, mat_id)
    if scene.nodes is not None and scene.nodes.num_nodes > 0:
        from . import nodes as node_mod
        mp = node_mod.apply_overrides(scene, sp, mat_id, mp)
    return mp


def _flag(flags: Tensor, bit: int) -> Tensor:
    return (flags & bit) != 0


def lobe_weights(mp: MP, cos_wo: Tensor):
    """Per-lane weights of the five lobes, summing to <= 1: ShinyDiffuse's
    cumulative component accumulation (material_shiny_diffuse.cc), the
    glossy material's split and glass's Fresnel split."""
    zero = torch.zeros_like(cos_wo)
    w_dr = w_dt = w_mf = w_di = w_tl = zero
    kr_ior = (vec.fresnel_dielectric(cos_wo, mp.ior)
              if mp.has_fresnel or mp.has(MAT_GLASS) else None)
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
        is_sd = mp.mat_type == MAT_SHINY_DIFFUSE
        w_dr = torch.where(is_sd, m, w_dr)
        w_dt = torch.where(is_sd, t, w_dt)
        w_tl = torch.where(is_sd, tl, w_tl)
        w_di = torch.where(is_sd, di, w_di)
    if mp.has(MAT_GLOSSY):
        is_gl = mp.mat_type == MAT_GLOSSY
        w_mf = torch.where(is_gl, mp.glossy_reflect, w_mf)
        w_di = torch.where(is_gl, mp.diffuse_reflect
                           * (1.0 - mp.glossy_reflect), w_di)
    if mp.has(MAT_GLASS):
        # Fresnel split between delta reflect and delta transmit
        is_gs = mp.mat_type == MAT_GLASS
        w_dr = torch.where(is_gs, kr_ior, w_dr)
        w_dt = torch.where(is_gs, 1.0 - kr_ior, w_dt)
    return w_dr, w_dt, w_mf, w_di, w_tl


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


def _eval_single(mp: MP, wo_l: Tensor, wi_l: Tensor):
    """Non-delta f and solid-angle pdf for one parameter row per lane."""
    cos_wo = torch.abs(wo_l[..., 2])
    w_dr, w_dt, w_mf, w_di, w_tl = lobe_weights(mp, cos_wo)
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
    # microfacet: only the families present in the scene are evaluated
    if mp.has(MAT_GLOSSY):
        f_mf, pdf_mf = _glossy_f(mp, wo_l, wi_l)
    else:
        f_mf = torch.zeros_like(mp.diffuse_color)
        pdf_mf = torch.zeros_like(cos_wi)
    f = f_di + f_tl + w_mf[..., None] * f_mf
    w_sum = w_dr + w_dt + w_mf + w_di + w_tl
    pdf = (w_di * pdf_di + w_tl * pdf_tl + w_mf * pdf_mf) / torch.clamp_min(
        w_sum, 1e-6)
    return f, pdf


def _to_local(sp, w):
    return vec.to_local(w, sp.nu, sp.nv, sp.n)


def _from_local(sp, l):
    return vec.from_local(l, sp.nu, sp.nv, sp.n)


def eval_bsdf(scene: SceneData, sp, wo: Tensor, wi: Tensor):
    """f(wo, wi) of the non-delta lobes and the solid-angle pdf
    (Material::eval / pdf)."""
    mp = resolve_mp(scene, sp)
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
                         # 2 microfacet, 3 diffuse, 4 translucent


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

    sgn_wo = torch.sign(wo_l[..., 2:3])
    sgn_wo = torch.where(sgn_wo == 0, 1.0, sgn_wo)
    # delta reflect: mirror about local z
    wi_dr = torch.stack([-wo_l[..., 0], -wo_l[..., 1], wo_l[..., 2]], dim=-1)
    # delta transmit: shiny-diffuse transparency passes straight through,
    # unfiltered; glass refracts through the local normal on wo's side by
    # the relative IOR and transmits its filter colour, or reflects with its
    # mirror colour under total internal reflection
    wi_dt = -wo_l
    col_dt = torch.ones_like(mp.filter_color)
    if mp.has(MAT_GLASS):
        eta_rel = torch.where(wo_l[..., 2] > 0, mp.ior, 1.0 / mp.ior)
        n_l = torch.cat([torch.zeros_like(wo_l[..., :2]), sgn_wo], dim=-1)
        wt, tir = vec.refract(wo_l, n_l, eta_rel)
        is_gs = mp.mat_type == MAT_GLASS
        wi_dt = torch.where(is_gs[..., None], wt, wi_dt)
        wi_dt = torch.where((is_gs & tir)[..., None], wi_dr, wi_dt)
        col_dt = torch.where(is_gs[..., None], mp.filter_color, col_dt)
        col_dt = torch.where((is_gs & tir)[..., None], mp.mirror_color,
                             col_dt)
    # diffuse lobes
    d_loc = vec.cosine_sample_hemisphere(u1, u2)
    wi_di = d_loc * sgn_wo     # same hemisphere as wo
    wi_tl = -d_loc * sgn_wo    # opposite hemisphere
    # microfacet: a half vector on wo's side, wo reflected about it (only
    # the families present in the scene are traced)
    if mp.has(MAT_GLOSSY):
        if mp.has_aniso:
            aniso = _flag(mp.mat_flags, FLAG_ANISOTROPIC)
            h = torch.where(aniso[..., None],
                            mf.as_aniso_sample_h(u1, u2, mp.exp_u, mp.exp_v),
                            mf.blinn_sample_h(u1, u2, mp.exponent))
        else:
            h = mf.blinn_sample_h(u1, u2, mp.exponent)
        h = h * sgn_wo
        cos_wo_h = vec.dot(wo_l, h)
        wi_mf = vec.normalize(2.0 * cos_wo_h[..., None] * h - wo_l)
    else:
        wi_mf = wi_dr
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


def sample_bsdf(scene: SceneData, sp, wo: Tensor, u1, u2, u3) -> MatSample:
    """Material::sample for the whole wavefront; `wi` comes back in world
    space."""
    mp = resolve_mp(scene, sp)
    s = _sample_single(mp, _to_local(sp, wo), u1, u2, u3)
    s.wi = _from_local(sp, s.wi)
    return s


def emit(scene: SceneData, sp, wo: Tensor) -> Tensor:
    """Material emission toward wo (one-sided: front face, ng . wo > 0)."""
    emit_color = take(scene.materials.emit_color, sp.mat_id.long())
    front = vec.dot(wo, sp.ng) > 0.0
    return torch.where((front & sp.valid)[..., None], emit_color, 0.0)
