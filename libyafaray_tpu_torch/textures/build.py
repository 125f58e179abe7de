"""TexturePool builder: the staged textures frozen into SoA tables.

Counterpart of `libyafaray_tpu/textures/build.py`. Every image is packed
with its box-filtered mip chain into one flat texel pool, so trilinear and
EWA sampling are gathers and lerps. The pool's dtype follows the
`image_optimization` parameters (the reference's image.h:47-48): f32
unless every image asks for "optimized" (f16) or "compressed" (uint8 with
a scale per texture). A procedural texture (blend, clouds, marble, wood,
voronoi, musgrave, distorted noise, rgb cube) keeps its parameters in its
params_f row, as the JAX package lays them out, and adds its noise bases
and octaves to the pool's `used_noise` and `max_octaves`. Image files of
every format `io.load_image` reads are loaded through it.
`build_env_tables` builds a texture background's importance tables (the
alias method), the JAX package's exactly.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..io import load_image
from ..scene_types import Background, TexturePool
from . import (MAX_MIPS, RAMP_MAX, TEX_BLEND, TEX_CLOUDS,
               TEX_DISTORTED_NOISE, TEX_IMAGE, TEX_MARBLE, TEX_MUSGRAVE,
               TEX_RGB_CUBE, TEX_VORONOI, TEX_WOOD)
from .noise import NOISE_VORONOI_F1, noise_type_id

_TEX_BY_NAME = {
    "image": TEX_IMAGE, "blend": TEX_BLEND, "clouds": TEX_CLOUDS,
    "marble": TEX_MARBLE, "wood": TEX_WOOD, "voronoi": TEX_VORONOI,
    "musgrave": TEX_MUSGRAVE, "distorted_noise": TEX_DISTORTED_NOISE,
    "rgb_cube": TEX_RGB_CUBE,
}
_BLEND_STYPE = {"lin": 0, "quad": 1, "ease": 2, "diag": 3, "sphere": 4,
                "halo": 5, "radial": 6}
_MARBLE_SHAPE = {"sin": 0, "saw": 1, "tri": 2}
_WOOD_TYPE = {"bands": 0, "rings": 1, "bandnoise": 2, "ringnoise": 3}
_VORONOI_CMODE = {"intensity-without-color": 0, "int": 0, "position": 1,
                  "col1": 1, "position-outline": 2, "col2": 2,
                  "position-outline-intensity": 3, "col3": 3}
_MUSGRAVE_TYPE = {"fBm": 0, "multifractal": 1, "heteroterrain": 2,
                  "hybridmf": 3, "ridgedmf": 4}
# the types whose params_f row is [size, depth, hard, noise type, ...] and
# that run the turbulence
_TURBULENT = (TEX_CLOUDS, TEX_MARBLE, TEX_WOOD)
_INTERP = {"none": 0, "bilinear": 1, "bicubic": 2, "mipmap_trilinear": 3,
           "mipmap_ewa": 4}
_EXTEND = {"repeat": 0, "extend": 1, "clip": 2, "clipcube": 2, "checker": 3}


def _mip_chain(img: np.ndarray):
    """Box-filtered mip pyramid down to 1 texel on the short side (odd sizes
    floor-divide), at most MAX_MIPS levels."""
    mips = [img]
    while min(img.shape[0], img.shape[1]) > 1 and len(mips) < MAX_MIPS:
        h, w = img.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        img = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 4).mean((1, 3))
        mips.append(img.astype(np.float32))
    return mips


def _rgba(pm, img) -> np.ndarray:
    """The texture's pixels as linear f32 rgba (colour space, gamma and
    rot90 applied)."""
    if img is None:
        path = pm.get_string("filename", pm.get_string("image_name", ""))
        img = load_image(path) if path else np.ones((1, 1, 4), np.float32)
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
    gamma = pm.get_float("gamma", 1.0)
    if pm.get_string("color_space", "") in ("sRGB", "srgb"):
        lin = np.clip(img[..., :3], 0, None)
        a = lin / 12.92
        b = ((lin + 0.055) / 1.055) ** 2.4
        img = np.concatenate([np.where(lin <= 0.04045, a, b), img[..., 3:]],
                             -1)
    elif gamma != 1.0:
        img = np.concatenate(
            [np.clip(img[..., :3], 0, None) ** gamma, img[..., 3:]], -1)
    if pm.get_bool("rot90", False):
        img = np.rot90(img, axes=(0, 1)).copy()
    return img.astype(np.float32)


def _procedural_row(pm, ty: int, row: np.ndarray):
    """Fill a procedural texture's params_f row from its ParamMap (the JAX
    package's layout); returns (the noise bases it reads, the octaves the
    pool's loops must run for it)."""
    nt = noise_type_id(pm.get_string("noise_type", "newperlin"))
    if ty == TEX_BLEND:
        row[0] = _BLEND_STYPE.get(pm.get_string("stype", "lin"), 0)
        row[1] = 1.0 if pm.get_bool("use_flip_axis", False) else 0.0
        return (), 0
    if ty in _TURBULENT:
        depth = pm.get_int("depth", 2)
        row[0] = pm.get_float("size", 1.0 if ty == TEX_WOOD else 4.0)
        row[1] = depth
        row[2] = 1.0 if pm.get_bool("hard", False) else 0.0
        row[3] = nt
        if ty == TEX_CLOUDS:
            row[4] = {"none": 0, "positive": 1, "negative": 2}.get(
                pm.get_string("bias", "none"), 0)
        elif ty == TEX_MARBLE:
            row[4] = pm.get_float("turbulence", 5.0)
            row[5] = pm.get_float("sharpness", 1.0)
            row[6] = _MARBLE_SHAPE.get(pm.get_string("shape", "sin"), 0)
        else:
            row[4] = pm.get_float("turbulence", 1.0)
            row[5] = _WOOD_TYPE.get(pm.get_string("wood_type", "bands"), 0)
            row[6] = _MARBLE_SHAPE.get(pm.get_string("shape", "sin"), 0)
        return (nt,), depth + 1
    if ty == TEX_VORONOI:
        row[:8] = (pm.get_float("size", 0.25), pm.get_float("weight1", 1.0),
                   pm.get_float("weight2", 0.0), pm.get_float("weight3", 0.0),
                   pm.get_float("weight4", 0.0),
                   pm.get_float("mk_exponent", 2.5),
                   pm.get_float("intensity", 1.0),
                   _VORONOI_CMODE.get(pm.get_string("color_mode", "int"), 0))
        # the JAX build counts voronoi_f1 as used; the texture reads
        # voronoi_f directly
        return (NOISE_VORONOI_F1,), 0
    if ty == TEX_MUSGRAVE:
        octaves = min(pm.get_float("octaves", 2.0), 8.0)
        row[:9] = (pm.get_float("size", 1.0), pm.get_float("H", 1.0),
                   pm.get_float("lacunarity", 2.0), octaves,
                   pm.get_float("offset", 1.0), pm.get_float("gain", 1.0),
                   pm.get_float("intensity", 1.0),
                   _MUSGRAVE_TYPE.get(pm.get_string("musgrave_type", "fBm"),
                                      0), nt)
        return (nt,), int(math.ceil(octaves)) + 1
    if ty == TEX_DISTORTED_NOISE:
        n1 = noise_type_id(pm.get_string("noise_type1", "newperlin"))
        n2 = noise_type_id(pm.get_string("noise_type2", "newperlin"))
        row[:4] = (pm.get_float("size", 1.0), pm.get_float("distort", 1.0),
                   n1, n2)
        return (n1, n2), 0
    return (), 0     # rgb cube


def texture_statics(tex_type, params_f, ramp_count,
                    max_octaves: int) -> tuple:
    """Per texture, (type, the noise bases it reads, the octaves its
    evaluation needs, whether it has a colour ramp), from the pool's
    columns: the static sets with which `eval_textures` evaluates one
    texture alone. Octaves past these add exact zeros in the pool-wide
    loops, and a texture without a ramp keeps its colour, so both give the
    same values."""
    out = []
    for ty, row, ramp in zip(np.asarray(tex_type).tolist(),
                             np.asarray(params_f),
                             np.asarray(ramp_count).tolist()):
        bases, octs = (), 0
        if ty in _TURBULENT:
            bases, octs = (int(row[3]),), int(row[1]) + 1
        elif ty == TEX_MUSGRAVE:
            bases, octs = (int(row[8]),), int(math.ceil(row[3])) + 1
        elif ty == TEX_DISTORTED_NOISE:
            bases = tuple(sorted({int(row[2]), int(row[3])}))
        out.append((int(ty), bases, min(octs, max_octaves), ramp > 0))
    return tuple(out)


def build_pool(builder) -> TexturePool:
    names = builder.texture_order
    n = len(names)
    texels = [np.zeros((1, 4), np.float32)]
    opt_req = []   # each image's image_optimization request
    off = 1
    img_offset = np.zeros((n,), np.int32)
    img_w = np.zeros((n,), np.int32)
    img_h = np.zeros((n,), np.int32)
    mip_offsets = np.full((n, MAX_MIPS), -1, np.int32)
    num_mips = np.zeros((n,), np.int32)
    tex_type = np.zeros((n,), np.int32)
    params_f = np.zeros((n, 16), np.float32)
    params_c = np.zeros((n, 2, 4), np.float32)
    params_c[:, 0] = (0, 0, 0, 1)
    params_c[:, 1] = (1, 1, 1, 1)
    ramp_pos = np.zeros((n, RAMP_MAX), np.float32)
    ramp_col = np.zeros((n, RAMP_MAX, 4), np.float32)
    ramp_count = np.zeros((n,), np.int32)
    ramp_mode = np.zeros((n,), np.int32)
    interp = np.zeros((n,), np.int32)
    extend = np.zeros((n,), np.int32)
    adj = np.zeros((n, 8), np.float32)
    used_noise = set()
    max_oct = 2

    for i, name in enumerate(names):
        pm = builder.textures[name]
        ty_name = pm.get_string("type", "image")
        if ty_name not in _TEX_BY_NAME:
            raise KeyError(f"texture: unknown type {ty_name!r}")
        ty = tex_type[i] = _TEX_BY_NAME[ty_name]
        if "color1" in pm:
            params_c[i, 0] = pm.get_color("color1")
        if "color2" in pm:
            params_c[i, 1] = pm.get_color("color2")
        adj[i] = (pm.get_float("adj_mult_factor_red", 1.0),
                  pm.get_float("adj_mult_factor_green", 1.0),
                  pm.get_float("adj_mult_factor_blue", 1.0),
                  pm.get_float("adj_intensity", 1.0),
                  pm.get_float("adj_contrast", 1.0),
                  pm.get_float("adj_saturation", 1.0),
                  pm.get_float("adj_hue", 0.0),
                  1.0 if pm.get_bool("adj_clamp", False) else 0.0)
        if pm.get_bool("use_color_ramp", False):
            items = pm.get("ramp_items", [])
            cnt = min(len(items), RAMP_MAX)
            for k in range(cnt):
                it = items[k]
                ramp_pos[i, k] = float(it.get("position", k / max(cnt - 1, 1)))
                c = np.asarray(it.get("color", (0, 0, 0, 1)), np.float32)
                ramp_col[i, k, : len(c)] = c[:4]
            ramp_count[i] = cnt
            ramp_mode[i] = {"rgb": 0, "hsv": 1, "hsl": 2}.get(
                pm.get_string("ramp_color_mode", "rgb"), 0)
        if ty != TEX_IMAGE:
            bases, octs = _procedural_row(pm, ty, params_f[i])
            used_noise.update(bases)
            max_oct = max(max_oct, octs)
            continue

        img = _rgba(pm, builder.texture_images.get(name))
        opt = pm.get_string("image_optimization", "none")
        opt_req.append(opt if opt in ("none", "optimized", "compressed")
                       else "none")
        mips = _mip_chain(img)
        img_offset[i] = off
        img_h[i], img_w[i] = img.shape[:2]
        num_mips[i] = len(mips)
        for mi, m in enumerate(mips):
            mip_offsets[i, mi] = off
            texels.append(m.reshape(-1, 4))
            off += m.shape[0] * m.shape[1]
        params_f[i, 0] = pm.get_float("xrepeat", 1.0)
        params_f[i, 1] = pm.get_float("yrepeat", 1.0)
        params_f[i, 2] = pm.get_float("cropmin_x", 0.0)
        params_f[i, 3] = pm.get_float("cropmin_y", 0.0)
        params_f[i, 4] = pm.get_float("cropmax_x", 1.0)
        params_f[i, 5] = pm.get_float("cropmax_y", 1.0)
        params_f[i, 6] = 1.0 if pm.get_bool("mirror_x", False) else 0.0
        params_f[i, 7] = 1.0 if pm.get_bool("mirror_y", False) else 0.0
        params_f[i, 8] = pm.get_float("trilinear_level_bias", 0.0)
        params_f[i, 9] = pm.get_float("ewa_max_anisotropy", 8.0)
        interp[i] = _INTERP.get(pm.get_string("interpolate", "bilinear"), 1)
        extend[i] = _EXTEND.get(pm.get_string("clipping", "repeat"), 0)

    # the pool's dtype: the highest precision any image asks for
    texel_np = np.concatenate(texels, axis=0)
    texel_scale = np.ones((max(n, 1),), np.float32)
    if opt_req and all(o == "compressed" for o in opt_req):
        # uint8 with a scale per texture (which keeps HDR images)
        for i in range(n):
            if num_mips[i] == 0:
                continue
            end = img_offset[i] + sum(
                max(1, img_h[i] >> lv) * max(1, img_w[i] >> lv)
                for lv in range(num_mips[i]))
            sl = texel_np[img_offset[i]:end]
            sc = max(1.0, float(sl.max())) if sl.size else 1.0
            texel_scale[i] = sc
            texel_np[img_offset[i]:end] = np.clip(sl / sc, 0.0, 1.0)
        texel_np = np.round(texel_np * 255.0).astype(np.uint8)
    elif opt_req and all(o in ("optimized", "compressed") for o in opt_req):
        texel_np = texel_np.astype(np.float16)
    t = torch.from_numpy
    return TexturePool(
        texel_pool=t(texel_np), texel_scale=t(texel_scale),
        img_offset=t(img_offset), img_width=t(img_w), img_height=t(img_h),
        mip_offsets=t(mip_offsets), num_mips=t(num_mips),
        tex_type=t(tex_type), params_f=t(params_f), params_c=t(params_c),
        ramp_pos=t(ramp_pos), ramp_col=t(ramp_col),
        ramp_count=t(ramp_count), ramp_mode=t(ramp_mode), interp=t(interp),
        extend=t(extend), adj=t(adj), num_textures=n,
        used_types=tuple(sorted({int(x) for x in tex_type})),
        used_noise=tuple(sorted(used_noise)) or (0,),
        max_octaves=int(max_oct),
        statics=texture_statics(tex_type, params_f, ramp_count,
                                int(max_oct)),
        used_interps=tuple(sorted({int(x) for x in interp})))


def build_env_tables(bg: Background, tex_images: dict,
                     tex_name: str) -> Background:
    """bg with the alias-method importance tables of its equirectangular
    environment map (the pixels staged as `tex_name`): each texel weighted
    by its mean RGB times sin(theta), a Walker alias table over them, and
    each texel's solid-angle pdf. bg as it is without the pixels or with a
    black map. On the host, in numpy, in the JAX package's order, so the
    tables are the same."""
    img = tex_images.get(tex_name)
    if img is None:
        return bg
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    h, w = img.shape[:2]
    lum = img[..., :3].mean(-1)
    # the solid-angle weight of each row: sin(theta)
    theta = (np.arange(h) + 0.5) / h * np.pi
    flat = (lum * np.sin(theta)[:, None]).reshape(-1).astype(np.float64)
    total = flat.sum()
    if total <= 0:
        return bg
    prob = flat / total
    n = h * w
    texel_sa = (2 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
    pdf_sa = (prob.reshape(h, w) / np.maximum(texel_sa, 1e-12)).reshape(-1)
    # Walker's alias table
    scaled = prob * n
    alias = np.arange(n, dtype=np.int64)
    accept = np.ones(n)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        big = large.pop()
        accept[s] = scaled[s]
        alias[s] = big
        scaled[big] = scaled[big] - (1.0 - scaled[s])
        (small if scaled[big] < 1.0 else large).append(big)
    t = torch.from_numpy
    return dataclasses.replace(
        bg, env_alias_prob=t(accept.astype(np.float32)),
        env_alias_idx=t(alias.astype(np.int32)),
        env_pdf=t(pdf_sa.astype(np.float32)), env_shape=(h, w))
