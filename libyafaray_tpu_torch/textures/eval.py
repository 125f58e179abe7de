"""Per-lane texture evaluation: the procedural types, the image sampler,
the colour ramp and the adjustments.

Counterpart of `libyafaray_tpu/textures/eval.py`, the single entry point
behind `textures.sample_texture`. Every lane carries its own texture id.
The procedural types present in the pool (`TexturePool.used_types`) are
evaluated masked beside the image lanes, as in the JAX package; a lookup
of one known texture (`static_tex`: a texture-mapper node's, a texture
background's, a noise region's) runs only its own type, noise bases and
octaves, and its ramp only if it has one, which gives the same values. Then the Blender-style colour ramp
(src/color/color_ramp.cc) and the adj_* post adjustments (texture.h
applyAdjustments) apply, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..scene_types import SceneData
from . import TEX_IMAGE
from .image import sample_image
from .procedural import eval_procedural

Tensor = torch.Tensor


def mean_rgb(c: Tensor) -> Tensor:
    """The mean of the first three channels as `jnp.mean` computes it: the
    sum times 1/3 in f32 (torch's mean divides by 3, one last bit apart
    on a third of lanes)."""
    return c[..., :3].sum(-1) * (1.0 / 3.0)


def _select6(i: Tensor, vals):
    """vals[i] per lane for a sextant index i in [0, 6)."""
    out = vals[5]
    for k in range(4, -1, -1):
        out = torch.where(i == k, vals[k], out)
    return out


def _hue(r: Tensor, g: Tensor, b: Tensor, mx: Tensor, d: Tensor) -> Tensor:
    safe = torch.clamp_min(d, 1e-9)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0)) / 6.0
    return torch.where(d <= 1e-9, 0.0, h)


def _rgb_to_hsv(c: Tensor):
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    h = _hue(r, g, b, mx, d)
    s = torch.where(mx > 1e-9, d / torch.clamp_min(mx, 1e-9), 0.0)
    return h, s, mx


def _hsv_to_rgb(h: Tensor, s: Tensor, v: Tensor) -> Tensor:
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    return torch.stack([_select6(i, (v, q, p, p, t, v)),
                        _select6(i, (t, v, v, q, p, p)),
                        _select6(i, (p, p, t, v, v, q))], -1)


def _rgb_to_hsl(c: Tensor):
    """Rgb::rgbToHsl (color.h): lightness (max + min) / 2."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    l_ = 0.5 * (mx + mn)
    h = _hue(r, g, b, mx, d)
    denom = torch.clamp_min(1.0 - torch.abs(2.0 * l_ - 1.0), 1e-9)
    s = torch.where(d <= 1e-9, 0.0, d / denom)
    return h, s, l_


def _hsl_to_rgb(h: Tensor, s: Tensor, l_: Tensor) -> Tensor:
    """hslToRgb by chroma (the inverse of _rgb_to_hsl)."""
    c = (1.0 - torch.abs(2.0 * l_ - 1.0)) * s
    h6 = torch.remainder(h, 1.0) * 6.0
    x = c * (1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0))
    i = torch.remainder(torch.floor(h6).to(torch.int32), 6)
    z = torch.zeros_like(c)
    m = l_ - 0.5 * c
    return torch.stack([_select6(i, (c, x, z, z, x, c)) + m,
                        _select6(i, (x, c, c, x, z, z)) + m,
                        _select6(i, (z, z, x, c, c, x)) + m], -1)


def _near_hue(dh: Tensor) -> Tensor:
    return torch.where(dh > 0.5, dh - 1.0,
                       torch.where(dh < -0.5, dh + 1.0, dh))


def apply_ramp(pool, tex_id: Tensor, inten: Tensor, col: Tensor) -> Tensor:
    """The colour ramp's remap of the texture intensity (color_ramp.cc:
    66-110: RGB, HSV or true HSL interpolation, the near hue path)."""
    cnt = pool.ramp_count[tex_id]
    pos = pool.ramp_pos[tex_id]          # [N, RAMP_MAX]
    cols = pool.ramp_col[tex_id]         # [N, RAMP_MAX, 4]
    r = pos.shape[-1]
    x = inten
    # the segment: the largest k with pos[k] <= x (positions sorted)
    ks = torch.arange(r, device=pos.device)
    idx = ((pos <= x[..., None]) & (ks[None, :] < cnt[..., None])).sum(
        -1, dtype=torch.int32) - 1
    i0 = torch.clamp(idx, 0, r - 1)
    i1 = torch.minimum(torch.clamp(idx + 1, 0, r - 1),
                       torch.clamp_min(cnt - 1, 0))

    def pick(tab, ii):
        ii = ii.long()[:, None]
        if tab.dim() == 3:
            return torch.gather(tab, 1, ii[..., None].expand(-1, 1, 4))[:, 0]
        return torch.gather(tab, 1, ii)[:, 0]

    p0, p1 = pick(pos, i0), pick(pos, i1)
    c0, c1 = pick(cols, i0), pick(cols, i1)
    t = torch.clamp((x - p0) / torch.clamp_min(p1 - p0, 1e-9), 0.0, 1.0)
    t = torch.where(i0 == i1, 0.0, t)
    lin = c0 + (c1 - c0) * t[..., None]
    h0, s0, v0 = _rgb_to_hsv(c0[..., :3])
    h1, s1, v1 = _rgb_to_hsv(c1[..., :3])
    hsv_rgb = _hsv_to_rgb(h0 + _near_hue(h1 - h0) * t, s0 + (s1 - s0) * t,
                          v0 + (v1 - v0) * t)
    hsv = torch.cat([hsv_rgb, lin[..., 3:]], -1)
    g0, q0, l0 = _rgb_to_hsl(c0[..., :3])
    g1, q1, l1 = _rgb_to_hsl(c1[..., :3])
    hsl_rgb = _hsl_to_rgb(g0 + _near_hue(g1 - g0) * t, q0 + (q1 - q0) * t,
                          l0 + (l1 - l0) * t)
    hsl = torch.cat([hsl_rgb, lin[..., 3:]], -1)
    mode = pool.ramp_mode[tex_id]
    ramped = torch.where((mode == 2)[..., None], hsl,
                         torch.where((mode == 1)[..., None], hsv, lin))
    return torch.where((cnt > 0)[..., None], ramped, col)


def apply_adjustments(pool, tex_id: Tensor, col: Tensor) -> Tensor:
    """adj_*: per-channel scale, intensity, contrast, saturation, hue shift
    and clamp (the reference's Texture::applyAdjustments)."""
    adj = pool.adj[tex_id]
    rgb = col[..., :3] * adj[..., :3] * adj[..., 3:4]
    rgb = (rgb - 0.5) * adj[..., 4:5] + 0.5
    # saturation and hue in HSV
    needs_hsv = (adj[..., 5] != 1.0) | (adj[..., 6] != 0.0)
    h, s, v = _rgb_to_hsv(torch.clamp_min(rgb, 0.0))
    rgb_hsv = _hsv_to_rgb(h + adj[..., 6],
                          torch.clamp(s * adj[..., 5], 0, 1), v)
    rgb = torch.where(needs_hsv[..., None], rgb_hsv, rgb)
    rgb = torch.where((adj[..., 7] > 0)[..., None],
                      torch.clamp(rgb, 0.0, 1.0), rgb)
    return torch.cat([rgb, col[..., 3:]], -1)


def eval_textures(scene: SceneData, tex_id: Tensor, p: Tensor, uv: Tensor,
                  lod: Optional[Tensor] = None,
                  duv_dx: Optional[Tensor] = None,
                  duv_dy: Optional[Tensor] = None,
                  static_tex: Optional[int] = None) -> Tensor:
    """rgba f32[N, 4] per lane for per-lane texture ids; `static_tex`, when
    given, is the one texture every lane reads."""
    pool = scene.textures
    if pool is None or pool.num_textures == 0:
        return torch.zeros(p.shape[:-1] + (4,), dtype=torch.float32,
                           device=p.device)
    tex_id = torch.clamp(tex_id, 0, pool.num_textures - 1).long()
    if static_tex is None:
        types, noise, octs = (pool.used_types, pool.used_noise,
                              pool.max_octaves)
        ramped = any(st[3] for st in pool.statics)
    else:
        ty, noise, octs, ramped = pool.statics[static_tex]
        types = (ty,)
    procedural = any(t != TEX_IMAGE for t in types)
    if procedural:
        col, inten = eval_procedural(pool, tex_id, p, types, noise, octs)
    if TEX_IMAGE in types:
        img = sample_image(pool, tex_id, uv, lod, duv_dx, duv_dy)
        if procedural:
            is_img = pool.tex_type[tex_id] == TEX_IMAGE
            col = torch.where(is_img[..., None], img, col)
            inten = torch.where(is_img, mean_rgb(img), inten)
        else:
            col, inten = img, mean_rgb(img)
    if ramped:       # without a ramp apply_ramp returns col as it is
        col = apply_ramp(pool, tex_id, inten, col)
    return apply_adjustments(pool, tex_id, col)
