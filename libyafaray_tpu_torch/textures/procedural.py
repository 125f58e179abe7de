"""Procedural texture evaluators, masked over the wavefront.

Counterpart of `libyafaray_tpu/textures/procedural.py` (the reference's
texture_basic.cc: blend, clouds, marble, wood, voronoi, musgrave,
distorted noise and rgb cube) on the noise bases of `textures/noise.py`.
Each evaluator runs on every lane and is selected by the lane's texture
type. Only the types in `used_types` run, only the bases in `used_noise`
and only `max_oct` octaves, as the JAX package traces only those: the
caller passes the pool's sets, or one texture's own (`TexturePool.statics`)
when every lane reads that texture, which gives the same values.
"""
from __future__ import annotations

import math

import torch

from ..scene_types import TexturePool
from . import (TEX_BLEND, TEX_CLOUDS, TEX_DISTORTED_NOISE, TEX_MARBLE,
               TEX_MUSGRAVE, TEX_RGB_CUBE, TEX_VORONOI, TEX_WOOD)
from .noise import static_basis_noise, voronoi_f

Tensor = torch.Tensor


def _masked_turbulence(p: Tensor, depth: Tensor, size: Tensor, hard: Tensor,
                       ntype: Tensor, max_oct: int, used_noise) -> Tensor:
    """Turbulence with a per-lane octave count and noise basis, run for
    max_oct octaves over the bases in used_noise. `size` multiplies the
    point (a frequency, as the reference's NoiseGenerator::turbulence)."""
    freq = size
    amp = torch.ones_like(size)
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    norm = torch.zeros_like(total)
    for o in range(max_oct):
        n2 = _basis_masked(ntype, p * freq[..., None], o, used_noise) \
            * 2.0 - 1.0
        n = torch.where(hard > 0, torch.abs(n2), 0.5 + 0.5 * n2)
        w = (o <= depth).to(torch.float32)
        total = total + amp * n * w
        norm = norm + amp * w
        amp = amp * 0.5
        freq = freq * 2.0
    return total / torch.clamp_min(norm, 1e-9)


def _basis_masked(ntype: Tensor, p: Tensor, seed: int, used_noise) -> Tensor:
    """The noise basis of each lane's type, over the bases in used_noise
    (one basis: that one for every lane, as in the JAX package)."""
    if len(used_noise) == 1:
        return static_basis_noise(used_noise[0], p, seed)
    out = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for k in used_noise:
        out = torch.where(ntype == k, static_basis_noise(k, p, seed), out)
    return out


def _waveform(x: Tensor, shape: Tensor) -> Tensor:
    """Sine, saw or triangle bands (marble and wood). The saw's wrap is the
    floor modulo of jnp's `%`: torch.remainder, not fmod."""
    s_sin = 0.5 + 0.5 * torch.sin(x)
    fx = torch.remainder(x / (2 * math.pi), 1.0)
    s_tri = 1.0 - 2.0 * torch.abs(fx - 0.5)
    return torch.where(shape == 1, fx, torch.where(shape == 2, s_tri, s_sin))


def eval_procedural(pool: TexturePool, tex_id: Tensor, p: Tensor,
                    used_types, used_noise, max_oct: int):
    """(colour f32[N, 4], intensity f32[N]) of the procedural types; other
    lanes get color1 and intensity 0 (the image sampler overrides them)."""
    pf = pool.params_f[tex_id]
    ty = pool.tex_type[tex_id]
    c1 = pool.params_c[tex_id, 0]
    c2 = pool.params_c[tex_id, 1]
    inten = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]

    def turb():
        return _masked_turbulence(p, pf[..., 1], pf[..., 0], pf[..., 2],
                                  pf[..., 3].to(torch.int32), max_oct,
                                  used_noise)

    if TEX_BLEND in used_types:
        # BlendTexture: the progression over x (y when flipped)
        stype = pf[..., 0]
        flip = pf[..., 1] > 0
        bx = torch.where(flip, y, x)
        by = torch.where(flip, x, y)
        lin = (1.0 + bx) * 0.5
        v = torch.where(stype == 1, lin * lin, lin)
        ease = torch.where(lin <= 0, 0.0, torch.where(
            lin >= 1, 1.0, 3.0 * (lin * lin) - 2.0 * (lin * (lin * lin))))
        v = torch.where(stype == 2, ease, v)
        v = torch.where(stype == 3, (2.0 + bx + by) * 0.25, v)
        sph = torch.clamp_min(1.0 - torch.sqrt(bx * bx + by * by + z * z),
                              0.0)
        v = torch.where(stype == 4, sph, v)
        v = torch.where(stype == 5, sph * sph, v)
        rad = torch.atan2(by, bx) / (2 * math.pi) + 0.5
        v = torch.where(stype == 6, rad, v)
        inten = torch.where(ty == TEX_BLEND, v, inten)

    if TEX_CLOUDS in used_types:
        v = turb()
        v = torch.where(pf[..., 4] == 2, 1.0 - v, v)
        inten = torch.where(ty == TEX_CLOUDS, v, inten)

    if TEX_MARBLE in used_types:
        band = (x + y + z) * 5.0 + pf[..., 4] * turb()
        v = torch.pow(torch.clamp_min(_waveform(band, pf[..., 6]), 1e-6),
                      pf[..., 5])
        inten = torch.where(ty == TEX_MARBLE, v, inten)

    if TEX_WOOD in used_types:
        t = turb()
        wt = pf[..., 5]
        rings = torch.sqrt(x * x + y * y + z * z) * 20.0
        bands = (x + y + z) * 10.0
        base = torch.where((wt == 1) | (wt == 3), rings, bands)
        wob = torch.where(wt >= 2, pf[..., 4] * t, 0.0)
        inten = torch.where(ty == TEX_WOOD, _waveform(base + wob, pf[..., 6]),
                            inten)

    if TEX_VORONOI in used_types:
        size = torch.clamp_min(pf[..., 0], 1e-9)
        f1, f2, f3, f4 = voronoi_f(p * size[..., None])
        sc = (pf[..., 1] * f1 + pf[..., 2] * f2 + pf[..., 3] * f3
              + pf[..., 4] * f4) * pf[..., 6]
        inten = torch.where(ty == TEX_VORONOI, torch.clamp(sc, 0.0, 1.0),
                            inten)

    if TEX_MUSGRAVE in used_types:
        size = torch.clamp_min(pf[..., 0], 1e-9)
        h_exp = pf[..., 1]
        lac = torch.clamp_min(pf[..., 2], 1e-6)
        octs, offs, gain, mty = pf[..., 3], pf[..., 4], pf[..., 5], pf[..., 7]
        ntype = pf[..., 8].to(torch.int32)
        pp = p * size[..., None]
        fbm = torch.zeros_like(inten)
        mult = torch.ones_like(inten)
        ridge_w = torch.ones_like(inten)
        ridge = torch.zeros_like(inten)
        freq = torch.ones_like(inten)
        for o in range(max_oct):
            w = torch.clamp(octs - o, 0.0, 1.0)   # the fractional last octave
            n = _basis_masked(ntype, pp * freq[..., None], o, used_noise) \
                * 2.0 - 1.0
            pw = torch.pow(freq, -h_exp)
            fbm = fbm + w * n * pw
            mult = mult * torch.where(w > 0, 1.0 + w * n * pw, 1.0)
            r = offs - torch.abs(n)
            r = r * r * ridge_w
            ridge = ridge + w * r * pw
            ridge_w = torch.clamp(r * gain, 0.0, 1.0)
            freq = freq * lac
        value = torch.where(mty == 1, mult - 1.0, fbm)
        value = torch.where((mty == 2) | (mty == 3), fbm + offs, value)
        value = torch.where(mty == 4, ridge, value)
        v = value * pf[..., 6]
        inten = torch.where(ty == TEX_MUSGRAVE,
                            torch.clamp(0.5 + 0.5 * v, 0.0, 1.0), inten)

    if TEX_DISTORTED_NOISE in used_types:
        size = torch.clamp_min(pf[..., 0], 1e-9)
        pp = p * size[..., None]
        n1 = pf[..., 2].to(torch.int32)
        n2 = pf[..., 3].to(torch.int32)
        off = torch.stack([_basis_masked(n1, pp, s, used_noise) * 2.0 - 1.0
                           for s in (11, 12, 13)], -1)
        pd = pp + pf[..., 1][..., None] * off
        inten = torch.where(ty == TEX_DISTORTED_NOISE,
                            _basis_masked(n2, pd, 17, used_noise), inten)

    col = c1 + (c2 - c1) * inten[..., None]

    if TEX_RGB_CUBE in used_types:
        from .eval import mean_rgb
        # |p| % 1: floor modulo as jnp's % (torch.remainder, not fmod)
        rgbc = torch.cat([torch.remainder(torch.abs(p), 1.0),
                          torch.ones_like(p[..., :1])], -1)
        cube = ty == TEX_RGB_CUBE
        col = torch.where(cube[..., None], rgbc, col)
        inten = torch.where(cube, mean_rgb(rgbc), inten)
    return col, inten
