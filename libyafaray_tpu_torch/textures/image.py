"""Image texture sampling from the flat texel pool.

Counterpart of `libyafaray_tpu/textures/image.py`: nearest, bilinear,
bicubic (Catmull-Rom) and trilinear-mipmap sampling with the repeat,
extend, clip and checker wrap modes, crop windows and mirrored tiling, and
EWA as eight Gaussian-weighted trilinear probes along the footprint's major
axis (the JAX package's fixed-footprint form of the reference's texel loop,
texture_image.cc:345-443). Every tap is one row gather from the pool for
the whole wavefront, through `ops.fast_grad.take`, as the JAX package's
goes through its `fast_take`. Integer wraps use floor modulo
(`torch.remainder`), as JAX's `%` does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.fast_grad import take
from ..scene_types import TexturePool

Tensor = torch.Tensor

EWA_TAPS = 8              # probes along the ellipse's major axis
EWA_MAX_ANISOTROPY = 8.0  # the reference's default (texture_image.cc:547)
_EWA_T = np.linspace(-0.5, 0.5, EWA_TAPS).astype(np.float32)
_EWA_W = np.exp(np.float32(-2.0) * (_EWA_T * np.float32(2.0)) ** 2)
_EWA_W = (_EWA_W / _EWA_W.sum()).astype(np.float32)


def _wrap(coord: Tensor, n: Tensor, extend: Tensor, mirror: Tensor):
    """The wrap mode applied to integer texel coordinates: (wrapped,
    inside the image)."""
    ns = torch.clamp_min(n, 1)
    # repeat (mode 0), optionally mirrored
    period = torch.remainder(coord, 2 * ns)
    mirrored = torch.where(period >= ns, 2 * ns - 1 - period, period)
    rep = torch.where(mirror > 0, mirrored, torch.remainder(coord, ns))
    ext = torch.minimum(torch.clamp_min(coord, 0), ns - 1)
    inside = (coord >= 0) & (coord < ns)
    out = torch.where(extend == 0, rep, ext)
    # clip (2): outside is transparent black, through `inside`; checker
    # (3) repeats, and the caller applies the tile parity
    out = torch.where(extend == 3, torch.remainder(coord, ns), out)
    return out, inside


def _fetch(pool: TexturePool, base: Tensor, w: Tensor, h: Tensor,
           xi: Tensor, yi: Tensor, extend: Tensor, mx: Tensor, my: Tensor):
    xw, in_x = _wrap(xi, w, extend, mx)
    yw, in_y = _wrap(yi, h, extend, my)
    inside = in_x & in_y
    flat = base + yw * w + xw
    texel = take(pool.texel_pool, flat.long(), "texel_pool")
    if texel.dtype == torch.uint8:
        # compressed pool: dequantised (the caller applies the scale)
        texel = texel.to(torch.float32) * (1.0 / 255.0)
    elif texel.dtype != torch.float32:
        texel = texel.to(torch.float32)      # optimized (f16) pool
    clip = extend == 2
    return torch.where((clip & ~inside)[..., None], 0.0, texel)


def _cr_weights(t: Tensor):
    """The four Catmull-Rom weights at fraction t."""
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t,
            1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t,
            0.5 * t3 - 0.5 * t2)


def _sample_level(pool: TexturePool, tex_id: Tensor, u: Tensor, v: Tensor,
                  base: Tensor, w: Tensor, h: Tensor, interp: Tensor,
                  modes=(0, 1, 2)):
    """One mip level at (u, v) in [0, 1): nearest, bilinear or bicubic per
    lane. The JAX package computes all three; here nearest (0) and bicubic
    (2) are computed only when `modes`, the interpolations the lanes may
    ask for, holds them, which picks the same values."""
    pf = pool.params_f[tex_id]
    extend = pool.extend[tex_id]
    mx = pf[..., 6]
    my = pf[..., 7]
    fx = u * w.to(torch.float32) - 0.5
    fy = v * h.to(torch.float32) - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = fx - x0.to(torch.float32)
    ty = fy - y0.to(torch.float32)
    fetch = lambda xi, yi: _fetch(pool, base, w, h, xi, yi, extend, mx, my)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    txe = tx[..., None]
    tye = ty[..., None]
    bil = ((c00 * (1 - txe) + c10 * txe) * (1 - tye)
           + (c01 * (1 - txe) + c11 * txe) * tye)
    out = bil
    if 0 in modes:
        near = fetch(torch.round(fx).to(torch.int32),
                     torch.round(fy).to(torch.int32))
        out = torch.where((interp == 0)[..., None], near, bil)
    if 2 not in modes:
        return out

    # bicubic Catmull-Rom (interp 2)
    wx = _cr_weights(tx)
    wy = _cr_weights(ty)
    acc = None
    for j in range(4):
        row = None
        for i in range(4):
            c = fetch(x0 - 1 + i, y0 - 1 + j) * wx[i][..., None]
            row = c if row is None else row + c
        row = row * wy[j][..., None]
        acc = row if acc is None else acc + row
    return torch.where((interp == 2)[..., None], acc, out)


def _norm2(x: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(x[..., 0] * x[..., 0]
                                      + x[..., 1] * x[..., 1], 1e-20))


def sample_image(pool: TexturePool, tex_id: Tensor, uv: Tensor,
                 lod: Optional[Tensor] = None,
                 duv_dx: Optional[Tensor] = None,
                 duv_dy: Optional[Tensor] = None) -> Tensor:
    """rgba f32[N, 4] of image textures at uv (any real values: the wrap
    mode applies). The mip level comes from an explicit per-lane `lod`, or
    from the uv-space screen derivatives duv_dx / duv_dy, which also give
    the EWA ellipse; without either, trilinear and EWA lanes sample level
    0 as their base interpolation."""
    pf = pool.params_f[tex_id]
    # crop window and repeat counts (texture_image.cc's mapping chain)
    xrep = torch.clamp_min(pf[..., 0], 1e-9)
    yrep = torch.clamp_min(pf[..., 1], 1e-9)
    u = uv[..., 0] * xrep
    v = (1.0 - uv[..., 1]) * yrep          # image rows run top-down
    cminx, cminy = pf[..., 2], pf[..., 3]
    cmaxx, cmaxy = pf[..., 4], pf[..., 5]
    has_crop = (cminx != 0.0) | (cminy != 0.0) | (cmaxx != 1.0) | (cmaxy
                                                                   != 1.0)
    u = torch.where(has_crop,
                    cminx + torch.remainder(u, 1.0) * (cmaxx - cminx), u)
    v = torch.where(has_crop,
                    cminy + torch.remainder(v, 1.0) * (cmaxy - cminy), v)

    interp = pool.interp[tex_id]
    w0 = pool.img_width[tex_id]
    h0 = pool.img_height[tex_id]
    out = _sample_level(pool, tex_id, torch.remainder(u, 1.0),
                        torch.remainder(v, 1.0), pool.img_offset[tex_id], w0,
                        h0, interp, pool.used_interps)

    # the trilinear / EWA machinery runs only when a texture uses it
    any_mip = 3 in pool.used_interps or 4 in pool.used_interps
    any_ewa = 4 in pool.used_interps
    mip_rows = pool.mip_offsets[tex_id] if any_mip else None
    num_mips = pool.num_mips[tex_id]

    def trilinear(uq, vq, lod_c):
        l0 = torch.floor(lod_c).to(torch.int32)
        l1 = torch.minimum(l0 + 1, torch.clamp_min(num_mips - 1, 0))
        fl = (lod_c - l0.to(torch.float32))[..., None]

        def level(li):
            base = torch.gather(mip_rows, 1, li.long()[:, None])[:, 0]
            wl = torch.clamp_min(torch.bitwise_right_shift(w0, li), 1)
            hl = torch.clamp_min(torch.bitwise_right_shift(h0, li), 1)
            return _sample_level(pool, tex_id, torch.remainder(uq, 1.0),
                                 torch.remainder(vq, 1.0),
                                 torch.clamp_min(base, 0), wl, hl,
                                 torch.ones_like(interp), (1,))
        return level(l0) * (1 - fl) + level(l1) * fl

    nm_f = torch.clamp_min(num_mips - 1, 0).to(torch.float32)
    if any_mip and lod is None and duv_dx is not None:
        # the derivatives are in uv: scale them like u and v above
        sx = torch.where(has_crop, xrep * (cmaxx - cminx), xrep)
        sy = torch.where(has_crop, yrep * (cmaxy - cminy), yrep)
        s = torch.stack([sx, sy], -1)
        dx = duv_dx * s
        dy = duv_dy * s
        # texel-space lengths of the two screen axes
        tex_scale = torch.stack([w0.to(torch.float32),
                                 h0.to(torch.float32)], -1)
        lx = _norm2(dx * tex_scale)
        ly = _norm2(dy * tex_scale)
        major = torch.maximum(lx, ly)
        minor = torch.minimum(lx, ly)
        # the anisotropy clamp (texture_image.cc:361-368)
        minor = torch.where(minor * EWA_MAX_ANISOTROPY < major,
                            major / EWA_MAX_ANISOTROPY, minor)
        lod_tri = torch.minimum(torch.clamp_min(
            torch.log2(torch.clamp_min(major, 1e-9)) + pf[..., 8], 0.0), nm_f)
        lod_ewa = torch.minimum(torch.clamp_min(
            torch.log2(torch.clamp_min(minor, 1e-9)) + pf[..., 8], 0.0), nm_f)
        tri = trilinear(u, v, lod_tri)
        out = torch.where((interp == 3)[..., None], tri, out)
        if any_ewa:
            # Gaussian-weighted probes along the major axis
            maj_uv = torch.where((lx >= ly)[..., None], dx, dy)
            ewa = None
            for k in range(EWA_TAPS):
                tk, wk = float(_EWA_T[k]), float(_EWA_W[k])
                probe = wk * trilinear(u + tk * maj_uv[..., 0],
                                       v + tk * maj_uv[..., 1], lod_ewa)
                ewa = probe if ewa is None else ewa + probe
            out = torch.where((interp == 4)[..., None], ewa, out)
    elif any_mip and lod is not None:
        lod_c = torch.minimum(torch.clamp_min(lod + pf[..., 8], 0.0), nm_f)
        wants_mip = (interp == 3) | (interp == 4)
        out = torch.where(wants_mip[..., None], trilinear(u, v, lod_c), out)

    # checker: odd tiles are transparent
    extend = pool.extend[tex_id]
    parity = torch.remainder(torch.floor(u).to(torch.int32)
                             + torch.floor(v).to(torch.int32), 2)
    out = torch.where(((extend == 3) & (parity == 1))[..., None], 0.0, out)
    if pool.texel_pool.dtype == torch.uint8:
        # compressed pool: the texture's dequantisation scale (HDR-safe)
        out = out * pool.texel_scale[tex_id][..., None]
    return out
