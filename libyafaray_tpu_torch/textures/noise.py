"""Procedural noise: lattice hashes, the noise bases and turbulence.

Counterpart of `libyafaray_tpu/textures/noise.py` (the reference's
noise_generator.cc: newperlin, stdperlin, cellnoise, voronoi F1-F4 and the
fBm / turbulence combinators), with its counter-based integer hash in
place of the permutation tables. Every function takes points p[..., 3]
and returns values in about [0, 1].

The JAX hash works in wrapping uint32. Here every hash value is an int64
holding a uint32, masked with M32 after each operation that can carry
past bit 31, and multiplied through the sampler's `_mul32` (a plain int64
product of two 32-bit values overflows). A negative lattice coordinate
wraps as `astype(uint32)` wraps it: x & M32.
"""
from __future__ import annotations

import torch

from ..sampler import M32, _mul32

Tensor = torch.Tensor

_INV_U32 = 2.3283064365386963e-10   # 2^-32, exact in float32


_HX, _HY, _HZ = 0x8DA6B343, 0xD8163841, 0xCB1AB31F   # the lattice weights


def _axis(i: Tensor, weight: int) -> Tensor:
    """One lattice coordinate's share of the hash: (i mod 2^32) * weight
    mod 2^32. The three shares add mod 2^32 as the JAX package's uint32
    sum does, so a noise function computes each coordinate's share once
    and reuses it at every corner and seed."""
    return _mul32(i.to(torch.int64) & M32, weight)


def _finish(lattice: Tensor, seed: int) -> Tensor:
    """The hash of a lattice sum (the three shares added, unmasked): the
    seed's constant added mod 2^32, then the xorshift-multiply mix."""
    h = (lattice + ((seed * 0x9E3779B9) & M32)) & M32
    h = h ^ (h >> 13)
    h = _mul32(h, 0x85EBCA6B)
    return h ^ (h >> 16)


def _hash3(ix: Tensor, iy: Tensor, iz: Tensor, seed: int = 0) -> Tensor:
    """Integer lattice hash: uint32 (held in int64) of three int lattice
    coordinates, the JAX package's pcg-style mix."""
    return _finish(_axis(ix, _HX) + _axis(iy, _HY) + _axis(iz, _HZ), seed)


def _unit(h: Tensor) -> Tensor:
    """A hash as a float in [0, 1]: the uint32 rounded to the nearest
    float32 (XLA's convert), times 2^-32. A hash within 128 of 2^32 rounds
    to 2^32 and gives exactly 1.0; unlike the sampler's draws this is not
    clamped below 1, as in the JAX package."""
    return h.to(torch.float32) * _INV_U32


def _hash_unit(ix, iy, iz, seed: int = 0) -> Tensor:
    """The hash of a lattice point as a float in [0, 1] (`_unit`)."""
    return _unit(_hash3(ix, iy, iz, seed))


def _grad_dot(h: Tensor, fx: Tensor, fy: Tensor, fz: Tensor) -> Tensor:
    """Gradient dot product from the hash's low 4 bits (improved Perlin's
    gradient set)."""
    h = h & 15
    u = torch.where(h < 8, fx, fy)
    v = torch.where(h < 4, fy, torch.where((h == 12) | (h == 14), fx, fz))
    return (torch.where((h & 1) != 0, -u, u)
            + torch.where((h & 2) != 0, -v, v))


def _fade(t: Tensor) -> Tensor:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _cell(p: Tensor):
    """(floor(p), its int64 lattice coordinates ix, iy, iz)."""
    pf = torch.floor(p)
    ii = pf.to(torch.int32).to(torch.int64)
    return pf, ii[..., 0], ii[..., 1], ii[..., 2]


def _corner_sums(ix: Tensor, iy: Tensor, iz: Tensor):
    """lattice(dx, dy, dz): the hash's lattice sum at the cell corner
    (ix + dx, iy + dy, iz + dz), from each axis's two shares."""
    sx = [_axis(ix + k, _HX) for k in (0, 1)]
    sy = [_axis(iy + k, _HY) for k in (0, 1)]
    sz = [_axis(iz + k, _HZ) for k in (0, 1)]
    return lambda dx, dy, dz: sx[dx] + sy[dy] + sz[dz]


def perlin(p: Tensor, seed: int = 0) -> Tensor:
    """Improved Perlin noise ('newperlin') in [0, 1]."""
    pf, ix, iy, iz = _cell(p)
    fx = p[..., 0] - pf[..., 0]
    fy = p[..., 1] - pf[..., 1]
    fz = p[..., 2] - pf[..., 2]
    u, v, w = _fade(fx), _fade(fy), _fade(fz)
    lattice = _corner_sums(ix, iy, iz)

    def corner(dx, dy, dz):
        h = _finish(lattice(dx, dy, dz), seed)
        return _grad_dot(h, fx - dx, fy - dy, fz - dz)

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    x00 = c000 + u * (c100 - c000)
    x10 = c010 + u * (c110 - c010)
    x01 = c001 + u * (c101 - c001)
    x11 = c011 + u * (c111 - c011)
    y0 = x00 + v * (x10 - x00)
    y1 = x01 + v * (x11 - x01)
    n = y0 + w * (y1 - y0)
    return torch.clamp(0.5 + 0.5 * n, 0.0, 1.0)


def cellnoise(p: Tensor, seed: int = 0) -> Tensor:
    """A constant hash value per lattice cell (the reference's cellNoise)."""
    _, ix, iy, iz = _cell(p)
    return _hash_unit(ix, iy, iz, seed)


def value_noise(p: Tensor, seed: int = 0) -> Tensor:
    """Lattice value noise, interpolated with the fade curve ('stdperlin')."""
    pf, ix, iy, iz = _cell(p)
    fx = _fade(p[..., 0] - pf[..., 0])
    fy = _fade(p[..., 1] - pf[..., 1])
    fz = _fade(p[..., 2] - pf[..., 2])
    lattice = _corner_sums(ix, iy, iz)

    def c(dx, dy, dz):
        return _unit(_finish(lattice(dx, dy, dz), seed))

    c000 = c(0, 0, 0)
    c010 = c(0, 1, 0)
    c001 = c(0, 0, 1)
    c011 = c(0, 1, 1)
    x00 = c000 + fx * (c(1, 0, 0) - c000)
    x10 = c010 + fx * (c(1, 1, 0) - c010)
    x01 = c001 + fx * (c(1, 0, 1) - c001)
    x11 = c011 + fx * (c(1, 1, 1) - c011)
    y0 = x00 + fy * (x10 - x00)
    y1 = x01 + fy * (x11 - x01)
    return y0 + fz * (y1 - y0)


NOISE_NEWPERLIN = 0
NOISE_STDPERLIN = 1
NOISE_CELL = 2
NOISE_VORONOI_F1 = 3
NOISE_VORONOI_F2 = 4
NOISE_VORONOI_F3 = 5
NOISE_VORONOI_F4 = 6
NOISE_VORONOI_F2F1 = 7
NOISE_VORONOI_CRACKLE = 8

_NOISE_BY_NAME = {
    "newperlin": NOISE_NEWPERLIN, "improved_perlin": NOISE_NEWPERLIN,
    "stdperlin": NOISE_STDPERLIN, "original_perlin": NOISE_STDPERLIN,
    "blender": NOISE_STDPERLIN, "blender_original": NOISE_STDPERLIN,
    "cellnoise": NOISE_CELL, "cell_noise": NOISE_CELL,
    "voronoi_f1": NOISE_VORONOI_F1, "voronoi_f2": NOISE_VORONOI_F2,
    "voronoi_f3": NOISE_VORONOI_F3, "voronoi_f4": NOISE_VORONOI_F4,
    "voronoi_f2f1": NOISE_VORONOI_F2F1,
    "voronoi_crackle": NOISE_VORONOI_CRACKLE,
}
_VORONOI = (NOISE_VORONOI_F1, NOISE_VORONOI_F2, NOISE_VORONOI_F3,
            NOISE_VORONOI_F4, NOISE_VORONOI_F2F1, NOISE_VORONOI_CRACKLE)


def noise_type_id(name: str) -> int:
    """The NOISE_* id of a noise name (newperlin for unknown names)."""
    return _NOISE_BY_NAME.get(name, NOISE_NEWPERLIN)


def voronoi_f(p: Tensor, seed: int = 0):
    """(f1, f2, f3, f4): the four nearest distances to the hashed feature
    points of the 3x3x3 cells around p (the reference's voronoi). The cells
    are visited in the JAX package's order and every update is a strict <,
    so ties resolve as there."""
    _, ix, iy, iz = _cell(p)
    f1 = torch.full(p.shape[:-1], 1e10, dtype=torch.float32, device=p.device)
    f2, f3, f4 = f1.clone(), f1.clone(), f1.clone()
    shares = [[_axis(i + k, w) for k in (-1, 0, 1)]
              for i, w in ((ix, _HX), (iy, _HY), (iz, _HZ))]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                lattice = (shares[0][dx + 1] + shares[1][dy + 1]
                           + shares[2][dz + 1])
                fx = (ix + dx).to(torch.float32) + _unit(_finish(lattice,
                                                                 seed))
                fy = (iy + dy).to(torch.float32) + _unit(_finish(lattice,
                                                                 seed + 1))
                fz = (iz + dz).to(torch.float32) + _unit(_finish(lattice,
                                                                 seed + 2))
                ex = p[..., 0] - fx
                ey = p[..., 1] - fy
                ez = p[..., 2] - fz
                d = torch.sqrt(ex * ex + ey * ey + ez * ez)
                lt1, lt2, lt3, lt4 = d < f1, d < f2, d < f3, d < f4
                f4 = torch.where(lt4, torch.where(lt3, f3, d), f4)
                f3 = torch.where(lt3, torch.where(lt2, f2, d), f3)
                f2 = torch.where(lt2, torch.where(lt1, f1, d), f2)
                f1 = torch.where(lt1, d, f1)
    return f1, f2, f3, f4


def _voronoi_basis(kind: int, f) -> Tensor:
    f1, f2, f3, f4 = f
    if kind == NOISE_VORONOI_F1:
        return torch.clamp(f1, 0, 1)
    if kind == NOISE_VORONOI_F2:
        return torch.clamp(f2, 0, 1)
    if kind == NOISE_VORONOI_F3:
        return torch.clamp(f3, 0, 1)
    if kind == NOISE_VORONOI_F4:
        return torch.clamp(f4, 0, 1)
    if kind == NOISE_VORONOI_F2F1:
        return torch.clamp(f2 - f1, 0, 1)
    return torch.clamp(1.0 - 0.5 * (f2 - f1), 0.0, 1.0)


def basis_noise(kind: Tensor, p: Tensor, seed: int = 0) -> Tensor:
    """The noise basis chosen per lane by `kind` (every basis computed,
    then selected, as in the JAX package)."""
    f = voronoi_f(p, seed)
    out = perlin(p, seed)
    out = torch.where(kind == NOISE_STDPERLIN, value_noise(p, seed), out)
    out = torch.where(kind == NOISE_CELL, cellnoise(p, seed), out)
    for k in _VORONOI:
        out = torch.where(kind == k, _voronoi_basis(k, f), out)
    return out


def static_basis_noise(kind: int, p: Tensor, seed: int = 0) -> Tensor:
    """The noise basis `kind` (a Python int): only that generator runs."""
    if kind == NOISE_STDPERLIN:
        return value_noise(p, seed)
    if kind == NOISE_CELL:
        return cellnoise(p, seed)
    if kind in _VORONOI:
        return _voronoi_basis(kind, voronoi_f(p, seed))
    return perlin(p, seed)


def turbulence(p: Tensor, oct_: int, size: Tensor, hard: bool,
               kind: int = NOISE_NEWPERLIN, seed: int = 0) -> Tensor:
    """fBm turbulence over `oct_` octaves (a Python int) of frequency
    1 / size: the sum of |noise| (hard) or of noise, normalised."""
    amp = 1.0
    freq = 1.0 / torch.clamp_min(size, 1e-9)
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    norm = 0.0
    for o in range(max(int(oct_), 1)):
        n = static_basis_noise(kind, p * freq, seed + o) * 2.0 - 1.0
        n = torch.abs(n) if hard else 0.5 + 0.5 * n
        total = total + amp * n
        norm += amp
        amp *= 0.5
        freq = freq * 2.0
    return total / norm
