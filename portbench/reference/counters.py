"""The samples of a render as functions of integer counters: the inputs
that the program and the reference share, as a seed is shared.

Every number a sample draws is fixed by (pixel id, sample index, bounce,
dimension): the PCG4D hash (Jarzynski and Olano, "Hash Functions for GPU
Rendering", JCGT 9(3), 2020) of the four counters, each output word taken
as a uniform in [0, 1) (u / 2^32 rounded to float32, and below 1). A
pixel's film position is its corner plus an Owen-scrambled (0,2)-sequence
point: the first coordinate the bit-reversed Laine-Karras hash of the
sample index, the second the Larcher-Pillichshammer radical inverse, each
scrambled from a PCG4D hash of the pixel id.

Written from those definitions, in 32-bit words held in int64 (every sum
and product taken modulo 2^32).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

MASK = (1 << 32) - 1
_TWO_TO_MINUS_32 = 2.0 ** -32
_BELOW_ONE = 0.99999994          # the largest float32 under 1


def _mulmod(a: Tensor, k: int) -> Tensor:
    """(a * k) mod 2^32 for words a and a constant word k, without leaving
    int64: the product is split on k's 16-bit halves."""
    k_lo, k_hi = k & 0xFFFF, k >> 16
    return (a * k_lo + (((a * k_hi) & 0xFFFF) << 16)) & MASK


def _mulmod_t(a: Tensor, b: Tensor) -> Tensor:
    """(a * b) mod 2^32 for two tensors of words."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & MASK


def pcg4d(x: Tensor, y: Tensor, z: Tensor, w: Tensor):
    """The PCG4D hash of four tensors of words (int64 holding uint32)."""
    x, y, z, w = ((_mulmod(c & MASK, 1664525) + 1013904223) & MASK
                  for c in (x, y, z, w))
    for rnd in range(2):
        x = (x + _mulmod_t(y, w)) & MASK
        y = (y + _mulmod_t(z, x)) & MASK
        z = (z + _mulmod_t(x, y)) & MASK
        w = (w + _mulmod_t(y, z)) & MASK
        if rnd == 0:
            x, y, z, w = (c ^ (c >> 16) for c in (x, y, z, w))
    return x, y, z, w


def unit(word: Tensor) -> Tensor:
    """A word as a float32 uniform in [0, 1)."""
    return torch.clamp_max(word.to(torch.float32) * _TWO_TO_MINUS_32,
                           _BELOW_ONE)


def uniforms(pixel: Tensor, sample: int, bounce: int, dim: int) -> Tensor:
    """f32[N, 4]: the four uniforms of counters (pixel, sample, bounce,
    dim) for each pixel id."""
    full = lambda v: torch.full_like(pixel, int(v) & MASK)
    words = pcg4d(pixel & MASK, full(sample), full(bounce), full(dim))
    return torch.stack([unit(c) for c in words], dim=-1)


def _bit_reverse(x: Tensor) -> Tensor:
    out = torch.zeros_like(x)
    for b in range(32):
        out = out | (((x >> b) & 1) << (31 - b))
    return out


def _laine_karras(x: Tensor, seed: Tensor) -> Tensor:
    x = (x + seed) & MASK
    for k in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mulmod(x, k)
    return x


def _larcher_pillichshammer(n: Tensor, scramble: Tensor) -> Tensor:
    """The radical inverse whose generator column starts at bit 31 and
    becomes v ^ (v >> 1) at each bit, over the bits of n from the lowest."""
    r = scramble.clone()
    v = 1 << 31
    for b in range(32):
        r = torch.where(((n >> b) & 1) != 0, r ^ v, r)
        v = v ^ (v >> 1)
    return unit(r)


def film_position(pixel: Tensor, sample: int, width: int):
    """(px, py) f32: where sample `sample` of each pixel id lands on the
    film, the pixel's corner plus its jitter."""
    key = pcg4d(pixel & MASK, torch.full_like(pixel, 0x9E3779B9),
                torch.full_like(pixel, 7), torch.full_like(pixel, 11))[0]
    n = torch.full_like(key, int(sample) & MASK)
    ju = unit(_bit_reverse(_laine_karras(n, key)))
    key2 = pcg4d(key, key ^ 0x9E3779B9, torch.zeros_like(key),
                 torch.ones_like(key))[0]
    jv = _larcher_pillichshammer(n, key2)
    return ((pixel % width).to(torch.float32) + ju,
            (pixel // width).to(torch.float32) + jv)
