"""Counter-based sampling, bit-exact with `libyafaray_tpu/sampler.py`.

Every sample is a pure function of integer counters (pixel id, sample index,
bounce depth, dimension), so the port draws the same numbers as the JAX
package for the same counters and renders can be compared pixel by pixel.

The JAX code does wrapping uint32 arithmetic. PyTorch lacks `+`, `<<` and
`>>` for `torch.uint32` on some devices, so here every value is an int64
holding a uint32, masked with 0xFFFFFFFF after each operation that can carry
past bit 31. A product of two uint32 values can reach 2^64 and wrap int64,
so `_mul32` splits one factor into 16-bit halves: each partial product stays
below 2^48 and the low 32 bits of the result are exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import profiling as PF

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
_INV_U32 = 2.3283064365386963e-10  # 2^-32, exact in float32
_ONE_MINUS_ULP = 0.99999994        # largest float32 below 1


def _mul32(a: Tensor, b) -> Tensor:
    """(a * b) mod 2^32 for a, b holding uint32 values (b may be an int)."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def _u32(x, like: Tensor | None = None) -> Tensor:
    """An int or tensor of uint32 values as int64 (masked)."""
    if isinstance(x, Tensor):
        return x.to(torch.int64) & M32
    if like is None:
        return torch.tensor(int(x) & M32, dtype=torch.int64)
    # a copy to the keys' device, which waits for it
    with PF.host_sync("sampler.key"):
        return torch.tensor(int(x) & M32, dtype=torch.int64,
                            device=like.device)


def _pcg4d(x: Tensor, y: Tensor, z: Tensor, w: Tensor):
    x = (_mul32(x, 1664525) + 1013904223) & M32
    y = (_mul32(y, 1664525) + 1013904223) & M32
    z = (_mul32(z, 1664525) + 1013904223) & M32
    w = (_mul32(w, 1664525) + 1013904223) & M32
    x = (x + _mul32(y, w)) & M32
    y = (y + _mul32(z, x)) & M32
    z = (z + _mul32(x, y)) & M32
    w = (w + _mul32(y, z)) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & M32
    y = (y + _mul32(z, x)) & M32
    z = (z + _mul32(x, y)) & M32
    w = (w + _mul32(y, z)) & M32
    return x, y, z, w


def pcg4d(v: Tensor) -> Tensor:
    """PCG4D hash (Jarzynski & Olano, JCGT 2020): uint32[..., 4] -> uint32[..., 4],
    values held in int64."""
    v = _u32(v)
    return torch.stack(_pcg4d(v[..., 0], v[..., 1], v[..., 2], v[..., 3]),
                       dim=-1)


def _u32_to_unit_float(u: Tensor) -> Tensor:
    """uint32 -> float32 in [0, 1): round to nearest, then clamp below 1."""
    return torch.clamp_max(u.to(torch.float32) * _INV_U32, _ONE_MINUS_ULP)


def rand4(pixel_id, sample_idx, depth, dim) -> Tensor:
    """Four independent uniforms in [0,1) keyed on (pixel, sample, depth, dim)."""
    like = next(t for t in (pixel_id, sample_idx, depth, dim)
                if isinstance(t, Tensor))
    keys = [_u32(k, like) for k in (pixel_id, sample_idx, depth, dim)]
    keys = torch.broadcast_tensors(*keys)
    return _u32_to_unit_float(torch.stack(_pcg4d(*keys), dim=-1))


def rand2(pixel_id, sample_idx, depth, dim):
    r = rand4(pixel_id, sample_idx, depth, dim)
    return r[..., 0], r[..., 1]


def rand1(pixel_id, sample_idx, depth, dim):
    return rand4(pixel_id, sample_idx, depth, dim)[..., 0]


def _reverse_bits32(x: Tensor) -> Tensor:
    x = _u32(x)
    x = ((x >> 16) | (x << 16)) & M32
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    return x


# the Larcher-Pillichshammer generator column: v starts at 1<<31 and
# becomes v ^ (v >> 1) after each bit
_LP_V = []
_v = 1 << 31
for _ in range(32):
    _LP_V.append(_v)
    _v = _v ^ (_v >> 1)
del _v


def larcher_pillichshammer(n: Tensor, scramble=0) -> Tensor:
    """Larcher-Pillichshammer (0,1)-sequence second component, over 32 bits."""
    n = _reverse_bits32(n)
    r = _u32(scramble, n)
    n, r = torch.broadcast_tensors(n, r)
    for v in _LP_V:
        r = torch.where((n & (1 << 31)) != 0, r ^ v, r)
        n = (n << 1) & M32
    return _u32_to_unit_float(r)


def _owen_hash(x: Tensor, seed) -> Tensor:
    """Laine-Karras style hash for Owen scrambling in reversed-bit space."""
    x = (_u32(x) + _u32(seed, x)) & M32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def ld02(sample_idx, scramble_key: Tensor):
    """Owen-scrambled (0,2)-sequence pair: the per-pixel jitter."""
    k = _u32(scramble_key)
    n = _u32(sample_idx, k)
    u0 = _u32_to_unit_float(_reverse_bits32(_owen_hash(n, k)))
    key = _pcg4d(k, k ^ 0x9E3779B9, torch.zeros_like(k), torch.ones_like(k))[0]
    u1 = larcher_pillichshammer(n, key)
    return u0, u1


def van_der_corput(n, scramble=0) -> Tensor:
    """Base-2 radical inverse with an XOR scramble (the reference's
    sample.h `riVdC`)."""
    n = _u32(n)
    return _u32_to_unit_float(_reverse_bits32(n) ^ _u32(scramble, n))


# the first 30 primes: the bases of `halton`
_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
           61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113)


def halton(n, base_index: int) -> Tensor:
    """Radical inverse of n in the `base_index`-th prime base (the
    reference's include/sampler/halton.h), over a fixed 13 digits (exact
    for n < base^13). Every step rounds in float32, as the JAX package
    does: the digit weights are float32 powers of 1 / base."""
    base = np.float32(_PRIMES[base_index])
    inv_base = np.float32(1.0) / base
    n = _u32(n).to(torch.float32)
    result = torch.zeros_like(n)
    f = inv_base
    for _ in range(13):
        digit = torch.floor(n * float(inv_base))
        result = result + float(f) * (n - digit * float(base))
        n = digit
        f = f * inv_base
    return torch.clamp_max(result, _ONE_MINUS_ULP)


def host_sample_offset(host_id, samples_per_host: int = 100_000) -> Tensor:
    """The disjoint sample-counter base of a render-farm node, uint32 held
    in int64: the reference's `adv_base_sampling_offset = node_id * 100000`
    (src/scene/scene.cc:608-609, 639-640), so that nodes draw decorrelated
    streams."""
    return _mul32(_u32(host_id), int(samples_per_host) & M32)
