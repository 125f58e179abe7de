"""Morton (Z-order) codes: the 30-bit 3D interleave.

Counterpart of `libyafaray_tpu/accel/morton.py`. uint32 values are held in
int64 tensors and masked to 32 bits after every product (torch lacks
uint32 arithmetic on some devices, as in `sampler.py`); the codes equal the
JAX package's bit for bit.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _expand_bits(v: Tensor) -> Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each.
    Each product stays below 2**49, so int64 never wraps, and the mask keeps
    exactly the bits a uint32 product would."""
    v = v.to(torch.int64) & 0x3FF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(rel: Tensor) -> Tensor:
    """rel: [..., 3] coords in [0, 1] -> 30-bit morton code (int64 holding
    the uint32 value)."""
    q = torch.clamp(rel * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 2]))
