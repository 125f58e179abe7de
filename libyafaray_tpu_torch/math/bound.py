"""Axis-aligned boxes: the slab test.

Counterpart of `libyafaray_tpu/math/bound.py` (`ray_slab`, the function the
volume regions use).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def ray_slab(bmin: Tensor, bmax: Tensor, origin: Tensor, inv_dir: Tensor,
             t_min: Tensor, t_max: Tensor):
    """Branchless slab test (the reference's `Bound::cross`); every argument
    broadcasts over the leading dimensions. Returns (hit, t_near, t_far).
    A NaN from 0 * inf on an axis the ray runs along is ignored."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tsmall = torch.minimum(t0, t1)
    tbig = torch.maximum(t0, t1)
    tsmall = torch.where(torch.isnan(tsmall), -torch.inf, tsmall)
    tbig = torch.where(torch.isnan(tbig), torch.inf, tbig)
    t_near = torch.maximum(torch.amax(tsmall, dim=-1), t_min)
    t_far = torch.minimum(torch.amin(tbig, dim=-1), t_max)
    return t_near <= t_far, t_near, t_far
