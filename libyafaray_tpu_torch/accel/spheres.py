"""Analytic spheres: the ray-sphere test and the dense pass over a scene's
spheres that follows the triangle query on both accelerators.

Counterpart of `intersect_sphere` in `libyafaray_tpu/ops/intersect.py` and
of `_sphere_pass` in `libyafaray_tpu/accel/blocks.py`. The spheres sit in
no accelerator: scenes carry few, so every ray tests every sphere. Sphere
prim ids follow the faces, `num_faces + s`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..math import vec
from ..scene_types import Geometry

Tensor = torch.Tensor


def intersect_sphere(o: Tensor, d: Tensor, center: Tensor, radius: Tensor,
                     t_min, t_max):
    """Batched analytic sphere; returns (hit, t) with the nearest root in
    range."""
    oc = o - center
    b = vec.dot(oc, d)
    c = vec.dot(oc, oc) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t0_in = (t0 > t_min) & (t0 <= t_max)
    t1_in = (t1 > t_min) & (t1 <= t_max)
    t = torch.where(t0_in, t0, t1)
    return (disc >= 0.0) & (t0_in | t1_in), t


def sphere_pass(geom: Geometry, o: Tensor, d: Tensor, t_min: Tensor,
                t_max: Tensor, exclude: Optional[Tensor], vis_bit: int,
                bt: Tensor, bp: Tensor, buv: Tensor):
    """The analytic spheres after the triangles, dense over rays x spheres
    (scenes carry few spheres): a sphere hit nearer than the triangle hit
    (bp >= 0 at bt; a miss counts to t_max) takes its place, with prim id
    num_faces + s and uv 0. Ties keep the triangle, as in the JAX package.
    Returns (t, prim, uv)."""
    s = geom.num_spheres
    if s == 0:
        return bt, bp, buv
    best_t = torch.where(bp >= 0, bt, t_max)
    hit, t = intersect_sphere(o[:, None, :], d[:, None, :],
                              geom.sph_center[None], geom.sph_radius[None],
                              t_min[..., None], best_t[:, None])
    hit = hit & ((geom.sph_vis[None, :] & vis_bit) != 0)
    sph_ids = geom.num_faces + torch.arange(s, dtype=torch.int32,
                                            device=o.device)
    if exclude is not None:
        hit = hit & (sph_ids[None, :] != exclude[:, None])
    t = torch.where(hit, t, torch.inf)
    tj, j = torch.min(t, dim=1)
    better = tj < best_t
    return (torch.where(better, tj, bt), torch.where(better, sph_ids[j], bp),
            torch.where(better[:, None], 0.0, buv))
