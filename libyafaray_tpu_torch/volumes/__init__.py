"""Volume regions: the table build and the density queries of the volume
integrator (`integrators/volume.py`).

Counterpart of `libyafaray_tpu/volumes/__init__.py` for `UniformVolume`, a
constant density in an axis-aligned box. The other region types
(`ExpDensityVolume`, `NoiseVolume`, `GridVolume`, `SkyVolume`) raise
NotImplementedError when the scene is built.
"""
from __future__ import annotations

import numpy as np
import torch

from ..math import bound
from ..scene_types import SceneData, VolumeTable

Tensor = torch.Tensor

VOL_UNIFORM = 0   # the JAX package's enum: 1 exp, 2 noise, 3 grid, 4 sky


def build_volume_table(builder) -> VolumeTable:
    """The SceneBuilder's volume regions, in name order, as a VolumeTable."""
    names = sorted(builder.volumes)
    n = len(names)
    z = lambda: np.zeros((n,), np.float32)
    z3 = lambda: np.zeros((n, 3), np.float32)
    cols = dict(vol_type=np.zeros((n,), np.int32), bmin=z3(), bmax=z3(),
                sigma_a=z3(), sigma_s=z3(), emission=z3(), g=z())
    for i, name in enumerate(names):
        pm = builder.volumes[name]
        if pm.get_string("type", "UniformVolume") != "UniformVolume":
            raise NotImplementedError(
                f"volume type {pm.get_string('type')!r} is not ported to "
                "libyafaray_tpu_torch yet")
        cols["vol_type"][i] = VOL_UNIFORM
        cols["bmin"][i] = (pm.get_float("minX", -1.0),
                           pm.get_float("minY", -1.0),
                           pm.get_float("minZ", -1.0))
        cols["bmax"][i] = (pm.get_float("maxX", 1.0),
                           pm.get_float("maxY", 1.0),
                           pm.get_float("maxZ", 1.0))
        cols["sigma_a"][i] = pm.get_float("sigma_a", 0.1)
        cols["sigma_s"][i] = pm.get_float("sigma_s", 0.1)
        cols["emission"][i] = pm.get_float("l_e", 0.0)
        cols["g"][i] = pm.get_float("g", 0.0)
    return VolumeTable(num_volumes=n,
                       **{k: torch.from_numpy(v) for k, v in cols.items()})


def density(scene: SceneData, p: Tensor) -> Tensor:
    """Density factor [N, R] of each region at points p: 1 inside a
    uniform region's box, 0 outside."""
    vt = scene.volumes
    inside = torch.all((p[:, None, :] >= vt.bmin[None])
                       & (p[:, None, :] <= vt.bmax[None]), dim=-1)
    return inside.to(torch.float32)


def sigma_st(scene: SceneData, p: Tensor):
    """(sigma_s [N,3], sigma_t [N,3], emission [N,3]) at points p, summed
    over the regions that contain them."""
    vt = scene.volumes
    d = density(scene, p)[..., None]
    ss = (d * vt.sigma_s).sum(1)
    sa = (d * vt.sigma_a).sum(1)
    em = (d * vt.emission).sum(1)
    return ss, ss + sa, em


def ray_aabb_span(scene: SceneData, o: Tensor, d: Tensor, t_max: Tensor):
    """(hit, entry, exit) of rays against the union box of all regions,
    clipped to [0, t_max]."""
    vt = scene.volumes
    bmin = torch.amin(vt.bmin, dim=0)
    bmax = torch.amax(vt.bmax, dim=0)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    hit, t0, t1 = bound.ray_slab(bmin, bmax, o, inv_d,
                                 torch.zeros_like(t_max), t_max)
    return hit, torch.clamp_min(t0, 0.0), torch.minimum(t1, t_max)
