"""Volume regions: the table build and the density queries of the volume
integrators (`integrators/volume.py`).

Counterpart of `libyafaray_tpu/volumes/__init__.py` (the reference's
factory volume.cc:41-45): every region is a density in an axis-aligned
box, `UniformVolume` (1), `ExpDensityVolume` (a exp(-b h), h the height
above the box's floor), `NoiseVolume` (a texture's intensity shaped by
sharpness, cover and density), `GridVolume` (a trilinear lookup into a
voxel grid given as `grid_data`) and `SkyVolume` (1, as in the JAX
package). `density` runs the branches of the types the table holds, which
gives the JAX package's values: there every branch runs and a where()
keeps the region's own.
"""
from __future__ import annotations

import numpy as np
import torch

from ..math import bound
from ..scene_types import SceneData, VolumeTable

Tensor = torch.Tensor

VOL_UNIFORM = 0
VOL_EXP = 1
VOL_NOISE = 2
VOL_GRID = 3
VOL_SKY = 4

_VOL_BY_NAME = {
    "UniformVolume": VOL_UNIFORM,
    "ExpDensityVolume": VOL_EXP,
    "NoiseVolume": VOL_NOISE,
    "GridVolume": VOL_GRID,
    "SkyVolume": VOL_SKY,
}


def volume_table(cols: dict, grids, num_volumes: int) -> VolumeTable:
    """The VolumeTable of numpy columns and a grid pool, with its static
    copies of the region types and noise textures."""
    return VolumeTable(
        num_volumes=num_volumes, grids=torch.from_numpy(np.array(grids)),
        kinds=tuple(int(t) for t in cols["vol_type"]),
        noise_texs=tuple(int(t) for t in cols["noise_tex"]),
        **{k: torch.from_numpy(np.array(v)) for k, v in cols.items()})


def build_volume_table(builder) -> VolumeTable:
    """The SceneBuilder's volume regions, in name order, as a VolumeTable.
    Grids of several regions share one pool zero-padded to the largest
    size (which each lookup then scales to, as in the JAX package)."""
    names = sorted(builder.volumes)
    n = len(names)
    z = lambda: np.zeros((n,), np.float32)
    z3 = lambda: np.zeros((n, 3), np.float32)
    cols = dict(vol_type=np.zeros((n,), np.int32), bmin=z3(), bmax=z3(),
                sigma_a=z3(), sigma_s=z3(), emission=z3(), g=z(),
                params_f=np.zeros((n, 8), np.float32),
                noise_tex=np.full((n,), -1, np.int32),
                grid_id=np.full((n,), -1, np.int32))
    grids = []
    for i, name in enumerate(names):
        pm = builder.volumes[name]
        ty = pm.get_string("type", "UniformVolume")
        cols["vol_type"][i] = _VOL_BY_NAME[ty]
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
        if ty == "ExpDensityVolume":
            cols["params_f"][i, :2] = (pm.get_float("a", 1.0),
                                       pm.get_float("b", 1.0))
        elif ty == "NoiseVolume":
            cols["params_f"][i, :3] = (pm.get_float("sharpness", 1.0),
                                       pm.get_float("cover", 1.0),
                                       pm.get_float("density", 1.0))
            tex = pm.get_string("texture", "")
            if tex in builder.texture_order:
                cols["noise_tex"][i] = builder.texture_order.index(tex)
        elif ty == "GridVolume":
            grid = pm.get("grid_data")
            if grid is not None:
                cols["grid_id"][i] = len(grids)
                grids.append(np.asarray(grid, np.float32))
    if grids:
        pool = np.zeros((len(grids),) + tuple(
            max(g.shape[k] for g in grids) for k in range(3)), np.float32)
        for gi, g in enumerate(grids):
            pool[gi, :g.shape[0], :g.shape[1], :g.shape[2]] = g
    else:
        pool = np.zeros((1, 1, 1, 1), np.float32)
    return volume_table(cols, pool, n)


def _grid_density(vt: VolumeTable, p: Tensor) -> Tensor:
    """Trilinear lookup [N, R] of each region's grid (grid 0 for a region
    without one) at points p; D, H and W are the pool's."""
    rel = (p[:, None, :] - vt.bmin[None]) / torch.clamp_min(
        vt.bmax[None] - vt.bmin[None], 1e-9)
    gid = torch.clamp_min(vt.grid_id, 0).long()[None, :]
    g = vt.grids
    dd, hh, ww = g.shape[1], g.shape[2], g.shape[3]
    gx = torch.clamp(rel[..., 0] * (ww - 1), 0, ww - 1)
    gy = torch.clamp(rel[..., 1] * (hh - 1), 0, hh - 1)
    gz = torch.clamp(rel[..., 2] * (dd - 1), 0, dd - 1)
    x0, y0, z0 = (c.to(torch.int32) for c in (gx, gy, gz))
    x1 = torch.clamp_max(x0 + 1, ww - 1)
    y1 = torch.clamp_max(y0 + 1, hh - 1)
    z1 = torch.clamp_max(z0 + 1, dd - 1)
    fx, fy, fz = gx - x0, gy - y0, gz - z0

    def at(zz, yy, xx):
        return g[gid, zz.long(), yy.long(), xx.long()]

    c00 = at(z0, y0, x0) * (1 - fx) + at(z0, y0, x1) * fx
    c01 = at(z0, y1, x0) * (1 - fx) + at(z0, y1, x1) * fx
    c10 = at(z1, y0, x0) * (1 - fx) + at(z1, y0, x1) * fx
    c11 = at(z1, y1, x0) * (1 - fx) + at(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _noise_density(scene: SceneData, p: Tensor, r: int) -> Tensor:
    """Noise region r's density [N] at points p (volume_noise.cc): its
    texture's mean rgb at p, to the power sharpness, plus cover - 1,
    clamped at 0 and times the density. The texture is looked up at p with
    uv = p.xy, as in the JAX package."""
    from ..textures import sample_texture
    from ..textures.eval import mean_rgb
    vt = scene.volumes
    tex = vt.noise_texs[r]
    tid = torch.full(p.shape[:-1], tex, dtype=torch.int32, device=p.device)
    inten = mean_rgb(sample_texture(scene, tid, p, p[..., :2],
                                    static_tex=tex))
    sharp, cover, dscale = vt.params_f[r, 0], vt.params_f[r, 1], \
        vt.params_f[r, 2]
    nval = torch.pow(torch.clamp_min(inten, 1e-6), sharp)
    return torch.clamp_min(nval + cover - 1.0, 0.0) * dscale


def density(scene: SceneData, p: Tensor) -> Tensor:
    """Density factor [N, R] of each region at points p, 0 outside its
    box."""
    vt = scene.volumes
    inside = torch.all((p[:, None, :] >= vt.bmin[None])
                       & (p[:, None, :] <= vt.bmax[None]), dim=-1)
    kinds = set(vt.kinds)
    if kinds <= {VOL_UNIFORM, VOL_SKY}:
        return inside.to(torch.float32)
    ty = vt.vol_type[None, :]
    dens = torch.ones(inside.shape, dtype=torch.float32, device=p.device)
    if VOL_EXP in kinds:
        # a * exp(-b * height above the box's floor) (volume_exp_density.cc)
        h = p[:, None, 2] - vt.bmin[None, :, 2]
        dens = torch.where(ty == VOL_EXP, vt.params_f[None, :, 0] * torch.exp(
            -vt.params_f[None, :, 1] * h), dens)
    if VOL_GRID in kinds:
        dens = torch.where(ty == VOL_GRID, _grid_density(vt, p), dens)
    if VOL_NOISE in kinds and scene.textures is not None:
        for r, (kind, tex) in enumerate(zip(vt.kinds, vt.noise_texs)):
            if kind == VOL_NOISE and tex >= 0:
                dens[:, r] = _noise_density(scene, p, r)
    return torch.where(inside, torch.clamp_min(dens, 0.0), 0.0)


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
