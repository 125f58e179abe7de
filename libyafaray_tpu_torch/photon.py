"""Photon infrastructure: wavefront photon shooting and the grid-binned
gather.

Counterpart of `libyafaray_tpu/photon.py` (libYafaRay's PhotonMap, its
kd-tree and hash grid, and the photon-shooting workers): the photons walk
the scene together in one masked wavefront, and the map is a dense uniform
grid of GRID_RES^3 cells with MAX_PER_CELL photon slots each, filled by a
scatter. A query gathers the slots of its 27 neighbour cells; a cell that
overflowed keeps the first MAX_PER_CELL photons in photon order, and the
gather scales what it finds there by stored / kept. The maps are built
exactly as the JAX package builds them (the same slots and counts for the
same photons), and saved and loaded in its file format.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import sampler
from .lights import _has, sample_light_tri
from .materials import bsdf as B
from .math import vec
from .ops import intersect as I
from .ops import surface as S
from .scene_types import (LIGHT_AREA, LIGHT_MESH, LIGHT_POINT, LIGHT_SPHERE,
                          LIGHT_SPOT, PhotonData, SceneData, _Table)

Tensor = torch.Tensor

GRID_RES = 64          # cells per axis
MAX_PER_CELL = 8       # photon slots per cell
# the 27 neighbour offsets in the JAX package's order (dx outer, dz inner):
# each query's gather lists its 216 slots in this order
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
# queries per chunk of a gather. A query holds 216 slots: its int64 ids and
# f32 position, direction and power gathers take about 8 KiB, so a 1080p
# wavefront in one piece (2,073,600 queries) would hold a 5.4 GB [N, 216, 3]
# tensor for each gathered column and 3.6 GB of ids, and the final gather
# asks 16 such lookups a bounce. 2^17 queries keep every transient tensor
# near 1 GiB. Chunks do not change a query's result: its sum sees the same
# 216 operands in the same order, whatever the chunk
_CHUNK = 1 << 17
# the fields of a map, in the order of the JAX package's map files
MAP_FIELDS = ("pos", "dir", "power", "valid", "cell_slots", "cell_counts",
              "grid_min", "inv_cell", "num_stored", "radius")


@dataclass
class PhotonMap(_Table):
    """Flat photon storage and its uniform-grid index."""
    pos: Tensor           # f32[P, 3]
    dir: Tensor           # f32[P, 3] incident direction (toward the surface)
    power: Tensor         # f32[P, 3] flux
    valid: Tensor         # bool[P]
    cell_slots: Tensor    # i32[C, K] photon ids (-1 empty)
    cell_counts: Tensor   # i32[C] photons mapped to the cell (dropped too)
    grid_min: Tensor      # f32[3]
    inv_cell: Tensor      # f32[3] 1 / cell size
    num_stored: Tensor    # i32[] valid photons
    radius: Tensor        # f32[] gather radius (the cell is twice it)


def _emit_photons(scene: SceneData, n: int, seed):
    """Emission samples (Light::emitPhoton) for n photons: (origin,
    direction, power, valid). The light is picked uniformly and the power
    scaled by the number of lights."""
    lt = scene.lights
    nl = max(lt.num_lights, 1)
    dev = lt.color.device
    pid = torch.arange(n, dtype=torch.int64, device=dev)
    u = sampler.rand4(pid, seed, 0, 9000)
    ul, u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    u4 = sampler.rand1(pid, seed, 0, 9001)
    li = torch.clamp((ul * nl).to(torch.int32), 0, nl - 1).long()
    ty = lt.light_type[li]
    pos = lt.position[li]
    col = lt.color[li]
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    o, d, pw = zeros3, zeros3, zeros3
    valid = torch.zeros((n,), dtype=torch.bool, device=dev)

    def put(m, o_, d_, pw_):
        nonlocal o, d, pw, valid
        m3 = m[..., None]
        o = torch.where(m3, o_, o)
        d = torch.where(m3, d_, d)
        pw = torch.where(m3, pw_, pw)
        valid = valid | m

    if _has(lt, LIGHT_POINT):
        # a uniform sphere of directions; power 4 pi intensity
        put(ty == LIGHT_POINT, pos, vec.uniform_sample_sphere(u1, u2),
            col * (4.0 * math.pi))
    if _has(lt, LIGHT_SPOT):
        # a uniform cone (light_spot.cc emitPhoton)
        axis = lt.direction[li]
        au, av = vec.orthonormal_basis(axis)
        cone = vec.uniform_sample_cone(u1, u2, lt.cos_end[li])
        d_sp = (au * cone[..., 0:1] + av * cone[..., 1:2]
                + axis * cone[..., 2:3])
        omega = 2.0 * math.pi * (1.0 - lt.cos_end[li])
        put(ty == LIGHT_SPOT, pos, d_sp, col * omega[..., None])
    if _has(lt, LIGHT_AREA):
        # corner + u1 e1 + u2 e2, a cosine-distributed direction; the flux
        # is L * area * pi
        lp = pos + lt.edge1[li] * u1[..., None] + lt.edge2[li] * u2[..., None]
        nrm = lt.direction[li]
        nu, nv = vec.orthonormal_basis(nrm)
        dl = vec.cosine_sample_hemisphere(u3, u4)
        d_ar = nu * dl[..., 0:1] + nv * dl[..., 1:2] + nrm * dl[..., 2:3]
        put(ty == LIGHT_AREA, lp, d_ar,
            col * (lt.area[li] * math.pi)[..., None])
    if _has(lt, LIGHT_SPHERE):
        # a point on the sphere, a cosine-distributed direction about it
        sp_n = vec.uniform_sample_sphere(u1, u2)
        sp_p = pos + sp_n * lt.radius[li][..., None]
        su, sv = vec.orthonormal_basis(sp_n)
        dl2 = vec.cosine_sample_hemisphere(u3, u4)
        d_sl = su * dl2[..., 0:1] + sv * dl2[..., 1:2] + sp_n * dl2[..., 2:3]
        put(ty == LIGHT_SPHERE, sp_p, d_sl,
            col * (lt.area[li] * math.pi)[..., None])
    if scene.geom.num_faces > 0 and _has(lt, LIGHT_MESH):
        # an area-CDF face pick, a uniform point on it, a cosine direction
        g = scene.geom
        tri_i, _ = sample_light_tri(lt, g.num_faces, li, u1)
        fidx = g.faces[tri_i.long()].long()
        v0, v1, v2 = (g.vertices[fidx[:, k]] for k in range(3))
        b0, b1 = vec.sample_triangle_uniform(u2, u3)
        lp_m = (v0 * b0[..., None] + v1 * b1[..., None]
                + v2 * (1 - b0 - b1)[..., None])
        nrm_m = vec.normalize(vec.cross(v1 - v0, v2 - v0))
        mu, mv = vec.orthonormal_basis(nrm_m)
        dl3 = vec.cosine_sample_hemisphere(u4, ul)
        d_m = mu * dl3[..., 0:1] + mv * dl3[..., 1:2] + nrm_m * dl3[..., 2:3]
        put(ty == LIGHT_MESH, lp_m, d_m,
            col * (lt.area[li] * math.pi)[..., None])
    return o, d, pw * nl, valid


def shoot_photons(scene: SceneData, n_photons: int, max_bounces: int = 5,
                  seed=0):
    """Walk n photons through the scene. Returns the deposits, n_photons *
    max_bounces rows each: (pos, dir, power, is_caustic, indirect, valid,
    normal, albedo). A deposit is stored at every hit with a non-delta
    lobe (Material::scatterPhoton); `is_caustic` marks paths specular
    since their emission. Every depth's closest-hit query is one launch
    over all the photons (the dead ones with an empty t-range)."""
    o, d, pw, valid = _emit_photons(scene, n_photons, seed)
    dev = o.device
    pid = torch.arange(n_photons, dtype=torch.int64, device=dev)
    bias = scene.shadow_bias
    cols = [[] for _ in range(8)]
    specular_only = torch.ones((n_photons,), dtype=torch.bool, device=dev)
    prev_prim = torch.full((n_photons,), -1, dtype=torch.int32, device=dev)
    for depth in range(max_bounces):
        hit = I.closest_hit(scene, o, d, scene.ray_min_dist,
                            torch.where(valid, 1e30, -1.0),
                            exclude_prim=prev_prim)
        hit.valid = hit.valid & valid
        sp = S.make_surface(scene, hit, o, d)
        wo = -d
        mp = B.resolve_mp(scene, sp)
        _, _, w_mf, w_di, w_tl = B.lobe_weights(
            mp, torch.abs(vec.dot(wo, sp.n)))
        store = hit.valid & ((w_di + w_tl + w_mf) > 1e-5)
        caustic = specular_only & (depth > 0)
        for col, x in zip(cols, (
                sp.p, d, pw, caustic,
                torch.full((n_photons,), depth > 0, device=dev), store,
                sp.n, mp.diffuse_color)):
            col.append(x)
        if depth == max_bounces - 1:
            break
        r = sampler.rand4(pid, seed, depth, 9100)
        ms = B.sample_bsdf(scene, sp, wo, r[..., 0], r[..., 1], r[..., 2])
        new_pw = pw * ms.weight
        # Russian roulette on the power ratio (the scatter chain of
        # photon.cc). A photon position comes from the intersection's
        # arithmetic and can differ from the JAX package's in its last bit,
        # which can tip this draw or a cell; the tests hold shooting to a
        # stated bound and the map build exactly on shared arrays
        p_surv = torch.clamp(
            torch.amax(new_pw, dim=-1)
            / torch.clamp_min(torch.amax(pw, dim=-1), 1e-12), 0.05, 1.0)
        kill = r[..., 3] > p_surv
        new_pw = new_pw / p_surv[..., None]
        valid = hit.valid & valid & ms.valid & ~kill
        specular_only = specular_only & ms.is_delta
        pw = torch.where(valid[..., None], new_pw, pw)
        prev_prim = sp.prim
        o = sp.p + ms.wi * bias
        d = ms.wi
    return tuple(torch.cat(c, dim=0) for c in cols)


def build_photon_map(pos: Tensor, dir: Tensor, power: Tensor, valid: Tensor,
                     radius, scene_min: Tensor, scene_max: Tensor
                     ) -> PhotonMap:
    """Bin the photons into the grid (PhotonMap::updateTree's counterpart:
    a dense [C, K] slot table in place of a kd-tree), exactly as the JAX
    package does: a stable sort by cell, each photon's rank within its cell
    by a left search, the first MAX_PER_CELL of each cell kept."""
    p = pos.shape[0]
    dev = pos.device
    res, k = GRID_RES, MAX_PER_CELL
    # the cell is 2 * radius in float32, 1 / cell in float32, and the cell
    # index a truncating cast, as the JAX package's .astype(int32)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    cell = 2.0 * radius
    gmin = scene_min.to(torch.float32) - cell
    inv_cell = 1.0 / cell
    ci = torch.clamp(_cell_coords(pos, gmin, inv_cell), 0, res - 1)
    cid = (ci[..., 0] * res + ci[..., 1]) * res + ci[..., 2]
    cid = torch.where(valid, cid, res ** 3).long()   # invalid: overflow cell
    cid_sorted, order = torch.sort(cid, stable=True)
    first = torch.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = torch.arange(p, device=dev) - first
    keep = (rank < k) & (cid_sorted < res ** 3)
    dump = res ** 3 * k
    slot_ids = torch.where(keep, cid_sorted * k + rank, dump)
    # every photon not kept goes to the one dump slot past the table; on
    # the card index_put_ without accumulate picks an arbitrary winner
    # among duplicate indices, which is harmless only because the dump
    # slot is cut off (the kept slots are distinct)
    slots = torch.full((dump + 1,), -1, dtype=torch.int32, device=dev)
    slots.index_put_((slot_ids,),
                     torch.where(keep, order, -1).to(torch.int32))
    # the exact integer count per cell (segment_sum of the valid photons)
    counts = torch.bincount(cid, minlength=res ** 3 + 1)[:res ** 3]
    return PhotonMap(
        pos=pos, dir=dir, power=power, valid=valid,
        cell_slots=slots[:-1].reshape(res ** 3, k),
        cell_counts=counts.to(torch.int32), grid_min=gmin,
        inv_cell=inv_cell.expand(3).clone(),
        num_stored=valid.sum().to(torch.int32), radius=radius)


def _cell_coords(q: Tensor, gmin: Tensor, inv_cell: Tensor) -> Tensor:
    """Integer cell coordinates of points, truncated toward zero. The
    clamp to [-1, GRID_RES] first keeps the cast defined for points far
    outside the grid (a miss's position); every caller clips to the grid
    after, so the result equals the JAX package's for every finite point."""
    x = torch.clamp((q - gmin) * inv_cell, -1.0, float(GRID_RES))
    return x.to(torch.int32)


def _neighbour_slots(pm: PhotonMap, q: Tensor, with_scale: bool):
    """The 216 slot ids (int64 [N, 216], -1 empty) of the 27 cells around
    each query, in the JAX package's order, and with_scale the stored /
    kept factor of each slot's cell (f32 [N, 216])."""
    res, k = GRID_RES, MAX_PER_CELL
    ci = torch.clamp(_cell_coords(q, pm.grid_min, pm.inv_cell), 0, res - 1)
    off = torch.tensor(_OFFSETS, dtype=torch.int32, device=q.device)
    cc = torch.clamp(ci[:, None, :] + off, 0, res - 1)        # [N, 27, 3]
    cell_id = ((cc[..., 0] * res + cc[..., 1]) * res + cc[..., 2]).long()
    ids = pm.cell_slots[cell_id].reshape(q.shape[0], 27 * k).long()
    if not with_scale:
        return ids, None
    cnt = pm.cell_counts[cell_id].to(torch.float32)
    kept = torch.clamp_max(cnt, float(k))
    scale = torch.where(kept > 0, cnt / torch.clamp_min(kept, 1.0), 1.0)
    return ids, scale[..., None].expand(-1, -1, k).reshape(q.shape[0], 27 * k)


def _chunked(fn, n: int, *cols):
    """fn over chunks of _CHUNK queries of the per-query columns `cols`
    (None passes through), its outputs concatenated."""
    if n <= _CHUNK:
        return fn(*cols)
    outs = [fn(*(None if c is None else c[i:i + _CHUNK] for c in cols))
            for i in range(0, n, _CHUNK)]
    return tuple(torch.cat(x, dim=0) for x in zip(*outs))


def gather_flux(pm: PhotonMap, q: Tensor, n_hemi: Optional[Tensor] = None,
                r2: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The photon flux within the gather radius of each query point, over
    its 27 neighbour cells: (flux f32[N,3], count f32[N]), both scaled by
    each cell's stored / kept. `n_hemi` (the surface normal) rejects
    photons arriving from behind; `r2` (f32[N]) is a per-query radius^2
    (SPPM's shrinking radii), at most pm.radius^2 so that the 27 cells
    cover the sphere; by default the map's radius. Each query's sum runs
    over its 216 slots in the JAX package's order; XLA's CPU reduction
    need not add them in torch's order, so the two agree to 1e-5 relative,
    not bit for bit."""

    def one(qc, nc, r2c):
        ids, scale = _neighbour_slots(pm, qc, True)
        ok = ids >= 0
        pid = torch.clamp_min(ids, 0)
        d2 = torch.sum((pm.pos[pid] - qc[:, None, :]) ** 2, dim=-1)
        rr = pm.radius * pm.radius if r2c is None else r2c[:, None]
        in_r = ok & (d2 <= rr) & pm.valid[pid]
        if nc is not None:
            in_r = in_r & (torch.sum(-pm.dir[pid] * nc[:, None, :], dim=-1)
                           > 0)
        flux = torch.sum(torch.where(in_r[..., None],
                                     pm.power[pid] * scale[..., None], 0.0),
                         dim=1)
        # the density-corrected count: stored / kept makes the flux and
        # the count unbiased estimates of the uncapped gather
        count = torch.sum(torch.where(in_r, scale, 0.0), dim=1)
        return flux, count

    return _chunked(one, q.shape[0], q, n_hemi, r2)


def estimate_radiance(pm: PhotonMap, scene: SceneData, sp, wo: Tensor,
                      n_emitted: int) -> Tensor:
    """The Lambertian density estimate at surface points:
    L = (albedo / pi) * sum(flux) / (pi r^2 N_emitted)."""
    flux, _ = gather_flux(pm, sp.p, sp.n)
    f_diffuse = B.resolve_mp(scene, sp).diffuse_color / math.pi
    r2 = pm.radius * pm.radius
    return f_diffuse * flux / (math.pi * r2 * n_emitted)


def scene_bounds(scene: SceneData):
    """The least and greatest vertex coordinates (the grid's extent)."""
    v = scene.geom.vertices
    return v.amin(dim=0), v.amax(dim=0)


def make_maps(scene: SceneData, n_photons: int = 65536,
              max_bounces: int = 5, radius: float = 0.05, seed=0,
              final_gather: bool = False):
    """Shoot and bin the diffuse and caustic maps (PhotonIntegrator::
    preprocess) from one shoot of n_photons. Returns (diffuse map, caustic
    map, radiance cache or None). The diffuse map holds the indirect
    deposits that are not caustic (direct light comes from NEE), the
    caustic map the specular-only ones; with final_gather the radiance
    cache is computed from a map of every deposit. (The JAX package's
    make_maps also takes a caustic photon count, which it never reads.)"""
    smin, smax = scene_bounds(scene)
    pos, dir_, pw, caus, indirect, valid, dep_n, dep_albedo = shoot_photons(
        scene, n_photons, max_bounces, seed)
    dmap = build_photon_map(pos, dir_, pw, valid & indirect & ~caus, radius,
                            smin, smax)
    cmap = build_photon_map(pos, dir_, pw, valid & caus, radius, smin, smax)
    rcache = None
    if final_gather:
        gmap = build_photon_map(pos, dir_, pw, valid, radius, smin, smax)
        rcache = build_radiance_cache(gmap, pos, dep_n, dep_albedo, valid,
                                      radius, smin, smax, n_photons)
    return dmap, cmap, rcache


def build_radiance_cache(gmap: PhotonMap, pos: Tensor, nrm: Tensor,
                         albedo: Tensor, valid: Tensor, radius, scene_min,
                         scene_max, n_emitted: int) -> PhotonMap:
    """The outgoing (Lambertian) radiance at every photon deposit (the
    reference's "FG Radiance Photon Map", integrator_photon_mapping.cc:
    353-399), as a map whose `dir` holds the surface normal and whose
    `power` holds the radiance."""
    flux, _ = gather_flux(gmap, pos, nrm)
    r2 = gmap.radius * gmap.radius
    radiance = (albedo / math.pi) * flux / (math.pi * r2 * n_emitted)
    return build_photon_map(pos, nrm, radiance, valid, radius, scene_min,
                            scene_max)


def lookup_radiance(cache: PhotonMap, p: Tensor, n: Tensor) -> Tensor:
    """The normal-weighted mean of the cached radiance within the cache's
    radius of p, weights max(n . n_entry, 0) * (1 - d^2 / r^2)."""
    r2 = cache.radius * cache.radius

    def one(pc, nc):
        ids, _ = _neighbour_slots(cache, pc, False)
        ok = ids >= 0
        pid = torch.clamp_min(ids, 0)
        d2 = torch.sum((cache.pos[pid] - pc[:, None, :]) ** 2, dim=-1)
        ndot = torch.sum(cache.dir[pid] * nc[:, None, :], dim=-1)
        w = torch.where(ok & (d2 <= r2) & cache.valid[pid],
                        torch.clamp_min(ndot, 0.0) * (1.0 - d2 / r2), 0.0)
        wsum = torch.sum(w, dim=1)
        rad = torch.sum(cache.power[pid] * w[..., None], dim=1)
        return (torch.where(wsum[..., None] > 1e-9,
                            rad / torch.clamp_min(wsum, 1e-9)[..., None],
                            0.0),)

    return _chunked(one, p.shape[0], p, n)[0]


# ---------------------------------------------------------------------------
# Map files (PhotonMap::save / load, photon.cc:54-95; the processing modes
# generate / generate-save / load / reuse-previous,
# integrator_photon_mapping.cc:790-846), in the JAX package's format
# ---------------------------------------------------------------------------

_MAP_MAGIC = "YAF_TPU_PHOTONMAPv1"


def save_maps(photons: PhotonData, path: str) -> None:
    """Write the diffuse and caustic maps and the radiance cache (when
    there is one) to an .npz file."""
    arrs = {"magic": np.asarray(_MAP_MAGIC),
            "n_emitted": np.asarray(photons.n_emitted)}
    for prefix in ("diffuse", "caustic", "radiance"):
        pm = getattr(photons, prefix)
        if pm is not None:
            for f in MAP_FIELDS:
                arrs[f"{prefix}_{f}"] = getattr(pm, f).detach().cpu().numpy()
    np.savez_compressed(path, **arrs)


def map_from_numpy(arrays) -> PhotonMap:
    """A PhotonMap of the named arrays (a map file's, or a JAX map's leaves
    as numpy), on the CPU."""
    return PhotonMap(**{f: torch.from_numpy(np.array(arrays[f], copy=True))
                        for f in MAP_FIELDS})


def load_maps(path: str, device="cuda") -> PhotonData:
    """Read maps written by save_maps (or by the JAX package) onto
    `device`."""
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != _MAP_MAGIC:
        raise ValueError(f"{path}: not a {_MAP_MAGIC} file")

    def get(prefix):
        if f"{prefix}_pos" not in z:
            return None
        return map_from_numpy({f: z[f"{prefix}_{f}"]
                               for f in MAP_FIELDS}).to(device)

    return PhotonData(diffuse=get("diffuse"), caustic=get("caustic"),
                      radiance=get("radiance"),
                      n_emitted=int(z["n_emitted"]))
