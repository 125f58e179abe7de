"""Tile traversal of the block accelerator: the CUDA kernel
`csrc/tiles_traverse.cu` and its plain PyTorch version.

Counterpart of `libyafaray_tpu/accel/tiles.py`. Rays arrive sorted for
coherence (`accel/blocks.py` query) and are cut into tiles of RAY_TILE
rays. `tile_candidates` gives each tile the blocks that some of its rays
enter, front to back by a lower bound of the entry distance. `tile_walk`
then walks each tile's list: for every candidate block it runs
Möller-Trumbore over the block's (16, B) slab, SUB triangles at a time, and
stops once the next candidate's entry bound is beyond every ray's best hit
(closest hit) or beyond every unhit ray's t_max (any hit).

Two opt-in prepass branches of the JAX package read the same environment
variables at import: `SUPER` (`YAF_SUPER`, default 1) runs the exact
per-ray slab test on superblocks of SUPER blocks and refines it by each
tile's interval slab test per block; `CAND_K` (`YAF_CAND_K`, default 0 =
off) runs the interval test over every block and the exact test only on
each tile's CAND_K nearest. Both give the JAX package's lists, block for
block and key for key, and the walk over them is the same kernel.

An any-hit query can walk in cover order instead (`cover_order`, the JAX
package's opt-in `YAF_COVER_ORDER=1`): the prepass sorts each tile's blocks
by descending ray coverage (how many of the tile's rays enter the block)
and `ent` carries minus the coverage; the walk then stops once every live
ray of the tile has a hit or the list ends, and never reads `ent`.

Two arms extend the static walk, alone or together, as in the JAX
package's resident kernel:
  * motion blur (`tab_t1`, and `tab_t2` for the quadratic b-spline): each
    ray blends the slab's vertex rows with the weights of its own time
    (packed in ray column 9), row = v*w0 + t1*w1 [+ t2*w2];
  * true instancing (`blk_base`, `blk_minv`, `id_delta`, `inv_rows`): a
    candidate is a virtual block; its slab is the physical row
    blk_base[j], the rays are transformed object<-world by the 3x4 matrix
    inv_rows[blk_minv[j]] (row 0, the identity, is skipped) and the prim
    ids are rebased by id_delta[j] (as floats) before the exclude test and
    the tie-break.

`tile_walk` on CPU tensors runs the plain version `tile_walk_ref`; on a
CUDA device it launches the kernel (built at first use by `csrc_build`) or
raises. It never falls back from the kernel to the plain version.
`tile_candidates` likewise: on a CUDA device its default branch (SUPER 1,
CAND_K off, front to back or cover order) launches the prepass kernel of
the same source, which makes every tile's list in one launch with no host
read; other tensors run the plain version `tile_candidates_ref`. The SUPER
and CAND_K branches, opt-in and run by no benchmark cell, keep their
PyTorch code on every device.
`tiles_traverse` / `tiles_traverse_ref` pad and pack the rays, build the
candidate lists and walk them.
"""
from __future__ import annotations

import collections
import ctypes
import os
from typing import Optional

import torch

from .. import csrc_build
from ..utils import profiling as PF

Tensor = torch.Tensor

RAY_TILE = 128     # rays per tile (one CUDA block, eight threads a ray)
SUB = 128          # triangles per Möller-Trumbore batch inside a block
EPS_DET = 1e-10
# candidate blocks walked between two exit tests, as the JAX package's
# VMEM-resident kernel does (its default for closest and any hit alike). The
# exit test runs before every group of UNROLL candidates; the candidates of
# a group past the end of the list are skipped.
UNROLL = 6
# temporaries of the candidate prepass, per chunk of tiles (bytes)
_CAND_BYTES = 64e6
# blocks per superblock of the exact prepass (1: per block, the default)
SUPER = int(os.environ.get("YAF_SUPER", "1"))
# blocks per tile given the exact test after the interval test (0: every
# block, the default)
CAND_K = int(os.environ.get("YAF_CAND_K", "0"))
# tiles per step of the plain walk: [tiles, RAY_TILE, SUB] temporaries
_REF_TILES = 128

# number of kernel launches, counted by tile_walk where it launches, in
# all and per specialisation (`arm`), and by tile_candidates where it
# launches the prepass kernel
launches = 0
arm_launches = collections.Counter()
cand_launches = 0
_fn = None
_cand_fn = None


def _chunk_entry(bmin: Tensor, bmax: Tensor, oc: Tensor, ic: Tensor,
                 t0: Tensor, t1: Tensor, cover: bool = False):
    """Exact slab test of a chunk of tiles' rays ([G, R, 3]) against every
    block AABB; returns each block's entry distance per tile (the minimum
    over the tile's rays that enter it within their t-range; inf if none),
    f32[G, C], and with `cover` also each block's coverage (how many of
    the tile's rays enter it), f32[G, C]. Taken one axis at a time, which
    rounds as the JAX package's [G, R, C, 3] form does (max and min are
    exact)."""
    tn = tf = None
    for k in range(3):
        o_k = oc[..., k:k + 1]
        i_k = ic[..., k:k + 1]
        ta = (bmin[:, k] - o_k) * i_k          # [G, R, C]
        tb = (bmax[:, k] - o_k) * i_k
        lo = torch.minimum(ta, tb)
        hi = torch.maximum(ta, tb)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    t0 = t0[..., None]
    ok = (tn <= tf) & (tf >= t0) & (tn <= t1[..., None])
    ent = torch.where(ok, torch.maximum(tn, t0), torch.inf).amin(dim=1)
    if cover:
        return ent, ok.sum(dim=1, dtype=torch.int32).to(torch.float32)
    return ent


def _tile_interval(bmin: Tensor, bmax: Tensor, ot: Tensor, it: Tensor,
                   t0: Tensor, t1: Tensor):
    """The interval slab test of each tile (its rays' origin and inverse
    direction boxes, [T, R, 3]) against every block: (overlap bool[T, C],
    key f32[T, C], a lower bound of the tile's entry distance)."""
    tmin_lo, tmax_hi = t0.amin(dim=1), t1.amax(dim=1)
    olo, ohi = ot.amin(dim=1), ot.amax(dim=1)
    ilo, ihi = it.amin(dim=1)[:, None], it.amax(dim=1)[:, None]

    def ival_mul(p_lo, p_hi):
        # the interval product [p_lo, p_hi] x [ilo, ihi]
        a, b = p_lo * ilo, p_lo * ihi
        c, d = p_hi * ilo, p_hi * ihi
        return (torch.minimum(torch.minimum(a, b), torch.minimum(c, d)),
                torch.maximum(torch.maximum(a, b), torch.maximum(c, d)))

    a_lo, a_hi = ival_mul(bmin[None] - ohi[:, None], bmin[None] - olo[:, None])
    b_lo, b_hi = ival_mul(bmax[None] - ohi[:, None], bmax[None] - olo[:, None])
    near = torch.minimum(a_lo, b_lo).amax(dim=-1)      # [T, C]
    far = torch.maximum(a_hi, b_hi).amin(dim=-1)
    overlap = ((near <= far) & (far >= tmin_lo[:, None])
               & (near <= tmax_hi[:, None]))
    return overlap, torch.maximum(near, tmin_lo[:, None])


def _sorted_lists(key: Tensor, overlap: Tensor):
    """Each tile's blocks sorted by key (stable: ties keep block order),
    padded to a multiple of 128 with block 0 / inf: (cand, ent, count)."""
    t, c = key.shape
    key = torch.where(overlap, key, torch.inf)
    ent, cand = torch.sort(key, dim=1, stable=True)
    count = overlap.sum(dim=1, dtype=torch.int32)
    c_pad = -(-c // 128) * 128
    cand = cand.to(torch.int32)
    if c_pad != c:
        ent = torch.cat([ent, torch.full((t, c_pad - c), torch.inf,
                                         dtype=torch.float32,
                                         device=key.device)], 1)
        cand = torch.cat([cand, torch.zeros((t, c_pad - c), dtype=torch.int32,
                                            device=key.device)], 1)
    return cand.contiguous(), ent.contiguous(), count


def _tile_candidates_topk(bmin: Tensor, bmax: Tensor, ot: Tensor,
                          it: Tensor, t0: Tensor, t1: Tensor):
    """CAND_K's two stages: the interval test over every block, then the
    exact per-ray test on each tile's CAND_K nearest blocks by the interval
    key (a stable sort: the JAX package's order), whose exact keys replace
    the interval keys (an exact miss drops the block)."""
    t = ot.shape[0]
    k = CAND_K
    overlap, key = _tile_interval(bmin, bmax, ot, it, t0, t1)
    key = torch.where(overlap, key, torch.inf)
    sel = torch.sort(key, dim=1, stable=True).indices[:, :k]   # [T, K]
    bm_k, bx_k = bmin[sel], bmax[sel]                          # [T, K, 3]
    g = max(1, min(t, int(_CAND_BYTES / (RAY_TILE * k * 12))))
    exact = torch.empty((t, k), dtype=torch.float32, device=key.device)
    for s0 in range(0, t, g):
        s = slice(s0, min(t, s0 + g))
        tn = tf = None
        for a in range(3):
            o_a = ot[s, :, None, a]
            i_a = it[s, :, None, a]
            ta = (bm_k[s, None, :, a] - o_a) * i_a          # [G, R, K]
            tb = (bx_k[s, None, :, a] - o_a) * i_a
            lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
            tn = lo if tn is None else torch.maximum(tn, lo)
            tf = hi if tf is None else torch.minimum(tf, hi)
        t0s = t0[s, :, None]
        ok = (tn <= tf) & (tf >= t0s) & (tn <= t1[s, :, None])
        exact[s] = torch.where(ok, torch.maximum(tn, t0s),
                               torch.inf).amin(dim=1)
    key = key.scatter(1, sel, exact)
    return _sorted_lists(key, torch.isfinite(key))


def _chunk_tiles(t: int, c: int) -> int:
    """Tiles a chunk of the prepass: its [G, R, C] temporaries near
    _CAND_BYTES, as in the JAX package. The chunk rule follows it on every
    device: a tile gets no candidates only when its whole chunk is dead."""
    return max(1, min(t, int(_CAND_BYTES / (RAY_TILE * c * 12))))


@PF.span("accel.prepass")
def tile_candidates(bmin: Tensor, bmax: Tensor, o: Tensor, d: Tensor,
                    t_min: Tensor, t_max: Tensor, any_hit: bool = False):
    """Per-tile candidate block lists (the JAX package's branch of one block
    per candidate; front-to-back order, or with `any_hit` cover order; the
    SUPER and CAND_K branches when those are set).

    Rays must be sorted and padded to a RAY_TILE multiple. Returns
    (cand i32[T, Cpad], ent f32[T, Cpad], count i32[T]): each tile's first
    count[t] entries are the blocks some of its rays enter, sorted by entry
    distance, or with `any_hit` by descending coverage, with `ent` minus
    the coverage (stable either way, so ties keep block order), then the
    other blocks in block order with `ent` inf; Cpad pads C to a multiple
    of 128 with block 0 / inf.

    On a CUDA device the default branch launches the prepass kernel
    (`csrc/tiles_traverse.cu`), whose lists equal `tile_candidates_ref`'s
    entry for entry; everything else runs `tile_candidates_ref`."""
    c = bmin.shape[0]
    t = o.shape[0] // RAY_TILE
    if PF.recording():
        PF.count("prepass.tiles", t)
        PF.count("prepass.live_tiles", (t_max.reshape(t, RAY_TILE)
                                        >= t_min.reshape(t, RAY_TILE))
                 .any(dim=1).sum())
    if o.device.type == "cuda" and SUPER == 1 and not 0 < CAND_K < c:
        return _counted(_candidates_kernel(bmin, bmax, o, d, t_min, t_max,
                                           any_hit))
    return _counted(tile_candidates_ref(bmin, bmax, o, d, t_min, t_max,
                                        any_hit))


def tile_candidates_ref(bmin: Tensor, bmax: Tensor, o: Tensor, d: Tensor,
                        t_min: Tensor, t_max: Tensor, any_hit: bool = False):
    """Plain PyTorch version of `tile_candidates`, on any device: the same
    arguments and lists.

    Tiles are processed in chunks whose [G, R, C] temporaries stay near
    64 MB, as in the JAX package. A chunk whose rays all have an empty
    t-range gets no candidates; one host sync per call reads which chunks
    are live.

    With SUPER > 1 the exact test runs on superblocks (the blocks' AABBs
    united SUPER at a time) and a block survives where its superblock is
    entered and its own interval test passes, keyed by the larger of the
    two bounds; cover order is off there, as in the JAX package. With
    0 < CAND_K < C (and SUPER 1) the lists come from
    `_tile_candidates_topk`."""
    c = bmin.shape[0]
    n = o.shape[0]
    t = n // RAY_TILE
    dev = o.device
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12,
                            torch.where(d < 0, -1e-12, 1e-12), d)
    ot = o.reshape(t, RAY_TILE, 3)
    it = inv.reshape(t, RAY_TILE, 3)
    t0 = t_min.reshape(t, RAY_TILE)
    t1 = t_max.reshape(t, RAY_TILE)
    if SUPER == 1 and 0 < CAND_K < c:
        return _tile_candidates_topk(bmin, bmax, ot, it, t0, t1)
    any_hit = any_hit and SUPER == 1
    if SUPER > 1:
        iv_overlap, iv_key = _tile_interval(bmin, bmax, ot, it, t0, t1)
        n_sb = -(-c // SUPER)
        pad = n_sb * SUPER - c
        fill = lambda x, v: torch.cat([x, torch.full(
            (pad, 3), v, dtype=torch.float32, device=dev)]) if pad else x
        bmin = fill(bmin, torch.inf).reshape(n_sb, SUPER, 3).amin(dim=1)
        bmax = fill(bmax, -torch.inf).reshape(n_sb, SUPER, 3).amax(dim=1)
    g = _chunk_tiles(t, bmin.shape[0])
    chunks = -(-t // g)
    tile_live = (t1 >= t0).any(dim=1)
    pad = chunks * g - t
    if pad:
        tile_live = torch.cat([tile_live, tile_live.new_zeros(pad)])
    live = PF.host_read("tiles.live_chunks",
                        tile_live.reshape(chunks, g).any(dim=1))
    key = torch.full((t, bmin.shape[0]), torch.inf, dtype=torch.float32,
                     device=dev)
    cover = torch.zeros_like(key) if any_hit else None
    for k in range(chunks):
        if live[k]:
            s = slice(k * g, min(t, (k + 1) * g))
            out = _chunk_entry(bmin, bmax, ot[s], it[s], t0[s], t1[s],
                               any_hit)
            if any_hit:
                key[s], cover[s] = out
            else:
                key[s] = out
    if SUPER > 1:
        # each block: its superblock's exact entry refines its interval key
        sb = key[:, torch.arange(c, device=dev) // SUPER]
        overlap = iv_overlap & torch.isfinite(sb)
        key = torch.maximum(iv_key, sb)
    else:
        overlap = torch.isfinite(key)
    if any_hit:
        # an any-hit walk needs no front-to-back order: candidate membership
        # already holds each ray's t-range, and it ends when no live ray is
        # left unhit, so the blocks that most rays enter go first
        key = -cover
    return _sorted_lists(key, overlap)


def _cand_launcher():
    """The prepass kernel's C entry point, built and loaded at first use."""
    global _cand_fn
    if _cand_fn is None:
        lib = csrc_build.library("tiles_traverse")
        fn = lib.tile_candidates_launch
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 6 + [cl] * 6 + [ci] * 5 + [vp] * 5
        fn.restype = ci
        lib.tile_candidates_sort_cap.restype = ci
        _cand_fn = (fn, lib.tile_candidates_sort_cap())
    return _cand_fn


def _candidates_kernel(bmin: Tensor, bmax: Tensor, o: Tensor, d: Tensor,
                       t_min: Tensor, t_max: Tensor, any_hit: bool):
    """`tile_candidates`' default branch on the prepass kernel (one launch;
    the rays and t-ranges by their strides)."""
    global cand_launches
    dev = o.device
    c = bmin.shape[0]
    n = o.shape[0]
    t = n // RAY_TILE
    c_pad = -(-c // 128) * 128
    check = lambda *a: csrc_build.check_arg("tile_candidates", *a, dev)
    check("bmin", bmin, torch.float32, (c, 3))
    check("bmax", bmax, torch.float32, (c, 3))
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("t_min", t_min, (n,)), ("t_max", t_max, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or x.device != dev:
            raise ValueError(f"tile_candidates: {name} must be "
                             f"torch.float32 {shape} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if n % RAY_TILE:
        raise ValueError(f"tile_candidates: {n} rays are not a multiple of "
                         f"{RAY_TILE}")
    launch, sort_cap = _cand_launcher()
    cand = torch.empty((t, c_pad), dtype=torch.int32, device=dev)
    ent = torch.empty((t, c_pad), dtype=torch.float32, device=dev)
    count = torch.empty((t,), dtype=torch.int32, device=dev)
    scratch = (torch.empty((t, c), dtype=torch.int64, device=dev)
               if c > sort_cap else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(bmin.data_ptr(), bmax.data_ptr(), o.data_ptr(),
                 d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
                 *o.stride(), *d.stride(), t_min.stride(0), t_max.stride(0),
                 t, c, c_pad, _chunk_tiles(t, c), int(bool(any_hit)),
                 cand.data_ptr(), ent.data_ptr(), count.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tile_candidates kernel launch failed (CUDA "
                           f"error {err})")
    if t:
        cand_launches += 1
        PF.count("kernel.tile_candidates.launches", 1)
        PF.count("kernel.tile_candidates.tiles", t)
    return cand, ent, count


def _counted(lists):
    """`lists` (cand, ent, count), with tracing on their candidates
    counted."""
    if PF.recording():
        PF.count("prepass.candidates", lists[2].sum())
    return lists


def _mt_update(tr: Tensor, cols, carry, vis_col: int,
               step_ok: Optional[Tensor], delta: Optional[Tensor] = None,
               motion=None):
    """Möller-Trumbore of a batch of (16, SUB) slabs (tr f32[G, 16, SUB])
    against their tiles' rays (cols: ox..oz, dx..dz, t_min, exclude, each
    [G, R, 1]); returns the updated (best_t, best_id, best_u, best_v), each
    [G, R, 1]. The JAX package's `_mt_update` with the same arithmetic in
    the same order: within the slab the hit at the lowest t wins, and among
    hits at that t the lowest prim id; it replaces the best hit only on a
    strictly lower t. `delta` ([G, 1, 1]) rebases the prim ids of instanced
    blocks; `motion` = (tr1, tr2 or None, w0, w1, w2) blends the vertex
    rows per ray (weights [G, R, 1])."""
    ox, oy, oz, dx, dy, dz, t_min, excl = cols
    best_t, best_id, best_u, best_v = carry

    def row(r):
        v = tr[:, r:r + 1, :]                   # [G, 1, SUB]
        if motion is None:
            return v
        tr1, tr2, w0, w1, w2 = motion
        v = v * w0 + tr1[:, r:r + 1, :] * w1    # [G, R, SUB]
        if tr2 is not None:
            v = v + tr2[:, r:r + 1, :] * w2
        return v

    ax, ay, az = row(0), row(1), row(2)
    bx, by, bz = row(3), row(4), row(5)
    cx, cy, cz = row(6), row(7), row(8)
    vis = tr[:, vis_col:vis_col + 1, :]
    pid = tr[:, 11:12, :]
    if delta is not None:
        pid = pid + delta
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > EPS_DET
    inv_det = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    # tvec = o - v0
    tvx, tvy, tvz = ox - ax, oy - ay, oz - az
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t <= best_t) & (vis > 0.5) & (pid != excl))
    if step_ok is not None:
        hit = hit & step_ok
    t = torch.where(hit, t, torch.inf)
    tc = t.amin(dim=2, keepdim=True)
    better = tc < best_t
    win = t <= tc
    cid = torch.where(win, pid, torch.inf).amin(dim=2, keepdim=True)
    sel = win & (pid == cid)
    best_id = torch.where(better, cid, best_id)
    best_u = torch.where(better, torch.where(sel, u, -torch.inf).amax(
        dim=2, keepdim=True), best_u)
    best_v = torch.where(better, torch.where(sel, v, -torch.inf).amax(
        dim=2, keepdim=True), best_v)
    best_t = torch.where(better, tc, best_t)
    return best_t, best_id, best_u, best_v


def _motion_weights(tt: Tensor, quadratic: bool):
    """Per-ray keyframe weights (w0, w1, w2) of shutter times tt."""
    if quadratic:               # the b-spline's three control points
        tc = 1.0 - tt
        return tc * tc, 2.0 * tt * tc, tt * tt
    return 1.0 - tt, tt, tt     # two keyframes, linear


def _instance_cols(cols, m: Tensor):
    """The ray columns transformed by 3x4 matrices m ([G, 12]), in the
    Pallas kernel's order (left to right, no fused operations)."""
    ox, oy, oz, dx, dy, dz, tmn, exc = cols
    m = [m[:, i].view(-1, 1, 1) for i in range(12)]
    return (m[0] * ox + m[1] * oy + m[2] * oz + m[3],
            m[4] * ox + m[5] * oy + m[6] * oz + m[7],
            m[8] * ox + m[9] * oy + m[10] * oz + m[11],
            m[0] * dx + m[1] * dy + m[2] * dz,
            m[4] * dx + m[5] * dy + m[6] * dz,
            m[8] * dx + m[9] * dy + m[10] * dz, tmn, exc)


def tile_walk_ref(rays: Tensor, cand: Tensor, ent: Tensor, count: Tensor,
                  tab: Tensor, *, shadow: bool = False,
                  any_hit: bool = False, cover_order: bool = False,
                  tab_t1: Optional[Tensor] = None,
                  tab_t2: Optional[Tensor] = None,
                  blk_base: Optional[Tensor] = None,
                  blk_minv: Optional[Tensor] = None,
                  id_delta: Optional[Tensor] = None,
                  inv_rows: Optional[Tensor] = None,
                  steps: Optional[Tensor] = None):
    """Plain PyTorch version of the kernel: a loop over candidate steps,
    vectorised across tiles. Before every group of UNROLL steps each tile
    still walking takes the exit test; at step k a tile takes its k-th
    candidate, masked by k < count. Returns (t, id, u, v), each f32[Npad]
    (id -1 on a miss, t the ray's t_max). `steps` (i64[Npad], optional)
    is set to the number of candidate steps each ray was tested at while
    unhit with a live range: a cover-order walk's needed work."""
    t = count.shape[0]
    r = rays.reshape(t, RAY_TILE, 16)
    cols = [r[:, :, k:k + 1] for k in (0, 1, 2, 3, 4, 5, 6, 8)]
    weights = (None if tab_t1 is None else
               _motion_weights(r[:, :, 9:10], tab_t2 is not None))
    best_t = r[:, :, 7:8].clone()
    best_id = torch.full_like(best_t, -1.0)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    c_pad = cand.shape[1]
    n_sub = tab.shape[2] // SUB
    vis_col = 10 if shadow else 9
    cnt = count.to(torch.int64)
    walking = cnt > 0
    # cover order: a ray is still looked for while unhit with a live range
    live = r[:, :, 7:8] >= r[:, :, 6:7]
    if steps is not None:
        steps.zero_()
        ray_steps = steps.view(t, RAY_TILE, 1)
    c = 0
    while True:
        if cover_order:
            more = ((best_id < 0.0) & live).any(dim=2).any(dim=1)
        else:
            reach = (torch.where(best_id < 0.0, best_t, -torch.inf)
                     if any_hit else best_t)
            more = ent[:, min(c, c_pad - 1)] <= reach.amax(dim=(1, 2))
        walking &= (c < cnt) & more
        idx = walking.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        for s in range(0, idx.numel(), _REF_TILES):
            sel = idx[s:s + _REF_TILES]
            carry = (best_t[sel], best_id[sel], best_u[sel], best_v[sel])
            cs = [x[sel] for x in cols]
            ws = None if weights is None else [w[sel] for w in weights]
            for k in range(UNROLL):
                ci = c + k
                step_ok = (ci < cnt[sel]).view(-1, 1, 1) if k else None
                if steps is not None:
                    need = (carry[1] < 0.0) & live[sel]
                    ray_steps[sel] += need if k == 0 else need & step_ok
                blk = cand[sel, min(ci, c_pad - 1)].to(torch.int64)
                delta, cols_k = None, cs
                if blk_base is not None:
                    mi = blk_minv[blk].to(torch.int64)
                    delta = id_delta[blk].to(torch.float32).view(-1, 1, 1)
                    moved = _instance_cols(cs, inv_rows[mi])
                    inst = (mi > 0).view(-1, 1, 1)
                    cols_k = [torch.where(inst, a, b)
                              for a, b in zip(moved, cs)]
                    blk = blk_base[blk].to(torch.int64)
                for j in range(n_sub):
                    sub = slice(j * SUB, (j + 1) * SUB)
                    motion = None
                    if ws is not None:
                        motion = (tab_t1[blk, :, sub],
                                  None if tab_t2 is None
                                  else tab_t2[blk, :, sub], *ws)
                    carry = _mt_update(tab[blk, :, sub], cols_k, carry,
                                       vis_col, step_ok, delta, motion)
            best_t[sel], best_id[sel], best_u[sel], best_v[sel] = carry
        c += UNROLL
    return (best_t.reshape(-1), best_id.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))


def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    global _fn
    if _fn is None:
        fn = csrc_build.library("tiles_traverse").tiles_traverse_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                       ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                       vp, vp, vp, vp, vp]
        fn.restype = ci
        _fn = fn
    return _fn


def arm(motion: int, instanced: bool, cover: bool = False) -> str:
    """Name of a specialisation of the kernel: "static", "motion1"
    (linear), "motion2" (quadratic), "instanced", "instanced+motion1"...,
    with "+cover" for the cover-order any-hit walk ("static+cover")."""
    parts = (["instanced"] if instanced else []) + (
        [f"motion{motion}"] if motion else [])
    return "+".join((parts or ["static"]) + (["cover"] if cover else []))


def cover_order_on(any_hit: bool, num_blocks: int = 0) -> bool:
    """Whether an any-hit query over `num_blocks` blocks walks in cover
    order: as in the JAX package, when the environment sets
    YAF_COVER_ORDER=1 (read at each call), SUPER is 1 and CAND_K is off
    for that many blocks."""
    return (bool(any_hit) and SUPER == 1
            and not 0 < CAND_K < num_blocks
            and os.environ.get("YAF_COVER_ORDER", "0") == "1")


@PF.span("accel.walk")
def tile_walk(rays: Tensor, cand: Tensor, ent: Tensor, count: Tensor,
              tab: Tensor, *, shadow: bool = False, any_hit: bool = False,
              cover_order: bool = False,
              tab_t1: Optional[Tensor] = None,
              tab_t2: Optional[Tensor] = None,
              blk_base: Optional[Tensor] = None,
              blk_minv: Optional[Tensor] = None,
              id_delta: Optional[Tensor] = None,
              inv_rows: Optional[Tensor] = None):
    """Walk each tile's candidate blocks (the kernel's wrapper).

    rays f32[Npad, 16] (ox oy oz dx dy dz t_min t_max exclude time, then
    zeros; Npad = T * RAY_TILE); cand i32[T, Cpad]; ent f32[T, Cpad]; count
    i32[T]; tab f32[C_phys, 16, B] with B a multiple of SUB. Motion blur:
    tab_t1 (and tab_t2) shaped as tab. Instancing: blk_base, blk_minv,
    id_delta i32[C] and inv_rows f32[K+1, 12], all four or none. All
    contiguous, on one device; tab, tab_t1 and tab_t2 start on a 16-byte
    boundary (the kernel stages them with 16-byte asynchronous copies).
    `cover_order` (any hit only) walks lists from
    `tile_candidates(any_hit=True)` by the cover rule.
    Returns (t, id, u, v), each f32[Npad]. For a closest hit they are the
    ray's nearest hit; for any hit only hit/miss is defined: the kernel
    stops testing a warp's rays once each has a hit, so the t, id, u, v it
    reports may come from an earlier triangle than `tile_walk_ref`'s."""
    global launches
    dev = rays.device
    t, c_pad = cand.shape
    npad = t * RAY_TILE
    check = lambda *a: csrc_build.check_arg("tile_walk", *a, dev)
    check("rays", rays, torch.float32, (npad, 16))
    check("cand", cand, torch.int32, (t, c_pad))
    check("ent", ent, torch.float32, (t, c_pad))
    check("count", count, torch.int32, (t,))
    if tab.dim() != 3 or tab.shape[1] != 16 or tab.shape[2] % SUB:
        raise ValueError(f"tile_walk: tab must be f32[C, 16, B] with B a "
                         f"multiple of {SUB}, got {tuple(tab.shape)}")
    if tab_t2 is not None and tab_t1 is None:
        raise ValueError("tile_walk: tab_t2 needs tab_t1")
    if cover_order and not any_hit:
        raise ValueError("tile_walk: cover order is an any-hit walk")
    for name, x in (("tab", tab), ("tab_t1", tab_t1), ("tab_t2", tab_t2)):
        if x is not None:
            check(name, x, torch.float32, tuple(tab.shape))
            if x.data_ptr() % 16:
                raise ValueError(f"tile_walk: {name} must start on a 16-byte "
                                 "boundary")
    inst = (blk_base, blk_minv, id_delta, inv_rows)
    instanced = blk_base is not None
    if any((x is None) == instanced for x in inst):
        raise ValueError("tile_walk: blk_base, blk_minv, id_delta and "
                         "inv_rows go together")
    if instanced:
        c_virt = blk_base.shape[0]
        for name, x in zip(("blk_base", "blk_minv", "id_delta"), inst):
            check(name, x, torch.int32, (c_virt,))
        check("inv_rows", inv_rows, torch.float32, (inv_rows.shape[0], 12))
    kw = dict(shadow=shadow, any_hit=any_hit, cover_order=cover_order,
              tab_t1=tab_t1, tab_t2=tab_t2, blk_base=blk_base,
              blk_minv=blk_minv, id_delta=id_delta, inv_rows=inv_rows)
    if dev.type == "cpu":
        return tile_walk_ref(rays, cand, ent, count, tab, **kw)
    if dev.type != "cuda":
        raise ValueError(f"tile_walk: no kernel for device {dev}")
    launch = _launcher()
    motion = 0 if tab_t1 is None else (2 if tab_t2 is not None else 1)
    out = [torch.empty((npad,), dtype=torch.float32, device=dev)
           for _ in range(4)]
    ptr = lambda x: None if x is None else x.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(rays.data_ptr(), cand.data_ptr(), ent.data_ptr(),
                 count.data_ptr(), tab.data_ptr(), ptr(tab_t1), ptr(tab_t2),
                 *(ptr(x) for x in inst), t, c_pad, tab.shape[2],
                 10 if shadow else 9, int(bool(any_hit)),
                 int(bool(cover_order)), motion,
                 blk_base.shape[0] if instanced else tab.shape[0],
                 tab.shape[0], inv_rows.shape[0] if instanced else 0,
                 *(x.data_ptr() for x in out), stream)
    if err != 0:
        raise RuntimeError(f"tiles_traverse kernel launch failed (CUDA error "
                           f"{err})")
    launches += 1
    arm_launches[arm(motion, instanced, cover_order)] += 1
    PF.count("kernel.tile_walk.rays", npad)
    if any_hit:
        PF.count("kernel.tile_walk.any_hit_rays", npad)
    return tuple(out)


def prepare(bmin: Tensor, bmax: Tensor, o: Tensor, d: Tensor, t_min: Tensor,
            t_max: Tensor, exclude: Tensor, time: Optional[Tensor] = None,
            cover_order: bool = False):
    """Pad the rays to a RAY_TILE multiple (padding rays have an empty
    t-range), pack them f32[Npad, 16] (the shutter time in column 9, 0
    without one) and build the candidate lists (in cover order with
    `cover_order`). Returns (rays, cand, ent, count)."""
    n = o.shape[0]
    npad = -(-n // RAY_TILE) * RAY_TILE
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    t_min = t_min.to(torch.float32).expand(n)
    t_max = t_max.to(torch.float32).expand(n)
    exclude = exclude.to(torch.float32).expand(n)
    time = (torch.zeros((n,), **f32) if time is None
            else time.to(torch.float32).expand(n))
    if npad != n:
        k = npad - n
        o = torch.cat([o, torch.zeros((k, 3), **f32)])
        d = torch.cat([d, torch.ones((k, 3), **f32)])
        t_min = torch.cat([t_min, torch.zeros((k,), **f32)])
        t_max = torch.cat([t_max, torch.full((k,), -1.0, **f32)])
        exclude = torch.cat([exclude, torch.full((k,), -1.0, **f32)])
        time = torch.cat([time, torch.zeros((k,), **f32)])
    rays = torch.cat([o, d, t_min[:, None], t_max[:, None], exclude[:, None],
                      time[:, None], torch.zeros((npad, 6), **f32)], dim=1)
    cand, ent, count = tile_candidates(bmin, bmax, o, d, t_min, t_max,
                                       any_hit=cover_order)
    return rays, cand, ent, count


def _traverse(walk, tab, bmin, bmax, o, d, t_min, t_max, exclude, shadow,
              any_hit, blk_base, blk_minv, id_delta, inv_rows, tab_t1,
              tab_t2, time):
    if tab_t1 is None or time is None:     # no motion: the keyframes idle
        tab_t1 = tab_t2 = time = None
    n = o.shape[0]
    cover = cover_order_on(any_hit, bmin.shape[0])
    rays, cand, ent, count = prepare(bmin, bmax, o, d, t_min, t_max, exclude,
                                     time, cover)
    bt, bid, bu, bv = walk(rays, cand, ent, count, tab, shadow=shadow,
                           any_hit=any_hit, cover_order=cover,
                           tab_t1=tab_t1, tab_t2=tab_t2,
                           blk_base=blk_base, blk_minv=blk_minv,
                           id_delta=id_delta, inv_rows=inv_rows)
    return bt[:n], bid[:n].to(torch.int32), bu[:n], bv[:n]


def tiles_traverse(tab: Tensor, bmin: Tensor, bmax: Tensor, o: Tensor,
                   d: Tensor, t_min: Tensor, t_max: Tensor, exclude: Tensor,
                   *, shadow: bool = False, any_hit: bool = False,
                   blk_base=None, blk_minv=None, id_delta=None, inv_rows=None,
                   tab_t1=None, tab_t2=None, time=None):
    """Traverse sorted rays through the block table.

    tab f32[C_phys, 16, B] (BlockAccel.tab); bmin/bmax f32[C, 3] per
    virtual block; o, d f32[N, 3]; t_min, t_max f32[N]; exclude i32[N].
    Instanced scenes pass blk_base / blk_minv / id_delta i32[C] and
    inv_rows f32[K+1, 12]; motion blur passes tab_t1 (and tab_t2) with the
    rays' shutter times `time` f32[N]. Any-hit queries walk in cover order
    when `cover_order_on` says so. Returns (t, prim i32 (-1 on a miss), u,
    v), each [N]."""
    return _traverse(tile_walk, tab, bmin, bmax, o, d, t_min, t_max, exclude,
                     shadow, any_hit, blk_base, blk_minv, id_delta, inv_rows,
                     tab_t1, tab_t2, time)


def tiles_traverse_ref(tab: Tensor, bmin: Tensor, bmax: Tensor, o: Tensor,
                       d: Tensor, t_min: Tensor, t_max: Tensor,
                       exclude: Tensor, *, shadow: bool = False,
                       any_hit: bool = False, blk_base=None, blk_minv=None,
                       id_delta=None, inv_rows=None, tab_t1=None, tab_t2=None,
                       time=None):
    """`tiles_traverse` through the plain walk, on any device."""
    return _traverse(tile_walk_ref, tab, bmin, bmax, o, d, t_min, t_max,
                     exclude, shadow, any_hit, blk_base, blk_minv, id_delta,
                     inv_rows, tab_t1, tab_t2, time)
