"""The port's block accelerator against the JAX package: morton codes, the
block tables, the tile candidate lists, the tile walk's plain version
against the Pallas kernel in interpret mode, the scene-level queries, and
the sun and background lights of the terrain scene (BASELINE config 3,
untextured, at 2048 faces).

Tolerances: morton codes, block tables and candidate lists exact (entry
distances within rtol 1e-6). Hits: at least 99.9% of rays agree, a ray
agreeing when its prim id is equal and its t, u, v are within rtol 1e-5
(atol 1e-6 near 0): XLA's CPU code may contract products and sums into
FMAs, so a ray grazing a triangle edge can land on the other side of it;
the port's plain version rounds every operation on its own, as its CUDA
kernel does. Any-hit queries agree on hit or miss (the prim they report
depends on how many candidates were walked). Per-lane light sampling within
1e-5.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from libyafaray_tpu import lights as JL
from libyafaray_tpu.accel import blocks as JB
from libyafaray_tpu.accel import morton as JM
from libyafaray_tpu.accel import tiles as JT
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu_torch import lights as L
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.accel import blocks as BL
from libyafaray_tpu_torch.accel import morton as M
from libyafaray_tpu_torch.accel import tiles as TL
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.csrc_build import launch_counts
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.scene_types import Geometry
from libyafaray_tpu_torch.scenes import bigmesh_builder as port_bigmesh
from scenes import bigmesh_builder
from test_pallas_intersect import _random_geom
from test_torch_foundations import one_torch_thread  # noqa: F401

RES = 24


def T(a):
    return torch.from_numpy(np.array(a))


def _port_geom(g):
    """The port's Geometry with the JAX Geometry's triangle arrays."""
    names = ("vertices", "normals", "uvs", "faces", "face_uvs", "face_mat",
             "face_obj", "face_smooth", "face_light", "face_vis")
    return Geometry(num_faces=int(g.num_faces),
                    **{k: T(getattr(g, k)) for k in names})


def _rays(rng, n, lo=-2.0, hi=2.0):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::7] = -1.0                       # dead rays: empty t-range
    excl = np.full(n, -1, np.int32)
    excl[::5] = rng.integers(0, 300, excl[::5].shape)
    return o, d, t_min, t_max, excl


def _agree(got, want):
    """Rays whose prim ids are equal and t, u, v within rtol 1e-5."""
    same = np.asarray(got[1]) == np.asarray(want[1])
    for k in (0, 2, 3):
        same &= np.isclose(np.asarray(got[k]), np.asarray(want[k]),
                           rtol=1e-5, atol=1e-6)
    return same


@pytest.fixture(scope="module")
def random_geom():
    return _random_geom(np.random.default_rng(3), 300)


@pytest.fixture(scope="module")
def random_acc(random_geom):
    """The JAX package's block tables of the random triangles."""
    return jax.jit(JB.build_blocks)(random_geom)


@pytest.fixture(scope="module")
def terrain():
    """The 2048-face terrain compiled by the JAX package, and carried across
    to the port."""
    b = bigmesh_builder(33, textured=False)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    js = b.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def test_morton3d_bit_exact(rng):
    rel = rng.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    rel[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 1 / 3], [1023 / 1024] * 3,
               [-1, 2, 0], [0.999999, 0, 1], [1e-7, 0.5, 0.5], [0.1] * 3]
    want = np.asarray(jax.jit(JM.morton3d)(rel)).astype(np.int64)
    np.testing.assert_array_equal(M.morton3d(T(rel)).numpy(), want)


@pytest.mark.parametrize("scene", ["random", "terrain"])
def test_build_blocks_matches_jax(request, scene):
    g = (request.getfixturevalue("random_geom") if scene == "random"
         else request.getfixturevalue("terrain")[0].geom)
    want = jax.jit(JB.build_blocks)(g)
    got = BL.build_blocks(_port_geom(g))
    assert (got.block_size, got.num_blocks) == (want.block_size,
                                                want.num_blocks)
    for f in ("tab", "bmin", "bmax"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def _shadow_rays(rng, js, n=1024):
    """Rays from points on and above the terrain toward the sun and in
    random directions, some excluding a prim, 1/7 dead."""
    o, d, excl = _scene_rays(rng, js, n)
    o[: n // 2, 2] = rng.uniform(-0.3, 0.4, n // 2)
    d[: n // 2] = -np.asarray(js.lights.direction)[0]
    t_max = np.full(n, 1e30, np.float32)
    t_max[::7] = -1.0
    return o, d, np.zeros(n, np.float32), t_max, excl


@pytest.fixture(scope="module")
def random_acc_256(random_geom):
    """The random triangles' block bounds in blocks of 256 (two blocks)."""
    t = jax.jit(lambda g: JB._tables_for(g, b=256, face_ids=None))(
        random_geom)
    return t["bmin"], t["bmax"]


@pytest.fixture(scope="module")
def terrain_slice():
    """The block bounds of the 203,522-face terrain from the port's tables
    (1,591 blocks of 128: not a multiple of 128), and the 4,096 pixel-centre
    camera rays of a 64x64 view of it in the block accelerator's sorted
    order."""
    b = port_bigmesh(320, textured=False)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 64
    scene = b.compile("cam", device="cpu")
    py, px = torch.meshgrid(torch.arange(64.0) + 0.5,
                            torch.arange(64.0) + 0.5, indexing="ij")
    o, d, _ = shoot_rays(scene.camera, px.reshape(-1), py.reshape(-1))
    t_min = torch.zeros(4096)
    t_max = torch.full((4096,), 1e30)
    perm = torch.sort(BL.sort_key(scene.blocks, o, d, t_min, t_max),
                      stable=True).indices
    return tuple(x.numpy() for x in (scene.blocks.bmin, scene.blocks.bmax,
                                     o[perm], d[perm], t_min, t_max))


def _cand_case(request, rng, name):
    """(bmin, bmax, o, d, t_min, t_max) of one prepass case, whole tiles."""
    fix = request.getfixturevalue
    if name in ("terrain_slice", "dead_chunk"):
        bmin, bmax, o, d, t_min, t_max = (x.copy()
                                          for x in fix("terrain_slice"))
        if name == "dead_chunk":
            # 32 tiles in chunks of 26: tile 3 dead inside a live chunk, its
            # rays starting inside blocks with t_max just below t_min; the
            # second chunk (tiles 26-31) dead throughout
            r = slice(3 * 128, 4 * 128)
            o[r] = 0.5 * (bmin[:128] + bmax[:128])
            t_max[r] = -1e-3
            t_max[26 * 128:] = -1.0
        return bmin, bmax, o, d, t_min, t_max
    if name == "terrain":
        js, _ = fix("terrain")
        return (js.blocks.bmin, js.blocks.bmax) + _shadow_rays(rng, js)[:4]
    bmin, bmax = (fix("random_acc_256") if name == "block_256" else
                  (fix("random_acc").bmin, fix("random_acc").bmax))
    o, d, t_min, t_max, _ = _rays(rng, 768 if name == "tmax_short" else 1024)
    if name == "tmax_short":
        t_max[t_max > 0] = 0.8
    t_max[:128] = -1.0
    return bmin, bmax, o, d, t_min, t_max


@pytest.mark.parametrize("order", ["front", "cover"])
@pytest.mark.parametrize("case", ["random", "tmax_short", "block_256",
                                  "terrain", "terrain_slice", "dead_chunk"])
def test_tile_candidates_match(request, rng, case, order):
    """The prepass's lists against the JAX package's, front to back (`ent`
    the entry distance, within rtol 1e-6) and in cover order (`ent` minus
    the coverage, equal). Random triangles in blocks of 128 and 256, a
    short t_max, the 2,048-face terrain's shadow rays, and a slice of the
    203,522-face terrain's camera rays (1,591 blocks). Tile 0 of the random
    cases holds only dead rays and, as in the JAX package, still gets
    candidates: the prepass skips only whole chunks of dead tiles, and a
    dead ray whose slab interval straddles t_min passes the slab test. The
    dead-chunk case has such a tile in a live chunk and a dead chunk
    (every list the identity, count 0)."""
    args = _cand_case(request, rng, case)
    cover = order == "cover"
    cand, ent, count = jax.jit(JT.tile_candidates,
                               static_argnames=("any_hit",))(*args,
                                                             any_hit=cover)
    c, e, n = TL.tile_candidates(*(T(x) for x in args), any_hit=cover)
    t = args[2].shape[0] // TL.RAY_TILE
    assert c.dtype == n.dtype == torch.int32 and n.shape == (t,)
    np.testing.assert_array_equal(n.numpy(), np.asarray(count)[:, 0])
    np.testing.assert_array_equal(c.numpy(), np.asarray(cand))
    if cover:
        np.testing.assert_array_equal(e.numpy(), np.asarray(ent))
        # ent holds minus each block's coverage, in ascending order
        k = np.arange(e.shape[1]) < n.numpy()[:, None]
        ent_np = e.numpy()
        assert (ent_np[k] <= -1).all() and (ent_np[~k] == np.inf).all()
        assert (ent_np[:, 1:] >= ent_np[:, :-1]).all()
    else:
        np.testing.assert_allclose(e.numpy(), np.asarray(ent), rtol=1e-6)
    if case in ("random", "tmax_short"):
        assert (n > 0).all()
    if case == "terrain_slice":
        assert args[0].shape[0] == 1591 and (n > 0).sum() > t // 2
    if case == "dead_chunk":
        assert TL._chunk_tiles(t, 1591) == 26
        assert n[3] > 0 and (n[26:] == 0).all()
        c_pad = c.shape[1]
        ident = torch.where(torch.arange(c_pad) < 1591, torch.arange(c_pad),
                            0).to(torch.int32)
        assert (c[26:] == ident).all() and torch.isinf(e[26:]).all()


@pytest.mark.parametrize("case", ["closest", "shadow", "any_hit",
                                  "tmax_short", "block_256"])
def test_tile_walk_matches_pallas_interpret(rng, random_geom, random_acc,
                                            case):
    acc = random_acc
    tab, bmin, bmax = acc.tab, acc.bmin, acc.bmax
    if case == "block_256":
        # two sub-chunks per block: the walk's sub-chunk loop
        t = jax.jit(functools.partial(JB._tables_for, face_ids=None, b=256))(
            random_geom)
        tab, bmin, bmax = t["tab"], t["bmin"], t["bmax"]
        got_tab = BL._tables_for(_port_geom(random_geom), 256)["tab"]
        np.testing.assert_array_equal(got_tab.numpy(), np.asarray(tab))
        assert tab.shape == (2, 16, 256)
    n = 777 if case == "tmax_short" else 1024
    o, d, t_min, t_max, excl = _rays(rng, n)
    if case == "tmax_short":
        t_max[t_max > 0] = 0.8               # many rays stop short
    kw = dict(shadow=case in ("shadow", "any_hit"), any_hit=case == "any_hit")
    want = JT.tiles_traverse(tab, bmin, bmax, o, d, t_min, t_max, excl,
                             interpret=True, **kw)
    got = TL.tiles_traverse_ref(T(tab), T(bmin), T(bmax), T(o), T(d),
                                T(t_min), T(t_max), T(excl), **kw)
    assert got[1].dtype == torch.int32 and got[0].shape == (n,)
    hits = np.asarray(want[1]) >= 0
    assert 0.1 < hits.mean() < 0.9
    if case == "any_hit":
        np.testing.assert_array_equal(got[1].numpy() >= 0, hits)
    else:
        assert _agree(got, want).mean() >= 0.999


def _tie_table():
    """One block whose lanes 0 and 1 hold two triangles sharing the edge
    x = 0 in the plane z = 1, with prim ids 5 and 3 (not in lane order)."""
    tab = np.zeros((1, 16, 128), np.float32)
    tab[0, 11] = -2.0
    tris = {0: ([0, -1, 1], [1, -1, 1], [0, 1, 1], 5.0),
            1: ([0, -1, 1], [0, 1, 1], [-1, -1, 1], 3.0)}
    for lane, (a, b, c, pid) in tris.items():
        tab[0, 0:9, lane] = a + b + c
        tab[0, 9:12, lane] = [1.0, 1.0, pid]
    bmin = np.array([[-1, -1, 1]], np.float32)
    bmax = np.array([[1, 1, 1]], np.float32)
    return tab, bmin, bmax


def test_tie_in_a_sub_chunk_takes_the_lowest_prim_id():
    tab, bmin, bmax = _tie_table()
    ray = (np.zeros((1, 3), np.float32), np.array([[0, 0, 1]], np.float32),
           np.array([1e-4], np.float32), np.array([1e30], np.float32),
           np.array([-1], np.int32))
    want = JT.tiles_traverse(tab, bmin, bmax, *ray, interpret=True)
    got = TL.tiles_traverse_ref(T(tab), T(bmin), T(bmax),
                                *(T(x) for x in ray))
    assert int(got[1][0]) == int(want[1][0]) == 3
    np.testing.assert_allclose([float(x[0]) for x in (got[0], got[2], got[3])],
                               [1.0, 0.5, 0.0], atol=1e-6)
    np.testing.assert_allclose([float(x[0]) for x in got[::2]],
                               [float(want[k][0]) for k in (0, 2)], atol=1e-6)


def test_wrapper_routes_cpu_tensors_to_the_plain_version(rng, random_acc):
    acc = random_acc
    args = [T(x) for x in (acc.tab, acc.bmin, acc.bmax)
            + _rays(rng, 300)]
    before = launch_counts["kernel.tile_walk.launches"]
    got = TL.tiles_traverse(*args, shadow=True)
    want = TL.tiles_traverse_ref(*args, shadow=True)
    assert launch_counts["kernel.tile_walk.launches"] == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the motion arm on CPU tensors also runs the plain version
    time = torch.rand(300, generator=torch.Generator().manual_seed(0))
    got = TL.tiles_traverse(*args, tab_t1=args[0], time=time)
    want = TL.tiles_traverse_ref(*args, tab_t1=args[0], time=time)
    assert launch_counts["kernel.tile_walk.launches"] == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the instancing tables go together
    with pytest.raises(ValueError):
        TL.tiles_traverse(*args, blk_base=torch.zeros(3, dtype=torch.int32))
    rays, cand, ent, count = TL.prepare(*args[1:])
    with pytest.raises(ValueError):
        TL.tile_walk(rays.to("meta"), cand.to("meta"), ent.to("meta"),
                     count.to("meta"), args[0].to("meta"))
    with pytest.raises(ValueError):
        TL.tile_walk(rays, cand, ent, count, args[0][:, :, :100])


def test_wrapper_refuses_a_table_off_a_16_byte_boundary(rng, random_acc):
    """The kernel stages the tables with 16-byte copies: a table view that
    starts 4 bytes into its storage is refused, on the CPU too."""
    args = [T(x) for x in (random_acc.tab, random_acc.bmin, random_acc.bmax)
            + _rays(rng, 300)]
    rays, cand, ent, count = TL.prepare(*args[1:])
    tab = args[0]
    shifted = torch.empty(tab.numel() + 1)[1:].view(tab.shape)
    shifted.copy_(tab)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    for kw in (dict(tab=shifted), dict(tab=tab, tab_t1=shifted),
               dict(tab=tab, tab_t1=tab, tab_t2=shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            TL.tile_walk(rays, cand, ent, count, **kw)
    TL.tile_walk(rays, cand, ent, count, tab)


def _scene_rays(rng, js, n=1024):
    """Camera rays and rays from above the terrain, some excluding a prim."""
    o = rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0.2, 1.0, n)
    o[: n // 2] = np.asarray(js.camera.origin)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 2] = [0.0, 4.5, -2.2] + rng.uniform(-1.5, 1.5, (n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = np.full(n, -1, np.int32)
    excl[::9] = rng.integers(0, 2048, excl[::9].shape)
    return o, d, excl


@pytest.mark.parametrize("path", ["tiles", "query_chunk"])
def test_scene_queries_match(rng, terrain, monkeypatch, path):
    """closest_hit / any_hit on the compiled terrain against the JAX
    package's, on its TPU path ("tiles": the ray sort and the tile kernel in
    interpret mode) and on its CPU path ("query_chunk": the per-ray block
    loop). Prim ids and t as everywhere; u and v within 1e-4: the terrain's
    triangles are 0.125 wide and seen from about 6 units, so the barycentrics
    lose about six bits to cancellation, and XLA's FMA contraction moves
    them by up to 1.2e-5 (on about 1% of rays) on both paths."""
    js, ts = terrain
    assert ts.accel_kind == js.accel_kind == "blocks"
    o, d, excl = _scene_rays(rng, js)
    query = lambda s, o, d, e: (
        JI.closest_hit(s, o, d, s.ray_min_dist, 1e30, exclude_prim=e),
        JI.any_hit(s, o, d, 0.0, 1e30, exclude_prim=e))
    if path == "tiles":
        monkeypatch.setattr(JT, "use_tiles", lambda: True)
        monkeypatch.setattr(JT, "tiles_traverse", functools.partial(
            JT.tiles_traverse, interpret=True))
    jhit, jany = jax.jit(query)(js, o, d, excl)
    hit = I.closest_hit(ts, T(o), T(d), ts.ray_min_dist, 1e30,
                        exclude_prim=T(excl))
    np.testing.assert_array_equal(hit.valid.numpy(), np.asarray(jhit.valid))
    assert 0.2 < hit.valid.numpy().mean() < 0.95
    same = hit.prim.numpy() == np.asarray(jhit.prim)
    same &= np.isclose(hit.t.numpy(), np.asarray(jhit.t), rtol=1e-5,
                       atol=1e-6)
    same &= np.isclose(hit.uv.numpy(), np.asarray(jhit.uv), rtol=0,
                       atol=1e-4).all(-1)
    assert same.mean() >= 0.999
    anyh = I.any_hit(ts, T(o), T(d), 0.0, 1e30, exclude_prim=T(excl))
    np.testing.assert_array_equal(anyh.numpy(), np.asarray(jany))


def test_sun_and_background_light_sampling_match(rng, terrain):
    js, ts = terrain
    n = 2048
    p = rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32)
    ns = np.tile(np.float32([0, 0, 1]), (n, 1))
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    li = (np.arange(n) % 2).astype(np.int32)     # 0 the sun, 1 the bg light
    assert ts.lights.bg_light_idx == 1
    jls = jax.jit(JL.sample_light)(js, li, p, ns, u1, u2)
    ls = L.sample_light(ts, T(li), T(p), T(ns), T(u1), T(u2))
    np.testing.assert_array_equal(ls.valid.numpy(), np.asarray(jls.valid))
    np.testing.assert_array_equal(ls.is_dirac.numpy(),
                                  np.asarray(jls.is_dirac))
    for name in ("wi", "dist", "pdf", "radiance"):
        np.testing.assert_allclose(getattr(ls, name).numpy(),
                                   np.asarray(getattr(jls, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert ls.valid.numpy().all()
    jpdf = jax.jit(JL.background_pdf)(js, np.asarray(jls.wi))
    np.testing.assert_allclose(L.background_pdf(ts, ls.wi).numpy(),
                               np.asarray(jpdf), rtol=1e-6)
