"""True instancing in the port against the JAX package: the compiled tables
(`_build_blocks_instanced` included), `resolve_prim` and the instanced
surface point, the instancing arm of the tile walk against the Pallas
kernel in interpret mode, scene queries, the point light, and renders of
the forest (terrain, true instances and moving baked instances) and of the
libYafaRay golden's instanced cubes, baked and true.

Tolerances: tables, prim resolution and integer surface fields exact.
Hits: at least 99.9% of rays with equal prim ids, t within rtol 1e-5 (atol
1e-6 near 0) and u, v within 1e-5, as in `test_torch_blocks.py`: XLA's CPU
code may contract products and sums into FMAs, so a ray grazing an edge can
land on the other side, and the ray's transform into object space is one
more such stage, which moves the barycentrics of the small instanced
triangles by up to 2.2e-6; any hits agree on hit or miss. Surface points and light
samples within 1e-5. Renders: at least 98% of pixels within rtol = atol =
1e-4, and the mean within 1e-3 relative.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import libyafaray_tpu
import test_refparity
from libyafaray_tpu import film as JF
from libyafaray_tpu import io as JIO
from libyafaray_tpu import lights as JL
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu import scene_types as JST
from libyafaray_tpu.accel import tiles as JT
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu_torch import SceneBuilder
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import io as TIO
from libyafaray_tpu_torch import lights as L
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch import scene_types as ST
from libyafaray_tpu_torch import scenes as PS
from libyafaray_tpu_torch.accel import tiles as TL
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.csrc_build import launch_counts
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.ops import surface as S
from test_torch_foundations import one_torch_thread  # noqa: F401

RES = 12


def T(a):
    return torch.from_numpy(np.array(a))


def _blob_scene(builder, n_inst=24):
    """The scene of `tests/test_instancing.py` `_instanced_builder`: a
    ground quad and n_inst instances of a 96-triangle blob (more than 2048
    virtual faces, so "auto" elects true instancing)."""
    rng = np.random.default_rng(5)
    b = builder()
    b.create_material("grey", {"type": "shinydiffusemat",
                               "color": (0.7, 0.68, 0.65)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.7, 0.2, 0.15)})
    b.create_object("ground")
    b.set_current_material("grey")
    b.add_quad(*[b.add_vertex(*p) for p in ((-8, -8, 0), (8, -8, 0),
                                            (8, 8, 0), (-8, 8, 0))])
    b.create_object("blob")
    b.set_current_material("red")
    PS._rock(b)
    for _ in range(n_inst):
        x, y = rng.uniform(-3, 3, 2)
        s = rng.uniform(0.6, 1.6)
        m = PS._rot_z(rng.uniform(0, 2 * np.pi))
        m[:3, :3] *= s
        m[0, 3], m[1, 3], m[2, 3] = x, y, 0.35 * s
        b.add_instance("blob", m)
    b.create_light("sun", {"type": "sunlight", "direction": (0.4, 0.3, 0.85),
                           "color": (1, 1, 0.95), "power": 2.0})
    b.create_camera("cam", {"type": "perspective", "from": (0, -6.5, 4.0),
                            "to": (0, 0, 0.3), "up": (0, -6.5, 5.0),
                            "resx": 48, "resy": 48, "fov": 55.0})
    b.create_background({"type": "constant", "color": (0.2, 0.25, 0.35)})
    return b


@pytest.fixture(scope="module")
def blobs():
    """(JAX scene, the port's own compile, the JAX scene carried across)."""
    js = _blob_scene(libyafaray_tpu.SceneBuilder).compile("cam")
    own = _blob_scene(SceneBuilder).compile("cam", device="cpu")
    return js, own, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def _jax_scene(monkeypatch, make, **kw):
    """A scene of the port's `scenes` module built by the JAX package."""
    with monkeypatch.context() as m:
        m.setattr(PS, "SceneBuilder", libyafaray_tpu.SceneBuilder)
        return make(**kw)


def _rays(rng, n):
    o = np.stack([rng.uniform(-4, 4, n), rng.uniform(-7, 2, n),
                  rng.uniform(0.2, 3.0, n)], -1).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::7] = -1.0                       # dead rays
    excl = np.full(n, -1, np.int32)
    excl[::5] = rng.integers(0, 2402, excl[::5].shape)
    return o, d, t_max, excl


def _agree(got, want):
    """Rays whose prim ids are equal, t within rtol 1e-5 and u, v within
    1e-5."""
    same = np.asarray(got[1]) == np.asarray(want[1])
    same &= np.isclose(np.asarray(got[0]), np.asarray(want[0]), rtol=1e-5,
                       atol=1e-6)
    for k in (2, 3):
        same &= np.isclose(np.asarray(got[k]), np.asarray(want[k]), rtol=0,
                           atol=1e-5)
    return same


def test_instanced_tables_match_jax(blobs):
    _, own, want = blobs
    assert own.accel_kind == want.accel_kind == "blocks"
    g, wg = own.geom, want.geom
    assert (g.num_faces, g.num_base_faces) == (wg.num_faces,
                                               wg.num_base_faces) == (2402, 98)
    for f in ("vertices", "normals", "faces", "face_vis", "face_obj",
              "face_mat", "inst_mat", "inst_inv", "inst_nrm",
              "inst_face_base", "inst_face_off", "inst_obj", "inst_vis"):
        a, b = getattr(g, f), getattr(wg, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert g.tri_table is None and not g.has_motion
    bl, wb = own.blocks, want.blocks
    for f in ("tab", "bmin", "bmax", "blk_base", "blk_minv", "id_delta",
              "inv_rows"):
        a, b = getattr(bl, f), getattr(wb, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert bl.tab_t1 is None and bl.tab.shape == (2, 16, 128)
    assert (bl.num_blocks, bl.block_size) == (wb.num_blocks, 128) == (25, 128)


@pytest.fixture(scope="module")
def jax_queries(blobs):
    """Rays through the blob scene and the JAX package's answers on its CPU
    path (the per-ray block loop): closest hits, any hits, surface points."""
    js = blobs[0]
    o, d, t_max, excl = _rays(np.random.default_rng(42), 1024)

    @jax.jit
    def jq(s, o, d, t_max, excl):
        hit = JI.closest_hit(s, o, d, s.ray_min_dist, t_max,
                             exclude_prim=excl)
        return (hit, JI.any_hit(s, o, d, 0.0, t_max, exclude_prim=excl),
                JS.make_surface(s, hit, o, d))

    return (o, d, t_max, excl) + tuple(jq(js, o, d, t_max, excl))


def test_resolve_prim_and_surface_match(blobs, jax_queries):
    js, ts, _ = blobs
    prim = np.concatenate([np.arange(0, 2402, 7), [97, 98, 2401]]
                          ).astype(np.int32)
    jbase, jinst = JST.resolve_prim(js.geom, prim)
    base, inst = ST.resolve_prim(ts.geom, T(prim))
    np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    np.testing.assert_array_equal(inst.numpy(), np.asarray(jinst))
    o, d, _, _, jhit, _, jsp = jax_queries
    assert (np.asarray(jhit.prim)[np.asarray(jhit.valid)] >= 98).mean() > 0.1
    sp = S.make_surface(ts, I.Hit(valid=T(jhit.valid), t=T(jhit.t),
                                  prim=T(jhit.prim), uv=T(jhit.uv)),
                        T(o), T(d))
    for f in ("valid", "mat_id", "obj_id", "light_id", "prim"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(),
                                      np.asarray(getattr(jsp, f)), err_msg=f)
    for f in ("p", "n", "ng", "nu", "nv", "uv", "dp_du", "dp_dv"):
        np.testing.assert_allclose(getattr(sp, f).numpy(),
                                   np.asarray(getattr(jsp, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("query", ["closest", "any_hit"])
def test_instanced_walk_matches_pallas_interpret(blobs, query):
    """The instancing arm of `tile_walk_ref` against the Pallas kernel."""
    js, _, _ = blobs
    acc = js.blocks
    o, d, t_max, excl = _rays(np.random.default_rng(11), 500)
    t_min = np.full(500, 1e-4, np.float32)
    inst = dict(blk_base=acc.blk_base, blk_minv=acc.blk_minv,
                id_delta=acc.id_delta, inv_rows=acc.inv_rows)
    kw = dict(shadow=query == "any_hit", any_hit=query == "any_hit")
    want = JT.tiles_traverse(acc.tab, acc.bmin, acc.bmax, o, d, t_min, t_max,
                             excl, interpret=True, **inst, **kw)
    got = TL.tiles_traverse_ref(
        *(T(x) for x in (acc.tab, acc.bmin, acc.bmax, o, d, t_min, t_max,
                         excl)), **{k: T(v) for k, v in inst.items()}, **kw)
    hits = np.asarray(want[1]) >= 0
    assert 0.1 < hits.mean() < 0.9 and (np.asarray(want[1]) >= 98).any()
    if query == "any_hit":
        np.testing.assert_array_equal(got[1].numpy() >= 0, hits)
    else:
        assert _agree(got, want).mean() >= 0.999


@pytest.mark.parametrize("query", ["closest", "any_hit"])
def test_instanced_motion_walk_matches_pallas_interpret(blobs, query):
    """The instancing and linear motion arms together: the blob scene's
    instanced tables with a keyframe table whose vertices move by up to
    0.05, at random shutter times."""
    _, own, _ = blobs
    acc = own.blocks
    rng = np.random.default_rng(13)
    tab = acc.tab.numpy()
    tab_t1 = tab.copy()
    tab_t1[:, 0:9] += rng.uniform(-0.05, 0.05, tab_t1[:, 0:9].shape
                                  ).astype(np.float32)
    o, d, t_max, excl = _rays(rng, 500)
    t_min = np.full(500, 1e-4, np.float32)
    tm = rng.random(500).astype(np.float32)
    tabs = dict(blk_base=acc.blk_base.numpy(), blk_minv=acc.blk_minv.numpy(),
                id_delta=acc.id_delta.numpy(), inv_rows=acc.inv_rows.numpy(),
                tab_t1=tab_t1, time=tm)
    kw = dict(shadow=query == "any_hit", any_hit=query == "any_hit")
    # the AABBs of the shutter-open table, widened to hold the keyframe
    bmin, bmax = acc.bmin.numpy() - 0.1, acc.bmax.numpy() + 0.1
    want = JT.tiles_traverse(tab, bmin, bmax, o, d, t_min, t_max, excl,
                             interpret=True, **tabs, **kw)
    got = TL.tiles_traverse_ref(
        *(T(x) for x in (tab, bmin, bmax, o, d, t_min, t_max, excl)),
        **{k: T(v) for k, v in tabs.items()}, **kw)
    hits = np.asarray(want[1]) >= 0
    assert 0.1 < hits.mean() < 0.9 and (np.asarray(want[1]) >= 98).any()
    if query == "any_hit":
        np.testing.assert_array_equal(got[1].numpy() >= 0, hits)
    else:
        assert _agree(got, want).mean() >= 0.999


def test_instanced_scene_queries_match(blobs, jax_queries):
    """closest_hit / any_hit on the instanced scene: the port's tile walk
    against the JAX package's CPU path (its per-ray block loop)."""
    _, ts, _ = blobs
    o, d, t_max, excl, jhit, jany, _ = jax_queries
    hit = I.closest_hit(ts, T(o), T(d), ts.ray_min_dist, T(t_max),
                        exclude_prim=T(excl))
    np.testing.assert_array_equal(hit.valid.numpy(), np.asarray(jhit.valid))
    same = _agree((hit.t.numpy(), hit.prim.numpy(), hit.uv.numpy()[:, 0],
                   hit.uv.numpy()[:, 1]),
                  (jhit.t, jhit.prim, jhit.uv[:, 0], jhit.uv[:, 1]))
    assert same.mean() >= 0.999
    anyh = I.any_hit(ts, T(o), T(d), 0.0, T(t_max), exclude_prim=T(excl))
    np.testing.assert_array_equal(anyh.numpy(), np.asarray(jany))


def test_camera_hit_clamps_virtual_prim_ids(blobs):
    """With a camera-invisible lamp, camera_hit reads the visibility of the
    first hit's face: a virtual id past the physical faces reads the last
    physical face, as the JAX package's clamping gather does."""
    _, ts, _ = blobs
    nf = ts.geom.face_vis.shape[0]
    scene = dataclasses.replace(ts, has_cam_invisible=True)
    o = torch.tensor([[0.0, -6.5, 4.0]]).expand(64, 3).contiguous()
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, 6.5, -3.7]) + torch.randn(64, 3,
        generator=torch.Generator().manual_seed(1)) * 0.3, dim=-1)
    hit = I.camera_hit(scene, o, d, 1e-4, 1e30)
    want = I.closest_hit(ts, o, d, 1e-4, 1e30)
    assert (want.prim[want.valid] >= nf).any()
    assert torch.equal(hit.prim, want.prim) and torch.equal(hit.t, want.t)


def test_point_light_sampling_matches():
    js = _instances_pair("baked")[0]
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    rng = np.random.default_rng(2)
    n = 1024
    p = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    ns = np.tile(np.float32([0, 0, 1]), (n, 1))
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    li = np.zeros(n, np.int32)
    jls = jax.jit(JL.sample_light)(js, li, p, ns, u1, u2)
    ls = L.sample_light(ts, T(li), T(p), T(ns), T(u1), T(u2))
    for name in ("valid", "is_dirac"):
        np.testing.assert_array_equal(getattr(ls, name).numpy(),
                                      np.asarray(getattr(jls, name)))
    assert ls.is_dirac.numpy().all()
    for name in ("wi", "dist", "pdf", "radiance"):
        np.testing.assert_allclose(getattr(ls, name).numpy(),
                                   np.asarray(getattr(jls, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _assert_images_close(img, want):
    assert img.shape == want.shape and np.isfinite(img).all()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-4).all(-1)
    assert close.mean() >= 0.98, close.mean()
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def test_forest_render_matches_jax(monkeypatch):
    """The slice at 12x12, 1 spp, 2 bounces: the terrain (grid 24) under 40
    true instances and 2 moving baked ones, so every query runs the
    instanced and motion arms together."""
    cut = dict(n_inst=40, n_moving=2, grid=24)
    jb = _jax_scene(monkeypatch, PS.forest_builder, **cut)
    tb = PS.forest_builder(**cut)
    for b in (jb, tb):
        b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    js = jb.compile("cam")
    ts = tb.compile("cam", device="cpu")
    assert ts.geom.has_motion and ts.geom.inst_mat is not None
    assert ts.blocks.tab_t1 is not None and ts.blocks.blk_base is not None
    assert ts.geom.num_faces == js.geom.num_faces == 1058 + 96 * 43
    cfg = {"type": "pathtracing", "bounces": 2}
    want = np.asarray(JF.resolve(jrender(js, jmake_integrator(cfg), RES, RES,
                                         spp=1)))
    before = dict(launch_counts)
    img = F.resolve(render(ts, make_integrator(cfg), spp=1,
                           device="cpu")).numpy()
    assert dict(launch_counts) == before  # CPU tensors never launch
    _assert_images_close(img, want)
    assert 0.1 < img[..., 3].mean() < 0.9


def _instances_pair(mode):
    """The golden's instanced cubes at 16x16 compiled by the JAX package (the
    builder of `test_refparity.py`) and by the port, in instancing mode
    "baked" or "true"."""
    jb, tb = test_refparity._instances_builder(), PS.instances_builder()
    for b in (jb, tb):
        if mode == "true":
            b.set_render_params({"instancing": "true",
                                 "scene_accelerator": "blocks"})
        b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 16
    return jb.compile("cam"), tb.compile("cam", device="cpu")


@pytest.mark.parametrize("mode", ["baked", "true"])
def test_instances_render_matches_jax(mode):
    """The golden's scene (point light, direct lighting) in both instancing
    modes; the port's tables equal the JAX compile's."""
    js, ts = _instances_pair(mode)
    want_tables = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    assert ts.accel_kind == js.accel_kind == ("blocks" if mode == "true"
                                              else "brute")
    for f in ("vertices", "faces", "face_vis", "tri_table", "inst_mat"):
        a, b = getattr(ts.geom, f), getattr(want_tables.geom, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    cfg = {"type": "directlighting"}
    want = np.asarray(JF.resolve(jrender(js, jmake_integrator(cfg), 16, 16,
                                         spp=2)))
    img = F.resolve(render(ts, make_integrator(cfg), spp=2,
                           device="cpu")).numpy()
    _assert_images_close(img, want)


def test_load_hdr_matches_jax():
    path = "tests/golden/instances_ref_160.hdr"
    got = TIO.load_hdr(path)
    assert got.shape == (160, 160, 3)
    np.testing.assert_array_equal(got, np.asarray(JIO.load_hdr(path)))
