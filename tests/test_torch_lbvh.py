"""The port's accelerators against the JAX package where the accelerator
slice completed them: the LBVH (`scene_accelerator: "bvh"`: the Karras
build, the refit, the per-ray stack walk with its 48 slots, the static and
motion arms, a render), the brute-force path above 16,384 faces, instances
of spheres and curves, and the block query against the JAX package's
`_query_chunk` route.

The JAX walk is a jitted vmap of a while loop (`_traverse_batch`), compiled
once per module for each variant used here: closest, any and motion (and
once more for each of the two small fault scenes).

Tolerances, and why:
  * the LBVH's node tables and `prim_order` and the compiled sphere
    tables: equal (the same integer and min / max steps, no rounding
    between them);
  * walks: prim ids equal on at least 99.9% of rays, t within rtol 1e-5
    (atol 1e-6) on every ray and u, v within 1e-5 where the ids agree; any
    hits equal on every ray. XLA's CPU code contracts the jitted walk's
    products and sums into fused multiply-adds (the keyframe blend, the
    sphere's b*b - c), which moves t by up to 3.7e-6 relative on rays that
    graze a sphere (2.1e-6 on the moving cloud; most rays agree to the
    bit); where two faces tie at one t (the lamp quad in the ceiling's
    plane) such an ulp picks the other face. The port's plain version
    rounds every operation on its own, as its CUDA kernel does;
  * the brute-force path above 16,384 faces against the JAX scan: the same
    rule with t within rtol 1e-5 (the scan's FMAs on a 92 x 92 grid's
    shared edges);
  * the render: the slice bound of `tests/test_torch_render.py`, at least
    98% of pixels within rtol = atol = 1e-4 and the mean within 1e-3
    relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import film as JF
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.accel import lbvh as LB_J
from libyafaray_tpu.accel import tiles as JT
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu.scene_types import BVH as JBVH
from libyafaray_tpu_torch import SceneBuilder, make_integrator, render
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import scenes as PS
from libyafaray_tpu_torch.accel import lbvh as LB
from libyafaray_tpu_torch.accel import mt_intersect as MT
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.csrc_build import launch_counts
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.scene_types import BVH
from scenes import cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_motion import _cloud
from test_torch_motion import _rays as _cloud_rays
from test_torch_spheres import _curves

RES = 16
BVH_FIELDS = ("node_min", "node_max", "node_left", "node_right",
              "node_is_leaf", "prim_order")
# each test scene's tree depth and its refit passes (2 ceil(log2 P) + 4):
# every tree here is refit completely
DEPTHS = {"cornell": (8, 16), "spheres": (8, 16), "cloud": (14, 20)}


def T(a):
    return torch.from_numpy(np.array(a))


def _bvh(b):
    b.set_render_params({"scene_accelerator": "bvh"})
    return b


def _spheres(builder):
    """The Cornell box with three spheres: one seen by every ray, one that
    casts no shadow, one seen by shadow rays only."""
    b = builder()
    for name, c, r, vis in (("ball", (0.3, 0.6, 0.25), 0.15, "normal"),
                            ("bubble", (0.7, 0.4, 0.6), 0.1, "no_shadows"),
                            ("ghost", (0.5, 0.5, 0.85), 0.08,
                             "shadow_only")):
        b.create_object(name, {"type": "sphere", "center": c, "radius": r,
                               "visibility": vis})
    return b


SCENES = {"cornell": lambda b: b(), "spheres": _spheres,
          "cloud": lambda b: _cloud(b, 2)}


@pytest.fixture(scope="module")
def pairs():
    """Each scene compiled with the LBVH by both packages (16 x 16)."""
    out = {}
    for name, make in SCENES.items():
        built = []
        for builder in (cornell_builder, PS.cornell_builder):
            b = _bvh(make(builder))
            b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
            built.append(b)
        out[name] = (built[0].compile("cam"),
                     built[1].compile("cam", device="cpu"))
    return out


@pytest.mark.parametrize("scene", list(SCENES))
def test_build_matches_jax(pairs, scene):
    js, ts = pairs[scene]
    assert js.accel_kind == ts.accel_kind == "bvh"
    p = ts.geom.num_faces + ts.geom.num_spheres
    assert ts.bvh.num_nodes == js.bvh.num_nodes == 2 * p - 1
    for f in BVH_FIELDS:
        got, want = getattr(ts.bvh, f).numpy(), np.asarray(getattr(js.bvh, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    if scene == "spheres":
        assert (ts.bvh.prim_order >= ts.geom.num_faces).sum() == 3


@pytest.mark.parametrize("scene", list(SCENES))
def test_refit_covers_the_tree(pairs, scene):
    """The tree is no deeper than the refit's passes, so every internal box
    is its children's union and the root's holds every primitive."""
    bvh = pairs[scene][1].bvh
    p = bvh.prim_order.shape[0]
    assert (LB.tree_depth(bvh), LB.refit_passes(p)) == DEPTHS[scene]
    n_int = p - 1
    lc, rc = bvh.node_left[:n_int].long(), bvh.node_right[:n_int].long()
    assert torch.equal(bvh.node_min[:n_int],
                       torch.minimum(bvh.node_min[lc], bvh.node_min[rc]))
    assert torch.equal(bvh.node_max[:n_int],
                       torch.maximum(bvh.node_max[lc], bvh.node_max[rc]))
    assert torch.equal(bvh.node_min[0], bvh.node_min[n_int:].amin(0))


def _decode(rec, bvh):
    """The packed records read back into node ids: for each internal node
    (in id order) its (left, right) child ids, and each record's boxes."""
    p = bvh.prim_order.shape[0]
    inner = (~bvh.node_is_leaf).nonzero()[:, 0]
    leaf_node = torch.full((p,), -1, dtype=torch.int64)
    leaves = bvh.node_is_leaf.nonzero()[:, 0]
    leaf_node[torch.clamp(bvh.node_left[leaves].long(), 0, p - 1)] = leaves
    as_id = lambda c: torch.where(c >= 0, inner[torch.clamp_min(c, 0)],
                                  leaf_node[(-1 - c).clamp_min(0)])
    rows = rec.nodes[:inner.shape[0]]
    return as_id(rows[:, 3].long()), as_id(rows[:, 7].long()), rows


@pytest.mark.parametrize("scene", list(SCENES))
def test_packed_records_reproduce_the_tables(pairs, scene):
    """`pack_lbvh`'s child-pair records hold each internal node's children
    and their boxes as the node tables have them (the same float bits),
    the root's box and code apart, and each leaf slot's primitive in
    `prim_order`; the JAX scene's tree carried across packs the same."""
    js, ts = pairs[scene]
    bvh = ts.bvh
    rec = LB.pack_lbvh(bvh, ts.geom)
    n_int = bvh.prim_order.shape[0] - 1
    assert rec.nodes.shape == (n_int, 16) and rec.nodes.dtype == torch.int32
    left, right, rows = _decode(rec, bvh)
    assert torch.equal(left, bvh.node_left[:n_int].long())
    assert torch.equal(right, bvh.node_right[:n_int].long())
    bits = lambda x: x.view(torch.int32)
    for child, lo, hi in ((left, 0, 4), (right, 8, 12)):
        assert torch.equal(rows[:, lo:lo + 3], bits(bvh.node_min[child]))
        assert torch.equal(rows[:, hi:hi + 3], bits(bvh.node_max[child]))
    assert torch.equal(rec.root[:3], bits(bvh.node_min[0]))
    assert torch.equal(rec.root[4:7], bits(bvh.node_max[0]))
    assert rec.root[3] == 0 and rec.root[7] == 1     # internal; boxes finite
    assert torch.equal(rec.leaves[:, 3], bvh.prim_order)
    conv = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    again = LB.pack_lbvh(conv.bvh, conv.geom)
    for f in ("nodes", "root", "leaves", "keyframes"):
        a, b = getattr(rec, f), getattr(again, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_leaf_records_follow_prim_order(pairs):
    """The leaf-ordered records equal `faces` -> `vertices` gathered in
    `prim_order`: v0, and e1 = v1 - v0, e2 = v2 - v0 bit for bit the
    subtraction the plain walk makes (`moller_trumbore`); the face's or the
    sphere's visibility; a sphere's centre and radius; a moving
    geometry's keyframes unsubtracted."""
    bits = lambda x: x.view(torch.int32)
    for name in ("spheres", "cloud"):
        g, bvh = pairs[name][1].geom, pairs[name][1].bvh
        rec = LB.pack_lbvh(bvh, g)
        prim = bvh.prim_order.long()
        tri = prim < g.num_faces
        fidx = g.faces[prim[tri]].long()
        v0, v1, v2 = (g.vertices[fidx[:, k]] for k in range(3))
        rows = rec.leaves[tri]
        assert torch.equal(rows[:, 0:3], bits(v0))
        assert torch.equal(rows[:, 4:7], bits(v1 - v0))
        assert torch.equal(rows[:, 8:11], bits(v2 - v0))
        assert torch.equal(rows[:, 7], g.face_vis[prim[tri]])
        sph = prim[~tri] - g.num_faces
        assert sph.shape[0] == g.num_spheres
        if g.num_spheres:
            rows = rec.leaves[~tri]
            assert torch.equal(rows[:, 0:3], bits(g.sph_center[sph]))
            assert torch.equal(rows[:, 4], bits(g.sph_radius[sph]))
            assert torch.equal(rows[:, 7], g.sph_vis[sph])
            assert rec.keyframes is None
            continue
        keys = (g.vertices, g.vertices_t1, g.vertices_t2)
        assert rec.keyframes.shape == (prim.shape[0], 36)
        for k, v in enumerate(keys):
            frame = rec.keyframes[tri, 12 * k:12 * k + 12]
            for c in range(3):
                assert torch.equal(frame[:, 4 * c:4 * c + 3],
                                   bits(v[fidx[:, c]]))
            assert torch.equal(frame[:, 3], prim[tri].int())
            assert torch.equal(frame[:, 7], g.face_vis[prim[tri]])


def test_dead_and_nan_rays_miss_in_both_walks(pairs):
    """The rule the kernel's early exit relies on: a ray with
    !(t_max > t_min), or a NaN in o, d, t_min or t_max, gets
    (t_max, -1, 0, 0) from the plain walk and from the JAX walk
    (`_traverse_batch`), closest and any hit alike."""
    js, ts = pairs["spheres"]
    n = 64
    rng = np.random.default_rng(4)
    o = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e30, np.float32)
    kind = np.arange(n) % 8
    t_max[kind == 0] = -1.0
    t_max[kind == 1] = 1e-4                      # t_max == t_min
    t_min[kind == 2], t_max[kind == 2] = 5.0, 2.0
    t_min[kind == 3] = np.nan
    t_max[kind == 4] = np.nan
    o[kind == 5, 1] = np.nan
    d[kind == 6, 0] = np.nan
    excl = np.full(n, -1, np.int32)
    dead = kind < 7
    for shadow, any_hit in ((False, False), (True, True)):
        bt, bp, bu, bv = LB.lbvh_traverse_ref(
            ts.bvh, ts.geom, T(o), T(d), T(t_min), T(t_max), T(excl),
            shadow=shadow, any_hit=any_hit)
        jt, jp, juv = LB_J._traverse_batch(
            js.bvh, js.geom, o, d, (t_min, t_max, excl), 2 if shadow else 1,
            any_hit)
        for t, p, u, v in ((bt.numpy(), bp.numpy(), bu.numpy(), bv.numpy()),
                           (np.asarray(jt), np.asarray(jp),
                            np.asarray(juv)[:, 0], np.asarray(juv)[:, 1])):
            np.testing.assert_array_equal(t[dead], t_max[dead])
            assert (p[dead] == -1).all()
            assert (u[dead] == 0).all() and (v[dead] == 0).all()
        assert (bp.numpy()[~dead] >= 0).any()        # the live rays hit


def test_packed_once_per_tree_and_geometry(pairs):
    """The wrapper's records are made once per tree and geometry: a second
    query reuses them, while another geometry, or a table written in
    place, packs anew."""
    ts = pairs["cornell"][1]
    bvh = dataclasses.replace(ts.bvh)            # a tree of its own
    first = LB.packed(bvh, ts.geom)
    assert LB.packed(bvh, ts.geom) is first
    moved = dataclasses.replace(ts.geom, vertices=ts.geom.vertices.clone())
    other = LB.packed(bvh, moved)
    assert other is not first
    assert torch.equal(other.leaves, first.leaves)
    assert LB.packed(bvh, moved) is other
    moved.vertices.add_(1.0)                      # written in place
    again = LB.packed(bvh, moved)
    assert again is not other
    assert not torch.equal(again.leaves, other.leaves)


def _chain(b, accel):
    """31 small faces whose morton codes are 0 and the 30 powers of two
    (one bit each, in cells 2^l along one axis), under one face whose box
    is the scene's: a chain 30 levels deep over 32 primitives, refit in 14
    passes. The deepest face (code 0) fills its cell in y and z, beyond
    the small faces' boxes."""
    b.set_render_params({"scene_accelerator": accel})
    b.create_material("m", {"type": "shinydiffusemat"})
    b.create_object("chain")
    b.set_current_material("m")

    def tri(*pts):
        b.add_triangle(*[b.add_vertex(*p) for p in pts])

    cell = 2.0 / 1024      # the scene spans [-1, 1] on every axis
    tri((-1, -1, -1), (1, 1, 1), (1, -1, -1))
    s = 0.01 * cell
    for bit in range(30):
        at = [0, 0, 0]
        at[2 - bit % 3] = 2 ** (bit // 3)
        c = [-1 + (k + 0.5) * cell for k in at]
        tri([x - s for x in c], [x + s for x in c],
            (c[0] + s, c[1] - s, c[2] - s))
    xm = -1 + 0.5 * cell
    tri((xm, -1, -1), (xm, -1 + cell, -1), (xm, -1, -1 + cell))
    b.create_camera("cam", {"type": "perspective", "from": (0, -5, 0),
                            "to": (0, 0, 0), "resx": 8, "resy": 8})
    return b


def test_a_tree_deeper_than_its_refit_misses_in_both_packages():
    """A fault of both packages (ROADMAP section 3): the refit runs
    2 ceil(log2 P) + 4 passes, and a Karras tree over clustered codes can
    be deeper. Boxes above that many levels then miss deep primitives, and
    a ray that brute force sees hit the deepest face misses it on the
    LBVH, in the JAX package and in the port alike."""
    js = _chain(JSceneBuilder(), "bvh").compile("cam")
    ts = _chain(SceneBuilder(), "bvh").compile("cam", device="cpu")
    brute = _chain(SceneBuilder(), "brute").compile("cam", device="cpu")
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(ts.bvh, f).numpy(),
                                      np.asarray(getattr(js.bvh, f)))
    assert (LB.tree_depth(ts.bvh), LB.refit_passes(32)) == (30, 14)
    o = np.float32([[-2.0, -1 + 0.2 / 1024, -1 + 0.2 / 1024]])
    d = np.float32([[1.0, 0.0, 0.0]])
    want = I.closest_hit(brute, T(o), T(d), 0.0, 1e30)
    assert want.valid.item() and want.prim.item() == 31
    got = I.closest_hit(ts, T(o), T(d), 0.0, 1e30)
    jgot = JI.closest_hit(js, o, d, 0.0, 1e30)
    assert not got.valid.item() and not bool(jgot.valid[0])


def test_stack_overflow_drops_pushes_and_clamps_pops_as_jax():
    """The walk's 48 slots on a tree 60 levels deep. In the JAX package a
    push past the last slot is an out-of-bounds scatter, dropped, while the
    pointer grows, and a pop past it a clamped gather of the last slot; the
    port does the same. So the subtree under internal node 48 is never
    walked: rays at faces 0-47 hit them, rays at faces 48-60 miss, in both
    packages, where brute force hits every face."""
    js = PS.ladder_builder(JSceneBuilder()).compile("cam")
    ts = PS.ladder_builder().compile("cam", device="cpu")
    v = ts.geom.vertices[ts.geom.faces.long()].numpy()
    tables = PS.ladder_bvh(v.min(1), v.max(1))
    js_v = js.replace(bvh=JBVH(**{k: jnp.asarray(x)
                                  for k, x in tables.items()}, num_nodes=121),
                      accel_kind="bvh")
    ts_v = dataclasses.replace(ts, accel_kind="bvh", bvh=BVH(
        **{k: T(x) for k, x in tables.items()}, num_nodes=121))
    k = np.arange(61)
    o = np.stack([np.full(61, -1.0), (k % 8) / 10, (k // 8) / 10],
                 -1).astype(np.float32)
    d = np.tile(np.float32([[1.0, 0.0, 0.0]]), (61, 1))
    brute = I.closest_hit(ts, T(o), T(d), 0.0, 1e30)
    np.testing.assert_array_equal(brute.prim.numpy(), k)
    got = I.closest_hit(ts_v, T(o), T(d), 0.0, 1e30)
    want = JI.closest_hit(js_v, o, d, 0.0, 1e30)
    np.testing.assert_array_equal(got.valid.numpy(), k < 48)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)


def _box_rays(rng, n, face_ids):
    """Rays from inside the box in every direction; 1/7 dead (an empty
    range), 1/5 excluding a prim."""
    o = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::7] = -1.0
    excl = np.full(n, -1, np.int32)
    excl[::5] = rng.integers(0, face_ids, excl[::5].shape)
    return o, d, t_max, excl


def _assert_walks_agree(hit, jhit):
    np.testing.assert_array_equal(hit.valid.numpy(), np.asarray(jhit.valid))
    same = hit.prim.numpy() == np.asarray(jhit.prim)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(jhit.t), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(hit.uv.numpy()[same], np.asarray(jhit.uv)[same],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("query", ["closest", "shadow", "any_hit"])
def test_walk_matches_jax(rng, pairs, query):
    """The port's walk (its plain version, through `ops.intersect`) against
    the JAX walk on the Cornell box with spheres: closest hits of camera
    rays, the shadow rays' closest hits (`shadow_hit_surface`, the
    transparent-shadow walk) and any hits."""
    js, ts = pairs["spheres"]
    o, d, t_max, excl = _box_rays(rng, 2048, ts.geom.num_faces + 3)
    args = (T(o), T(d), 1e-4, T(t_max))
    if query == "any_hit":
        want = jax.jit(lambda s, *a: JI.any_hit(s, *a[:4], exclude_prim=a[4])
                       )(js, o, d, 1e-4, t_max, excl)
        got = I.any_hit(ts, *args, exclude_prim=T(excl))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0.3 < got.numpy().mean() < 0.95
        return
    jq = JI.closest_hit if query == "closest" else JI.shadow_hit_surface
    q = I.closest_hit if query == "closest" else I.shadow_hit_surface
    want = jax.jit(lambda s, *a: jq(s, *a[:4], exclude_prim=a[4]))(
        js, o, d, 1e-4, t_max, excl)
    got = q(ts, *args, exclude_prim=T(excl))
    _assert_walks_agree(got, want)
    # the spheres are leaves of the tree: some rays end on them
    on_sphere = got.valid & (got.prim >= ts.geom.num_faces)
    assert on_sphere.sum() > 20


def test_motion_walk_matches_jax(pairs):
    """The b-spline arm: the moving cloud's closest hits at per-ray shutter
    times, the port's walk against the JAX walk."""
    js, ts = pairs["cloud"]
    assert ts.geom.vertices_t2 is not None
    o, d, t_max, excl, tm = _cloud_rays(np.random.default_rng(9), 1024)
    want = jax.jit(lambda s, o, d, t, e, tm: JI.closest_hit(
        s, o, d, 1e-4, t, exclude_prim=e, time=tm))(js, o, d, t_max, excl, tm)
    got = I.closest_hit(ts, T(o), T(d), 1e-4, T(t_max), exclude_prim=T(excl),
                        time=T(tm))
    _assert_walks_agree(got, want)
    assert 0.2 < got.valid.numpy().mean() < 0.95
    # the time matters: at other times other rays hit
    moved = I.closest_hit(ts, T(o), T(d), 1e-4, T(t_max),
                          exclude_prim=T(excl), time=T(1.0 - tm))
    assert (moved.prim != got.prim).any()


def test_wrapper_routes_cpu_tensors_to_the_plain_version(rng, pairs,
                                                         monkeypatch):
    """On CPU tensors `lbvh_traverse` runs `lbvh_traverse_ref` and launches
    nothing; it refuses a device without a kernel and a tree built over
    other geometry."""
    _, ts = pairs["spheres"]
    o, d, t_max, excl = _box_rays(rng, 256, 10)
    args = (T(o), T(d), torch.full((256,), 1e-4), T(t_max), T(excl))
    calls = []
    ref = LB.lbvh_traverse_ref
    monkeypatch.setattr(LB, "lbvh_traverse_ref",
                        lambda *a, **k: calls.append(1) or ref(*a, **k))
    before = launch_counts["kernel.lbvh_traverse.launches"]
    got = LB.lbvh_traverse(ts.bvh, ts.geom, *args)
    assert calls == [1]
    assert launch_counts["kernel.lbvh_traverse.launches"] == before
    for a, b in zip(got, ref(ts.bvh, ts.geom, *args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no kernel"):
        LB.lbvh_traverse(ts.bvh.to("meta"), ts.geom.to("meta"),
                         *(x.to("meta") for x in args))
    other = pairs["cornell"][1]
    with pytest.raises(ValueError, match="not built over this geometry"):
        LB.lbvh_traverse(other.bvh, ts.geom, *args)


def _grid(b):
    """A 92 x 92 vertex grid (16,562 faces) on brute force, with the
    Cornell box's camera and lights."""
    b.set_render_params({"scene_accelerator": "brute"})
    b.create_object("grid")
    b.set_current_material("white")
    n = 92
    xs = np.linspace(0, 1, n, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs)
    zz = 0.05 * np.sin(7 * xx) * np.cos(5 * yy) + 0.3
    verts = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n * n).reshape(n, n)
    a, b2, c, d = (i[:-1, :-1].ravel(), i[1:, :-1].ravel(),
                   i[1:, 1:].ravel(), i[:-1, 1:].ravel())
    b.add_mesh_arrays(verts, np.concatenate([np.stack([a, b2, c], -1),
                                             np.stack([a, c, d], -1)]))
    return b


def test_brute_force_above_16384_faces(rng):
    """Above the JAX kernel's 16,384 rows the port's compile packs the whole
    table (kernel a takes any size) and its queries go to `mt_closest`; the
    JAX package scans in chunks. Closest and any hits agree. On blocks the
    same mesh carries no table, as in the JAX compile."""
    js = _grid(cornell_builder()).compile("cam")
    ts = _grid(PS.cornell_builder()).compile("cam", device="cpu")
    f = ts.geom.num_faces
    assert f == js.geom.num_faces > 16384 and ts.accel_kind == "brute"
    assert ts.geom.tri_table.shape == (MT.table_rows(f), 16)
    assert js.geom.tri_table is None
    blocks = _grid(PS.cornell_builder())
    blocks.set_render_params({"scene_accelerator": "blocks"})
    assert blocks.compile("cam", device="cpu").geom.tri_table is None
    # the JAX scene carried across gets the port's table
    conv = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    assert torch.equal(conv.geom.tri_table, ts.geom.tri_table)
    o, d, t_max, excl = _box_rays(rng, 1024, f)
    d[: 512, 2] = -np.abs(d[: 512, 2]) - 0.5        # half toward the grid
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want, wany = jax.jit(lambda s, *a: (
        JI.closest_hit(s, *a[:4], exclude_prim=a[4]),
        JI.any_hit(s, *a[:4], exclude_prim=a[4])))(js, o, d, 1e-4, t_max,
                                                   excl)
    got = I.closest_hit(ts, T(o), T(d), 1e-4, T(t_max), exclude_prim=T(excl))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    same = got.prim.numpy() == np.asarray(want.prim)
    assert same.mean() >= 0.999
    assert (got.prim.numpy()[same] >= 36).mean() > 0.2   # the grid is hit
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    anyh = I.any_hit(ts, T(o), T(d), 1e-4, T(t_max), exclude_prim=T(excl))
    np.testing.assert_array_equal(anyh.numpy(), np.asarray(wany))


def _instanced(b):
    """The curves scene with a sphere and instances of both: the sphere
    scaled by 1.5 (and once moving), the helix moved and scaled."""
    _curves(b)
    b.create_object("ball", {"type": "sphere", "center": (0.5, 0.5, 0.3),
                             "radius": 0.1})
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= 1.5
    m[:3, 3] = (0.2, 0.1, 0.05)
    m2 = m.copy()
    m2[:3, 3] += 0.3
    b.add_instance("ball", m)
    b.add_instance("helix", m)
    b.add_instance("ball", [m2, m])           # moving: the first matrix holds
    return b, m


@pytest.fixture(scope="module")
def instanced():
    """The instanced scene compiled by both packages, and its matrix."""
    jb, m = _instanced(JSceneBuilder())
    return (jb.compile("cam"),
            _instanced(SceneBuilder())[0].compile("cam", device="cpu"), m)


@pytest.mark.parametrize("kind", ["spheres", "curves"])
def test_instanced_tables_match_jax(instanced, kind):
    """Instances of spheres and curves are baked as in the JAX compile: a
    sphere's centre through the first matrix and its radius times
    cbrt|det| (a moving instance keeps that matrix, and the scene is then
    a motion scene); a curve's ribbon through the matrix. The JAX compile
    extrudes the staged curve in place, so its instance is the ribbon
    extruded again (ROADMAP section 3); the port's instance is the staged
    strand's ribbon, the JAX base ribbon moved by the matrix."""
    js, ts, m = instanced
    g, jg = ts.geom, js.geom
    if kind == "spheres":
        assert g.num_spheres == jg.num_spheres == 3
        for f in ("sph_center", "sph_radius", "sph_vis", "sph_mat",
                  "sph_obj"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(jg, f)), f)
        np.testing.assert_allclose(g.sph_center[2].numpy(),
                                   [0.95 + 0.3, 0.85 + 0.3, 0.5 + 0.3],
                                   rtol=1e-6)
        assert g.has_motion and jg.has_motion
        return
    base = 2 + 2 * 23 + 2 * 4          # floor, helix, bent
    n = 24                               # the helix's control points
    assert g.num_faces == base + 2 * (n - 1)
    assert jg.num_faces == base + 2 * (2 * n - 1)
    jv, jf = np.asarray(jg.vertices), np.asarray(jg.faces)
    np.testing.assert_array_equal(g.faces[:base].numpy(), jf[:base])
    helix = jv[jf[2:2 + 2 * (n - 1)]]                    # the base ribbon
    moved = (helix.reshape(-1, 3) @ m[:3, :3].T + m[:3, 3]).reshape(
        helix.shape)
    got = g.vertices[g.faces[base:].long()].numpy()
    np.testing.assert_array_equal(got, moved)
    assert (g.face_vis[base:] == 3).all()


@pytest.mark.parametrize("scene", ["static", "motion"])
def test_block_query_matches_query_chunk(rng, monkeypatch, scene):
    """The port's block query (the ray sort, the prepass and the tile walk's
    plain version) against the JAX package's `_query_chunk` route, the
    per-ray block loop it takes when its tile kernel cannot run: the
    Cornell box with spheres, and the moving cloud."""
    monkeypatch.setattr(JT, "use_tiles", lambda: False)
    make = _spheres if scene == "static" else (lambda b: _cloud(b, 1))
    built = [make(b) for b in (cornell_builder, PS.cornell_builder)]
    for b in built:
        b.set_render_params({"scene_accelerator": "blocks"})
    js = built[0].compile("cam")
    ts = built[1].compile("cam", device="cpu")
    assert js.accel_kind == ts.accel_kind == "blocks"
    o, d, t_max, excl = _box_rays(rng, 1024, ts.geom.num_faces)
    tm = (rng.random(1024).astype(np.float32) if scene == "motion"
          else None)
    jq = jax.jit(lambda s, o, d, t, e, tm: (
        JI.closest_hit(s, o, d, 1e-4, t, exclude_prim=e, time=tm),
        JI.any_hit(s, o, d, 1e-4, t, exclude_prim=e, time=tm)))
    want, wany = jq(js, o, d, t_max, excl, tm)
    tt = None if tm is None else T(tm)
    got = I.closest_hit(ts, T(o), T(d), 1e-4, T(t_max), exclude_prim=T(excl),
                        time=tt)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    same = got.prim.numpy() == np.asarray(want.prim)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5,
                               atol=1e-6)
    anyh = I.any_hit(ts, T(o), T(d), 1e-4, T(t_max), exclude_prim=T(excl),
                     time=tt)
    np.testing.assert_array_equal(anyh.numpy(), np.asarray(wany))


def test_bvh_render_matches_jax(pairs):
    """The slice: the Cornell box on the LBVH at 16 x 16, 1 spp, 2 bounces
    through both packages' render (the JAX walk jitted inside its render),
    under the slice bound; on CPU tensors no kernel is launched."""
    js, ts = pairs["cornell"]
    cfg = {"type": "pathtracing", "bounces": 2}
    want = np.asarray(JF.resolve(jrender(js, jmake_integrator(cfg), RES, RES,
                                         spp=1)))
    before = launch_counts["kernel.lbvh_traverse.launches"]
    img = F.resolve(render(ts, make_integrator(cfg), spp=1,
                           device="cpu")).numpy()
    assert launch_counts["kernel.lbvh_traverse.launches"] == before
    assert img.shape == want.shape == (RES, RES, 4)
    assert np.isfinite(img).all()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-4).reshape(-1, 4)
    assert close.all(-1).mean() >= 0.98
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    # the JAX scene carried across renders the same on the port
    conv = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    assert conv.accel_kind == "bvh"
    again = F.resolve(render(conv, make_integrator(cfg), spp=1,
                             device="cpu")).numpy()
    np.testing.assert_array_equal(again, img)
