"""Motion blur in the port against the JAX package: the compiled keyframe
tables (vertices, the brute-force path's packed tables and the block
accelerator's keyframe slabs with their AABB unions), the motion arms of
the tile walk against the Pallas kernel in interpret mode, scene queries at
per-ray shutter times on both accelerators, moving instances, and the
shutter time reaching every query of a render.

Tolerances: tables exact. Hits: at least 99.9% of rays with equal prim ids,
t within rtol 1e-5 (atol 1e-6 near 0) and u, v within 1e-5, as in
`test_torch_blocks.py`: XLA's CPU code may contract the keyframe blend and
the intersection's products and sums into FMAs, so a ray grazing an edge
can land on the other side, and a blended vertex that moves by an ulp moves
the barycentrics by up to 1.5e-6; any hits agree on hit or miss.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from libyafaray_tpu.accel import blocks as JB
from libyafaray_tpu.accel import tiles as JT
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu_torch import make_integrator, render, sampler
from libyafaray_tpu_torch import scenes as PS
from libyafaray_tpu_torch.accel import blocks as BL
from libyafaray_tpu_torch.accel import tiles as TL
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.ops import intersect as I
from scenes import cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401


def T(a):
    return torch.from_numpy(np.array(a))


def _cloud(builder, keyframes):
    """The Cornell box with a cloud of 120 random triangles that move: one
    extra keyframe (linear) or two (the quadratic b-spline), as in
    `tests/test_subsystems.py` `test_motion_blur_blocks_matches_brute`."""
    rng = np.random.default_rng(3)
    b = builder()
    b.create_object("cloud")
    b.set_current_material("white")
    f = 120
    vtx = rng.random((f * 3, 3)).astype(np.float32) * 0.8 + 0.1
    for p in vtx:
        b.add_vertex(*p)
    for i in range(f):
        b.add_triangle(3 * i, 3 * i + 1, 3 * i + 2)
    for p in vtx:
        b.add_vertex_time_step(p[0], p[1] + 0.2, p[2])
    if keyframes == 2:
        b.add_mesh_time_step(vtx + np.float32([-0.15, 0.0, 0.1]))
    return b


@pytest.fixture(scope="module", params=[1, 2], ids=["linear", "quadratic"])
def clouds(request):
    """(JAX scene, its blocks, the port's compile, the port's blocks) of the
    moving cloud."""
    js = _cloud(cornell_builder, request.param).compile("cam")
    ts = _cloud(PS.cornell_builder, request.param).compile("cam",
                                                          device="cpu")
    return (js, jax.jit(JB.build_blocks)(js.geom), ts,
            BL.build_blocks(ts.geom))


def _rays(rng, n):
    """Rays through the cloud with random shutter times; 1/7 dead, 1/5
    excluding a prim."""
    o = rng.random((n, 3)).astype(np.float32) * [1, 0, 1] + [0, -0.5, 0]
    d = np.tile(np.float32([[0.0, 1.0, 0.0]]), (n, 1))
    d[::2] += rng.standard_normal((n // 2, 3)).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::7] = -1.0
    excl = np.full(n, -1, np.int32)
    excl[::5] = rng.integers(0, 156, excl[::5].shape)
    return (o.astype(np.float32), d, t_max, excl,
            rng.random(n).astype(np.float32))


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


def test_keyframe_tables_match_jax(clouds):
    js, jacc, ts, acc = clouds
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    assert ts.geom.has_motion and want.geom.has_motion
    assert ts.accel_kind == "brute"
    quadratic = js.geom.vertices_t2 is not None
    for f in ("vertices", "vertices_t1", "vertices_t2", "tri_table",
              "tri_table_t1", "tri_table_t2"):
        a, b = getattr(ts.geom, f), getattr(want.geom, f)
        if f.endswith("t2") and not quadratic:
            assert a is None and b is None, f
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in ("tab", "tab_t1", "tab_t2", "bmin", "bmax"):
        a, b = getattr(acc, f), getattr(jacc, f)
        if f == "tab_t2" and not quadratic:
            assert a is None and b is None
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    # the AABBs hold every control point: wider than the shutter-open ones
    still = dataclasses.replace(ts.geom, has_motion=False)
    assert (acc.bmax[:, 1] > BL._tables_for(still, acc.block_size)["bmax"][
        :, 1]).any()


@pytest.mark.parametrize("query", ["closest", "any_hit"])
def test_motion_walk_matches_pallas_interpret(clouds, query):
    """The motion arms of `tile_walk_ref` (linear and quadratic) against the
    Pallas kernel, on 500 rays (a ray count that is not a multiple of
    128)."""
    _, jacc, _, _ = clouds
    o, d, t_max, excl, tm = _rays(np.random.default_rng(5), 500)
    t_min = np.full(500, 1e-4, np.float32)
    kw = dict(shadow=query == "any_hit", any_hit=query == "any_hit")
    mot = dict(tab_t1=jacc.tab_t1, tab_t2=jacc.tab_t2, time=tm)
    want = JT.tiles_traverse(jacc.tab, jacc.bmin, jacc.bmax, o, d, t_min,
                             t_max, excl, interpret=True, **mot, **kw)
    got = TL.tiles_traverse_ref(
        *(T(x) for x in (jacc.tab, jacc.bmin, jacc.bmax, o, d, t_min, t_max,
                         excl)),
        **{k: None if v is None else T(v) for k, v in mot.items()}, **kw)
    hits = np.asarray(want[1]) >= 0
    assert 0.2 < hits.mean() < 0.9
    if query == "any_hit":
        np.testing.assert_array_equal(got[1].numpy() >= 0, hits)
    else:
        assert _agree(got, want).mean() >= 0.999


@pytest.mark.parametrize("accel", ["brute", "blocks"])
def test_motion_scene_queries_match(clouds, accel):
    """closest_hit / any_hit with per-ray times against the JAX package's:
    the brute-force path (`mt_closest`'s motion arms against its scan) and
    the block accelerator (the port's tile walk against its per-ray block
    loop)."""
    js, jacc, ts, acc = clouds
    if accel == "blocks":
        js = js.replace(blocks=jacc, accel_kind="blocks")
        ts = dataclasses.replace(ts, blocks=acc, accel_kind="blocks")
    o, d, t_max, excl, tm = _rays(np.random.default_rng(9), 1024)

    @jax.jit
    def jq(s, o, d, t_max, excl, tm):
        return (JI.closest_hit(s, o, d, 1e-4, t_max, exclude_prim=excl,
                               time=tm),
                JI.any_hit(s, o, d, 1e-4, t_max, exclude_prim=excl, time=tm))

    jhit, jany = jq(js, o, d, t_max, excl, tm)
    hit = I.closest_hit(ts, T(o), T(d), 1e-4, T(t_max), exclude_prim=T(excl),
                        time=T(tm))
    np.testing.assert_array_equal(hit.valid.numpy(), np.asarray(jhit.valid))
    assert 0.2 < hit.valid.numpy().mean() < 0.95
    same = _agree((hit.t.numpy(), hit.prim.numpy(), hit.uv.numpy()[:, 0],
                   hit.uv.numpy()[:, 1]),
                  (jhit.t, jhit.prim, jhit.uv[:, 0], jhit.uv[:, 1]))
    assert same.mean() >= 0.999
    anyh = I.any_hit(ts, T(o), T(d), 1e-4, T(t_max), exclude_prim=T(excl),
                     time=T(tm))
    np.testing.assert_array_equal(anyh.numpy(), np.asarray(jany))
    # the time matters: at other times other rays hit
    moved = I.closest_hit(ts, T(o), T(d), 1e-4, T(t_max),
                          exclude_prim=T(excl), time=T(1.0 - tm))
    assert (moved.prim != hit.prim).any()


def test_moving_instance_is_hit_at_its_time():
    """A triangle instanced with two matrices (x = +5 at shutter open, -5 at
    close) is baked into a moving copy: rays at time 0 and 1 hit it where
    it is then (`tests/test_instancing.py`
    `test_instance_motion_time_steps`)."""
    b = PS.SceneBuilder()
    b.create_material("m", {"type": "shinydiffusemat", "color": (0.5,) * 3})
    b.create_object("tri")
    b.set_current_material("m")
    ids = [b.add_vertex(*p) for p in ((-0.5, 0, -0.5), (0.5, 0, -0.5),
                                      (0, 0, 0.5))]
    b.add_triangle(*ids)
    m0, m1 = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    m0[0, 3], m1[0, 3] = 5.0, -5.0
    b.add_instance("tri", [m0, m1])
    b.create_light("p", {"type": "pointlight", "from": (0, -3, 2),
                         "color": (1, 1, 1), "power": 5.0})
    b.create_camera("cam", {"type": "perspective", "from": (0, -4, 0),
                            "to": (0, 0, 0), "up": (0, -4, 1), "resx": 8,
                            "resy": 8, "fov": 60.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    scene = b.compile("cam", device="cpu")
    assert scene.geom.has_motion and scene.geom.inst_mat is None
    o = torch.tensor([[5.0, -4.0, 0.0], [-5.0, -4.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    for time, want in ((0.0, [True, False]), (1.0, [False, True])):
        h = I.closest_hit(scene, o, d, 1e-4, 1e9,
                          time=torch.full((2,), time))
        assert h.valid.tolist() == want


def test_shutter_time_reaches_every_query(monkeypatch, clouds):
    """In a render of a moving scene every camera, bounce and shadow query
    gets the sample's shutter time, sampler.rand1(pixel, sample, 0, 556)."""
    _, _, ts, _ = clouds
    seen = []
    for name in ("closest_hit", "any_hit"):
        real = getattr(I, name)

        def spy(*a, time=None, _real=real, **k):
            seen.append(time)
            return _real(*a, time=time, **k)

        monkeypatch.setattr(I, name, spy)
    render(ts, make_integrator({"type": "pathtracing", "bounces": 1}), 4, 4,
           spp=1, device="cpu", start_sample=3)
    want = sampler.rand1(torch.arange(16), 3, 0, 556)
    assert len(seen) == 2 * 2           # camera + bounce, one light each
    for time in seen:
        assert torch.equal(time, want)
