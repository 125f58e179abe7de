"""The cover-order any hit of the block accelerator (the JAX package's opt-in
`YAF_COVER_ORDER=1`, TPU kernels b and c) against the JAX package: the
plain walk's hits against the Pallas kernel in interpret mode, the switch,
and a render in cover order against the default render. The prepass's
coverage-sorted lists are cases of
`test_torch_blocks.py::test_tile_candidates_match`.

JAX's `tiles_traverse` is jitted and reads YAF_COVER_ORDER when it is
traced, so the JAX side here traces it afresh (`jax.jit` of its
`__wrapped__`) with the variable set.

Tolerances: any-hit results equal on hit or miss for every ray (which prim
an any-hit query reports depends on how far the walk went); the render in
cover order equal to the default render bit for bit (both walks find every
hit a ray has, and shading reads only hit or miss of a shadow ray).
"""
import jax
import numpy as np
import pytest
import torch

from libyafaray_tpu.accel import blocks as JB
from libyafaray_tpu.accel import tiles as JT
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.accel import tiles as TL
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.scenes import bigmesh_builder as port_bigmesh
from scenes import bigmesh_builder
from test_pallas_intersect import _random_geom
from test_torch_blocks import _rays, _shadow_rays
from test_torch_foundations import one_torch_thread  # noqa: F401


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def random_acc():
    """The JAX package's tables of 300 random triangles in blocks of 128,
    and in blocks of 256 (two sub-chunks a block)."""
    g = _random_geom(np.random.default_rng(3), 300)
    return (jax.jit(JB.build_blocks)(g),
            jax.jit(lambda g: JB._tables_for(g, b=256, face_ids=None))(g))


@pytest.fixture(scope="module")
def terrain():
    """The 2048-face textured terrain (16 blocks), compiled by the JAX
    package and carried across to the port, and its sun's direction."""
    b = bigmesh_builder(33, textured=True)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 24
    js = b.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def _query(name, rng, random_acc, terrain):
    """(tab, bmin, bmax, o, d, t_min, t_max, exclude) of one case."""
    if name == "terrain":
        js, _ = terrain
        acc = js.blocks
        return (acc.tab, acc.bmin, acc.bmax) + _shadow_rays(rng, js)
    acc = random_acc[1] if name == "block_256" else random_acc[0]
    tabs = ((acc["tab"], acc["bmin"], acc["bmax"]) if name == "block_256"
            else (acc.tab, acc.bmin, acc.bmax))
    o, d, t_min, t_max, excl = _rays(rng, 777 if name == "tmax_short"
                                     else 1024)
    if name == "tmax_short":
        t_max[t_max > 0] = 0.8
    return tabs + (o, d, t_min, t_max, excl)


CASES = ["random", "tmax_short", "block_256", "terrain"]


def _jax_cover_traverse(monkeypatch, *args, **kw):
    monkeypatch.setenv("YAF_COVER_ORDER", "1")
    fresh = jax.jit(JT.tiles_traverse.__wrapped__,
                    static_argnames=("shadow", "any_hit", "interpret"))
    return fresh(*args, shadow=True, any_hit=True, interpret=True, **kw)


@pytest.mark.parametrize("case", CASES)
def test_cover_walk_matches_pallas_interpret(rng, monkeypatch, random_acc,
                                             terrain, case):
    q = _query(case, rng, random_acc, terrain)
    want = _jax_cover_traverse(monkeypatch, *q)
    assert TL.cover_order_on(True) and not TL.cover_order_on(False)
    got = TL.tiles_traverse_ref(*(T(x) for x in q), shadow=True,
                                any_hit=True)
    hits = np.asarray(want[1]) >= 0
    assert 0.05 < hits.mean() < 0.95
    np.testing.assert_array_equal(got[1].numpy() >= 0, hits)
    # the default front-to-back walk finds the same hits
    monkeypatch.delenv("YAF_COVER_ORDER")
    front = TL.tiles_traverse_ref(*(T(x) for x in q), shadow=True,
                                  any_hit=True)
    np.testing.assert_array_equal(front[1].numpy() >= 0, hits)


def _floor_and_steps_table():
    """Block 0: a floor triangle at z = 0 under all of [0, 1]^2; blocks 1-8:
    triangles whose bounds cover x in [0, 0.5] of that square, at z = -1
    ... -8 (each block one triangle, padding lanes with prim id -2)."""
    tab = np.zeros((9, 16, 128), np.float32)
    tab[:, 11] = -2.0
    tab[0, 0:9, 0] = [-1, -1, 0, 3, -1, 0, -1, 3, 0]
    for k in range(1, 9):
        tab[k, 0:9, 0] = [0, 0, -k, 0.5, 0, -k, 0, 1, -k]
    tab[:, 9:11, 0] = 1.0
    tab[:, 11, 0] = np.arange(9)
    v = tab[:, 0:9, 0].reshape(9, 3, 3)
    return T(tab), T(v.min(1)), T(v.max(1))


def test_cover_walk_stops_when_every_ray_is_hit(rng, monkeypatch, terrain):
    """Rays straight down onto a floor: the floor's block is entered by all
    128 rays and goes first, the blocks under it by about half; every ray
    hits at its first candidate (one step of needed work each), and the
    walk stops after the first group of UNROLL candidates, short of its 9.
    A ray left unhit with a live range is tested at its tile's whole list
    (the terrain's shadow rays)."""
    tab, bmin, bmax = _floor_and_steps_table()
    o = torch.cat([torch.rand((128, 2)), torch.ones((128, 1))], 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(128, 3).contiguous()
    rays, cand, ent, count = TL.prepare(
        bmin, bmax, o, d, torch.zeros(128), torch.full((128,), 1e30),
        torch.full((128,), -1, dtype=torch.int32), cover_order=True)
    assert int(count[0]) == 9 and int(cand[0, 0]) == 0
    assert float(ent[0, 0]) == -128 and float(ent[0, 1]) > -128
    updates = []
    real = TL._mt_update
    steps = torch.zeros(128, dtype=torch.int64)
    with monkeypatch.context() as m:
        m.setattr(TL, "_mt_update", lambda *a: updates.append(1) or real(*a))
        out = TL.tile_walk_ref(rays, cand, ent, count, tab, shadow=True,
                               any_hit=True, cover_order=True, steps=steps)
    assert (out[1] == 0).all() and (steps == 1).all()
    assert len(updates) == TL.UNROLL * (tab.shape[2] // TL.SUB)

    _, ts = terrain
    _, _, _, o, d, t_min, t_max, excl = _query("terrain", rng, None, terrain)
    acc = ts.blocks
    rays, cand, ent, count = TL.prepare(acc.bmin, acc.bmax, T(o), T(d),
                                        T(t_min), T(t_max), T(excl),
                                        cover_order=True)
    steps = torch.zeros(rays.shape[0], dtype=torch.int64)
    out = TL.tile_walk_ref(rays, cand, ent, count, acc.tab, shadow=True,
                           any_hit=True, cover_order=True, steps=steps)
    ray_count = count.long().repeat_interleave(TL.RAY_TILE)
    live = rays[:, 7] >= rays[:, 6]
    unhit = (out[1] < 0) & live
    assert unhit.any() and (steps[unhit] == ray_count[unhit]).all()
    hit = out[1] >= 0
    assert hit.any() and (steps[hit] >= 1).all()
    assert (steps <= ray_count).all() and (steps[~live] == 0).all()


def test_scene_any_hit_in_cover_order(rng, monkeypatch, terrain):
    """ops.intersect.any_hit on the compiled terrain, cover order against
    the default walk."""
    js, ts = terrain
    _, _, _, o, d, t_min, t_max, excl = _query("terrain", rng, None, terrain)
    args = (ts, T(o), T(d), 0.0, T(t_max))
    want = I.any_hit(*args, exclude_prim=T(excl))
    before = dict(TL.arm_launches)
    monkeypatch.setenv("YAF_COVER_ORDER", "1")
    got = I.any_hit(*args, exclude_prim=T(excl))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert 0.05 < got.numpy().mean() < 0.95
    assert dict(TL.arm_launches) == before   # CPU tensors launch nothing


def test_textured_terrain_renders_the_same_in_cover_order(monkeypatch):
    b = port_bigmesh(33, textured=True)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 24
    scene = b.compile("cam", device="cpu")
    cfg = make_integrator({"type": "pathtracing", "bounces": 2})
    want = F.resolve(render(scene, cfg, spp=1, device="cpu"))
    monkeypatch.setenv("YAF_COVER_ORDER", "1")
    got = F.resolve(render(scene, cfg, spp=1, device="cpu"))
    assert torch.equal(got, want)


def test_arm_names_and_argument_checks(random_acc):
    assert TL.arm(0, False, True) == "static+cover"
    assert TL.arm(1, True, True) == "instanced+motion1+cover"
    assert TL.arm(2, False) == "motion2"
    acc = random_acc[0]
    rays, cand, ent, count = TL.prepare(
        T(acc.bmin), T(acc.bmax), torch.zeros((128, 3)),
        torch.ones((128, 3)), torch.zeros(128), torch.ones(128),
        torch.full((128,), -1, dtype=torch.int32), cover_order=True)
    with pytest.raises(ValueError, match="any-hit"):
        TL.tile_walk(rays, cand, ent, count, T(acc.tab), cover_order=True)
