"""The slice of procedural textures and orco coordinates, end to end, against
the JAX package: orco coordinates streamed, not streamed and mixed (the
compile's orco table and the surface's interpolation), orco in the texture
footprint's offsets, the node program over procedural textures (bump
through a clouds texture included), and the procedural Cornell box
(`procedural_cornell_builder`: every procedural type, three noise bases,
a colour ramp, a bump, an orco-streaming cube and an orco-mapped slab
that streams none): its tables, and a 16x16 render on brute force and on
blocks.

The JAX package's node program runs eagerly, each texture-mapper node
looking up its texture with the pool's static sets narrowed to that
texture's own type, bases and octaves (`_jax_pieces`); eagerly over the
whole pool every node would run all eight types, about 3 s a node on the
CPU. tests/test_torch_noise.py holds the narrowed lookup to the whole
pool's. A few other pieces are jitted, and the brute-force queries go
through the Pallas kernel in interpret mode (which the port's plain
version follows), as in tests/test_torch_materials_slice.py. Both packages
integrate the port's camera rays at the pixel centres.

Tolerances, each observed worst case in brackets:
  * tables equal, tensors bit for bit;
  * surface orco coordinates within 1e-6 [1.2e-7];
  * node outputs within 1e-5 [1.8e-7; the footprint's filtered colours
    equal]; bump-mapped normals within 1e-4 on 99% of lanes (PERF.md
    section 2's texture bound) [every lane within 1.8e-7];
  * images: at least 98% of pixels within rtol = atol = 1e-4 and the mean
    within 1e-3 relative (the slice bound) [every pixel within 4.7e-6,
    the mean within 2.3e-7, on both accelerators].
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import lights as JL
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu import textures as JT
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.materials import node_eval as JNE
from libyafaray_tpu.materials import nodes as JN
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu_torch import make_integrator
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.materials import node_eval as NE
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.ops import surface as S
from libyafaray_tpu_torch.scene import SceneBuilder
from libyafaray_tpu_torch.scenes import (_cube, cornell_builder,
                                         procedural_cornell_builder)
from test_torch_caustic import _equal_tables
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path
from test_torch_render import _assert_mostly_close

RES = 16
PM = {"type": "pathtracing", "bounces": 3}


def T(a):
    return torch.from_numpy(np.array(a))


_NODE_TEX = []   # the texture of the texture-mapper node being evaluated


def _narrowed(sample_texture, statics):
    """The JAX package's sample_texture inside a texture-mapper node: the
    pool's static sets replaced by the node's texture's own, `statics`
    (`TexturePool.statics`) at the node's static tex_id (`_node_marked`)."""

    def lookup(scene, tex_id, p, uv, duv_dx=None, duv_dy=None):
        if not _NODE_TEX:
            return sample_texture(scene, tex_id, p, uv, duv_dx, duv_dy)
        ty, noise, octs, _ = statics[_NODE_TEX[-1]]
        pool = scene.textures.replace(used_types=(ty,),
                                      used_noise=noise or (0,),
                                      max_octaves=octs)
        return sample_texture(scene.replace(textures=pool), tex_id, p, uv,
                              duv_dx, duv_dy)
    return lookup


def _node_marked(eval_node):
    def run(scene, sp, i, cols, vals, p=None):
        _NODE_TEX.append(scene.nodes.meta[i][4])
        try:
            return eval_node(scene, sp, i, cols, vals, p)
        finally:
            _NODE_TEX.pop()
    return run


def _memoized(eval_program):
    """The JAX package's eval_program, run once per shading batch: its
    outputs depend on the scene and the SurfacePoint's arrays alone, and
    eagerly each of a bounce's eleven reads would run it again."""
    kept = []

    def run(scene, sp):
        key = [scene.nodes, scene.textures] + [
            getattr(sp, f.name) for f in dataclasses.fields(sp)]
        for k, out in kept:
            if len(k) == len(key) and all(a is b for a, b in zip(k, key)):
                return out
        out = eval_program(scene, sp)
        kept[:] = kept[-3:] + [(key, out)]
        return out
    return run


_BUMP_ONLY = []   # the bump closure while the JAX package's eval_bump runs


def _bump_marked(eval_bump, run_program, only):
    """The JAX package's eval_bump with its three program runs restricted
    to the bump nodes and their inputs `only` (NodeProgram.bump_nodes), the
    slots it reads, as the port's; test_node_program_matches_jax holds
    the port's eval_bump to the unrestricted one."""
    def bump(scene, sp):
        _BUMP_ONLY.append(set(only))
        try:
            return eval_bump(scene, sp)
        finally:
            _BUMP_ONLY.pop()

    def run(scene, sp, p=None):
        if not _BUMP_ONLY:
            return run_program(scene, sp, p)
        cols, vals = [], []
        n = sp.p.shape[0]
        for i in range(scene.nodes.num_nodes):
            if i in _BUMP_ONLY[-1]:
                JNE._eval_node(scene, sp, i, cols, vals, p)
            else:
                cols.append(jnp.zeros((n, 4), jnp.float32))
                vals.append(jnp.zeros((n,), jnp.float32))
        return jnp.stack(cols, axis=1), jnp.stack(vals, axis=1)
    return bump, run


@contextlib.contextmanager
def _jax_context(statics, bump_nodes=None):
    """The JAX package's pieces for a scene whose texture pool has the
    port's `statics`; with `bump_nodes` (the slots its bump nodes read)
    eval_bump runs only those."""
    with _pallas_path(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "sample_texture",
                   _narrowed(JT.sample_texture, statics))
        mp.setattr(JNE, "_eval_node", _node_marked(JNE._eval_node))
        mp.setattr(JN, "eval_program", _memoized(JN.eval_program))
        if bump_nodes is not None:
            bump, run = _bump_marked(JNE.eval_bump, JNE.run_program,
                                     bump_nodes)
            mp.setattr(JNE, "eval_bump", bump)
            mp.setattr(JNE, "run_program", run)
        for mod, name in ((JS, "make_surface"), (JL, "sample_light")):
            mp.setattr(mod, name, jax.jit(getattr(mod, name)))
        yield


@pytest.fixture(scope="module")
def _jax_pieces():
    with _jax_context():
        yield


@pytest.fixture(scope="module")
def box():
    """(JAX compile, the port's compile) of the procedural Cornell box."""
    js = procedural_cornell_builder(RES, RES,
                                    builder=JSceneBuilder()).compile("cam")
    return js, procedural_cornell_builder(RES, RES).compile("cam",
                                                            device="cpu")


# ---------------------------------------------------------------- compile

@pytest.mark.parametrize("table", ["geom", "materials", "lights", "nodes",
                                   "textures"])
def test_procedural_box_tables_match_jax(box, table):
    js, ts = box
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    _equal_tables(getattr(ts, table), getattr(want, table))
    if table == "textures":
        assert ts.textures.used_types == tuple(range(1, 9))
        assert len(ts.textures.used_noise) >= 3
    if table == "geom":
        assert ts.geom.orcos is not None


# ------------------------------------------------------------------- orco

def _orco_scene(b, mode):
    """The Cornell box with a cube that streams orco coordinates
    ("streamed"), one that does not ("not_streamed": the scene then has no
    orco table), or both and a baked instance of the streaming one
    ("mixed"); the area lamp's quad has no orco rows."""
    b = cornell_builder(builder=b)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    if mode in ("streamed", "mixed"):
        b.create_object("oc")
        b.set_current_material("white")
        _cube(b, (0.62, 0.08, 0.02), (0.2, 0.2, 0.2), orco=True)
    if mode in ("not_streamed", "mixed"):
        b.create_object("plain")
        b.set_current_material("red")
        _cube(b, (0.1, 0.1, 0.05), (0.2, 0.15, 0.3))
    if mode == "mixed":
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (-0.2, 0.3, 0.4)
        b.add_instance("oc", m)
    return b


def _rays(rng, n):
    """Rays from the camera and from inside the box, in random
    directions."""
    o = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    o[: n // 2] = [0.5, -1.35, 0.5]
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 2, 1] = np.abs(d[: n // 2, 1]) * 4
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("mode", ["streamed", "not_streamed", "mixed"])
def test_orco_surfaces_match_jax(rng, mode):
    """The compile's orco table and make_surface's orco on 2,048 rays:
    interpolated by barycentrics where some object streamed orcos (an
    object that did not uses its untransformed vertices, a baked instance
    its object's orcos, the lamp quad's indices clamp to the last row),
    the hit point where none did."""
    js = _orco_scene(JSceneBuilder(), mode).compile("cam")
    ts = _orco_scene(SceneBuilder(), mode).compile("cam", device="cpu")
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    _equal_tables(ts.geom, want.geom)
    assert (ts.geom.orcos is None) == (mode == "not_streamed")
    o, d = _rays(rng, 2048)

    @jax.jit
    def jsurface(s, o, d):
        hit = JI.closest_hit(s, o, d, s.ray_min_dist, 1e30)
        return hit, JS.make_surface(s, hit, o, d)
    jhit, jsp = jsurface(js, o, d)
    hit = I.Hit(valid=T(jhit.valid), t=T(jhit.t), prim=T(jhit.prim),
                uv=T(jhit.uv))
    sp = S.make_surface(ts, hit, T(o), T(d))
    valid = np.asarray(jhit.valid)
    np.testing.assert_allclose(sp.orco.numpy()[valid],
                               np.asarray(jsp.orco)[valid], rtol=0,
                               atol=1e-6)
    differs = np.abs(sp.orco.numpy() - sp.p.numpy()).max(-1) > 1e-3
    if mode == "not_streamed":
        assert not differs.any()
    else:
        # the streaming cube's orcos are its own corners in [-1, 1]^3
        assert differs[valid].sum() > 50
    if mode == "mixed":
        lamp = np.isin(np.asarray(jhit.prim), np.nonzero(
            ts.geom.face_light.numpy() >= 0)[0]) & valid
        last = ts.geom.orcos.numpy()[-1]
        assert lamp.any()
        np.testing.assert_allclose(sp.orco.numpy()[lamp],
                                   np.broadcast_to(last, (lamp.sum(), 3)),
                                   atol=1e-6)


def _footprint_scene(b):
    """The Cornell box with an image texture, mipmapped, on a cube's orco
    coordinates (the cube streams none, so they are its vertices)."""
    b = cornell_builder(builder=b)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    img = np.indices((64, 64)).sum(0) % 2 * 0.8 + 0.1
    b.create_texture("check", {"type": "image",
                               "interpolate": "mipmap_trilinear"},
                     image=np.repeat(img[..., None], 3, -1))
    b.create_material("mapped", {"type": "shinydiffusemat",
                                 "diffuse_shader": "m"},
                      node_list=[{"name": "m", "type": "texture_mapper",
                                  "texture": "check", "texco": "orco",
                                  "scale": (4.0, 4.0, 4.0)}])
    b.create_object("oc")
    b.set_current_material("mapped")
    _cube(b, (0.3, 0.1, 0.05), (0.4, 0.3, 0.3), orco=False)
    b.create_object("streamed")
    b.set_current_material("white")
    _cube(b, (0.8, 0.8, 0.0), (0.1, 0.1, 0.1), orco=True)
    return b


def _port_sp(jsp):
    return S.SurfacePoint(**{f.name: T(getattr(jsp, f.name))
                             for f in dataclasses.fields(S.SurfacePoint)
                             if getattr(jsp, f.name) is not None})


def test_orco_footprint_offsets_match_jax():
    """A texture-mapper node on orco coordinates at the primary hits with
    their pixel footprints: the footprint's offsets move orco by dp_dx and
    dp_dy (JAX node_eval.py:114-117), which the trilinear filter reads."""
    js = _footprint_scene(JSceneBuilder()).compile("cam")
    ts = _footprint_scene(SceneBuilder()).compile("cam", device="cpu")
    px, py = (np.arange(RES * RES) % RES + 0.5, np.arange(RES * RES)
              // RES + 0.5)
    o, d, _ = shoot_rays(ts.camera, T(px.astype(np.float32)),
                         T(py.astype(np.float32)))

    @jax.jit
    def jsurface(s, o, d):
        hit = JI.closest_hit(s, o, d, s.ray_min_dist, 1e30)
        return JS.compute_differentials(s, JS.make_surface(s, hit, o, d), d)
    jsp = jsurface(js, o.numpy(), d.numpy())
    sp = _port_sp(jsp)
    cols, vals = NE.run_program(ts, sp)
    jcols, jvals = JNE.run_program(js, jsp)
    on = (sp.mat_id.numpy() == ts.materials.mat_type.shape[0] - 1) \
        & sp.valid.numpy()
    assert on.sum() > 20
    np.testing.assert_allclose(cols.numpy(), np.asarray(jcols), atol=1e-5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5)
    # the footprint is read: without it the filtered colours differ
    bare = dataclasses.replace(sp, duv_dx=None, duv_dy=None)
    sharp, _ = NE.run_program(ts, bare)
    assert np.abs(sharp.numpy() - cols.numpy())[on].max() > 1e-3


def _orco_bump_scene(b):
    """The Cornell box with a cube bump-mapped through a clouds texture on
    its orco coordinates."""
    b = cornell_builder(builder=b)
    b.create_texture("c", {"type": "clouds", "size": 6.0, "depth": 1})
    b.create_material("bumpy", {"type": "shinydiffusemat",
                                "bump_shader": "m"},
                      node_list=[{"name": "m", "type": "texture_mapper",
                                  "texture": "c", "texco": "orco",
                                  "bump_strength": 0.05}])
    b.create_object("oc")
    b.set_current_material("bumpy")
    _cube(b, (0.3, 0.1, 0.05), (0.4, 0.3, 0.3), orco=True)
    return b


def test_orco_bump_is_flat_in_both_packages(rng):
    """A fault of both packages (ROADMAP section 3): eval_bump offsets the
    hit point for its differences, and orco coordinates ignore that
    offset (JAX node_eval.py:36-37), so a bump node on orco coordinates
    differences equal values and leaves the normal as it was."""
    js = _orco_bump_scene(JSceneBuilder()).compile("cam")
    ts = _orco_bump_scene(SceneBuilder()).compile("cam", device="cpu")
    o, d = _rays(rng, 512)

    @jax.jit
    def jsurface(s, o, d):
        hit = JI.closest_hit(s, o, d, s.ray_min_dist, 1e30)
        return JS.make_surface(s, hit, o, d)
    jsp = jsurface(js, o, d)
    sp = _port_sp(jsp)
    on = (sp.mat_id.numpy() == 3) & sp.valid.numpy()
    assert on.sum() > 20
    bump, jbump = NE.eval_bump(ts, sp), JNE.eval_bump(js, jsp)
    for got, want in ((bump.n, jbump.n), (bump.nu, jbump.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(bump.n.numpy()[on], sp.n.numpy()[on],
                               atol=1e-6)


# ----------------------------------------------------------- node program

def test_node_program_matches_jax(box):
    """The node program of the procedural box (twelve textures, a mix, the
    bump) on its camera hits and on rays from inside the box: every
    node's outputs, and the bump-mapped frame of eval_bump, the port's
    bump runs restricted to NodeProgram.bump_nodes against the JAX
    package's full runs."""
    js, ts = box
    o, d = _rays(np.random.default_rng(3), 512)

    @jax.jit
    def jsurface(s, o, d):
        hit = JI.closest_hit(s, o, d, s.ray_min_dist, 1e30)
        return JS.make_surface(s, hit, o, d)
    jsp = jsurface(js, o, d)
    sp = _port_sp(jsp)
    with _jax_context(ts.textures.statics):
        jcols, jvals = JNE.run_program(js, jsp)
        jbump = JNE.eval_bump(js, jsp)
    cols, vals = NE.run_program(ts, sp)
    np.testing.assert_allclose(cols.numpy(), np.asarray(jcols), atol=1e-5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5)
    bump = NE.eval_bump(ts, sp)
    for f in ("n", "nu", "nv"):
        close = np.isclose(getattr(bump, f).numpy(),
                           np.asarray(getattr(jbump, f)), rtol=0,
                           atol=1e-4).all(-1)
        assert close.mean() >= 0.99, (f, close.mean())
    tilted = np.abs(bump.n.numpy() - sp.n.numpy()).max(-1) > 1e-3
    assert tilted.sum() > 10          # the right wall's bump is visible


# ----------------------------------------------------------------- images

def _pixel_rays(ts):
    yy, xx = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    pid = (yy * RES + xx).reshape(-1)
    px = (xx.reshape(-1) + 0.5).astype(np.float32)
    py = (yy.reshape(-1) + 0.5).astype(np.float32)
    o, d, valid = shoot_rays(ts.camera, T(px), T(py))
    return o, d, valid, pid


@pytest.fixture(scope="module")
def jax_image(box):
    """The JAX package's image of the box, 1 spp at the pixel centres."""
    js, ts = box
    o, d, valid, pid = _pixel_rays(ts)
    with _jax_context(ts.textures.statics, ts.nodes.bump_nodes):
        rgb = jintegrate(js, jmake_integrator(PM),
                         *(jnp.asarray(x.numpy()) for x in (o, d, valid)),
                         jnp.asarray(pid.astype(np.uint32)), jnp.uint32(0))[0]
    return np.asarray(rgb)


@pytest.mark.parametrize("accel", ["brute", "blocks"])
def test_procedural_box_render_matches_jax(accel, jax_image):
    b = procedural_cornell_builder(RES, RES)
    b.set_render_params({"scene_accelerator": accel})
    ts = b.compile("cam", device="cpu")
    assert ts.accel_kind == accel
    o, d, valid, pid = _pixel_rays(ts)
    img = integrate(ts, make_integrator(PM), o, d, valid, T(pid), 0)[0]
    img = img.numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    _assert_mostly_close(img, jax_image)
    assert abs(img.mean() - jax_image.mean()) <= 1e-3 * jax_image.mean()
