"""The port's analytic spheres and curves against the JAX package: the ray-
sphere test, the brute-force closest and any hit with spheres (TPU kernel
a's path), the sphere pass after the block walk (kernel b's path), the
sphere branch of `make_surface`, curve extrusion, and the glossy golden
scene (an analytic sphere on a textured floor) rendered by both packages
and by the port on both accelerators.

The JAX side's brute-force triangle queries run through its Pallas kernel
in interpret mode (`_pallas_path`, the route of tests/test_torch_gradients.py):
its CPU scan contracts to FMAs, while the port's `mt_closest_ref` follows
the Pallas kernel. Its block queries run its CPU path (`_query_chunk`,
then `_sphere_pass`). The JAX queries run eagerly: jitted, XLA contracts
the sphere's b*b - c into a fused multiply-add, which moves t by up to 4e-6
relative on rays that graze the sphere; eagerly it rounds each operation,
as the port does.

Tolerances: sphere hits equal, t within rtol 1e-6; closest-hit prim ids
equal on every ray, t within rtol 1e-6, barycentrics within 1e-6; any hit
equal on every ray. Surface points: ids equal, geometry within 1e-5 (the
sphere's uv from acos / atan2 of the normal). Curve vertices and faces
equal (the same numpy). Renders: the slice bound of
`tests/test_torch_render.py`, at least 98% of pixels within rtol = atol =
1e-4 and the image mean within 1e-3 relative.
"""
import jax
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import film as JF
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu_torch import SceneBuilder
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.accel import spheres as SP
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.ops import surface as S
from libyafaray_tpu_torch.scenes import glossy_golden_builder
from test_refparity import _glossy_builder
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path

RES = 32


def T(a):
    return torch.from_numpy(np.array(a))


def test_intersect_sphere_matches(rng):
    n, s = 2048, 7
    o = rng.uniform(-1.5, 1.5, (n, 1, 3)).astype(np.float32)
    d = rng.standard_normal((n, 1, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = rng.uniform(-1, 1, (1, s, 3)).astype(np.float32)
    r = rng.uniform(0.3, 0.9, (1, s)).astype(np.float32)
    t_max = np.where(rng.random((n, 1)) < 0.2, 0.5, 1e30).astype(np.float32)
    jh, jt = JI.intersect_sphere(o, d, c, r, 1e-4, t_max)
    h, t = SP.intersect_sphere(T(o), T(d), T(c), T(r), 1e-4, T(t_max))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    hit = h.numpy()
    assert 0.05 < hit.mean() < 0.8
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-6)


def _scene_pair(accel, builders=(_glossy_builder, glossy_golden_builder)):
    jb, tb = builders[0](), builders[1]()
    for b in (jb, tb):
        b.set_render_params({"scene_accelerator": accel})
        b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    return jb.compile("cam"), tb.compile("cam", device="cpu")


@pytest.fixture(scope="module")
def brute():
    return _scene_pair("brute")


@pytest.fixture(scope="module")
def blocks():
    return _scene_pair("blocks")


def _rays(rng, n=3000):
    """Rays from the camera toward the sphere and the floor, from inside the
    scene in random directions, and from the sphere's surface outward
    (excluding the sphere's own prim id)."""
    o = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    o[: n // 3] = [0.5, -0.9, 0.55]
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 3] = np.array([0.0, 1.4, -0.25]) + rng.normal(0, 0.25,
                                                           (n // 3, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = np.full(n, -1, np.int32)
    k = slice(2 * n // 3, n)
    o[k] = np.array([0.5, 0.5, 0.3]) + 0.25 * d[k] * (1 + 1e-4)
    return o, d, excl, k


def _assert_same_hits(hit, jhit, anyh, jany):
    np.testing.assert_array_equal(hit.valid.numpy(), np.asarray(jhit.valid))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(jhit.prim))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(jhit.t), rtol=1e-6)
    np.testing.assert_allclose(hit.uv.numpy(), np.asarray(jhit.uv), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(anyh.numpy(), np.asarray(jany))


@pytest.mark.parametrize("accel", ["brute", "blocks"])
def test_queries_with_spheres_match(rng, brute, blocks, accel):
    """closest_hit and any_hit with the sphere's id excluded on the rays that
    leave its surface (as a bounce does): TPU kernel a's path (brute) and
    the block walk with `sphere_pass` after it (blocks)."""
    js, ts = brute if accel == "brute" else blocks
    assert ts.accel_kind == js.accel_kind == accel
    assert ts.geom.num_spheres == js.geom.num_spheres == 1
    o, d, excl, k = _rays(rng)
    sph_id = ts.geom.num_faces
    excl[k] = sph_id
    query = lambda s, o, d, e: (
        JI.closest_hit(s, o, d, s.ray_min_dist, 1e30, exclude_prim=e),
        JI.any_hit(s, o, d, 0.0, 1e30, exclude_prim=e))
    with _pallas_path():
        jhit, jany = query(js, o, d, excl)
    hit = I.closest_hit(ts, T(o), T(d), ts.ray_min_dist, 1e30,
                        exclude_prim=T(excl))
    anyh = I.any_hit(ts, T(o), T(d), 0.0, 1e30, exclude_prim=T(excl))
    _assert_same_hits(hit, jhit, anyh, jany)
    prim = hit.prim.numpy()
    valid = hit.valid.numpy()
    # the camera rays hit the sphere, and the excluded sphere is never hit
    # again from its own surface
    assert (prim[: len(o) // 3][valid[: len(o) // 3]] == sph_id).mean() > 0.2
    assert not (prim[k][valid[k]] == sph_id).any()


def test_camera_hit_with_an_invisible_lamp_and_a_sphere(rng, brute):
    """camera_hit on the glossy scene, whose lamp is invisible to camera
    rays: its clamp of the prim id keeps sphere ids (num_faces + s) out of
    the face tables, as the JAX package's does."""
    js, ts = brute
    assert ts.has_cam_invisible
    o, d, _, _ = _rays(rng)
    o[:] = [0.5, 0.5, 0.9]      # under the lamp, looking everywhere
    with _pallas_path():
        jhit = JI.camera_hit(js, o, d, js.ray_min_dist, 1e30)
    hit = I.camera_hit(ts, T(o), T(d), ts.ray_min_dist, 1e30)
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(jhit.prim))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(jhit.t), rtol=1e-6)
    assert (hit.prim.numpy() == ts.geom.num_faces).any()


def test_make_surface_sphere_branch_matches(rng, brute):
    js, ts = brute
    o, d, excl, _ = _rays(rng)
    with _pallas_path():
        jhit = JI.closest_hit(js, o, d, js.ray_min_dist, 1e30)
    jsp = jax.jit(JS.make_surface)(js, jhit, o, d)
    sp = S.make_surface(ts, I.Hit(valid=T(jhit.valid), t=T(jhit.t),
                                  prim=T(jhit.prim), uv=T(jhit.uv)),
                        T(o), T(d))
    on_sphere = sp.prim.numpy() == ts.geom.num_faces
    assert on_sphere.mean() > 0.1
    for f in ("valid", "mat_id", "obj_id", "light_id", "prim"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(),
                                      np.asarray(getattr(jsp, f)), err_msg=f)
    for f in ("p", "n", "ng", "nu", "nv", "uv", "dp_du", "dp_dv"):
        np.testing.assert_allclose(getattr(sp, f).numpy(),
                                   np.asarray(getattr(jsp, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    # the sphere's material is the glossy one
    assert (sp.mat_id.numpy()[on_sphere] == 2).all()


def _curves(b):
    """Two curve objects (a helix of 24 control points and a bent strand of
    5) and one of a single point, which makes no ribbon, over a floor."""
    b.create_material("m", {"type": "shinydiffusemat"})
    b.create_material("hair", {"type": "shinydiffusemat",
                               "color": (0.6, 0.3, 0.1)})
    b.create_object("floor")
    b.set_current_material("m")
    b.add_quad(*[b.add_vertex(*p) for p in ((0, 0, 0), (1, 0, 0), (1, 1, 0),
                                            (0, 1, 0))])
    b.create_object("helix", {"type": "curve", "strand_start": 0.02,
                              "strand_end": 0.005})
    b.set_current_material("hair")
    for j in range(24):
        t = j / 23.0
        b.add_vertex(0.3 + 0.05 * np.cos(9 * t), 0.4 + 0.05 * np.sin(9 * t),
                     0.5 * t)
    b.create_object("bent", {"type": "curve"})
    b.set_current_material("hair")
    for p in ((0.7, 0.5, 0.0), (0.7, 0.5, 0.2), (0.72, 0.52, 0.35),
              (0.8, 0.6, 0.45), (0.95, 0.6, 0.45)):
        b.add_vertex(*p)
    b.create_object("dot", {"type": "curve"})
    b.add_vertex(0.1, 0.1, 0.1)
    b.create_light("sun", {"type": "sunlight", "direction": (0.2, 0.3, 1.0)})
    b.create_background({"type": "constant", "color": (0.2, 0.2, 0.3)})
    b.create_camera("cam", {"type": "perspective", "from": (0.5, -1.0, 0.6),
                            "to": (0.5, 0.5, 0.2), "resx": 16, "resy": 16})
    return b


def test_curve_extrusion_matches_the_jax_compile():
    js = _curves(JSceneBuilder()).compile("cam")
    tb = _curves(SceneBuilder())
    ts = tb.compile("cam", device="cpu")
    assert ts.geom.num_faces == js.geom.num_faces == 2 + 2 * 23 + 2 * 4
    for f in ("vertices", "faces", "face_mat", "face_obj", "face_vis",
              "face_smooth", "tri_table"):
        np.testing.assert_array_equal(getattr(ts.geom, f).numpy(),
                                      np.asarray(getattr(js.geom, f)),
                                      err_msg=f)
    # the staged strands stay as they were: a second compile is the same
    again = tb.compile("cam", device="cpu")
    assert torch.equal(again.geom.vertices, ts.geom.vertices)


@pytest.fixture(scope="module")
def port_images(brute, blocks):
    """The port's 32x32, 2-spp, 3-bounce render of the glossy golden scene
    on each accelerator."""
    cfg = make_integrator({"type": "pathtracing", "bounces": 3})
    return {name: F.resolve(render(pair[1], cfg, spp=2,
                                   device="cpu")).numpy()
            for name, pair in (("brute", brute), ("blocks", blocks))}


def _slice_bound(got, want, what):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(-1).mean()
    rel = abs(got.mean() - want.mean()) / abs(want.mean())
    print(f"{what}: {close:.4f} of pixels within 1e-4, mean rel {rel:.3g}")
    assert close >= 0.98 and rel < 1e-3


def test_glossy_golden_scene_matches_jax(brute, port_images):
    js, _ = brute
    cfg = jmake_integrator({"type": "pathtracing", "bounces": 3})
    want = np.asarray(JF.resolve(jrender(js, cfg, spp=2)))
    got = port_images["brute"]
    assert np.isfinite(got).all() and got[..., :3].mean() > 0.01
    _slice_bound(got, want, "port brute against JAX")


def test_glossy_golden_scene_brute_against_blocks(port_images):
    _slice_bound(port_images["blocks"], port_images["brute"],
                 "port blocks against port brute")
