"""Mesh lights, `light_mat` and the single-scatter volume of the port against
the JAX package: the compiled tables of `volume_emissive_builder` (BASELINE
config 5), mesh-light sampling and pdfs (on a light of two unequal
triangles), the uniform volume's transmittance, `in_scatter` and
`apply_volumetric`, and the whole scene rendered. The other region types
and volume integrators are held in tests/test_torch_volume_regions.py.

The JAX functions run under `jax.jit`, as the JAX package's renders do.

Tolerances, each observed worst case in brackets:
  * tables equal bit for bit;
  * `sample_light` and `light_pdf_hit` within 1e-6 (relative for pdfs,
    which scale with the squared distance), the picked faces equal;
  * the two estimators of a mesh light's irradiance (light sampling, and
    BSDF sampling that hits the light) within rel 0.08, the bound of
    tests/test_lights.py::test_mesh_light_area_cdf_estimators_agree;
  * the transmittance across the unit box within rtol 1e-3 of
    exp(-sigma_t), as tests/test_textures.py's analytic check;
  * `in_scatter` and `apply_volumetric` at 256 lanes and 4 steps: every
    lane within rtol = atol = 1e-5;
  * the render (12x12, 1 spp, 3 bounces, 4 volume steps): at least 98% of
    pixels within rtol = atol = 1e-4 and the mean within 1e-3 relative,
    every slice's bound (every pixel within 5e-7 observed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import film as JF
from libyafaray_tpu import lights as JL
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.integrators import volume as JVI
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu.scene import SceneBuilder as JSceneBuilder
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import lights as L
from libyafaray_tpu_torch import make_integrator, render, sampler
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators import volume as VI
from libyafaray_tpu_torch.math import vec
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.ops import surface as S
from libyafaray_tpu_torch.scene import SceneBuilder
from libyafaray_tpu_torch.scene_types import LIGHT_MESH, MAT_LIGHT
from libyafaray_tpu_torch.scenes import cornell_builder as port_cornell
from libyafaray_tpu_torch.scenes import \
    volume_emissive_builder as port_volume
from scenes import volume_emissive_builder
from test_torch_caustic import _equal_tables
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_render import _assert_mostly_close

RES, STEPS = 12, 4


def T(a):
    return torch.from_numpy(np.array(a))


def _pair(jb, tb):
    js = jb.compile("cam")
    return js, tb.compile("cam", device="cpu")


@pytest.fixture(scope="module")
def volume():
    """(JAX scene, the port's compile of its own builder) at RES x RES."""
    jb, tb = volume_emissive_builder(), port_volume()
    for b in (jb, tb):
        b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    return _pair(jb, tb)


def _unequal_lamp(b):
    """tests/test_lights.py's scene: a diffuse floor under a mesh light of
    two triangles about 100x apart in area, both facing down."""
    b.create_material("floor", {"type": "shinydiffusemat",
                                "color": (0.6, 0.6, 0.6)})
    b.create_material("emit", {"type": "light_mat", "color": (1, 1, 1),
                               "power": 1.0})
    b.create_object("floor")
    b.set_current_material("floor")
    i = [b.add_vertex(*v) for v in ((-3, -3, 0), (3, -3, 0), (3, 3, 0),
                                     (-3, 3, 0))]
    b.add_quad(*i)
    b.create_object("lamp")
    b.set_current_material("emit")
    j = [b.add_vertex(*v) for v in ((-1.0, -1.0, 1.0), (1.0, -1.0, 1.0),
                                     (-1.0, 1.0, 1.0))]
    b.add_triangle(j[0], j[2], j[1])
    k = [b.add_vertex(*v) for v in ((1.05, 1.0, 1.0), (1.25, 1.0, 1.0),
                                     (1.05, 1.2, 1.0))]
    b.add_triangle(k[0], k[2], k[1])
    b.create_light("ml", {"type": "meshlight", "object_name": "lamp",
                          "color": (1.0, 1.0, 1.0), "power": 3.0,
                          "samples": 1})
    b.create_camera("cam", {"type": "perspective", "from": (0, -4.0, 1.5),
                            "to": (0, 0, 0.3), "up": (0, -4.0, 2.5),
                            "resx": 16, "resy": 16, "fov": 45.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    return b


@pytest.fixture(scope="module")
def lamp():
    return _pair(_unequal_lamp(JSceneBuilder()), _unequal_lamp(SceneBuilder()))


# ---------------------------------------------------------------- compile

@pytest.mark.parametrize("table", ["geom", "materials", "lights", "volumes"])
def test_volume_tables_match_jax(volume, table):
    """The port's compile of its volume_emissive_builder equals the JAX
    package's compile of tests/scenes.py's, table by table: the glow
    triangle's face_light, the light_mat row, the mesh light's columns
    and area CDF, the uniform region."""
    js, ts = volume
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    _equal_tables(getattr(ts, table), getattr(want, table))
    if table == "lights":
        assert ts.lights.present_types == (3, LIGHT_MESH)
        assert int(ts.lights.tri_count[1]) == 1
    if table == "materials":
        assert MAT_LIGHT in ts.materials.present_types


def test_unequal_mesh_light_tables_match_jax(lamp):
    js, ts = lamp
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    for table in ("geom", "lights"):
        _equal_tables(getattr(ts, table), getattr(want, table))
    cdf = ts.lights.tri_cdf.numpy()
    assert 0.9 < cdf[2] < 1.0 and cdf[3] == 1.0    # the two lamp faces


# ------------------------------------------------------------- mesh light

def test_mesh_light_sampling_matches_jax(rng, lamp):
    """sample_light (its area-CDF face pick included) and light_pdf_hit at
    random points in the box above the floor."""
    js, ts = lamp
    n = 2048
    p = rng.uniform([-2, -2, 0.0], [2, 2, 0.9], (n, 3)).astype(np.float32)
    ns = np.tile(np.float32([0, 0, 1]), (n, 1))
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    u1[:3] = [0.0, 0.95, 1.0 - 2 ** -24]
    li = np.zeros(n, np.int32)
    jls = jax.jit(JL.sample_light)(js, li, p, ns, u1, u2)
    ls = L.sample_light(ts, T(li), T(p), T(ns), T(u1), T(u2))
    tri, u1r = L.sample_light_tri(ts.lights, ts.geom.num_faces, T(li), T(u1))
    jtri, ju1r = jax.jit(JL.sample_light_tri, static_argnums=1)(
        js.lights, js.geom.num_faces, li, u1)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    assert set(tri.numpy().tolist()) == {2, 3}
    np.testing.assert_allclose(u1r.numpy(), np.asarray(ju1r), atol=1e-6)
    np.testing.assert_array_equal(ls.valid.numpy(), np.asarray(jls.valid))
    for name in ("wi", "dist", "radiance"):
        np.testing.assert_allclose(getattr(ls, name).numpy(),
                                   np.asarray(getattr(jls, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(ls.pdf.numpy(), np.asarray(jls.pdf),
                               rtol=1e-6, err_msg="pdf")
    # the pdf of reaching the sampled point by BSDF sampling
    lp = p + np.asarray(jls.wi) * np.asarray(jls.dist)[:, None]
    ng = np.tile(np.float32([0, 0, -1]), (n, 1))
    pdf = L.light_pdf_hit(ts, T(li), T(lp), T(ng), T(p))
    jpdf = jax.jit(JL.light_pdf_hit)(js, li, lp, ng, p)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-6)


def test_mesh_light_area_cdf_estimators_agree(lamp):
    """tests/test_lights.py's furnace check on the port: the irradiance at
    a floor point from light sampling and from cosine-sampled rays that hit
    the light agree, and light_pdf_hit reproduces sample_light's pdf where
    a light sample's ray hits the light."""
    _, ts = lamp
    n = 8192
    p = torch.tensor([[0.2, 0.1, 0.0]]).repeat(n, 1)
    ns = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    pid = torch.arange(n, dtype=torch.int64)
    li = torch.zeros(n, dtype=torch.int32)
    ls = L.sample_light(ts, li, p, ns, sampler.rand1(pid, 0, 0, 11),
                        sampler.rand1(pid, 0, 0, 12))
    cos_s = torch.clamp_min(vec.dot(ls.wi, ns), 0.0)
    mean_a = float(torch.where(ls.valid, cos_s / ls.pdf, 0.0).mean()
                   * ls.radiance[0, 0])
    dl = vec.cosine_sample_hemisphere(sampler.rand1(pid, 1, 0, 13),
                                      sampler.rand1(pid, 1, 0, 14))
    hit = I.closest_hit(ts, p, dl, 1e-4, 1e9)
    light = ts.geom.face_light[hit.prim]
    mean_b = float(torch.where(hit.valid & (light >= 0), np.pi, 0.0).mean()
                   * ts.lights.color[0, 0])
    assert mean_a > 0 and mean_b > 0
    np.testing.assert_allclose(mean_a, mean_b, rtol=0.08)
    hit_l = I.closest_hit(ts, p, ls.wi, 1e-4, 1e9)
    sp = S.make_surface(ts, hit_l, p, ls.wi)
    on = ls.valid & hit_l.valid & (sp.light_id >= 0)
    assert int(on.sum()) > 100
    pdf = L.light_pdf_hit(ts, torch.clamp_min(sp.light_id, 0), sp.p, sp.ng,
                          p)
    np.testing.assert_allclose(pdf[on].numpy(), ls.pdf[on].numpy(),
                               rtol=1e-3)


# ----------------------------------------------------------------- volume

def test_uniform_transmittance_analytic():
    """exp(-sigma_t) across the unit fog box (sigma_a 0.3, sigma_s 0.2),
    as tests/test_textures.py::test_uniform_volume_transmittance_analytic."""
    b = port_cornell()
    b.create_volume_region("fog", {
        "type": "UniformVolume", "sigma_a": 0.3, "sigma_s": 0.2,
        "minX": 0, "minY": 0, "minZ": 0, "maxX": 1, "maxY": 1, "maxZ": 1})
    ts = b.compile("cam", device="cpu")
    tr = VI.transmittance(ts, torch.tensor([[0.5, -0.5, 0.5]]),
                          torch.tensor([[0.0, 1.0, 0.0]]),
                          torch.tensor([1.5]), steps=32)
    np.testing.assert_allclose(tr.numpy()[0], np.exp(-0.5), rtol=1e-3)


def test_in_scatter_matches_jax(rng, volume):
    """in_scatter and apply_volumetric on 256 camera rays through random
    pixels, ending at their first hits, 4 steps."""
    js, ts = volume
    n = 256
    px, py = (T(rng.random(n).astype(np.float32) * RES) for _ in range(2))
    o, d, _ = shoot_rays(ts.camera, px, py)
    t_hit = I.closest_hit(ts, o, d, ts.ray_min_dist, 1e30).t
    pid = T(rng.integers(0, RES * RES, n))
    radiance = T(rng.random((n, 3)).astype(np.float32))
    cfg = make_integrator({"type": "pathtracing", "volume_steps": STEPS})
    jcfg = jmake_integrator({"type": "pathtracing", "volume_steps": STEPS})
    got = (VI.in_scatter(ts, o, d, t_hit, pid, 3, steps=STEPS),
           VI.apply_volumetric(ts, cfg, radiance, o, d, t_hit, pid, 3))
    args = [x.numpy() for x in (o, d, t_hit)] + [pid.numpy().astype(
        np.uint32), jnp.uint32(3)]
    want = jax.jit(lambda s, o, d, t, p, i, rad: (
        JVI.in_scatter(s, o, d, t, p, i, STEPS),
        JVI.apply_volumetric(s, jcfg, rad, o, d, t, p, i)))(
            js, *args, radiance.numpy())
    for g, w in zip(got, want):
        assert float(g.abs().max()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_volume_render_matches_jax(volume):
    """The whole scene through both packages' render(): 12x12, 1 spp, 3
    bounces, the single-scatter integrator at 4 steps."""
    js, ts = volume
    cfg = {"type": "pathtracing", "bounces": 3, "volume_steps": STEPS}
    want = np.asarray(JF.resolve(jrender(js, jmake_integrator(cfg), RES, RES,
                                         spp=1)))
    img = F.resolve(render(ts, make_integrator(cfg), spp=1,
                           device="cpu")).numpy()
    assert img.shape == want.shape == (RES, RES, 4)
    assert np.isfinite(img).all()
    _assert_mostly_close(img.reshape(-1, 4), want.reshape(-1, 4))
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    # the fog is visible: it changes every pixel of the scene rendered
    # without it (it attenuates more than it scatters in: the mean falls,
    # in the JAX package too)
    bare = dataclasses.replace(ts, volumes=None)
    clear = F.resolve(render(bare, make_integrator(cfg), spp=1,
                             device="cpu")).numpy()
    changed = np.abs(img - clear)[..., :3].max(-1) > 1e-4
    assert changed.all()
