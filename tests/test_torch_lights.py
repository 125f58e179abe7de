"""Every light type of the port against the JAX package: `sample_light`
(direction, distance, pdf, radiance, Dirac and valid flags) and
`light_pdf_hit` for the area, spot, IES, sphere and directional lights of
`materials_cornell_builder` and the background portal of
`portal_room_builder`, the portal's emitted radiance, the IES profile
lookup, the spot's falloff across its blend band, and `parse_ies` against
the JAX package's on the same texts.

The scenes are compiled by the JAX package (its SceneBuilder filling the
port's builders) and carried across with `scene_from_numpy`; the shading
points and uniforms are seeded numpy lanes. The JAX functions run eagerly.
Tolerances, each observed worst case in brackets: directions, distances,
pdfs and radiances within rtol 1e-4, atol 1e-5, the bound of PERF.md
section 2 where XLA's CPU rsqrt, which is not correctly rounded, is
magnified [4.5e-5 relative: the sphere light's cone pdf 1 / (2 pi (1 -
cos_max)) with cos_max near 1; 1.7e-5 on the spot's falloff power; 1.1e-5
on the area light's pdf]; flags equal on every lane; parse_ies bit for bit
(both are numpy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import lights as JL
from libyafaray_tpu.integrators import common as JCM
from libyafaray_tpu.lights import ies as JIES
from libyafaray_tpu_torch import lights as L
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators import common as CM
from libyafaray_tpu_torch.lights import ies as IES
from libyafaray_tpu_torch.scene_types import (LIGHT_AREA, LIGHT_BGPORTAL,
                                              LIGHT_DIRECTIONAL, LIGHT_IES,
                                              LIGHT_SPHERE, LIGHT_SPOT)
from libyafaray_tpu_torch.scenes import (IES_PROFILE, materials_cornell_builder,
                                         portal_room_builder)
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_materials import _surfaces

N = 4096


def T(a):
    return torch.from_numpy(np.array(a))


def _carried(fn):
    b = fn(8, 8, builder=JSceneBuilder())
    js = b.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js)), b


@pytest.fixture(scope="module")
def cornell():
    return _carried(materials_cornell_builder)


@pytest.fixture(scope="module")
def room():
    return _carried(portal_room_builder)


def _close(got, want, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5, err_msg=name)


# light name -> (scene fixture, its type)
LIGHTS = {"lamp": ("cornell", LIGHT_AREA), "spot": ("cornell", LIGHT_SPOT),
          "ies": ("cornell", LIGHT_IES), "bulb": ("cornell", LIGHT_SPHERE),
          "sun": ("cornell", LIGHT_DIRECTIONAL),
          "portal": ("room", LIGHT_BGPORTAL)}


@pytest.mark.parametrize("name", list(LIGHTS))
def test_sample_light_matches_jax(rng, request, name):
    fixture, ty = LIGHTS[name]
    js, ts, b = request.getfixturevalue(fixture)
    li = b.light_order.index(name)
    assert int(ts.lights.light_type[li]) == ty
    p = rng.uniform(0.02, 0.98, (N, 3)).astype(np.float32)
    ns = np.tile([[0, 0, 1]], (N, 1)).astype(np.float32)
    u1, u2 = (rng.random(N).astype(np.float32) for _ in range(2))
    lis = np.full(N, li, np.int32)
    ls = L.sample_light(ts, T(lis), T(p), T(ns), T(u1), T(u2))
    jls = JL.sample_light(js, jnp.asarray(lis), jnp.asarray(p),
                          jnp.asarray(ns), jnp.asarray(u1), jnp.asarray(u2))
    for flag in ("is_dirac", "valid"):
        np.testing.assert_array_equal(getattr(ls, flag).numpy(),
                                      np.asarray(getattr(jls, flag)),
                                      err_msg=flag)
    v = ls.valid.numpy()
    assert v.mean() > 0.2
    for field in ("wi", "dist", "pdf", "radiance"):
        _close(getattr(ls, field)[v], np.asarray(getattr(jls, field))[v],
               field)
    assert float(ls.radiance[v].max()) > 0
    dirac = ty in (LIGHT_SPOT, LIGHT_IES, LIGHT_DIRECTIONAL)
    assert (ls.is_dirac.numpy() == dirac).all()


@pytest.mark.parametrize("name", ["lamp", "bulb", "portal"])
def test_light_pdf_hit_matches_jax(rng, request, name):
    fixture, _ = LIGHTS[name]
    js, ts, b = request.getfixturevalue(fixture)
    li = np.full(N, b.light_order.index(name), np.int32)
    p_hit = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    n_hit = rng.standard_normal((N, 3)).astype(np.float32)
    n_hit /= np.linalg.norm(n_hit, axis=1, keepdims=True)
    p_from = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    pdf = L.light_pdf_hit(ts, T(li), T(p_hit), T(n_hit), T(p_from))
    want = JL.light_pdf_hit(js, jnp.asarray(li), jnp.asarray(p_hit),
                            jnp.asarray(n_hit), jnp.asarray(p_from))
    _close(pdf, want, "pdf")
    assert (pdf.numpy() > 0).mean() > 0.4


def test_portal_emission_matches_jax(rng, room):
    """A BSDF ray that meets the portal sees the background behind it
    times the portal's power, from the portal's front only."""
    js, ts, b = room
    lp = b.light_order.index("portal")
    face = int(np.argmax(ts.geom.face_light.numpy() == lp))
    jsp, sp = _surfaces(rng, np.zeros(N, np.int32))
    ng = np.tile(np.asarray([[0, -1, 0]], np.float32), (N, 1))
    light_id = np.full(N, lp, np.int32)
    wo = rng.standard_normal((N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    jsp = jsp.replace(ng=jnp.asarray(ng), light_id=jnp.asarray(light_id),
                      prim=jnp.full((N,), face, jnp.int32))
    sp.ng, sp.light_id = T(ng), T(light_id)
    sp.prim = torch.full((N,), face, dtype=torch.int32)
    got = CM.emitted_radiance(ts, sp, T(wo)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JCM.emitted_radiance(js, jsp, jnp.asarray(wo))),
        rtol=1e-6, atol=0)
    front = wo[:, 1] < 0
    np.testing.assert_allclose(got[front], [[2.0, 1.6, 1.2]] * front.sum())
    assert not got[~front].any()


def test_ies_factor_matches_jax(rng, cornell):
    js, ts, b = cornell
    li = np.full(N, b.light_order.index("ies"), np.int32)
    cos_a = rng.uniform(-1, 1, N).astype(np.float32)
    cos_a[:3] = [1.0, -1.0, 0.0]
    wdir = rng.standard_normal((N, 3)).astype(np.float32)
    wdir /= np.linalg.norm(wdir, axis=1, keepdims=True)
    got = L._ies_factor(ts.lights, T(li), T(cos_a), T(wdir))
    want = JL._ies_factor(js.lights, jnp.asarray(li), jnp.asarray(cos_a),
                          jnp.asarray(wdir))
    _close(got, want, "ies factor")
    # the profile's beam: bright on the axis, dark opposite
    assert float(got[0]) == pytest.approx(1.0) and float(got[1]) == 0.0
    # a light without a profile: factor 1
    spot = np.full(N, b.light_order.index("spot"), np.int32)
    assert (L._ies_factor(ts.lights, T(spot), T(cos_a), T(wdir)) == 1).all()


def test_spot_falloff_across_its_blend_band(cornell):
    """1 inside the inner cone, 0 outside the outer one, rising
    monotonically across the blend band between them, as in the JAX
    package."""
    js, ts, b = cornell
    li = b.light_order.index("spot")
    lt = ts.lights
    c0, c1, fo = (float(x[li]) for x in (lt.cos_start, lt.cos_end,
                                          lt.falloff))
    assert c1 < c0 < 1.0 and fo == 2.0
    cos_a = np.linspace(c1 - 0.05, min(c0 + 0.05, 1.0), 2001,
                        dtype=np.float32)
    n = len(cos_a)
    args = [np.full(n, v, np.float32) for v in (c0, c1, fo)]
    got = L._spot_falloff(T(cos_a), *map(T, args)).numpy()
    want = np.asarray(JL._spot_falloff(jnp.asarray(cos_a),
                                       *map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[cos_a >= c0] == 1.0).all() and (got[cos_a <= c1] == 0.0).all()
    band = (cos_a > c1) & (cos_a < c0)
    assert band.sum() > 100 and (np.diff(got[band]) >= 0).all()
    assert 0.0 < got[band].min() and got[band].max() < 1.0


# ---------------------------------------------------------------- IES

_BILATERAL = """IESNA:LM-63-1995
TILT=NONE
1 1000.0 1.0 3 2 1 2 0.3 0.3 0.3
1.0 1.0 0.0
0.0 90.0 180.0
0.0 180.0
1000.0 1000.0 1000.0
0.0 0.0 0.0
"""
_QUADRANT = """IESNA:LM-63-2002
TILT=NONE
1 -1 2.0 4 2 1 1 0 0 0
1.0 1.0 50.0
0.0 45.0 90.0 180.0
0.0 90.0
500 400 100 0
800 300 50 0
"""
_FULL = """IESNA91
TILT=NONE
1 1000 1 3 4 1 2 0 0 0
1 1 60
0 90 180
0 90 180 270
100 50 0
200 60 0
300 70 0
400 80 0
"""
_TILT = """IESNA:LM-63-1995
TILT=INCLUDE
1
3
0 45 90
1.0 0.9 0.8
1 1000.0 1.0 3 1 1 2 0.3 0.3 0.3
1.0 1.0 0.0
0.0 90.0 180.0
0.0
700.0 350.0 0.0
"""


@pytest.mark.parametrize("text", [IES_PROFILE, _BILATERAL, _QUADRANT, _FULL,
                                  _TILT],
                         ids=["scene", "bilateral", "quadrant", "full",
                              "tilt"])
def test_parse_ies_matches_jax(text):
    got = IES.parse_ies(text)
    want = JIES.parse_ies(text)
    assert got.shape == (IES.IES_RES_H, IES.IES_RES) == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.max() == 1.0


def test_parse_ies_reads_a_file(tmp_path):
    path = tmp_path / "lamp.ies"
    path.write_text(_QUADRANT)
    np.testing.assert_array_equal(IES.parse_ies(str(path)),
                                  JIES.parse_ies(str(path)))


def test_ies_profile_arrays_compile_as_the_jax_package(rng):
    """An IES light given a raw vertical candela array ('ies_data') gets
    the same pool row as in the JAX compile."""
    prof = rng.random(17).astype(np.float32)
    tables = []
    for builder_cls in (JSceneBuilder, None):
        b = materials_cornell_builder(8, 8, builder=(
            builder_cls() if builder_cls else None))
        b.lights["ies"]["ies_data"] = prof
        tables.append(b.compile("cam") if builder_cls
                      else b.compile("cam", device="cpu"))
    js, ts = tables
    np.testing.assert_array_equal(ts.lights.ies_pool.numpy(),
                                  np.asarray(js.lights.ies_pool))
    np.testing.assert_array_equal(ts.lights.ies_id.numpy(),
                                  np.asarray(js.lights.ies_id))


def test_a_portal_needs_its_object():
    b = portal_room_builder(8, 8)
    b.lights["portal"]["object_name"] = "no_such_object"
    with pytest.raises(ValueError, match="needs a staged mesh object"):
        b.compile("cam", device="cpu")
