"""The port's cameras against the JAX package: `make_camera` for every
type, `shoot_rays` per type and per bokeh shape on the same pixel and lens
samples, the projections, and small Cornell renders under each camera type.

Tolerances: camera fields equal as f32 (both round the same float64 host
math once). Ray origins within 1e-6; directions within 1e-6 for the
perspective, architect and orthographic kinds and the lensless pinhole (a
normalised sum of products), within 1e-5 for the kinds built on trig
functions (angular, equirectangular, and the lens's bokeh shapes), whose
f32 sin/cos/atan/asin differ from XLA's by an ulp or two; the largest
difference observed is printed. `valid` equal on every ray. Projections:
raster positions within 1e-3 pixels (a 1e-6 relative error times raster
sizes of up to 64), visibility equal. Renders: the slice bound of
`tests/test_torch_render.py`, at least 98% of pixels within rtol = atol =
1e-4 and the image mean within 1e-3 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import cameras as JC
from libyafaray_tpu import film as JF
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.params import ParamMap as JParamMap
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu_torch import cameras as C
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.params import ParamMap
from libyafaray_tpu_torch.scenes import GOLDEN_CAMERAS
from scenes import cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401

RES = 32
BASE = {"from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
        "up": (0.5, -1.35, 1.5), "resx": 48, "resy": 40}
CAMERAS = {
    "perspective": {"type": "perspective", "fov": 39.0},
    "architect": {"type": "architect", "fov": 39.0, "from": (0.5, -1.35, 0.2),
                  "to": (0.5, 0.5, 0.8), "up": (0.5, -1.6, 1.1)},
    "orthographic": {"type": "orthographic", "scale": 1.4},
    "angular": {"type": "angular", "angle": 90.0, "max_angle": 80.0},
    "angular_mirrored_square": {"type": "angular", "angle": 60.0,
                                "mirrored": True, "circular": False},
    "angular_orthographic": {"type": "angular", "angle": 60.0,
                             "projection": "orthographic"},
    "angular_stereographic": {"type": "angular", "angle": 70.0,
                              "projection": "stereographic"},
    "angular_equisolid": {"type": "angular", "angle": 80.0,
                          "projection": "equisolid_angle"},
    "angular_rectilinear": {"type": "angular", "angle": 50.0,
                            "projection": "rectilinear"},
    "equirectangular": {"type": "equirectangular"},
    "dof": {"type": "perspective", "fov": 39.0, "aperture": 0.05,
            "dof_distance": 1.8},
}
# kinds whose directions come out of trig functions
TRIG = ("angular", "equirectangular")
BOKEH = ("disk", "disk1", "disk2", "ring", "triangle", "square", "pentagon",
         "hexagon")
FIELDS = ("origin", "cam_x", "cam_y", "cam_z", "focal", "aspect", "aperture",
          "dof_distance", "angle", "max_radius", "ortho_scale", "near_clip",
          "far_clip", "bokeh_rotation")


def T(a):
    return torch.from_numpy(np.array(a))


def _cams(params):
    pm = dict(BASE, **params)
    return JC.make_camera(JParamMap(pm)), C.make_camera(ParamMap(pm))


def _samples(rng, cam, n=4096):
    px = (rng.random(n) * cam.resx).astype(np.float32)
    py = (rng.random(n) * cam.resy).astype(np.float32)
    px[:3], py[:3] = [0.0, cam.resx / 2, cam.resx - 1e-3], [0.0, cam.resy / 2,
                                                              cam.resy - 1e-3]
    lu = rng.random(n).astype(np.float32)
    lv = rng.random(n).astype(np.float32)
    lu[:2], lv[:2] = [0.5, 0.0], [0.5, 0.0]   # the lens centre and a corner
    return px, py, lu, lv


def _compare_rays(jc, tc, px, py, lu, lv, tol):
    jo, jd, jv = jax.jit(JC.shoot_rays)(jc, px, py, lu, lv)
    o, d, v = C.shoot_rays(tc, T(px), T(py), T(lu), T(lv))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    err = float(np.abs(d.numpy() - np.asarray(jd)).max())
    print(f"max |d - d_jax| {err:.3g}")
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=tol)
    return v.numpy()


@pytest.mark.parametrize("name", list(CAMERAS))
def test_make_camera_matches(name):
    jc, tc = _cams(CAMERAS[name])
    assert tc.kind == jc.kind and (tc.resx, tc.resy) == (jc.resx, jc.resy)
    assert (tc.bokeh_kind, tc.angular_projection, tc.circular,
            tc.mirrored) == (jc.bokeh_kind, jc.angular_projection,
                             jc.circular, jc.mirrored)
    assert tc.dof == (float(jc.aperture) > 0)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_shoot_rays_match(rng, name):
    jc, tc = _cams(CAMERAS[name])
    valid = _compare_rays(jc, tc, *_samples(rng, tc),
                          1e-5 if jc.kind in TRIG or tc.dof else 1e-6)
    if name == "angular":
        # max_angle 80 of 90: the circle clips the frame's corners
        assert 0.3 < valid.mean() < 0.99


@pytest.mark.parametrize("bokeh", BOKEH)
def test_shoot_rays_match_for_each_bokeh(rng, bokeh):
    jc, tc = _cams(dict(CAMERAS["dof"], bokeh_type=bokeh))
    # make_camera leaves the rotation at 0 in both packages: turn it here
    jc = jc.replace(bokeh_rotation=jnp.float32(0.3))
    tc = dataclasses.replace(tc, bokeh_rotation=torch.tensor(0.3))
    _compare_rays(jc, tc, *_samples(rng, tc), 1e-5)
    # the lens spreads the origins over the aperture
    px, py, lu, lv = _samples(rng, tc)
    o, _, _ = C.shoot_rays(tc, T(px), T(py), T(lu), T(lv))
    r = (o - tc.origin).norm(dim=-1)
    assert float(r.max()) <= 0.05 * (1 + 1e-5) and float(r.max()) > 0.03


def test_lensless_rays_are_unchanged_bit_for_bit(rng):
    """With aperture 0 the lens samples change nothing: the rays equal the
    pinhole rays of a call without them, bit for bit, and a render of the
    Cornell camera draws no lens samples."""
    _, tc = _cams(CAMERAS["perspective"])
    px, py, lu, lv = _samples(rng, tc)
    o1, d1, v1 = C.shoot_rays(tc, T(px), T(py))
    o2, d2, v2 = C.shoot_rays(tc, T(px), T(py), T(lu), T(lv))
    assert torch.equal(o1, o2) and torch.equal(d1, d2) and torch.equal(v1, v2)
    assert not tc.dof


@pytest.mark.parametrize("sample_idx", [0, 5])
def test_lens_samples_match_jax_bit_for_bit(sample_idx):
    """`lens_samples` draws the thin lens's (lens_u, lens_v) as the JAX
    render does, `rand1(pixel_id, s, 0, 777 / 778)`, equal bit for bit; a
    camera without an aperture draws none."""
    from libyafaray_tpu import sampler as JSMP
    jc, tc = _cams(CAMERAS["dof"])
    pid = np.arange(0, 64 * 48, 7, dtype=np.int32)
    lu, lv = C.lens_samples(tc, torch.from_numpy(pid.astype(np.int64)),
                            sample_idx)
    for got, salt in ((lu, 777), (lv, 778)):
        want = jax.jit(lambda p, s=salt: JSMP.rand1(p, sample_idx, 0, s))(pid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, pinhole = _cams(CAMERAS["perspective"])
    assert C.lens_samples(pinhole, torch.from_numpy(pid), sample_idx) == (
        None, None)


@pytest.mark.parametrize("name", ["perspective", "architect", "orthographic",
                                  "dof"])
def test_project_matches(rng, name):
    jc, tc = _cams(CAMERAS[name])
    p = rng.uniform(-0.5, 1.5, (2048, 3)).astype(np.float32)
    got = C.project(tc, T(p))
    want = jax.jit(JC.project)(jc, p)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.2 < got[2].numpy().mean() < 1.0


@pytest.mark.parametrize("bokeh", ["disk", "hexagon"])
def test_project_lens_and_raster_jacobian_match(rng, bokeh):
    jc, tc = _cams(dict(CAMERAS["dof"], bokeh_type=bokeh))
    p = rng.uniform(0.0, 1.0, (2048, 3)).astype(np.float32)
    lu = rng.random(2048).astype(np.float32)
    lv = rng.random(2048).astype(np.float32)
    got = C.project_lens(tc, T(p), T(lu), T(lv))
    want = jax.jit(JC.project_lens)(jc, p, lu, lv)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)
    # visibility: equal except where a point sits within 1e-3 pixels of the
    # frame's edge
    px = got[0].numpy()
    edge = (np.abs(px) < 1e-3) | (np.abs(px - tc.resx) < 1e-3)
    vis_diff = got[2].numpy() != np.asarray(want[2])
    assert not (vis_diff & ~edge).any()
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=1e-6)
    _, tp = _cams(CAMERAS["perspective"])
    jp, _ = _cams(CAMERAS["perspective"])
    d = rng.standard_normal((512, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(
        C.raster_jacobian(tp, T(d)).numpy(),
        np.asarray(jax.jit(JC.raster_jacobian)(jp, d)), rtol=1e-5)


RENDERS = {"orthographic": dict(GOLDEN_CAMERAS["orthographic"],
                                type="orthographic"),
           "architect": dict(GOLDEN_CAMERAS["architect"], type="architect"),
           "angular": dict(GOLDEN_CAMERAS["angular"], type="angular"),
           "equirectangular": dict(GOLDEN_CAMERAS["equirectangular"],
                                   type="equirectangular"),
           "dof_hexagon": {"type": "perspective", "fov": 39.0,
                           "from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                           "up": (0.5, -1.35, 1.5), "aperture": 0.05,
                           "dof_distance": 1.85, "bokeh_type": "hexagon"}}


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_matches_jax(name):
    """A 32x32, 2-spp Cornell render, 2 bounces, under each camera type and
    with depth of field, through both packages' `render`."""
    from libyafaray_tpu_torch.scenes import cornell_builder as port_cornell
    cam = dict(RENDERS[name], resx=RES, resy=RES)
    jb, tb = cornell_builder(), port_cornell()
    jb.create_camera("cam", cam)
    tb.create_camera("cam", cam)
    cfg = {"type": "pathtracing", "bounces": 2}
    want = np.asarray(JF.resolve(jrender(jb.compile("cam"),
                                         jmake_integrator(cfg), spp=2)))
    got = F.resolve(render(tb.compile("cam", device="cpu"),
                           make_integrator(cfg), spp=2, device="cpu")).numpy()
    assert np.isfinite(got).all() and got[..., :3].mean() > 0.01
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(-1).mean()
    rel = abs(got.mean() - want.mean()) / abs(want.mean())
    print(f"{name}: {close:.4f} of pixels within 1e-4, mean rel {rel:.3g}")
    assert close >= 0.98 and rel < 1e-3
