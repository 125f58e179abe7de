"""The forward slice as a whole against the JAX package: camera rays, surface
points, BSDF sampling and evaluation, light sampling, the integrator per ray
and a full render, on the same scene tables (carried across with
`convert.scene_from_numpy`) and the same counter-based samples.

Tolerances: per-lane functions to 1e-5 (XLA's CPU code contracts some
products and sums into FMAs; the port rounds every operation). Radiance per
ray and per pixel: at least 98% within rtol = atol = 1e-4, and the image
mean within 1e-3 relative: a path whose floating-point noise tips a
decision (Russian roulette, a triangle edge) goes its own way, and such
lanes are allowed to be rare, not absent.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import film as JF
from libyafaray_tpu import lights as JL
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.cameras import shoot_rays as jshoot_rays
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.materials import bsdf as JB
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import lights as L
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.accel import mt_intersect as MT
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.materials import bsdf as B
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.ops import surface as S
from libyafaray_tpu_torch.accel import tiles as TL
from libyafaray_tpu_torch.scenes import cornell_builder as port_cornell
from scenes import bigmesh_builder, cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401

RES, SPP, BOUNCES = 16, 2, 3


def T(a):
    return torch.from_numpy(np.array(a))


def _lobes(b):
    """Cornell with every shiny-diffuse lobe in play: a Fresnel-weighted
    mirror on the white walls, transparency and translucency on the red."""
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73),
                                "specular_reflect": 0.2,
                                "fresnel_effect": True, "IOR": 1.5})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.65, 0.05, 0.05),
                              "transparency": 0.3, "translucency": 0.2})
    return b


def _pair(builder):
    builder.cameras["cam"]["resx"] = builder.cameras["cam"]["resy"] = RES
    js = builder.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


@pytest.fixture(scope="module")
def cornell():
    return _pair(cornell_builder())


@pytest.fixture(scope="module")
def lobes():
    return _pair(_lobes(cornell_builder()))


@pytest.fixture(scope="module")
def no_background():
    """The Cornell box without a background (kind "none": escaped rays
    black, no background light)."""
    b = cornell_builder()
    b.background_params = None
    return _pair(b)


@pytest.fixture(scope="module")
def jax_image(cornell):
    """The JAX package's render, made once for the module."""
    js, _ = cornell
    cfg = jmake_integrator({"type": "pathtracing", "bounces": BOUNCES})
    return np.asarray(JF.resolve(jrender(js, cfg, RES, RES, spp=SPP)))


def _assert_mostly_close(got, want, frac=0.98):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    close = close.reshape(close.shape[0], -1).all(-1) if close.ndim > 1 \
        else close
    assert close.mean() >= frac, f"{close.mean():.4f} within 1e-4"


def _hits(rng, js, n=1024):
    """Rays from the camera and from inside the box, with the JAX hits."""
    o = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    o[: n // 2] = [0.5, -1.35, 0.5]
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 2, 1] = np.abs(d[: n // 2, 1]) * 4
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit = jax.jit(lambda s, o, d: JI.closest_hit(s, o, d, s.ray_min_dist,
                                                 1e30))(js, o, d)
    return o, d, hit


def _port_hit(jhit):
    return I.Hit(valid=T(jhit.valid), t=T(jhit.t), prim=T(jhit.prim),
                 uv=T(jhit.uv))


def _port_sp(jsp):
    return S.SurfacePoint(**{f: T(getattr(jsp, f)) for f in (
        "valid", "p", "n", "ng", "nu", "nv", "uv", "dp_du", "dp_dv", "mat_id",
        "obj_id", "light_id", "prim", "t", "bary")})


def test_shoot_rays_match(rng, cornell):
    js, ts = cornell
    n = 4096
    px = (rng.random(n) * RES).astype(np.float32)
    py = (rng.random(n) * RES).astype(np.float32)
    px[:4], py[:4] = [0, RES - 1e-3, 0, RES / 2], [0, 0, RES - 1e-3, RES / 2]
    zero = np.zeros(n, np.float32)
    jo, jd, jv = jax.jit(jshoot_rays)(js.camera, px, py, zero, zero)
    o, d, v = shoot_rays(ts.camera, T(px), T(py))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert v.numpy().all() and np.asarray(jv).all()


def test_make_surface_matches(rng, cornell):
    js, ts = cornell
    o, d, jhit = _hits(rng, js)
    jsp = jax.jit(JS.make_surface)(js, jhit, o, d)
    sp = S.make_surface(ts, _port_hit(jhit), T(o), T(d))
    for f in ("valid", "mat_id", "obj_id", "light_id", "prim"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(),
                                      np.asarray(getattr(jsp, f)), err_msg=f)
    for f in ("p", "n", "ng", "nu", "nv", "uv", "dp_du", "dp_dv", "t", "bary"):
        np.testing.assert_allclose(getattr(sp, f).numpy(),
                                   np.asarray(getattr(jsp, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    assert sp.valid.numpy().mean() > 0.5   # the box is open at y = 0


def test_bsdf_sample_and_eval_match(rng, lobes):
    js, ts = lobes
    o, d, jhit = _hits(rng, js)
    jsp = jax.jit(JS.make_surface)(js, jhit, o, d)
    n = o.shape[0]
    u1, u2, u3 = (rng.random(n).astype(np.float32) for _ in range(3))
    wo = -d
    wi = rng.standard_normal((n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)

    @jax.jit
    def jbsdf(s, sp, wo, wi, u1, u2, u3):
        return JB.sample_bsdf(s, sp, wo, u1, u2, u3), \
            JB.eval_bsdf(s, sp, wo, wi), JB.emit(s, sp, wo)

    jms, (jf, jpdf), jem = jbsdf(js, jsp, wo, wi, u1, u2, u3)
    sp = _port_sp(jsp)
    ms = B.sample_bsdf(ts, sp, T(wo), T(u1), T(u2), T(u3))
    f, pdf = B.eval_bsdf(ts, sp, T(wo), T(wi))
    for name in ("is_delta", "is_transmit", "valid", "lobe"):
        np.testing.assert_array_equal(getattr(ms, name).numpy(),
                                      np.asarray(getattr(jms, name)),
                                      err_msg=name)
    assert len(set(ms.lobe.numpy().tolist())) == 4   # every lobe sampled
    for name in ("wi", "weight", "pdf"):
        np.testing.assert_allclose(getattr(ms, name).numpy(),
                                   np.asarray(getattr(jms, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(B.emit(ts, sp, T(wo)).numpy(),
                                  np.asarray(jem))


def test_sample_light_matches(rng, cornell):
    js, ts = cornell
    n = 2048
    p = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    p[:8, 2] = 1.0                     # level with / above the lamp
    ns = np.tile(np.float32([0, 0, 1]), (n, 1))
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    li = np.zeros(n, np.int32)
    jls = jax.jit(JL.sample_light)(js, li, p, ns, u1, u2)
    ls = L.sample_light(ts, T(li), T(p), T(ns), T(u1), T(u2))
    np.testing.assert_array_equal(ls.valid.numpy(), np.asarray(jls.valid))
    np.testing.assert_array_equal(ls.is_dirac.numpy(), np.asarray(jls.is_dirac))
    for name in ("wi", "dist", "pdf", "radiance"):
        np.testing.assert_allclose(getattr(ls, name).numpy(),
                                   np.asarray(getattr(jls, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert 0 < ls.valid.numpy().mean() < 1


@pytest.mark.parametrize("kind,scene", [("pathtracing", "cornell"),
                                        ("pathtracing", "lobes"),
                                        ("directlighting", "lobes"),
                                        ("pathtracing", "no_background")])
def test_integrate_per_ray_matches(request, kind, scene):
    js, ts = request.getfixturevalue(scene)
    pid = np.arange(RES * RES, dtype=np.uint32)
    px = (pid % RES).astype(np.float32) + 0.5
    py = (pid // RES).astype(np.float32) + 0.5
    o, d, valid = shoot_rays(ts.camera, T(px), T(py))
    cfg = {"type": kind, "bounces": BOUNCES}
    jcfg = jmake_integrator(cfg)
    jint = jax.jit(lambda s, o, d, p, si: jintegrate(
        s, jcfg, o, d, jnp.ones(o.shape[0], bool), p, si)[:2])
    for sample in (0, 1):
        jrgb, jalpha = jint(js, o.numpy(), d.numpy(), pid, jnp.uint32(sample))
        rgb, alpha, _ = integrate(ts, make_integrator(cfg), o, d, valid,
                               T(pid.astype(np.int64)), sample)
        _assert_mostly_close(rgb.numpy(), np.asarray(jrgb))
        np.testing.assert_array_equal(alpha.numpy(), np.asarray(jalpha))
        assert np.isfinite(rgb.numpy()).all()


def test_render_matches_jax(cornell, jax_image):
    """16x16, 2 spp, 3 bounces through both packages' render()."""
    _, ts = cornell
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    before = MT.launches
    img = F.resolve(render(ts, cfg, RES, RES, spp=SPP, device="cpu")).numpy()
    assert MT.launches == before      # CPU tensors never launch the kernel
    assert img.shape == jax_image.shape == (RES, RES, 4)
    assert np.isfinite(img).all()
    _assert_mostly_close(img.reshape(-1, 4), jax_image.reshape(-1, 4))
    assert abs(img.mean() - jax_image.mean()) <= 1e-3 * abs(jax_image.mean())
    # plausibility (colour bleed from the walls, the lamp in view)
    band = RES * 12 // 64
    assert img[:, :band, 0].mean() > img[:, :band, 1].mean()
    assert img[:, -band:, 1].mean() > img[:, -band:, 0].mean()
    assert abs(img[..., :3].max() - 12.0) < 1e-3


def test_port_compiled_scene_renders_the_same(cornell):
    """The port's own SceneBuilder gives the tables of the converted JAX
    scene, so the two render identically."""
    _, ts = cornell
    b = port_cornell()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    own = b.compile("cam", device="cpu")
    cfg = make_integrator({"type": "directlighting", "bounces": 1})
    a = F.resolve(render(own, cfg, spp=1, device="cpu"))
    c = F.resolve(render(ts, cfg, spp=1, device="cpu"))
    assert torch.equal(a, c)


def test_render_runs_on_the_card_unless_told_otherwise():
    assert inspect.signature(render).parameters["device"].default == "cuda"


def test_terrain_render_matches_jax():
    """The slice: BASELINE config 3 untextured, cut to 2048 faces and 24x24
    (576 camera rays, so the block accelerator sorts them), 1 spp, 2 bounces,
    under the sun and the background light, through both packages' render().
    The JAX package runs its CPU path (the per-ray block loop); the port its
    TPU path's plain version (the ray sort and the tile walk)."""
    res = 24
    b = bigmesh_builder(33, textured=False)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    js = b.compile("cam")
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    assert ts.accel_kind == "blocks" and ts.lights.bg_light_idx == 1
    cfg = {"type": "pathtracing", "bounces": 2}
    want = np.asarray(JF.resolve(jrender(js, jmake_integrator(cfg), res, res,
                                         spp=1)))
    before = TL.launches
    img = F.resolve(render(ts, make_integrator(cfg), spp=1,
                           device="cpu")).numpy()
    assert TL.launches == before      # CPU tensors never launch the kernel
    assert img.shape == want.shape == (res, res, 4)
    assert np.isfinite(img).all()
    _assert_mostly_close(img.reshape(-1, 4), want.reshape(-1, 4))
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    # the top row looks past the terrain's far edge: the background, whose
    # camera-ray MIS weight is 1; the terrain fills the middle of the frame
    sky = img[0, :, :3]
    np.testing.assert_allclose(sky, np.broadcast_to([0.3, 0.4, 0.6],
                                                    sky.shape), rtol=1e-6)
    assert img[res // 2, res // 2, 3] == 1.0
    assert 0.2 < img[..., 3].mean() < 0.8
