"""The slice of every material and light type, end to end, against the JAX
package: the compiled tables of `materials_cornell_builder` and
`portal_room_builder`; the transparent-shadow walk; the materials Cornell
box at 24x16, 2 spp, 4 bounces with transparent shadows; the portal room
at 24x24; glass with Beer absorption and with an sss interior, each alone
in the Cornell box; and the gradients of the image with respect to a
coated-glossy colour, an Oren-Nayar sigma, a blend value, a spot light's
colour and a glass absorption against `jax.grad`.

The JAX package renders these scenes with its functions called eagerly
between a few jitted pieces (`_jax_pieces`): the node program, the
surface construction, the shadow query, the BSDF, the transparency and
the light sample; its brute-force queries go through its Pallas kernel
in interpret mode, which the port's plain version follows (on a 16x16
Cornell box the JAX CPU scan sends one camera ray to the green wall across
the floor seam, 0.2% of the mean). One jit of the whole bounce loop takes
over ten minutes to compile on the CPU (the node program is traced some
twenty times a bounce), and a pass fully eager takes two minutes.

Tolerances (PERF.md section 2's slice bound), each observed worst case in
brackets:
  * tables equal, tensors bit for bit;
  * the transparent-shadow filters within 1e-6 on 99% of rays [all
    rays];
  * images: at least 98% of pixels within rtol = atol = 1e-4 and the
    mean within 1e-3 relative [the materials Cornell box: 99.5% of
    pixels, the mean within 7.0e-5, the largest difference 3.8e-3 on one
    of the two pixels outside 1e-4; the
    portal room and both glass interiors: every pixel within 3e-7];
  * gradients against `jax.grad` within rtol 1e-3, atol 1e-7 [1.4e-7 of
    the largest]. No clamp tie on these paths changes a gradient (ROADMAP
    section 3, "clamp ties"): the agreement would break on one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import lights as JL
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.cameras import shoot_rays as jshoot_rays
from libyafaray_tpu.integrators import common as JCM
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.materials import bsdf as JB
from libyafaray_tpu.materials import node_eval as JNE
from libyafaray_tpu.materials import nodes as JN
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu_torch import make_integrator
from libyafaray_tpu_torch import scenes as PS
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators import common as CM
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.scene import SceneBuilder
from libyafaray_tpu_torch.scenes import (MATERIALS_INTEGRATOR,
                                         materials_cornell_builder,
                                         portal_room_builder)
from test_torch_caustic import _equal_tables
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path
from test_torch_render import _assert_mostly_close

SPP = 2


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def _jax_pieces():
    """The JAX package's pieces that a pass calls many times, jitted, and
    its brute-force queries through the Pallas kernel in interpret mode
    (tests/test_torch_gradients.py's `_pallas_path`: the port's
    mt_closest_ref follows the kernel where the JAX CPU scan picks the
    other face of a seam)."""
    with _pallas_path(), pytest.MonkeyPatch.context() as mp:
        for mod, name in ((JN, "eval_program"), (JNE, "eval_bump"),
                          (JI, "shadow_hit_surface"), (JS, "make_surface"),
                          (JB, "transparency"), (JB, "sample_bsdf"),
                          (JL, "sample_light")):
            mp.setattr(mod, name, jax.jit(getattr(mod, name)))
        mp.setattr(JB, "eval_bsdf",
                   jax.jit(JB.eval_bsdf, static_argnames=("split",)))
        yield


def _pair(fn, w, h):
    """(JAX compile, the port's compile) of a builder function filled by
    each package's SceneBuilder."""
    js = fn(w, h, builder=JSceneBuilder()).compile("cam")
    return js, fn(w, h).compile("cam", device="cpu")


@pytest.fixture(scope="module")
def cornell():
    return _pair(materials_cornell_builder, 24, 16)


@pytest.fixture(scope="module")
def room():
    return _pair(portal_room_builder, 24, 24)


# ---------------------------------------------------------------- compile

@pytest.mark.parametrize("scene,table", [
    ("cornell", t) for t in ("geom", "materials", "lights", "nodes",
                             "textures")] + [
    ("room", t) for t in ("geom", "materials", "lights")])
def test_scene_tables_match_jax(request, scene, table):
    js, ts = request.getfixturevalue(scene)
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    _equal_tables(getattr(ts, table), getattr(want, table))


# -------------------------------------------------------- shadow walk

def test_transparent_shadow_walk_matches_jax(rng, cornell, _jax_pieces):
    """trace_shadow through up to 4 transparent surfaces (the veil, the
    null quad, glass without fake shadows is opaque) from points in the
    box toward each light, against the JAX package's walk."""
    js, ts = cornell
    n = 1536
    p = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    p[: n // 2, 2] = rng.uniform(0.01, 0.3, n // 2)      # under the veil
    li = np.arange(n, dtype=np.int32) % ts.lights.num_lights
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    ns = np.tile([[0, 0, 1]], (n, 1)).astype(np.float32)
    jls = JL.sample_light(js, jnp.asarray(li), jnp.asarray(p),
                          jnp.asarray(ns), jnp.asarray(u1), jnp.asarray(u2))
    wi, dist = np.asarray(jls.wi), np.asarray(jls.dist)
    prim = np.full(n, -1, np.int32)
    want = np.asarray(JCM.trace_shadow(js, jnp.asarray(p), jnp.asarray(prim),
                                       jnp.asarray(wi), jnp.asarray(dist),
                                       4))
    got = CM.trace_shadow(ts, T(p), T(prim), T(wi), T(dist), 4).numpy()
    close = np.isclose(got, want, rtol=0, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    # some rays pass the veil (half filtered), some are blocked, some free
    tinted = (got > 0).any(-1) & (got < 1).any(-1)
    assert tinted.sum() > 20 and (got == 0).all(-1).sum() > 20
    assert (got == 1).all(-1).sum() > 20


# ------------------------------------------------------------- images

def _pixels(w, h):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pid = (yy * w + xx).reshape(-1).astype(np.uint32)
    return ((xx.reshape(-1) + 0.5).astype(np.float32),
            (yy.reshape(-1) + 0.5).astype(np.float32), pid)


def _camera_rays(ts, w, h):
    """The port's camera rays at the pixel centres, which both packages
    integrate: at 24x16 the centres of pixels (19, 0) and (19, 15) fall on
    the box's corner edges, where the last bit of a ray (jitted XLA's
    against torch's shoot_rays) picks the face, and with it the light
    the pixel sees."""
    px, py, pid = _pixels(w, h)
    o, d, valid = shoot_rays(ts.camera, T(px), T(py))
    return o, d, valid, pid


def _jax_image(js, ts, pm, w, h, spp=SPP):
    o, d, valid, pid = _camera_rays(ts, w, h)
    cfg = jmake_integrator(pm)
    o, d, valid = (jnp.asarray(x.numpy()) for x in (o, d, valid))
    acc = 0.0
    for s in range(spp):
        acc = acc + np.asarray(jintegrate(js, cfg, o, d, valid,
                                          jnp.asarray(pid),
                                          jnp.uint32(s))[0])
    return acc / spp


def _port_image(ts, pm, w, h, spp=SPP):
    o, d, valid, pid = _camera_rays(ts, w, h)
    cfg = make_integrator(pm)
    acc = 0.0
    for s in range(spp):
        acc = acc + integrate(ts, cfg, o, d, valid, T(pid.astype(np.int64)),
                              s)[0].detach().numpy()
    return acc / spp


def _images_agree(img, want):
    assert np.isfinite(img).all() and img.mean() > 0
    _assert_mostly_close(img, want)
    assert abs(img.mean() - want.mean()) <= 1e-3 * want.mean()


def test_materials_cornell_matches_jax(cornell, _jax_pieces):
    js, ts = cornell
    assert make_integrator(MATERIALS_INTEGRATOR).transparent_shadows == 4
    img = _port_image(ts, MATERIALS_INTEGRATOR, 24, 16)
    _images_agree(img, _jax_image(js, ts, MATERIALS_INTEGRATOR, 24, 16))


def test_portal_room_matches_jax(room, _jax_pieces):
    js, ts = room
    pm = {"type": "pathtracing", "bounces": 4}
    img = _port_image(ts, pm, 24, 24)
    _images_agree(img, _jax_image(js, ts, pm, 24, 24))
    # lit only through the window: the floor under it is bright
    assert img.reshape(24, 24, 3)[18:, 8:16].mean() > 0.05


def _glass_slab(builder_mod, absorption=None, handler=None, dispersion=0.0):
    """tests/test_render.py's glass slab in the Cornell box (a glass box
    with interior Beer absorption, and with the sss handler), made with
    the named package's cornell_builder, but standing clear of the short
    box: there its bottom lies in the short box's top, and rays inside the
    glass meet the two faces at one t, a tie that the last bit of a
    refracted direction breaks (differently in the two packages)."""
    gp = {"type": "glass", "IOR": 1.5, "filter_color": (1.0, 1.0, 1.0)}
    if absorption is not None:
        gp["absorption"] = absorption
        gp["absorption_dist"] = 0.2
    if handler is not None:
        gp["volume_handler"] = handler
        gp["scatter_col"] = (0.9, 0.9, 0.9)
    if dispersion:
        gp["dispersion_power"] = dispersion
    b = builder_mod.cornell_builder(extras=[("glass", gp)])
    b.create_object("glassbox")
    b.set_current_material("glass")
    builder_mod._box(b, (0.3, 0.12, 0.05), (0.3, 0.2, 0.3))
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 16
    return b


def _compile(b, wavelength, **kw):
    """The slab compiled whole, or through a render view with a fixed
    wavelength (the spectral view: every dispersive path takes it)."""
    if not wavelength:
        return b.compile("cam", **kw)
    b.create_render_view("spectral", {"camera_name": "cam",
                                      "wavelength": wavelength})
    return b.compile_view("spectral", **kw)


@pytest.mark.parametrize("absorption,handler,wavelength", [
    ((0.2, 0.9, 0.2), None, 0.0), ((0.5, 0.5, 0.5), "sss", 0.0),
    ((0.2, 0.9, 0.2), None, 0.3)], ids=["beer", "sss", "dispersive_view"])
def test_glass_interior_matches_jax(absorption, handler, wavelength,
                                    _jax_pieces):
    import scenes as jscenes
    disp = 0.5 if wavelength else 0.0
    js = _compile(_glass_slab(jscenes, absorption, handler, disp),
                  wavelength)
    ts = _compile(_glass_slab(PS, absorption, handler, disp), wavelength,
                  device="cpu")
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    _equal_tables(ts.materials, want.materials)
    if wavelength:
        assert ts.materials.has_dispersion
        assert torch.equal(ts.fixed_wavelength, want.fixed_wavelength)
    assert ts.materials.has_beer and ts.materials.has_sss == (handler ==
                                                              "sss")
    pm = {"type": "pathtracing", "bounces": 4}
    img = _port_image(ts, pm, 16, 16)
    _images_agree(img, _jax_image(js, ts, pm, 16, 16))
    # the interior changes the image: against the clear glass slab (and
    # the view's wavelength against the slab's per-path wavelengths)
    clear = (_glass_slab(PS, absorption, handler, disp).compile(
        "cam", device="cpu") if wavelength
        else _glass_slab(PS).compile("cam", device="cpu"))
    assert np.abs(_port_image(clear, pm, 16, 16) - img).max() > 1e-3


# ---------------------------------------------------------- gradients

def _grad_scene(b, res=8):
    """A Cornell box with an Oren-Nayar left wall, a coated-glossy box, a
    blend (mirror and blue shiny-diffuse, constant factor 0.4) box, a glass
    slab with Beer absorption, the area lamp and a spotlight: the columns
    of the gradient test, each read on the image's paths."""
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.65, 0.05, 0.05),
                              "diffuse_brdf": "oren_nayar", "sigma": 0.3})
    b.create_material("coated", {"type": "coated_glossy",
                                 "color": (0.9, 0.8, 0.6),
                                 "diffuse_color": (0.6, 0.3, 0.2),
                                 "exponent": 30.0})
    b.create_material("mirror", {"type": "mirror"})
    b.create_material("blue", {"type": "shinydiffusemat",
                               "color": (0.2, 0.35, 0.8)})
    b.create_material("blend", {"type": "blend_mat", "material1": "mirror",
                                "material2": "blue", "blend_value": 0.4})
    b.create_material("glass", {"type": "glass", "IOR": 1.5,
                                "absorption": (0.5, 0.7, 0.9),
                                "absorption_dist": 0.3})

    def quad(p0, p1, p2, p3):
        b.add_quad(*[b.add_vertex(*q) for q in (p0, p1, p2, p3)])

    b.create_object("walls")
    b.set_current_material("white")
    quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    quad((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1))
    quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))
    quad((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))
    b.set_current_material("red")
    quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))
    for name, origin, size in (("coated", (0.12, 0.55, 0.0),
                                (0.3, 0.3, 0.5)),
                               ("blend", (0.55, 0.45, 0.0), (0.3, 0.3, 0.3)),
                               ("glass", (0.3, 0.15, 0.0), (0.3, 0.12, 0.25))):
        b.create_object(name)
        b.set_current_material(name)
        PS._box(b, origin, size)
    b.create_light("lamp", {
        "type": "arealight", "corner": (0.35, 0.35, 0.999),
        "point1": (0.35, 0.65, 0.999), "point2": (0.65, 0.35, 0.999),
        "color": (1.0, 0.9, 0.8), "power": 6.0, "samples": 1})
    b.create_light("spot", {"type": "spotlight", "from": (0.5, 0.2, 0.95),
                            "to": (0.5, 0.5, 0.0), "color": (1.0, 0.8, 0.5),
                            "power": 1.5, "cone_angle": 40.0, "blend": 0.3})
    b.create_camera("cam", {"type": "perspective",
                            "from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                            "up": (0.5, -1.35, 1.5), "resx": res,
                            "resy": res, "fov": 39.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    return b


# (table, column, row): the gradient test's parameters
GRAD_COLUMNS = (("materials", "glossy_color", 2), ("materials", "sigma", 1),
                ("materials", "blend_value", 5),
                ("lights", "color", 1), ("materials", "absorption", 6))
GRAD_RES, GRAD_BOUNCES = 8, 3


def _with(scene, values, replace):
    for (table, column, _), v in zip(GRAD_COLUMNS, values):
        tab = getattr(scene, table)
        scene = replace(scene, **{table: replace(tab, **{column: v})})
    return scene


def test_new_columns_grads_match_jax(_jax_pieces):
    js = _grad_scene(JSceneBuilder()).compile("cam")
    ts = _grad_scene(SceneBuilder()).compile("cam", device="cpu")
    pm = {"type": "pathtracing", "bounces": GRAD_BOUNCES}
    px, py, pid = _pixels(GRAD_RES, GRAD_RES)
    zero = jnp.zeros(px.shape, jnp.float32)
    jcfg = jmake_integrator(pm)

    def jloss(values):
        sc = _with(js, values, lambda x, **k: x.replace(**k))
        o, d, valid = jshoot_rays(sc.camera, px, py, zero, zero)
        return jnp.mean(jintegrate(sc, jcfg, o, d, valid, jnp.asarray(pid),
                                   jnp.uint32(0))[0])

    jvals = [getattr(getattr(js, t), c) for t, c, _ in GRAD_COLUMNS]
    want = [np.asarray(g) for g in jax.grad(jloss)(jvals)]

    leaves = [getattr(getattr(ts, t), c).clone().requires_grad_(True)
              for t, c, _ in GRAD_COLUMNS]
    sc = _with(ts, leaves, dataclasses.replace)
    o, d, valid = shoot_rays(sc.camera, T(px), T(py))
    rgb, _, _ = integrate(sc, make_integrator(pm), o, d, valid,
                       T(pid.astype(np.int64)), 0)
    got = torch.autograd.grad(rgb.mean(), leaves)
    for (t, c, row), g, w in zip(GRAD_COLUMNS, got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        assert np.abs(w[row]).max() > 0, (t, c)          # read on the paths
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-7,
                                   err_msg=f"{t}.{c}")


# ------------------------------------------------- a fault of both packages

def _moving_blocker(b):
    """A floor, and a blocker over the floor's centre at shutter open that
    has moved aside at shutter close; a point light above."""
    b.create_material("white", {"type": "shinydiffusemat"})
    b.create_object("floor")
    b.set_current_material("white")
    b.add_quad(*[b.add_vertex(*q) for q in ((0, 0, 0), (1, 0, 0),
                                            (1, 1, 0), (0, 1, 0))])
    b.create_object("blocker")
    b.set_current_material("white")
    quad = ((0.3, 0.3, 0.5), (0.7, 0.3, 0.5), (0.7, 0.7, 0.5),
            (0.3, 0.7, 0.5))
    b.add_quad(*[b.add_vertex(*q) for q in quad])
    for x, y, z in quad:
        b.add_vertex_time_step(x + 2.0, y, z)
    b.create_light("bulb", {"type": "pointlight", "from": (0.5, 0.5, 1.0)})
    b.create_camera("cam", {"type": "perspective", "from": (0.5, 0.5, 2.0),
                            "to": (0.5, 0.5, 0.0), "up": (0.5, 1.5, 2.0),
                            "resx": 8, "resy": 8})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    return b


def test_transparent_shadows_ignore_the_shutter_time():
    """The transparent-shadow walk queries the shutter-open geometry in
    both packages (the JAX package's trace_shadow passes no time to its
    shadow_hit_surface): at shutter close the binary shadow ray sees the
    blocker gone, the walk still meets it (ROADMAP section 3)."""
    js = _moving_blocker(JSceneBuilder()).compile("cam")
    ts = _moving_blocker(SceneBuilder()).compile("cam", device="cpu")
    assert ts.geom.has_motion
    p = np.asarray([[0.5, 0.5, 0.0]], np.float32)
    wi = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    dist = np.ones(1, np.float32)
    prim = np.full(1, -1, np.int32)
    args = [T(p), T(prim), T(wi), T(dist)]
    for t, binary in ((0.0, 0.0), (1.0, 1.0)):
        time = torch.full((1,), t)
        assert float(CM.trace_shadow(ts, *args, 0, time=time)[0, 0]) \
            == binary
        walked = CM.trace_shadow(ts, *args, 4, time=time).numpy()
        jwalked = np.asarray(JCM.trace_shadow(
            js, *(jnp.asarray(x) for x in (p, prim, wi, dist)), 4,
            time=jnp.full((1,), t)))
        np.testing.assert_array_equal(walked, jwalked)
        assert not walked.any()          # blocked at either time
