"""The port's public entry points against the JAX package: compile's
defaults (a scene without a background, without a camera), render views
(`create_render_view`, `compile_view`, the fixed wavelength), the C API's
render helper `capi_runtime.render_for_capi`, and the port's C API library
with its two C clients (`libyafaray_tpu_torch/native/`).

The JAX side runs its cheap pieces only: `compile`, `compile_view`,
`eval_background`, `background_pdf`, `_pad4`, and `render_for_capi` with
its `render` replaced by a recorder (so the staging of both helpers, the
integrator config, the AA params, the layer list, the film arguments and
the outputs' paths and pixels, is held without a JAX render). Images are
the port's own, on the CPU: `render_for_capi` with the "device" render
param "cpu" against `render`, bit for bit. The C clients run as their own
processes with the device "cpu" and a temporary output directory; test00's
printed numbers equal those of the same staging rendered in this process
(within 1e-6: the client prints six decimals).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import film as JF
from libyafaray_tpu import lights as JL
from libyafaray_tpu import io as jio
from libyafaray_tpu.backgrounds import eval_background as jeval_background
from libyafaray_tpu_torch import capi_build
from libyafaray_tpu_torch import capi_runtime as R
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import io as pio
from libyafaray_tpu_torch import lights as L
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.backgrounds import eval_background
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.lights import FLAG_ENABLED
from libyafaray_tpu_torch.render import AAParams
from libyafaray_tpu_torch.scene import SceneBuilder
from libyafaray_tpu_torch.scenes import capi_test00, cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401

LIGHTS = ("light_type", "position", "direction", "color", "edge1", "edge2",
          "area", "flags", "samples", "cos_start")


@pytest.fixture(scope="module")
def JR():
    """The JAX package's capi_runtime, imported with its persistent XLA
    cache switched off (it sets the cache directory when imported)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAFARAY_TPU_CACHE_DIR", "")
        from libyafaray_tpu import capi_runtime
    return capi_runtime


def _jax_scene(js):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def _no_background(b):
    b.background_params = None
    return b


# --------------------------------------------------- compile's defaults

def test_no_background_compile_matches_jax(rng):
    """The Cornell box without a background: kind "none", no background
    light and no env tables, the light table equal to the JAX compile's;
    the background radiance and the background light's pdf (the inputs of
    the escaped-ray and BDPT background strategies) zero, as in JAX."""
    js = _no_background(cornell_builder(builder=JSceneBuilder())).compile(
        "cam")
    want = _jax_scene(js)
    got = _no_background(cornell_builder()).compile("cam", device="cpu")
    assert got.background.kind == want.background.kind == "none"
    assert got.background.env_alias_prob is None
    assert got.background.env_shape == want.background.env_shape
    assert got.lights.bg_light_idx == want.lights.bg_light_idx == -1
    assert got.lights.num_lights == want.lights.num_lights
    for f in LIGHTS:
        assert torch.equal(getattr(got.lights, f), getattr(want.lights, f)), f
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_array_equal(
        eval_background(got, torch.from_numpy(d)).numpy(),
        np.asarray(jeval_background(js, jnp.asarray(d))))
    np.testing.assert_array_equal(
        L.background_pdf(got, torch.from_numpy(d)).numpy(),
        np.asarray(JL.background_pdf(js, jnp.asarray(d))))
    assert not eval_background(got, torch.from_numpy(d)).any()


@pytest.mark.parametrize("kind", ["pathtracing", "bidirectional"])
def test_no_background_renders_as_black(kind):
    """A box without a background renders, on the path tracer and on BDPT
    (whose background strategies read kind "none"), what it renders under
    a black constant background: the same image bit for bit."""
    cfg = make_integrator({"type": kind, "bounces": 3})
    imgs = []
    for b in (cornell_builder(), _no_background(cornell_builder())):
        b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 8
        imgs.append(F.resolve(render(b.compile("cam", device="cpu"), cfg,
                                     spp=1, device="cpu")))
    assert torch.equal(imgs[0], imgs[1]) and float(imgs[1].mean()) > 0


def test_no_camera_compile_fails_as_in_jax():
    """Without a camera both compiles take the default Camera, whose focal
    length is None, and fail at the pixel footprint with the same
    TypeError (ROADMAP section 3)."""
    jb = cornell_builder(builder=JSceneBuilder())
    jb.cameras.clear()
    b = cornell_builder()
    b.cameras.clear()
    with pytest.raises(TypeError) as jerr:
        jb.compile()
    with pytest.raises(TypeError) as err:
        b.compile(device="cpu")
    assert str(err.value) == str(jerr.value)


# ------------------------------------------------------------ render views

VIEWS = {
    "camera only": {"camera_name": "cam"},
    "lamp subset": {"camera_name": "top", "light_names": "lamp2 ; lamp"},
    "one light": {"light_names": "lamp2"},
    "wavelength": {"camera_name": "cam", "wavelength": 0.3},
}


def _views(b):
    """The Cornell box with a second light (an area light, so its quad
    joins the geometry), a second camera and the render views."""
    b.create_light("lamp2", {"type": "arealight", "corner": (0.1, 0.1, 0.9),
                             "point1": (0.1, 0.3, 0.9),
                             "point2": (0.3, 0.1, 0.9),
                             "color": (0.5, 0.5, 1.0), "power": 3.0})
    b.create_light("lamp3", {"type": "pointlight", "from": (0.5, 0.5, 0.5),
                             "color": (1, 1, 1), "power": 2.0,
                             "light_enabled": False})
    b.create_camera("top", {"type": "perspective", "from": (0.5, 0.5, 2.0),
                            "to": (0.5, 0.5, 0.0), "up": (0.5, 1.5, 2.0),
                            "resx": 12, "resy": 10, "fov": 45.0})
    for name, pm in VIEWS.items():
        b.create_render_view(name, pm)
    return b


@pytest.mark.parametrize("view", list(VIEWS))
def test_compile_view_matches_jax(view):
    """The view's camera, the lights' enabled flags (set on the listed
    lights, cleared on the others) and the fixed wavelength equal JAX's."""
    js = _views(cornell_builder(builder=JSceneBuilder())).compile_view(view)
    want = _jax_scene(js)
    got = _views(cornell_builder()).compile_view(view, device="cpu")
    for f in ("origin", "cam_x", "cam_y", "cam_z", "focal"):
        assert torch.equal(getattr(got.camera, f), getattr(want.camera, f)), f
    assert (got.camera.resx, got.camera.resy) == (want.camera.resx,
                                                  want.camera.resy)
    for f in LIGHTS:
        assert torch.equal(getattr(got.lights, f), getattr(want.lights, f)), f
    enabled = (got.lights.flags & FLAG_ENABLED) != 0
    if "light_names" in VIEWS[view]:
        named = {n.strip() for n in VIEWS[view]["light_names"].split(";")}
        assert enabled.tolist() == [n in named for n in
                                    ("lamp", "lamp2", "lamp3")]
    if view == "wavelength":
        assert got.fixed_wavelength.dtype == torch.float32
        assert float(got.fixed_wavelength) == float(js.fixed_wavelength) \
            == np.float32(0.3)
    else:
        assert got.fixed_wavelength is None and js.fixed_wavelength is None


def test_render_views():
    """tests/test_subsystems.py's render views on the port: a view that
    leaves out lamp2 renders darker than the whole scene (8x8)."""
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 8
    b.create_light("lamp2", {"type": "pointlight", "from": (0.5, 0.5, 0.5),
                             "color": (1, 1, 1), "power": 2.0})
    b.create_render_view("main", {"camera_name": "cam",
                                  "light_names": "lamp"})
    cfg = make_integrator({"type": "directlighting"})
    i_view = F.resolve(render(b.compile_view("main", device="cpu"), cfg,
                              spp=2, device="cpu"))
    i_all = F.resolve(render(b.compile("cam", device="cpu"), cfg, spp=2,
                             device="cpu"))
    assert i_view[..., :3].mean() < i_all[..., :3].mean()


# ------------------------------------------------------------ capi_runtime

def _capi_builder(b, views):
    b = cornell_builder(builder=b)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 8
    if views:
        b.create_camera("wide", {"type": "perspective",
                                 "from": (0.5, -1.6, 0.5),
                                 "to": (0.5, 0.5, 0.5),
                                 "up": (0.5, -1.6, 1.5), "resx": 6,
                                 "resy": 5, "fov": 45.0})
        b.create_render_view("front", {"camera_name": "cam",
                                       "light_names": "lamp"})
        b.create_render_view("wide", {"camera_name": "wide"})
    return b


def _staging(tmp_path, views):
    """(render params, outputs, layers) as a C client stages them."""
    rp = {"integrator_type": "directlighting", "integrator_do_AO": True,
          "integrator_AO_samples": 3, "raydepth": 5, "AA_minsamples": 3,
          "AA_passes": 2, "AA_inc_samples": 2, "AA_threshold": 0.02,
          "AA_dark_detection_type": "linear", "AA_pixelwidth": 1.5,
          "filter_type": "gauss", "adv_computer_node": 1,
          "device": "cpu"}
    if not views:
        rp.update(camera_name="cam", width=7, height=5)
    outputs = [("png", {"image_path": str(tmp_path / "out.png")}),
               ("depth", {"image_path": str(tmp_path / "depth"),
                          "layer": "z-depth-norm",
                          "color_space": "RawManualGamma", "gamma": 2.2}),
               ("denoised", {"image_path": str(tmp_path / "dn.hdr"),
                             "denoise_enabled": True, "denoise_mix": 0.5}),
               ("none", {"color_space": "sRGB"})]
    layers = [{"type": "z-depth-norm"}, {"type": "normal-geom"},
              {"type": "combined"}, {"type": "no-such-layer"},
              {"type": "z-depth-norm"}]
    return rp, outputs, layers


def _recorded(module, film_module, io_module, monkeypatch, b, staging,
              fields):
    """Run module.render_for_capi with `render` recording its arguments
    and returning a marker, resolve returning a fixed ramp per layer, and
    save_image recording what it writes."""
    calls, saved = [], []

    def fake_render(scene, cfg, width, height, **kw):
        calls.append((scene.camera.resx, scene.camera.resy, width, height,
                      {f: getattr(cfg, f) for f in fields},
                      dataclasses.asdict(kw.pop("aa")),
                      {k: v for k, v in kw.items()
                       if k not in ("progress_cb", "render_control",
                                    "device")},
                      np.asarray(scene.lights.flags).tolist()))
        return (width, height)

    def fake_resolve(film, name):
        w, h = film
        c = film_module.LAYER_CHANNELS[name]
        return np.linspace(0.0, 1.0, h * w * c, dtype=np.float32).reshape(
            h, w, c)

    def fake_save(path, img, color_space="sRGB", gamma=1.0):
        saved.append((path, np.asarray(img), color_space, gamma))

    monkeypatch.setattr(module, "render", fake_render)
    monkeypatch.setattr(film_module, "resolve", fake_resolve)
    monkeypatch.setattr(io_module, "save_image", fake_save)
    out = module.render_for_capi(b, *staging)
    return calls, saved, out


@pytest.mark.parametrize("views", [False, True], ids=["implicit", "views"])
def test_render_for_capi_staging_matches_jax(tmp_path, monkeypatch, JR,
                                             views):
    """The integrator staging (`integrator_*`, raydepth), the AA params,
    the layer list, the film arguments, the views and their cameras and
    light flags, the outputs' view-suffixed paths, their layers, colour
    spaces and denoised pixels, `_pad4` and the returned views equal the
    JAX helper's."""
    staging = _staging(tmp_path, views)
    fields = sorted({f.name for f in dataclasses.fields(make_integrator({}))}
                    & {f.name for f in dataclasses.fields(
                        JR.make_integrator({}))})
    got = _recorded(R, F, pio, monkeypatch,
                    _capi_builder(SceneBuilder(), views), staging, fields)
    want = _recorded(JR, JF, jio, monkeypatch,
                     _capi_builder(JSceneBuilder(), views), staging, fields)
    (gcalls, gsaved, gout), (wcalls, wsaved, wout) = got, want
    assert len(gcalls) == (2 if views else 1)
    assert gcalls == wcalls
    assert [s[0] for s in gsaved] == [s[0] for s in wsaved]
    assert len(gsaved) == 3 * len(gcalls)
    for g, w in zip(gsaved, wsaved):
        assert g[2:] == w[2:]
        np.testing.assert_array_equal(g[1], w[1])
    gviews, gcomb, *gres = gout
    wviews, wcomb, *wres = wout
    assert gres == wres and list(gviews) == list(wviews)
    for v in gviews:
        assert list(gviews[v]) == list(wviews[v]) == [
            "combined", "z-depth-norm", "normal-geom"]
        for name in gviews[v]:
            np.testing.assert_array_equal(gviews[v][name], wviews[v][name])
            assert gviews[v][name].dtype == np.float32
    np.testing.assert_array_equal(gcomb, wcomb)


@pytest.mark.parametrize("shape", [(5, 4), (5, 4, 1), (5, 4, 3), (5, 4, 4)])
def test_pad4_matches_jax(rng, JR, shape):
    img = rng.random(shape).astype(np.float32)
    got = R._pad4(torch.from_numpy(img))
    assert isinstance(got, np.ndarray) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, JR._pad4(img))
    np.testing.assert_array_equal(R._pad4(img), got)


def test_render_for_capi_equals_render(tmp_path):
    """render_for_capi on the CPU ("device" staged as "cpu"): its views,
    its combined layer and its PNG are those of `render` on the same
    builder's views."""
    rp = {"integrator_type": "pathtracing", "integrator_bounces": 2,
          "AA_minsamples": 2, "device": "cpu"}
    b = _capi_builder(SceneBuilder(), True)
    views, comb, w, h = R.render_for_capi(
        b, rp, [("png", {"image_path": str(tmp_path / "o.png")})],
        [{"type": "normal-geom"}])
    cfg = make_integrator({"type": "pathtracing", "bounces": 2})
    for view in ("front", "wide"):
        film = render(b.compile_view(view, device="cpu"), cfg,
                      aa=AAParams(aa_samples=2),
                      layer_names=("combined", "normal-geom"), device="cpu")
        for name in ("combined", "normal-geom"):
            np.testing.assert_array_equal(
                views[view][name], R._pad4(F.resolve(film, name)))
    np.testing.assert_array_equal(comb, views["front"]["combined"])
    assert (w, h) == (8, 8)
    assert (tmp_path / "o.png").exists() and (tmp_path / "o_wide.png").exists()


def test_render_for_capi_runs_on_the_card_unless_told_otherwise(
        monkeypatch):
    """Without a "device" render param the scene is compiled and rendered
    on "cuda" (recorded here, answered on the CPU)."""
    asked = []
    real_compile = SceneBuilder.compile

    def compile_(self, camera_name=None, *, device="cuda"):
        asked.append(("compile", device))
        return real_compile(self, camera_name, device="cpu")

    def render_(scene, cfg, *a, device="cuda", **kw):
        asked.append(("render", device))
        return render(scene, cfg, *a, device="cpu", **kw)

    monkeypatch.setattr(SceneBuilder, "compile", compile_)
    monkeypatch.setattr(R, "render", render_)
    b = _capi_builder(SceneBuilder(), False)
    R.render_for_capi(b, {"AA_minsamples": 1}, [], [])
    assert asked == [("compile", "cuda"), ("render", "cuda")]


def test_pass_cb_false_cancels(tmp_path):
    """A pass callback that returns False cancels the render after that
    pass: one callback, the first view only, and its image that of one
    sample."""
    seen = []

    def pass_cb(done, total, tag):
        seen.append((done, total, tag))
        return False

    b = _capi_builder(SceneBuilder(), True)
    views, comb, _, _ = R.render_for_capi(
        b, {"AA_minsamples": 3, "device": "cpu"}, [], [], pass_cb)
    assert seen == [(1, 3, "pass")]
    assert list(views) == ["front"]
    one = render(b.compile_view("front", device="cpu"),
                 make_integrator({"type": "pathtracing"}),
                 aa=AAParams(aa_samples=1), device="cpu")
    np.testing.assert_array_equal(comb, R._pad4(F.resolve(one)))


# ------------------------------------------------------------ C library

@pytest.fixture(scope="module")
def capi_dir():
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no native toolchain")
    return capi_build.build()


def test_capi_build(capi_dir):
    """The library and both clients are built once, under the package's
    ignored _build/capi/, and found again by the same hash."""
    assert os.path.dirname(capi_dir) == capi_build.BUILD_DIR
    for f in (capi_build.LIBRARY, *capi_build.CLIENTS):
        assert os.path.exists(os.path.join(capi_dir, f))
    assert capi_build.build() == capi_dir


@pytest.mark.parametrize("client", ["test00_client", "test05_client"])
def test_capi_client(capi_dir, tmp_path, client):
    r = capi_build.run_client(client, "cpu", str(tmp_path))
    assert r.returncode == 0, (r.stdout, r.stderr[-4000:])
    assert f"{client[:6]} C client OK" in r.stdout
    png = "capi_test00.png" if client == "test00_client" else \
        "capi_test05_out.png"
    assert (tmp_path / png).exists()
    if client == "test00_client":
        b, rp = capi_test00("cpu")
        _, img, w, h = R.render_for_capi(b, rp, [], [])
        assert (w, h) == (32, 32)
        want = capi_build.client_numbers(img)
        got = capi_build.parse_numbers(r.stdout)
        for k in ("mean", "left_r", "left_g"):
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
