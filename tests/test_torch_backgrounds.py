"""The port's backgrounds against the JAX package: `eval_background` of the
gradient, sunsky and darksky kinds over a grid of directions, the sun that
`add_sun` makes, the environment map's importance tables and sampling, and
small renders under a sky and under an environment map, both with `ibl`.

Tolerances: background radiance within rtol 1e-5 (atol 1e-7 where the sky
is clamped to 0) on every direction: the f32 acos/atan2/exp of torch and
XLA differ by an ulp or two, and nothing downstream magnifies them. The
sun's light row and the importance tables equal (the same host numpy and
f32 rounding); the alias draws equal on every lane, directions within 1e-5
(sin/cos of the same angles); the pdfs equal; the direction-to-uv maps
within 1e-6 and the environment lookups as `_assert_env_close` says.
Renders: the slice bound of
`tests/test_torch_render.py`, at least 98% of pixels within rtol = atol =
1e-4 and the image mean within 1e-3 relative.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import backgrounds as JB
from libyafaray_tpu import film as JF
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu import textures as JT
from libyafaray_tpu.params import ParamMap as JParamMap
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu_torch import SceneBuilder
from libyafaray_tpu_torch import backgrounds as B
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch import textures as TX
from libyafaray_tpu_torch.params import ParamMap
from libyafaray_tpu_torch.scenes import env_map
from test_torch_foundations import one_torch_thread  # noqa: F401

SKIES = {
    "gradient": {"type": "gradientback", "horizon_color": (0.9, 0.8, 0.7),
                 "zenith_color": (0.2, 0.4, 0.9),
                 "horizon_ground_color": (0.3, 0.25, 0.2),
                 "zenith_ground_color": (0.05, 0.05, 0.05), "power": 1.5},
    "sunsky": {"type": "sunsky", "from": (0.4, 0.3, 0.6), "turbidity": 3.0},
    "sunsky_hazy_bright": {"type": "sunsky", "from": (-0.2, 0.7, 0.2),
                           "turbidity": 6.5, "power": 2.0},
    # the sun below the horizon: the night fade
    "sunsky_night": {"type": "sunsky", "from": (0.4, 0.3, -0.15),
                     "turbidity": 3.0},
    "darksky": {"type": "darksky", "from": (0.4, 0.3, 0.6), "turbidity": 3.0,
                "altitude": 0.0, "exposure": 1.0},
    "darksky_night": {"type": "darksky", "from": (0.4, 0.3, 0.1),
                      "night": True, "bright": 1.3, "exposure": 1.0},
    "darksky_exposure": {"type": "darksky", "from": (0.1, -0.5, 0.4),
                         "turbidity": 5.0, "exposure": 1.8, "altitude": 0.2,
                         "a_var": 1.2, "b_var": 0.9, "c_var": 1.1,
                         "d_var": 0.8, "e_var": 1.3},
    "darksky_no_exposure_srgb": {"type": "darksky", "from": (0.3, 0.3, 0.5),
                                 "exposure": 0.0, "color_space": "sRGB"},
}


def T(a):
    return torch.from_numpy(np.array(a))


def _directions():
    """A 64 x 48 grid over the sphere, both poles and the horizon row
    included (below-horizon directions take the horizon's stretch)."""
    theta = np.linspace(0.0, np.pi, 48)
    phi = np.linspace(-np.pi, np.pi, 64, endpoint=False)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], -1).reshape(-1, 3)
    return d.astype(np.float32)


@pytest.mark.parametrize("name", list(SKIES))
def test_eval_background_matches(name):
    pm = SKIES[name]
    jbg = JB.make_background(JParamMap(pm))
    tbg = B.make_background(ParamMap(pm))
    assert tbg.kind == jbg.kind
    d = _directions()
    want = np.asarray(JB.eval_background(types.SimpleNamespace(
        background=jbg), jnp.asarray(d)))
    got = B.eval_background(types.SimpleNamespace(background=tbg),
                            T(d)).numpy()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    print(f"{name}: max |diff| / max {err:.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert want.max() > 0.0 and np.isfinite(got).all()
    if name == "sunsky_night":
        day = B.make_background(ParamMap(SKIES["sunsky"]))
        assert got.mean() < 0.5 * B.eval_background(
            types.SimpleNamespace(background=day), T(d)).numpy().mean()


def _open_scene(b, background, env=None):
    """A floor, a back wall and a box under `background` (either package's
    builder), seen by a 24x24 camera; with `env`, the texture "env"."""
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.7, 0.7, 0.7)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.7, 0.2, 0.1)})
    b.create_object("room")
    b.set_current_material("white")
    for quad in (((-1, -1, 0), (2, -1, 0), (2, 2, 0), (-1, 2, 0)),
                 ((-1, 1.5, 0), (2, 1.5, 0), (2, 1.5, 1), (-1, 1.5, 1))):
        b.add_quad(*[b.add_vertex(*p) for p in quad])
    b.set_current_material("red")
    box = [b.add_vertex(x, y, z) for z in (0, 0.4) for y in (0.3, 0.7)
           for x in (0.3, 0.7)]
    for q in ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
              (0, 2, 6, 4), (1, 5, 7, 3)):
        b.add_quad(*[box[i] for i in q])
    if env is not None:
        b.create_texture("env", {"type": "image"}, image=env)
    b.create_background(background)
    b.create_camera("cam", {"type": "perspective", "from": (0.5, -1.2, 0.8),
                            "to": (0.5, 0.5, 0.2), "up": (0.5, -1.2, 1.8),
                            "resx": 24, "resy": 24, "fov": 55.0})
    return b


SUN_BG = {"type": "sunsky", "from": (0.5, -0.3, 0.7), "turbidity": 4.0,
          "add_sun": True, "sun_power": 1.5, "ibl": True, "ibl_samples": 2}
ENV = env_map(32, 16, sun_deg=30.0)
ENV_BG = {"type": "textureback", "texture": "env", "ibl": True,
          "ibl_samples": 4, "rotation": 20.0, "power": 0.8}


@pytest.mark.parametrize("bg", [SUN_BG, dict(SUN_BG, type="darksky"),
                                dict(SUN_BG, add_sun=False)],
                         ids=["sunsky", "darksky", "sunsky_no_sun"])
def test_add_sun_makes_the_same_light(bg):
    js = _open_scene(JSceneBuilder(), bg).compile("cam")
    ts = _open_scene(SceneBuilder(), bg).compile("cam", device="cpu")
    jl, tl = js.lights, ts.lights
    assert (tl.num_lights, tl.bg_light_idx, tl.present_types,
            tl.samples_static) == (jl.num_lights, jl.bg_light_idx,
                                   jl.present_types, jl.samples_static)
    for f in ("light_type", "direction", "color", "flags", "samples",
              "cos_start"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    assert tl.num_lights == (2 if bg["add_sun"] else 1)


@pytest.fixture(scope="module")
def env_scenes():
    """The open scene under an environment map, compiled by each package."""
    return (_open_scene(JSceneBuilder(), ENV_BG, ENV).compile("cam"),
            _open_scene(SceneBuilder(), ENV_BG, ENV).compile("cam",
                                                             device="cpu"))


def test_build_env_tables_match(env_scenes):
    js, ts = env_scenes
    jbg, tbg = js.background, ts.background
    assert tbg.env_shape == jbg.env_shape == (16, 32)
    for f in ("env_alias_prob", "env_alias_idx", "env_pdf"):
        np.testing.assert_array_equal(getattr(tbg, f).numpy(),
                                      np.asarray(getattr(jbg, f)), err_msg=f)
    # the sun disc's texels carry most of the probability
    assert float(tbg.env_pdf.max()) > 100 * float(tbg.env_pdf.median())


def test_env_sampling_matches(env_scenes, rng):
    js, ts = env_scenes
    n = 8192
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rot = ts.background.rotation
    for jf, tf in ((JT._dir_to_equirect_uv, TX._dir_to_equirect_uv),
                   (JT._dir_to_angular_uv, TX._dir_to_angular_uv)):
        np.testing.assert_allclose(tf(T(d), rot).numpy(),
                                   np.asarray(jf(jnp.asarray(d),
                                                 js.background.rotation)),
                                   rtol=0, atol=1e-6)
    want = np.asarray(JT.sample_env(js, jnp.asarray(d), js.background))
    got = TX.sample_env(ts, T(d), ts.background).numpy()
    _assert_env_close(got, want)
    np.testing.assert_array_equal(TX.env_pdf_dir(ts, T(d)).numpy(),
                                  np.asarray(JT.env_pdf_dir(js, d)))
    u1 = rng.random(n).astype(np.float32)
    u2 = rng.random(n).astype(np.float32)
    jd, jpdf = JT.env_alias_sample(js, jnp.asarray(u1), jnp.asarray(u2))
    td, tpdf = TX.env_alias_sample(ts, T(u1), T(u2))
    np.testing.assert_array_equal(tpdf.numpy(), np.asarray(jpdf))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    # the angular mapping
    jbg = js.background.replace(mapping="angular")
    tbg = B.make_background(ParamMap(dict(ENV_BG, mapping="angular")),
                            tex_id=ts.background.tex_id)
    _assert_env_close(TX.sample_env(ts, T(d), tbg).numpy(),
                      np.asarray(JT.sample_env(js, jnp.asarray(d), jbg)))


def _assert_env_close(got, want):
    """Environment lookups: rtol 1e-5 on at least 99.9% of lanes and 1e-4
    on all: at the sun disc's rim the bilinear weights multiply the last
    bit of a uv (within 1e-6) by a texel contrast of 1,000."""
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6).all(-1).mean()
    assert close >= 0.999, close
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_env_alias_sample_mirrors_its_texel(env_scenes, rng):
    """A fault the port keeps for parity with the JAX package: the alias
    draw of texel row ty returns a direction in row h - 1 - ty (theta =
    (1 - v) pi, while the tables and `env_pdf_dir` put row 0 at the
    zenith), so the pdf it returns is the mirrored texel's."""
    _, ts = env_scenes
    h, w = ts.background.env_shape
    u1 = torch.from_numpy(rng.random(4096).astype(np.float32))
    u2 = torch.from_numpy(rng.random(4096).astype(np.float32))
    d, pdf = TX.env_alias_sample(ts, u1, u2)
    uv = TX._dir_to_equirect_uv(d, ts.background.rotation)
    row = torch.clamp(((1.0 - uv[:, 1]) * h).long(), 0, h - 1)
    col = torch.clamp((uv[:, 0] * w).long(), 0, w - 1)
    mirrored = ts.background.env_pdf[(h - 1 - row) * w + col]
    agree = torch.isclose(torch.clamp_min(mirrored, 1e-12), pdf,
                          rtol=1e-5).float().mean()
    assert float(agree) > 0.95
    assert not torch.allclose(TX.env_pdf_dir(ts, d), pdf)


@pytest.mark.parametrize("case", ["sunsky", "texture"])
def test_render_matches_jax(case, env_scenes):
    """24x24, 2 spp, 2 bounces under a sunsky with add_sun and ibl, and
    under the environment map with ibl (its importance tables), through
    both packages' `render`."""
    if case == "texture":
        js, ts = env_scenes
    else:
        js = _open_scene(JSceneBuilder(), SUN_BG).compile("cam")
        ts = _open_scene(SceneBuilder(), SUN_BG).compile("cam", device="cpu")
    cfg = {"type": "pathtracing", "bounces": 2}
    want = np.asarray(JF.resolve(jrender(js, jmake_integrator(cfg), spp=2)))
    got = F.resolve(render(ts, make_integrator(cfg), spp=2,
                           device="cpu")).numpy()
    assert np.isfinite(got).all() and got[..., :3].mean() > 0.01
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(-1).mean()
    rel = abs(got.mean() - want.mean()) / abs(want.mean())
    print(f"{case}: {close:.4f} of pixels within 1e-4, mean rel {rel:.3g}")
    assert close >= 0.98 and rel < 1e-3
