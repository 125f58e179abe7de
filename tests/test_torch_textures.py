"""Image textures and shader nodes of the port against the JAX package: the
texel pool and its three precisions, `sample_image` for every interpolation
and wrap mode, the colour ramp and the adjustments, the node programs
(texture_mapper, value, mix, layer and bump), the primary hits'
differentials, the textured terrain (BASELINE config 3 as the bench runs
it, cut to 2048 faces and 24x24) and the gradient with respect to the texel
pool.

The JAX texture and node functions run eagerly here, as the JAX package's
own texture tests call them (each op its own computation, so XLA contracts
nothing across them); the renders and the gradient run under `jax.jit`.

Tolerances, each observed worst case in brackets:
  * texel pools equal bit for bit;
  * sampled colours within 1e-5 on every lane (2.3e-6 with the JAX side
    jitted: XLA's exp, log2 and FMA-contracted sums differ in the last
    bits; no lane tips to another texel);
  * ramps, adjustments, the node programs and the differentials within
    1e-5 (relative for the differentials, whose footprints scale with
    the hit distance);
  * bump-mapped normals within 1e-4 on at least 99% of lanes and within
    1e-2 on all (4 of 1024 lanes between 1e-4 and 1.7e-3): the bump value
    is differenced over eps = 1e-4, which scales a last-bit difference of
    the texture's value by 1e4, and the bump strength (3) by 3 more;
  * the terrain render as every slice's: at least 98% of pixels within
    rtol = atol = 1e-4, the mean within 1e-3 relative (100% observed);
  * the texel gradient against `jax.grad` within rtol 1e-3, atol 1e-7, and
    against a central finite difference of the port's own loss within
    rtol 2e-2 (the JAX package's own bound, tests/test_gradients.py:163).
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import film as JF
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.materials import bsdf as JB
from libyafaray_tpu.materials import node_eval as JNE
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu.scene import SceneBuilder as JSceneBuilder
from libyafaray_tpu.textures import eval as JE
from libyafaray_tpu.textures.build import build_pool as jbuild_pool
from libyafaray_tpu.textures.image import sample_image as jsample_image
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.materials import bsdf as B
from libyafaray_tpu_torch.materials import node_eval as NE
from libyafaray_tpu_torch.ops import surface as S
from libyafaray_tpu_torch.scene import SceneBuilder
from libyafaray_tpu_torch.scenes import bigmesh_builder as port_bigmesh
from libyafaray_tpu_torch.scenes import cornell_builder as port_cornell
from libyafaray_tpu_torch.textures import eval as E
from libyafaray_tpu_torch.textures.build import build_pool
from libyafaray_tpu_torch.textures.image import sample_image
from scenes import bigmesh_builder, cornell_builder
from test_gradients import _ray_batch
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path
from test_torch_render import _assert_mostly_close

INTERP = ("none", "bilinear", "bicubic", "mipmap_trilinear", "mipmap_ewa")
WRAP = ("repeat", "extend", "clip", "checker")
PRECISIONS = ("none", "optimized", "compressed")
N_LANES = 4096
GOLDEN = pathlib.Path(__file__).parent / "golden" / "cornell_ref_256.hdr"


def T(a):
    return torch.from_numpy(np.array(a))


def _stage_textures(b, opt):
    """One image texture per interpolation and wrap mode (20), with
    mirrored tiling, repeat counts, a crop window and a lod bias among
    them, all at the pool precision `opt`."""
    rng = np.random.default_rng(1)
    for i, interp in enumerate(INTERP):
        for j, wrap in enumerate(WRAP):
            hi = 2.0 if opt == "compressed" else 1.0   # HDR under uint8
            img = rng.uniform(0, hi, (6 + 2 * i, 8 + 3 * j, 3))
            pm = {"type": "image", "interpolate": interp, "clipping": wrap,
                  "image_optimization": opt,
                  "mirror_x": j == 0 and i % 2 == 0,
                  "mirror_y": j == 0 and i % 2 == 1,
                  "xrepeat": 1.0 + (i == 3), "yrepeat": 1.0 + 2 * (j == 3),
                  "trilinear_level_bias": 0.5 * (i == 4)}
            if wrap == "clip":
                pm.update(cropmin_x=0.1, cropmax_x=0.8, cropmin_y=0.2,
                          cropmax_y=0.9)
            b.create_texture(f"t{i}{j}", pm, image=img.astype(np.float32))
    return b


@pytest.fixture(scope="module")
def pools():
    """{precision: (JAX pool, port pool)}."""
    return {opt: (jbuild_pool(_stage_textures(JSceneBuilder(), opt)),
                  build_pool(_stage_textures(SceneBuilder(), opt)))
            for opt in PRECISIONS}


@pytest.fixture(scope="module")
def lanes():
    """Texture ids, uv over several periods and screen derivatives from
    1e-3 to 0.3 of the texture, for N_LANES lanes."""
    rng = np.random.default_rng(2)
    tid = rng.integers(0, len(INTERP) * len(WRAP), N_LANES).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (N_LANES, 2)).astype(np.float32)
    scale = 10 ** rng.uniform(-3, -0.5, (N_LANES, 1))
    dx = (rng.standard_normal((N_LANES, 2)) * scale).astype(np.float32)
    dy = (rng.standard_normal((N_LANES, 2)) * scale[::-1]).astype(np.float32)
    return tid, uv, dx, dy


@pytest.fixture(scope="module")
def sampled(pools, lanes):
    """{precision: (JAX colours, port colours)} at the lanes."""
    out = {}
    for opt, (jp, tp) in pools.items():
        want = jsample_image(jp, *(jnp.asarray(x) for x in lanes[:2]), None,
                             *(jnp.asarray(x) for x in lanes[2:]))
        got = sample_image(tp, T(lanes[0]).long(), T(lanes[1]), None,
                           T(lanes[2]), T(lanes[3]))
        out[opt] = (np.asarray(want), got.numpy())
    return out


@pytest.mark.parametrize("opt", PRECISIONS)
def test_pool_matches_jax(pools, opt):
    jp, tp = pools[opt]
    want_dtype = {"none": torch.float32, "optimized": torch.float16,
                  "compressed": torch.uint8}[opt]
    assert tp.texel_pool.dtype == want_dtype
    for name in ("texel_pool", "texel_scale", "img_offset", "img_width",
                 "img_height", "mip_offsets", "num_mips", "tex_type",
                 "params_f", "params_c", "interp", "extend", "adj"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert tp.used_interps == tuple(jp.used_interps) == (0, 1, 2, 3, 4)


def test_texture_from_an_hdr_file_matches_jax():
    """Image textures named by filename (a Radiance .hdr, the format the
    port's io reads): one sRGB-decoded, one rotated with gamma 2.2."""
    path = str(GOLDEN)
    pms = ({"type": "image", "filename": path, "color_space": "sRGB"},
           {"type": "image", "filename": path, "rot90": True,
            "gamma": 2.2})
    jb, tb = JSceneBuilder(), SceneBuilder()
    for k, pm in enumerate(pms):
        jb.create_texture(f"f{k}", dict(pm))
        tb.create_texture(f"f{k}", dict(pm))
    jp, tp = jbuild_pool(jb), build_pool(tb)
    np.testing.assert_array_equal(tp.texel_pool.numpy(),
                                  np.asarray(jp.texel_pool))
    np.testing.assert_array_equal(tp.mip_offsets.numpy(),
                                  np.asarray(jp.mip_offsets))


@pytest.mark.parametrize("interp", INTERP)
@pytest.mark.parametrize("opt", PRECISIONS)
def test_sample_image_matches_jax(sampled, lanes, opt, interp):
    """Every wrap mode of one interpolation (the lanes of its 4 textures)."""
    want, got = sampled[opt]
    mine = lanes[0] // len(WRAP) == INTERP.index(interp)
    assert mine.sum() > 500 and np.isfinite(got).all()
    np.testing.assert_allclose(got[mine], want[mine], rtol=0, atol=1e-5)
    # the clip mode's transparent black and the checker's empty tiles occur
    assert (want[mine][:, 3] == 0).any() and (want[mine][:, 3] > 0).any()


def test_sample_image_explicit_lod_matches_jax(pools, lanes):
    jp, tp = pools["none"]
    lod = np.random.default_rng(3).uniform(-1, 5, N_LANES).astype(np.float32)
    want = jsample_image(jp, jnp.asarray(lanes[0]), jnp.asarray(lanes[1]),
                         jnp.asarray(lod))
    got = sample_image(tp, T(lanes[0]).long(), T(lanes[1]), T(lod))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_color_transforms_match_jax():
    c = np.random.default_rng(4).uniform(0, 1, (1024, 3)).astype(np.float32)
    c[:8] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1], [0, 0, 0],
             [0.5, 0.5, 0.5], [1, 1, 0], [0.2, 0.9, 0.9]]
    for to_j, back_j, to_t, back_t in (
            (JE._rgb_to_hsv, JE._hsv_to_rgb, E._rgb_to_hsv, E._hsv_to_rgb),
            (JE._rgb_to_hsl, JE._hsl_to_rgb, E._rgb_to_hsl, E._hsl_to_rgb)):
        want = to_j(jnp.asarray(c))
        got = to_t(T(c))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        np.testing.assert_allclose(back_t(*got).numpy(),
                                   np.asarray(back_j(*want)), atol=1e-6)
        np.testing.assert_allclose(back_t(*got).numpy(), c, atol=2e-6)


def _stage_ramps(b):
    """Four 2x2 textures: ramps in rgb, hsv and hsl mode (2, 3 and 4
    items), and every adjustment."""
    img = np.full((2, 2, 3), 0.5, np.float32)
    items = [{"position": 0.0, "color": (1, 0, 0, 1)},
             {"position": 0.3, "color": (0.1, 0.8, 0.2, 0.5)},
             {"position": 0.7, "color": (0.2, 0.3, 0.9, 1)},
             {"position": 1.0, "color": (1, 1, 1, 1)}]
    for k, mode in enumerate(("rgb", "hsv", "hsl")):
        b.create_texture(mode, {"type": "image", "use_color_ramp": True,
                                "ramp_color_mode": mode,
                                "ramp_items": items[: k + 2]}, image=img)
    b.create_texture("adj", {"type": "image", "adj_mult_factor_red": 1.3,
                             "adj_mult_factor_blue": 0.7,
                             "adj_intensity": 1.1, "adj_contrast": 1.4,
                             "adj_saturation": 0.6, "adj_hue": 0.15,
                             "adj_clamp": True}, image=img)
    return b


@pytest.mark.parametrize("tex", ["rgb", "hsv", "hsl", "adj"])
def test_ramp_and_adjustments_match_jax(tex):
    jp = jbuild_pool(_stage_ramps(JSceneBuilder()))
    tp = build_pool(_stage_ramps(SceneBuilder()))
    np.testing.assert_array_equal(tp.ramp_col.numpy(),
                                  np.asarray(jp.ramp_col))
    rng = np.random.default_rng(5)
    k = ("rgb", "hsv", "hsl", "adj").index(tex)
    tid = np.full(2048, k, np.int32)
    inten = rng.uniform(-0.1, 1.1, 2048).astype(np.float32)
    col = rng.uniform(0, 1.2, (2048, 4)).astype(np.float32)
    if tex == "adj":
        want = JE.apply_adjustments(jp, jnp.asarray(tid), jnp.asarray(col))
        got = E.apply_adjustments(tp, T(tid).long(), T(col))
    else:
        want = JE.apply_ramp(jp, jnp.asarray(tid), jnp.asarray(inten),
                             jnp.asarray(col))
        got = E.apply_ramp(tp, T(tid).long(), T(inten), T(col))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert np.abs(got.numpy() - col).max() > 0.1      # it changed them


def test_hsl_ramp_is_true_hsl_interpolation():
    """The HSL case of tests/test_textures.py:295 on an image texture: a
    red -> white ramp read at intensity 0.5 passes through l = 0.75 (a
    muted pink), not the HSV midpoint."""
    b = port_cornell()
    b.create_texture("t", {"type": "image", "use_color_ramp": True,
                           "ramp_color_mode": "hsl",
                           "ramp_items": [
                               {"position": 0.0, "color": (1, 0, 0, 1)},
                               {"position": 1.0, "color": (1, 1, 1, 1)}]},
                     image=np.full((1, 1, 3), 0.5, np.float32))
    pool = b.compile("cam", device="cpu").textures
    tid = torch.zeros(3, dtype=torch.int64)
    col = E.apply_ramp(pool, tid, torch.tensor([0.0, 1.0, 0.5]),
                       torch.zeros(3, 4))
    np.testing.assert_allclose(col[:2, :3].numpy(), [[1, 0, 0], [1, 1, 1]],
                               atol=1e-6)
    mid = E._hsl_to_rgb(torch.tensor(0.0), torch.tensor(0.5),
                        torch.tensor(0.75))
    np.testing.assert_allclose(col[2, :3].numpy(), mid.numpy(), atol=1e-6)
    hsv_mid = E._hsv_to_rgb(torch.tensor(0.0), torch.tensor(0.5),
                            torch.tensor(1.0))
    assert (mid - hsv_mid).abs().max() > 0.1


# --- shader nodes --------------------------------------------------------

# the floor's four quads: (material, its shader nodes, its bindings)
_ROT = [[0.8, -0.6, 0, 0.1], [0.6, 0.8, 0, 0], [0, 0, 1, 0.2], [0, 0, 0, 1]]
NODE_MATS = {
    "texmap": ({"diffuse_shader": "map"},
               [{"name": "map", "type": "texture_mapper", "texture": "img",
                 "texco": "uv", "transform": _ROT, "scale": (2, 1.5, 1)}]),
    "mix": ({"diffuse_shader": "mx", "mirror_shader": "v",
             "specular_reflect": 0.1},
            [{"name": "mx", "type": "mix", "input1": "a", "input2": "v",
              "factor": "v", "blend_mode": "overlay"},
             {"name": "a", "type": "texture_mapper", "texture": "img2",
              "texco": "global", "mapping": "cube", "scale": (2, 2, 2),
              "offset": (0.1, 0, 0)},
             {"name": "v", "type": "value", "color": (0.2, 0.7, 0.1),
              "scalar": 0.3}]),
    "layer": ({"diffuse_shader": "ly", "diffuse_refl_shader": "ly"},
              [{"name": "t", "type": "texture_mapper", "texture": "img",
                "texco": "normal", "mapping": "tube", "proj_x": 2,
                "proj_y": 1, "proj_z": 3},
               {"name": "ly", "type": "layer", "input": "t",
                "upper_color": (0.3, 0.3, 0.9, 1.0), "blend_mode": "mult",
                "stencil": True, "negative": True, "colfac": 0.7,
                "do_scalar": True, "upper_value": 0.4},
               {"name": "s", "type": "texture_mapper", "texture": "img2",
                "texco": "global", "mapping": "sphere"}]),
    "bump": ({"bump_shader": "b", "diffuse_shader": "b"},
             [{"name": "b", "type": "texture_mapper", "texture": "img2",
               "texco": "global", "scale": (3, 3, 3), "bump_strength": 3.0}]),
}


def _node_scene(b):
    """The Cornell box with a floor of four quads (uv over [0, 2]^2), one
    material with shader nodes each; 24x24."""
    rng = np.random.default_rng(6)
    b.create_texture("img", {"type": "image"},
                     image=rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    b.create_texture("img2", {"type": "image", "interpolate": "bicubic",
                              "mirror_x": True},
                     image=rng.uniform(0, 1, (8, 8, 3)).astype(np.float32))
    for name, (binds, nodes) in NODE_MATS.items():
        b.create_material(name, dict(type="shinydiffusemat",
                                     color=(0.5, 0.5, 0.5), **binds),
                          node_list=nodes)
    b.create_object("tiles")
    for k, name in enumerate(NODE_MATS):
        b.set_current_material(name)
        x0, y0 = 0.5 * (k % 2), 0.5 * (k // 2)
        vs = [b.add_vertex(x0 + dx, y0 + dy, 0.01)
              for dx, dy in ((0, 0), (0.5, 0), (0.5, 0.5), (0, 0.5))]
        us = [b.add_uv(2 * (x0 + dx), 2 * (y0 + dy))
              for dx, dy in ((0, 0), (0.5, 0), (0.5, 0.5), (0, 0.5))]
        b.add_quad(*vs, uv=us)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 24
    return b


@pytest.fixture(scope="module")
def node_scene():
    """(JAX scene, converted port scene, the port's own compile, the JAX
    surface points of 1024 rays from the camera to the floor (with their
    differentials), the rays' directions)."""
    js = _node_scene(cornell_builder()).compile("cam")
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    own = _node_scene(port_cornell()).compile("cam", device="cpu")
    rng = np.random.default_rng(7)
    n = 1024
    o = np.tile(np.asarray(js.camera.origin, np.float32), (n, 1))
    target = np.concatenate([rng.uniform(0.02, 0.98, (n, 2)),
                             np.full((n, 1), 0.01)], 1).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    @jax.jit
    def surface(s, o, d):
        hit = JI.closest_hit(s, o, d, s.ray_min_dist, 1e30)
        return JS.compute_differentials(s, JS.make_surface(s, hit, o, d), d)
    return js, ts, own, surface(js, o, d), d


def _port_sp(jsp):
    return S.SurfacePoint(**{f.name: T(getattr(jsp, f.name))
                             for f in dataclasses.fields(S.SurfacePoint)})


def test_node_program_compiles_as_jax(node_scene):
    js, ts, own, _, _ = node_scene
    assert own.nodes.meta == ts.nodes.meta and own.nodes.imeta == ts.nodes.imeta
    assert own.nodes.has_bump and own.nodes.bound == ts.nodes.bound
    for name in ("node_type", "tex_id", "const_a", "const_b", "const_fac",
                 "params_f", "params_i"):
        np.testing.assert_array_equal(getattr(own.nodes, name).numpy(),
                                      np.asarray(getattr(js.nodes, name)),
                                      err_msg=name)
    for name in ("node_diffuse", "node_bump", "node_mirror_strength",
                 "node_diffuse_reflect"):
        np.testing.assert_array_equal(getattr(own.materials, name).numpy(),
                                      np.asarray(getattr(js.materials, name)))
    np.testing.assert_array_equal(own.textures.texel_pool.numpy(),
                                  np.asarray(js.textures.texel_pool))


@pytest.fixture(scope="module")
def programs(node_scene):
    """Both packages' node programs at the floor's surface points."""
    js, ts, _, jsp, _ = node_scene
    want = JNE.run_program(js, jsp)
    got = NE.run_program(ts, _port_sp(jsp))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("node", ["texture_mapper", "value", "mix", "layer"])
def test_node_program_matches_jax(node_scene, programs, node):
    js = node_scene[0]
    types = {"texture_mapper": 0, "value": 1, "mix": 2, "layer": 3}
    slots = [i for i, m in enumerate(js.nodes.meta) if m[0] == types[node]]
    (want_c, want_v), (got_c, got_v) = programs
    assert slots and got_c.shape == want_c.shape
    np.testing.assert_allclose(got_c[:, slots], want_c[:, slots], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_v[:, slots], want_v[:, slots], rtol=0,
                               atol=1e-5)
    assert np.ptp(got_c[:, slots]) > 0.1 or node == "value"


def test_bump_matches_jax(node_scene):
    js, ts, _, jsp, _ = node_scene
    want = JNE.eval_bump(js, jsp)
    got = NE.eval_bump(ts, _port_sp(jsp))
    bumped = np.asarray(js.materials.node_bump)[np.asarray(jsp.mat_id)] >= 0
    assert 40 < bumped.sum() < 1000
    for name in ("n", "nu", "nv"):
        err = np.abs(getattr(got, name).numpy()
                     - np.asarray(getattr(want, name))).max(-1)
        assert (err <= 1e-4).mean() >= 0.99 and err.max() <= 1e-2, name
    tilt = np.abs(got.n.numpy() - np.asarray(jsp.n)).max(-1)
    assert (tilt[bumped] > 1e-3).mean() > 0.5 and tilt[~bumped].max() == 0


def test_resolve_mp_overrides_match_jax(node_scene):
    js, ts, _, jsp, _ = node_scene
    want = JB.resolve_mp(js, jsp)
    got = B.resolve_mp(ts, _port_sp(jsp))
    for name in ("diffuse_color", "specular_refl", "diffuse_reflect",
                 "emit_color", "transparency"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    base = B.gather_mp(ts.materials, T(jsp.mat_id))
    assert (got.diffuse_color - base.diffuse_color).abs().max() > 0.1
    # emit_color is no node channel: emit's plain gather is what it reads
    assert torch.equal(got.emit_color, base.emit_color)


def test_compute_differentials_matches_jax(node_scene):
    js, ts, _, jsp, d = node_scene
    sp = _port_sp(jsp)
    bare = dataclasses.replace(sp, dp_dx=None, dp_dy=None, duv_dx=None,
                               duv_dy=None)
    got = S.compute_differentials(ts, bare, T(d))
    for name in ("dp_dx", "dp_dy", "duv_dx", "duv_dy"):
        want = np.asarray(getattr(jsp, name))
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(getattr(got, name).numpy(), want,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


# --- the slice -----------------------------------------------------------

def test_textured_terrain_render_matches_jax():
    """BASELINE config 3 as the bench runs it (the image-textured terrain),
    cut to 2048 faces and 24x24, 1 spp, 2 bounces, through both packages'
    render(); the port's own compile renders the converted scene's image."""
    res = 24
    b = bigmesh_builder(33, textured=True)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    js = b.compile("cam")
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    assert ts.accel_kind == "blocks" and ts.nodes.bound == ("node_diffuse",)
    cfg = {"type": "pathtracing", "bounces": 2}
    want = np.asarray(JF.resolve(jrender(js, jmake_integrator(cfg), res, res,
                                         spp=1)))
    img = F.resolve(render(ts, make_integrator(cfg), spp=1,
                           device="cpu")).numpy()
    assert img.shape == want.shape == (res, res, 4)
    assert np.isfinite(img).all()
    _assert_mostly_close(img.reshape(-1, 4), want.reshape(-1, 4))
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    ob = port_bigmesh(33, textured=True)
    ob.cameras["cam"]["resx"] = ob.cameras["cam"]["resy"] = res
    own = F.resolve(render(ob.compile("cam", device="cpu"),
                           make_integrator(cfg), spp=1, device="cpu"))
    np.testing.assert_array_equal(own.numpy(), img)
    # the texture shows: the untextured terrain differs on covered pixels
    ub = port_bigmesh(33, textured=False)
    ub.cameras["cam"]["resx"] = ub.cameras["cam"]["resy"] = res
    bare = F.resolve(render(ub.compile("cam", device="cpu"),
                            make_integrator(cfg), spp=1, device="cpu"))
    covered = img[..., 3] > 0
    changed = np.abs(bare.numpy() - img)[..., :3].max(-1) > 1e-2
    assert changed[covered].mean() > 0.5 and not changed[~covered].any()


@pytest.fixture(scope="module")
def texel_grads():
    """The texel gradient of mean(rgb) over the 8x8 rays of
    tests/test_gradients.py::test_grad_texture_texels (bigmesh_builder(10),
    162 faces, 1 bounce), by jax.grad (its brute-force queries through the
    Pallas kernel in interpret mode, the path the port's plain version
    follows) and by the port's autograd; with the port's loss."""
    js = bigmesh_builder(10, textured=True).compile("cam")
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    o, d, valid, pid = (np.asarray(x) for x in _ray_batch(js, span=720))
    jcfg = jmake_integrator({"type": "pathtracing", "bounces": 1})

    def jloss(pool):
        sc = js.replace(textures=js.textures.replace(texel_pool=pool))
        rgb, _, _ = jintegrate(sc, jcfg, o, d, valid, pid, jnp.uint32(0))
        return jnp.mean(rgb)

    with _pallas_path():
        want = np.asarray(jax.jit(jax.grad(jloss))(js.textures.texel_pool))
    cfg = make_integrator({"type": "pathtracing", "bounces": 1})
    rays = (T(o), T(d), T(valid), T(pid.astype(np.int64)))

    def loss(pool):
        sc = dataclasses.replace(ts, textures=dataclasses.replace(
            ts.textures, texel_pool=pool))
        rgb, _, _ = integrate(sc, cfg, *rays, 0)
        return rgb.mean()

    leaf = ts.textures.texel_pool.clone().requires_grad_(True)
    got, = torch.autograd.grad(loss(leaf), leaf)
    return got.numpy(), want, loss, ts.textures.texel_pool


def test_texel_gradient_matches_jax_grad(texel_grads):
    got, want, _, pool = texel_grads
    assert pool.shape[0] > 4096      # the plain gather's backward, as JAX
    mag = np.abs(want[:, :3]).sum(-1)
    assert (mag > 1e-6).sum() >= 4 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-7)


def test_texel_gradient_matches_finite_difference(texel_grads):
    got, _, loss, pool = texel_grads
    mag = np.abs(got[:, :3]).sum(-1)
    t = int(np.argmax(mag))
    c = int(np.argmax(np.abs(got[t, :3])))
    e = 1e-2
    up, down = pool.clone(), pool.clone()
    up[t, c] += e
    down[t, c] -= e
    with torch.no_grad():
        fd = (float(loss(up)) - float(loss(down))) / (2 * e)
    assert float(got[t, c]) == pytest.approx(fd, rel=2e-2, abs=1e-7)
