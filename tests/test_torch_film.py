"""The film, the adaptive-AA noise detection and the image files of the port
against the JAX package.

- Reconstruction filters: `filter_weight` of every kind at widths 0.5, 1.0,
  1.5 and 2.5 against the JAX function jitted, as its render runs it, and
  `add_samples` of one sample per pixel into three layers: the weights,
  the weight sums and the splatted layers within 1e-6 relative and 1e-6 of
  the largest value (the Mitchell polynomial cancels near its zero and its
  and the Lanczos lobes are negative, so a pixel's sum can cancel too;
  worst seen 2.1e-7 of the largest): torch's exp and sin and XLA's CPU
  code may differ by an ulp, and XLA contracts the filter polynomials into
  fused multiply-adds. The taps are
  the JAX package's, in its order.
- `resolve` of each kind of layer (the normalized accumulators, the splat
  term of combined, and the flush layers, which go through the same numpy
  post-processing in both packages) equal.
- Film files: a film saved by either package loads in the other with equal
  arrays, header and offsets; `merge` and `load_all_in_folder` equal.
- `compute_resample_mask` under each criterion on the same film: the masks
  equal exactly (the JAX package computes it eagerly, op by op).
- Image files written from the same array byte for byte equal, read back
  equal; a `.png` texture compiled through both packages' builders equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import film as JF
from libyafaray_tpu import io as JIO
from libyafaray_tpu.io import exr as JEXR
from libyafaray_tpu.render import AAParams as JAAParams
from libyafaray_tpu.render import compute_resample_mask as jmask
from libyafaray_tpu.scene import SceneBuilder as JSceneBuilder
from libyafaray_tpu.textures.build import build_pool as jbuild_pool
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import io as TIO
from libyafaray_tpu_torch.io import exr as TEXR
from libyafaray_tpu_torch.render import AAParams, compute_resample_mask
from libyafaray_tpu_torch.scene import SceneBuilder
from libyafaray_tpu_torch.textures.build import build_pool
from test_torch_foundations import one_torch_thread  # noqa: F401

KINDS = ("box", "mitchell", "gauss", "lanczos")
WIDTHS = (0.5, 1.0, 1.5, 2.5)
W, H = 13, 9
LAYERS = ("combined", "normal-geom", "z-depth-abs")


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-6, atol=1e-6):
    """Within rtol of each value and atol of the largest."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


def _samples(rng):
    """One sample per pixel of a W x H film at a random position inside it
    (a render pass), every 7th lane dead, and its layer values."""
    pid = np.arange(W * H)
    px = (pid % W + rng.random(W * H)).astype(np.float32)
    py = (pid // W + rng.random(W * H)).astype(np.float32)
    weight = np.float32(np.arange(W * H) % 7 != 3)
    vals = {k: rng.uniform(0.0, 2.0, (W * H, JF.LAYER_CHANNELS[k])).astype(
        np.float32) for k in LAYERS}
    return px, py, vals, weight


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_filter_and_splat_match_jax(rng, kind, width):
    assert F._tap_offsets(kind, width) == JF._tap_offsets(kind, width)
    d = rng.uniform(-width, width, (2, 4096)).astype(np.float32)
    d[:, :3] = [[0.0, width, -width], [0.0, 0.5, -width]]
    jw = jax.jit(JF.filter_weight, static_argnums=(0, 3))(
        kind, d[0], d[1], width)
    tw = F.filter_weight(kind, T(d[0]), T(d[1]), width).numpy()
    _close(tw, jw)
    if kind != "box":
        assert np.ptp(tw) > 0.1        # the filter is not flat

    px, py, vals, weight = _samples(rng)
    jfilm = JF.make_film(W, H, LAYERS, kind, width)
    jfilm = jax.jit(JF.add_samples)(jfilm, px, py, vals, weight)
    film = F.make_film(W, H, LAYERS, kind, width, device="cpu")
    F.add_samples(film, T(px), T(py), {k: T(v) for k, v in vals.items()},
                  T(weight))
    _close(film.weights.numpy(), jfilm.weights)
    for k in LAYERS:
        _close(film.layers[k].numpy(), jfilm.layers[k])
    taps = len(F._tap_offsets(kind, width))
    # every live sample's taps inside the film carry its weight
    assert film.weights.numpy().sum() > 0
    assert taps == (1 if kind == "box" or width <= 0.5
                    else (2 * int(np.ceil(width - 0.5)) + 1) ** 2)


def _jax_film(rng, names, kind="gauss", width=1.5, splat=True):
    """A JAX film with samples in every named layer that accumulates (and a
    few pixels unrendered), and its splat accumulator filled."""
    acc = [n for n in names if n not in JF.FLUSH_LAYERS]
    pid = np.arange(W * H)
    px = (pid % W + rng.random(W * H)).astype(np.float32)
    py = (pid // W + rng.random(W * H)).astype(np.float32)
    vals = {k: rng.uniform(0, 2, (W * H, JF.LAYER_CHANNELS[k])).astype(
        np.float32) for k in acc}
    if "obj-index-abs" in vals:          # two objects, left and right
        vals["obj-index-abs"][:, 0] = pid % W >= W // 2
    film = JF.make_film(W, H, names, kind, width, computer_node=2)
    film = jax.jit(JF.add_samples)(film, px, py, vals,
                                   np.ones(W * H, np.float32))
    if splat:
        film = film.replace(
            splat=jnp.asarray(rng.random((H, W, 3)).astype(np.float32)),
            splat_paths=jnp.float32(37.0))
    return film


def _port_film(jfilm) -> F.Film:
    opt = lambda a: None if a is None else T(a)
    return F.Film(weights=T(jfilm.weights),
                  layers={k: T(v) for k, v in jfilm.layers.items()},
                  splat=opt(jfilm.splat), splat_paths=opt(jfilm.splat_paths),
                  flt_kind=jfilm.flt_kind, flt_width=jfilm.flt_width,
                  base_sampling_offset=jfilm.base_sampling_offset,
                  computer_node=jfilm.computer_node)


@pytest.mark.parametrize("layer,others", [
    ("combined", ()), ("normal-geom", ()), ("z-depth-abs", ()),
    ("debug-aa-samples", ()),
    ("debug-faces-edges", ("normal-geom",)),
    ("debug-faces-edges", ()),          # from combined without normal-geom
    ("debug-objects-edges", ("obj-index-abs",)),
    ("toon", ())])
def test_resolve_matches_jax(rng, layer, others):
    names = ("combined",) + others + ((layer,) if layer != "combined"
                                      else ())
    jfilm = _jax_film(rng, names)
    got = F.resolve(_port_film(jfilm), layer)
    want = np.asarray(JF.resolve(jfilm, layer))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if layer in JF.FLUSH_LAYERS[1:]:
        assert 0 < want.mean() < 1       # edges found, not everywhere


def _assert_films_equal(f, jf):
    np.testing.assert_array_equal(f.weights.numpy(), np.asarray(jf.weights))
    assert list(f.layers) == list(jf.layers)
    for k in jf.layers:
        np.testing.assert_array_equal(f.layers[k].numpy(),
                                      np.asarray(jf.layers[k]))
        assert f.layers[k].dtype == torch.float32
    np.testing.assert_array_equal(f.splat.numpy(), np.asarray(jf.splat))
    assert float(f.splat_paths) == float(jf.splat_paths)
    assert (f.flt_kind, f.flt_width, f.computer_node,
            f.base_sampling_offset) == (jf.flt_kind, jf.flt_width,
                                        jf.computer_node,
                                        jf.base_sampling_offset)


def test_film_files_cross_packages(rng, tmp_path):
    jfilm = _jax_film(rng, ("combined", "albedo", "z-depth-abs"))
    JF.save_film(jfilm, str(tmp_path / "j.film.npz"), sampling_offset=11)
    f, off = F.load_film(str(tmp_path / "j.film.npz"), device="cpu")
    assert off == 11
    # a loaded film's base offset is 0 in both packages (the file keeps
    # the node; the offset to resume from is the one returned)
    _assert_films_equal(f, JF.load_film(str(tmp_path / "j.film.npz"))[0])
    _assert_films_equal(f, jfilm.replace(base_sampling_offset=0))
    F.save_film(_port_film(jfilm), str(tmp_path / "t.film.npz"),
                sampling_offset=12)
    jf, joff = JF.load_film(str(tmp_path / "t.film.npz"))
    assert joff == 12
    _assert_films_equal(f, jf)
    # the same keys, dtypes and shapes in both files
    a, b = (np.load(str(tmp_path / n)) for n in ("j.film.npz", "t.film.npz"))
    assert a.files == b.files
    for k in a.files:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k


def test_merge_and_folder_match_jax(rng, tmp_path):
    jfilms = [_jax_film(rng, ("combined", "emit")) for _ in range(3)]
    _assert_films_equal(F.merge([_port_film(f) for f in jfilms]),
                        JF.merge(jfilms))
    for i, f in enumerate(jfilms):
        JF.save_film(f, str(tmp_path / f"node{i}.film.npz"),
                     sampling_offset=5 + i)
    f, off = F.load_all_in_folder(str(tmp_path), device="cpu")
    jf, joff = JF.load_all_in_folder(str(tmp_path))
    assert off == joff == 7
    _assert_films_equal(f, jf)
    with pytest.raises(FileNotFoundError):
        F.load_all_in_folder(str(tmp_path / "none"), device="cpu")


def _noisy_film(rng, unrendered=False):
    """A 32x32 film like a render's after a pass: a bright noisy half, a
    dark quadrant with small noise, a smooth region, and optionally a few
    pixels without samples."""
    h = w = 32
    img = np.full((h, w, 4), 0.5, np.float32)
    img[..., 3] = 1.0
    img[:16, :16, :3] = 0.05 + rng.uniform(-0.015, 0.015, (16, 16, 1))
    img[16:, :, :3] = rng.uniform(0.0, 1.6, (16, w, 3))
    img[:16, 16:, 0] += rng.uniform(0, 0.08, (16, 16))    # colour noise
    wts = rng.uniform(1.0, 3.0, (h, w)).astype(np.float32)
    if unrendered:
        wts[rng.random((h, w)) < 0.05] = 0.0
    comb = (img * wts[..., None]).astype(np.float32)
    jfilm = JF.make_film(w, h).replace(weights=jnp.asarray(wts),
                                       layers={"combined": jnp.asarray(comb)})
    return jfilm


@pytest.mark.parametrize("params,unrendered", [
    (dict(), False),
    (dict(dark_detection_type="linear", dark_threshold_factor=0.7), False),
    (dict(dark_detection_type="curve"), False),
    (dict(detect_color_noise=True, threshold=0.03), False),
    (dict(variance_pixels=3, variance_edge_size=10, threshold=0.1), False),
    (dict(variance_pixels=2, variance_edge_size=7, threshold=0.1), False),
    (dict(dark_detection_type="linear", dark_threshold_factor=0.5,
          variance_pixels=2, variance_edge_size=4, threshold=0.2), True),
    (dict(threshold=10.0), True)],
    ids=["flat", "linear", "curve", "color", "variance-even",
         "variance-odd", "all-unrendered", "unrendered-only"])
def test_resample_mask_matches_jax(rng, params, unrendered):
    jfilm = _noisy_film(rng, unrendered)
    want = np.asarray(jmask(jfilm, JAAParams(**params)))
    got = compute_resample_mask(_port_film(jfilm), AAParams(**params))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1
    if unrendered:
        assert (want[np.asarray(jfilm.weights) == 0] == 1).all()


def test_to_u8_matches_jax_on_a_dense_grid():
    """The sRGB encode of the writers on 2^20 + 1 values over [0, 1] (and
    past both ends): every 8-bit value equal."""
    x = np.linspace(-0.1, 1.1, (1 << 20) + 1, dtype=np.float32)
    for srgb in (True, False):
        np.testing.assert_array_equal(TIO._to_u8(x, srgb),
                                      JIO._to_u8(x, srgb))


def _image(rng, c):
    img = rng.uniform(0.0, 1.2, (7, 11, c)).astype(np.float32)
    img[0, 0] = 0.0
    img[0, 1] = 1e-4
    return img


@pytest.mark.parametrize("name,c,kw", [
    ("a.png", 3, {}), ("a.png", 4, {}),
    ("b.png", 3, dict(color_space="RawManualGamma", gamma=2.2)),
    ("c.png", 4, dict(color_space="LinearRGB")),
    ("a.ppm", 3, {}), ("a.tga", 3, {}), ("a.tga", 4, {}),
    ("a.hdr", 3, {}), ("a.exr", 4, {})])
def test_image_files_match_jax(rng, tmp_path, name, c, kw):
    img = _image(rng, c)
    if name.endswith(".hdr"):
        img *= 40.0                 # radiance well above 1
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath, tpath = str(tmp_path / "j" / name), str(tmp_path / "t" / name)
    JIO.save_image(jpath, img, **kw)
    TIO.save_image(tpath, img, **kw)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    if not name.endswith(".ppm"):
        got, want = TIO.load_image(tpath), JIO.load_image(jpath)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_multilayer_exr_matches_jax(rng, tmp_path):
    layers = {"combined": _image(rng, 4), "z-depth-abs": _image(rng, 1),
              "normal-geom": _image(rng, 3)}
    JEXR.save_exr(str(tmp_path / "j.exr"), layers, half=True)
    TEXR.save_exr(str(tmp_path / "t.exr"), layers, half=True)
    assert (tmp_path / "j.exr").read_bytes() == (tmp_path / "t.exr"
                                                 ).read_bytes()
    got = TEXR.load_exr(str(tmp_path / "t.exr"), layer="*")
    want = JEXR.load_exr(str(tmp_path / "j.exr"), layer="*")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_png_texture_compiles_as_jax(rng, tmp_path):
    """A texture named by a .png file goes through `io.load_image` in the
    port's compile, as in the JAX package's (once sRGB-decoded by the
    reader, once more by the texture's colour space, as there)."""
    path = str(tmp_path / "tex.png")
    TIO.save_png(path, rng.uniform(0, 1, (6, 10, 4)).astype(np.float32))
    pms = ({"type": "image", "filename": path},
           {"type": "image", "filename": path, "color_space": "sRGB",
            "rot90": True})
    jb, tb = JSceneBuilder(), SceneBuilder()
    for k, pm in enumerate(pms):
        jb.create_texture(f"p{k}", dict(pm))
        tb.create_texture(f"p{k}", dict(pm))
    jp, tp = jbuild_pool(jb), build_pool(tb)
    np.testing.assert_array_equal(tp.texel_pool.numpy(),
                                  np.asarray(jp.texel_pool))
    np.testing.assert_array_equal(tp.mip_offsets.numpy(),
                                  np.asarray(jp.mip_offsets))
    assert np.ptp(tp.texel_pool.numpy()) > 0.5


def test_denoise_and_postprocess_match_jax(rng):
    from libyafaray_tpu.io import postprocess as JPP
    from libyafaray_tpu_torch.io import postprocess as TPP
    img = _image(rng, 4)
    np.testing.assert_array_equal(TPP.denoise(img, hlum=8.0, mix=0.8),
                                  JPP.denoise(img, hlum=8.0, mix=0.8))
    np.testing.assert_array_equal(TPP.toon(img), JPP.toon(img))
    np.testing.assert_array_equal(TPP.sobel_edges(img, 0.2),
                                  JPP.sobel_edges(img, 0.2))


# faults of both packages, kept for parity (ROADMAP §3)

def test_a_loaded_film_drops_its_node_offset_in_both_packages(tmp_path):
    """A film of render node 1 samples from index 100000 on, but its file
    keeps only the node: loaded, its base offset is 0 in both packages, so
    a resumed node draws node 0's samples."""
    jf = JF.make_film(4, 3, computer_node=1)
    tf = F.make_film(4, 3, computer_node=1, device="cpu")
    assert jf.base_sampling_offset == tf.base_sampling_offset == 100_000
    JF.save_film(jf, str(tmp_path / "j.film.npz"))
    F.save_film(tf, str(tmp_path / "t.film.npz"))
    for got in (JF.load_film(str(tmp_path / "t.film.npz"))[0],
                F.load_film(str(tmp_path / "j.film.npz"), device="cpu")[0]):
        assert (got.computer_node, got.base_sampling_offset) == (1, 0)


def test_debug_aa_samples_is_the_filter_weight_in_both_packages(rng):
    """debug-aa-samples resolves to the weight buffer: a sample count under
    the box filter only; under the Gauss filter a sum of tap weights."""
    px, py, vals, weight = _samples(rng)
    names = ("combined", "debug-aa-samples")
    jfilm = jax.jit(JF.add_samples)(JF.make_film(W, H, names, "gauss", 1.5),
                                    px, py, {"combined": vals["combined"]},
                                    np.ones_like(weight))
    got = F.resolve(_port_film(jfilm), "debug-aa-samples").numpy()
    np.testing.assert_array_equal(got, np.asarray(
        JF.resolve(jfilm, "debug-aa-samples")))
    assert not np.allclose(got, np.round(got))    # not a count


def test_z_depth_norm_is_not_normalized_in_both_packages(rng):
    """The integrator writes the hit distance into z-depth-norm "normalized
    at flush", but resolve only divides by the weights: the layer equals
    z-depth-abs, distances past 1 included."""
    names = ("combined", "z-depth-abs", "z-depth-norm")
    jfilm = _jax_film(rng, names)
    jfilm = jfilm.replace(layers=dict(
        jfilm.layers, **{"z-depth-norm": jfilm.layers["z-depth-abs"]}))
    for resolve, film in ((JF.resolve, jfilm),
                          (F.resolve, _port_film(jfilm))):
        norm = np.asarray(resolve(film, "z-depth-norm"))
        assert norm.max() > 1.0
        np.testing.assert_array_equal(norm,
                                      np.asarray(resolve(film, "z-depth-abs")))
