"""The render loop's slice against the JAX package: the AOV layers per ray,
ambient occlusion, the debug integrator, the volume parts, the layer
closure, an adaptive Gauss-filtered render, and resuming a render from its
film file.

The JAX side jits `integrate` once per integrator config for the module
(pathtracing with every layer, directlighting with AO, debug), with its
brute-force queries through its Pallas kernel in interpret mode
(`_pallas_path`, as tests/test_torch_gradients.py: the CPU scan sends a
seam ray to the other face). Both packages integrate the port's camera
rays at the pixel centres of the scenes of tests/test_torch_render.py
(the Cornell box and `_lobes`, 16x16) on the same tables.

Tolerances (worst case observed in brackets):
  * first-hit layers: every lane within rtol = atol = 1e-5 [3.0e-7];
    debug-wireframe, 1 - edge / 0.02, within 50 times that [3.7e-5];
  * accumulated layers, rgb, AO, the volume parts and the inverted index
    masks (against the JAX radiance and shadow): the slice bound, at
    least 98% of lanes within rtol = atol = 1e-4 and the mean within 1e-3
    relative (every lane within 3e-7 on these scenes);
  * the debug integrator: every lane within 1e-5;
  * the adaptive render (16x16, 3 passes, Gauss 1.5, two layers of each
    kind): the slice bound per layer; the sample counts equal on 98% of
    pixels;
  * the port against itself: the layer closure within 1e-5, a resumed
    render bit for bit, a compacted pass bit for bit against a full-image
    wavefront with the other lanes masked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import film as JF
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.render import AAParams as JAAParams
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.render import (AAParams, _render_ids,
                                         compute_resample_mask,
                                         render_pass_fn)
from libyafaray_tpu_torch.utils.logger import RenderControl
from scenes import cornell_builder, volume_emissive_builder
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path
from test_torch_render import RES, _assert_mostly_close, _lobes

BOUNCES = 3
PT = {"type": "pathtracing", "bounces": BOUNCES}
AO = {"type": "directlighting", "do_AO": True, "AO_samples": 4,
      "AO_distance": 0.6, "AO_color": (0.9, 1.0, 0.8)}
# the layers `integrate` returns: all but combined, adv-radiance (photon
# mapping only) and the flush layers, which `resolve` derives
AOV = tuple(n for n in JF.LAYER_CHANNELS
            if n not in ("combined", "adv-radiance") + JF.FLUSH_LAYERS)
FIRST_HIT = ("normal-smooth", "normal-geom", "z-depth-abs", "z-depth-norm",
             "uv", "albedo", "mat-index-abs", "obj-index-abs", "emit",
             "debug-nu", "debug-nv", "debug-dpdu", "debug-dpdv", "debug-dpdx",
             "debug-dpdy", "debug-dpdxy", "debug-dsdu", "debug-dsdv",
             "debug-barycentric-uvw", "debug-wireframe", "mist",
             "mat-index-norm", "obj-index-norm", "mat-index-auto",
             "mat-index-auto-abs", "obj-index-auto", "obj-index-auto-abs",
             "mat-index-mask", "obj-index-mask", "debug-uv",
             "debug-normal-geom", "debug-normal-smooth", "adv-diffuse-color",
             "adv-glossy-color", "adv-trans-color", "adv-subsurface-color",
             "debug-sampling-factor", "debug-dp-lengths", "debug-dudx-dvdx",
             "debug-dudy-dvdy", "debug-dudxy-dvdxy")
ACCUMULATED = tuple(n for n in AOV if n not in FIRST_HIT
                    and n not in ("ao", "ao-clay"))


def T(a):
    return torch.from_numpy(np.array(a))


def _pair(builder, res=RES):
    builder.cameras["cam"]["resx"] = builder.cameras["cam"]["resy"] = res
    js = builder.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def _rays(ts, res=RES):
    pid = np.arange(res * res)
    px = (pid % res).astype(np.float32) + 0.5
    py = (pid // res).astype(np.float32) + 0.5
    o, d, valid = shoot_rays(ts.camera, T(px), T(py))
    return o, d, valid, pid


def _both(js, ts, pm, layers, res=RES, sample=1):
    """(JAX, port) integrate of one sample of the pixel-centre rays under
    `pm` with `layers`: each (rgb, alpha, aux) as numpy."""
    o, d, valid, pid = _rays(ts, res)
    jcfg = dataclasses.replace(jmake_integrator(pm), aov_layers=layers)
    with _pallas_path():
        jout = jax.jit(lambda s, o, d, v, p, si: jintegrate(
            s, jcfg, o, d, v, p, si))(js, o.numpy(), d.numpy(),
                                      valid.numpy(), pid.astype(np.uint32),
                                      jnp.uint32(sample))
    cfg = dataclasses.replace(make_integrator(pm), aov_layers=layers)
    tout = integrate(ts, cfg, o, d, valid, T(pid), sample)
    as_np = lambda out: tuple(np.asarray(x) for x in out[:2]) + (
        {k: np.asarray(v) for k, v in out[2].items()},)
    return as_np(jout), as_np(tout)


@pytest.fixture(scope="module")
def every_layer():
    """Per scene: the JAX and port results of one pathtracing sample with
    every layer."""
    return {name: _both(*_pair(b), PT, AOV)
            for name, b in (("cornell", cornell_builder()),
                            ("lobes", _lobes(cornell_builder())))}


def _slice_bound(got, want, label):
    got = got.reshape(got.shape[0], -1)
    want = want.reshape(want.shape[0], -1)
    _assert_mostly_close(got, want)
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean()) + 1e-9, \
        label


@pytest.mark.parametrize("layer", FIRST_HIT)
@pytest.mark.parametrize("scene", ["cornell", "lobes"])
def test_first_hit_layer_matches_jax(every_layer, scene, layer):
    (_, _, jaux), (_, _, aux) = every_layer[scene]
    assert set(aux) == set(jaux) == set(AOV) - {"ao", "ao-clay"}
    tol = 50e-5 if layer == "debug-wireframe" else 1e-5
    assert aux[layer].shape == jaux[layer].shape == (
        RES * RES, JF.LAYER_CHANNELS[layer])
    np.testing.assert_allclose(aux[layer], jaux[layer], rtol=tol, atol=tol)


@pytest.mark.parametrize("layer", ACCUMULATED)
@pytest.mark.parametrize("scene", ["cornell", "lobes"])
def test_accumulated_layer_matches_jax(every_layer, scene, layer):
    (_, _, jaux), (_, _, aux) = every_layer[scene]
    assert aux[layer].shape == jaux[layer].shape
    assert np.isfinite(aux[layer]).all()
    _slice_bound(aux[layer], jaux[layer], layer)


@pytest.mark.parametrize("scene", ["cornell", "lobes"])
def test_every_layer_render_rgb_matches_jax(every_layer, scene):
    (jrgb, jalpha, jaux), (rgb, alpha, aux) = every_layer[scene]
    _slice_bound(rgb, jrgb, "rgb")
    np.testing.assert_array_equal(alpha, jalpha)
    # the layers the scene exercises are populated
    lit = {k for k, v in aux.items() if np.abs(v).sum() > 0}
    want = {"shadow", "indirect", "diffuse", "emit", "albedo",
            "diffuse-indirect", "debug-light-estimation-mat-sampling",
            "mat-index-mask-all", "obj-index-mask-shadow"}
    if scene == "lobes":
        # the mirror coat's first bounces (the red wall's transparency
        # looks out of the box into the black, so refract stays empty)
        want |= {"reflect", "adv-reflect", "adv-indirect",
                 "adv-trans-color", "adv-subsurface-color"}
    assert want <= lit, want - lit


def test_combined_alone_runs_no_layer(every_layer):
    """With no AOV layer asked for, `integrate` returns none, and the same
    radiance as with every layer."""
    js, ts = _pair(cornell_builder())
    o, d, valid, pid = _rays(ts)
    rgb, alpha, aux = integrate(ts, make_integrator(PT), o, d, valid, T(pid),
                                1)
    assert aux == {}
    np.testing.assert_array_equal(rgb.numpy(), every_layer["cornell"][1][0])


@pytest.mark.parametrize("prefix", ["mat", "obj"])
def test_inverted_index_mask_matches_jax(every_layer, prefix):
    """`layer_mask_{mat,obj}_index` and `layer_mask_invert` as parsed: the
    inverted mask layers keep the first hits whose index is not the one
    named, held against the JAX radiance and shadow of the same sample
    (slice bound)."""
    (jrgb, jalpha, jaux), _ = every_layer["cornell"]
    ids = jaux[f"{prefix}-index-abs"][:, 0]
    vals, counts = np.unique(ids[ids >= 0], return_counts=True)
    idx = int(vals[counts.argmax()])                       # the commonest
    js, ts = _pair(cornell_builder())
    o, d, valid, pid = _rays(ts)
    names = (f"{prefix}-index-mask-all", f"{prefix}-index-mask-shadow")
    cfg = dataclasses.replace(make_integrator(dict(
        PT, layer_mask_invert=True, **{f"layer_mask_{prefix}_index": idx})),
        aov_layers=names + ("shadow",))
    assert cfg.mask_invert and getattr(cfg, f"mask_{prefix}_index") == idx
    _, _, aux = integrate(ts, cfg, o, d, valid, T(pid), 1)
    keep = ((jalpha > 0) & (ids != idx))[:, None]
    assert 0 < keep.mean() < 1
    for name, src in zip(names, (jrgb, jaux["shadow"])):
        _slice_bound(aux[name].numpy(), np.where(keep, src, 0.0), name)


@pytest.fixture(scope="module")
def ao_pair():
    return _both(*_pair(_lobes(cornell_builder())), AO,
                 ("ao", "ao-clay", "shadow"))


@pytest.mark.parametrize("what", ["rgb", "ao", "ao-clay", "shadow"])
def test_ambient_occlusion_matches_jax(ao_pair, what):
    (jrgb, _, jaux), (rgb, _, aux) = ao_pair
    got, want = (rgb, jrgb) if what == "rgb" else (aux[what], jaux[what])
    _slice_bound(got, want, what)
    if what == "ao":
        assert 0.05 < want.max(-1).mean() < 1.0    # occluded and open


def test_ambient_occlusion_under_pathtracing():
    """use_ao adds its term at the first hit under every integrator kind,
    as in the JAX package: the path tracer's radiance with AO is its
    radiance without plus the AO term (albedo * ao / pi on live lanes)."""
    _, ts = _pair(cornell_builder())
    o, d, valid, pid = _rays(ts)
    pm = dict(PT, do_AO=True, AO_samples=4)
    cfg = dataclasses.replace(make_integrator(pm),
                              aov_layers=("ao", "albedo"))
    rgb, _, aux = integrate(ts, cfg, o, d, valid, T(pid), 2)
    plain, _, _ = integrate(ts, make_integrator(PT), o, d, valid, T(pid), 2)
    term = aux["ao"] * aux["albedo"] / np.pi
    assert term.max() > 0.01
    np.testing.assert_allclose(rgb.numpy(), (plain + term).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_debug_integrator_matches_jax():
    js, ts = _pair(_lobes(cornell_builder()))
    (jrgb, jalpha, jaux), (rgb, alpha, aux) = _both(
        js, ts, {"type": "debug"}, ("normal-geom",))
    assert aux == jaux == {}
    np.testing.assert_allclose(rgb, jrgb, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(alpha, jalpha)
    assert 0 < alpha.mean() <= 1 and rgb.max() > 0.5


@pytest.fixture(scope="module")
def fog_parts():
    """Config 5's fog at 8x8: the JAX and port results with the volume
    parts."""
    return _both(*_pair(volume_emissive_builder(), 8),
                 dict(PT, volume_steps=4),
                 ("adv-surface-integration", "adv-volume-integration",
                  "adv-volume-transmittance"), res=8)


@pytest.mark.parametrize("layer", ["rgb", "adv-surface-integration",
                                   "adv-volume-integration",
                                   "adv-volume-transmittance"])
def test_volume_parts_match_jax(fog_parts, layer):
    (jrgb, _, jaux), (rgb, _, aux) = fog_parts
    got, want = (rgb, jrgb) if layer == "rgb" else (aux[layer], jaux[layer])
    _slice_bound(got, want, layer)
    # the parts compose the radiance: T * surface + in-scatter
    np.testing.assert_allclose(
        aux["adv-volume-transmittance"] * aux["adv-surface-integration"]
        + aux["adv-volume-integration"], rgb, rtol=1e-5, atol=1e-6)
    assert 0 < aux["adv-volume-transmittance"].mean() < 1


def test_layer_closure_is_exact():
    """combined == radiance_d0 + env_after_d0 + indirect, per sample: the
    first-hit radiance and env of a render cut at depth 0 (the same draws
    at depth 0) plus the full render's indirect and later env."""
    b = cornell_builder()
    b.create_background({"type": "constant", "color": (0.2, 0.3, 0.4)})
    _, ts = _pair(b, 12)
    o, d, valid, pid = _rays(ts, 12)
    out = {}
    for bounces in (0, BOUNCES):
        cfg = dataclasses.replace(
            make_integrator({"type": "pathtracing", "bounces": bounces}),
            aov_layers=("env", "indirect"))
        out[bounces] = integrate(ts, cfg, o, d, valid, T(pid), 3)
    rgb, _, aux = out[BOUNCES]
    rgb0, _, aux0 = out[0]
    env_after = aux["env"] - aux0["env"]
    np.testing.assert_allclose(rgb.numpy(),
                               (rgb0 + env_after + aux["indirect"]).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert aux["indirect"].sum() > 0.1 and env_after.sum() > 0.01


AA = dict(aa_samples=2, aa_passes=3, aa_inc_samples=1, threshold=0.05,
          dark_detection_type="curve")
AA_LAYERS = ("combined", "normal-geom", "albedo", "indirect", "shadow",
             "debug-aa-samples", "debug-faces-edges")


def test_adaptive_gauss_render_matches_jax():
    """16x16, 2 + 1 + 1 samples (the later passes on flagged pixels), the
    Gauss filter of width 1.5, two layers of each kind."""
    js, ts = _pair(cornell_builder())
    pm = {"type": "pathtracing", "bounces": 2}
    kw = dict(layer_names=AA_LAYERS, flt_kind="gauss", flt_width=1.5)
    jfilm = jrender(js, jmake_integrator(pm), RES, RES,
                    aa=JAAParams(**AA), **kw)
    counts = []
    film = render(ts, make_integrator(pm), RES, RES, aa=AAParams(**AA),
                  device="cpu", progress_cb=lambda s, n: counts.append(
                      (s, n)), **kw)
    assert counts == [(1, 4), (2, 4), (3, 4), (4, 4)]
    for layer in AA_LAYERS:
        got = F.resolve(film, layer).numpy()
        want = np.asarray(JF.resolve(jfilm, layer))
        assert got.shape == want.shape and np.isfinite(got).all()
        if layer == "debug-aa-samples":
            # the later passes resampled part of the image only
            assert (np.isclose(got, want, rtol=1e-4, atol=1e-4).mean()
                    >= 0.98)
            continue
        _slice_bound(got.reshape(RES * RES, -1), want.reshape(RES * RES, -1),
                     layer)
    w = film.weights.numpy()
    assert w.min() < w.max()          # some pixels took more samples


def test_compacted_pass_equals_the_masked_full_pass():
    """The flagged ids as one short wavefront give the film of a full-image
    wavefront with the other lanes masked, bit for bit (samples keyed by
    pixel id and sample index alone, not by lane)."""
    _, ts = _pair(cornell_builder())
    cfg = dataclasses.replace(make_integrator({"type": "pathtracing",
                                               "bounces": 2}),
                              aov_layers=("normal-geom",))
    film = F.make_film(RES, RES, ("combined", "normal-geom"), "mitchell",
                       2.0, device="cpu")
    for s in range(2):
        render_pass_fn(ts, cfg, film, s)
    mask = compute_resample_mask(film, AAParams(threshold=0.1))
    assert 0 < mask.mean() < 0.5
    ids = torch.nonzero(mask.reshape(-1) > 0).squeeze(1)
    copy = lambda f: dataclasses.replace(
        f, weights=f.weights.clone(),
        layers={k: v.clone() for k, v in f.layers.items()})
    every = torch.arange(RES * RES, dtype=torch.int64)
    full = _render_ids(ts, cfg, copy(film), 2, every, mask.reshape(-1) > 0)
    compact = _render_ids(ts, cfg, copy(film), 2, ids,
                          torch.ones_like(ids, dtype=torch.bool))
    for k in full.layers:
        assert torch.equal(full.layers[k], compact.layers[k]), k
    assert torch.equal(full.weights, compact.weights)


def test_resumed_render_equals_uninterrupted(tmp_path):
    """2 + 2 samples through a saved and reloaded film equal 4 samples bit
    for bit; the node's sampling offset keys the samples."""
    _, ts = _pair(cornell_builder(), 12)
    cfg = make_integrator({"type": "pathtracing", "bounces": 2})
    kw = dict(layer_names=("combined", "indirect", "normal-geom"),
              flt_kind="gauss", flt_width=1.5, device="cpu")
    path = str(tmp_path / "r.film.npz")
    rc = RenderControl()
    render(ts, cfg, spp=2, film_path=path, film_load_save_mode="save",
           render_control=rc, **kw)
    assert rc.finished and not rc.resumed and rc.progress == 1.0
    rc = RenderControl()
    resumed = render(ts, cfg, spp=2, film_path=path,
                     film_load_save_mode="load-save", render_control=rc, **kw)
    assert rc.resumed and rc.finished
    straight = render(ts, cfg, spp=4, **kw)
    for k in straight.layers:
        assert torch.equal(resumed.layers[k], straight.layers[k]), k
    assert torch.equal(resumed.weights, straight.weights)
    assert F.load_film(path, device="cpu")[1] == 4
    # autosave every pass, and the node's offset: node 1 renders the
    # samples 100000 on
    auto = str(tmp_path / "a.film.npz")
    node = render(ts, cfg, spp=1, computer_node=1, film_path=auto,
                  film_load_save_mode="save", film_autosave_interval_passes=1,
                  **kw)
    later = render(ts, cfg, spp=1, start_sample=100_000, **kw)
    assert node.base_sampling_offset == 100_000
    for k in later.layers:
        assert torch.equal(node.layers[k], later.layers[k]), k
    assert F.load_film(auto, device="cpu")[0].computer_node == 1


def test_canceled_render_stops_between_passes():
    _, ts = _pair(cornell_builder(), 8)
    rc = RenderControl()
    seen = []

    def cancel(s, total):
        seen.append(s)
        rc.set_canceled()

    film = render(ts, make_integrator({"type": "pathtracing", "bounces": 1}),
                  spp=4, render_control=rc, progress_cb=cancel, device="cpu")
    assert seen == [1] and rc.started and not rc.finished
    assert float(film.weights.max()) <= 1.0 + 1e-6
