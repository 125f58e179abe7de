"""The photon-mapping integrator against the JAX package: photon
shooting (in the Cornell box and the caustic scene), the grid map's build, the flux gather, the radiance cache
and its lookup, the map files, the processing modes of `render`, the final
gather with and without fg_min_pathlen, and the adv-radiance layer.

The JAX references come from jitted JAX pieces, once per module: its
photons shot in the Cornell box (3,000 of 3 bounces), its maps built from
them, and its `integrate` at the pixel centres with its maps. The port
builds its maps from the JAX package's photon arrays where a test holds it
exactly, and integrates with the JAX package's maps where it holds an
image. The JAX side's brute-force queries go through its Pallas kernel in
interpret mode (`_pallas_path`, as tests/test_torch_gradients.py).

The grid starts one cell below the scene's least vertex, so the Cornell
box's left wall (x = 0) and floor (z = 0) lie on the boundary of the grid's
first cell. A hit there whose last bit rounds below 0 falls in the first
cell, whose clipped neighbour offsets list it twice: its photons count
double (a fault of both packages, pinned by
`test_the_grid_counts_its_edge_cells_twice`). XLA's CPU code fuses parts of
a hit position into a fused multiply-add, torch does not, so the two
packages round those walls' hits differently, and the double count falls on
different pixels. The images are therefore held on the box with a
zero-area triangle below and left of it (`_off_the_walls`), which moves
the grid's origin off the walls and changes nothing else in the scene.

Tolerances (worst case observed in brackets):
  * shooting: the deposit masks equal on every row [equal]; the positions
    of the deposits that both store within 1e-5 [2.4e-6];
  * the map build, on the same photon arrays: every field equal, the slot
    table and the counts bit for bit;
  * the gather, the radiance cache and its lookup on the same arrays:
    within 1e-5 relative to the largest value (XLA's CPU sum of the 216
    slots need not add in torch's order) [1e-7];
  * the images (rgb and adv-radiance, at the pixel centres): the slice
    bound, at least 98% of lanes within rtol = atol = 1e-4 and the mean
    within 1e-3 relative [every lane within 1e-6];
  * the port against itself: the map files and the processing modes bit
    for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu import photon as JPH
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.scene_types import PhotonData as JPhotonData
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch import photon as PH
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.scene_types import PhotonData
import scenes as JS
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path
from test_torch_render import _assert_mostly_close

RES = 12
N_PHOTONS, PM_BOUNCES, RADIUS = 3000, 3, 0.08
# the integrators at the first hit alone (the box has no specular surface
# for photon mapping to continue through): with fg_min_pathlen a near
# gather hit takes a direct estimate and bounces on (up to 2 bounces)
FG_NEAR = {"type": "photonmapping", "bounces": 0, "fg_samples": 2,
           "fg_bounces": 2, "fg_min_pathlen": 0.4}
FG_FAR = {"type": "photonmapping", "bounces": 0, "fg_samples": 2,
          "fg_min_pathlen": 0.0}
NO_FG = {"type": "photonmapping", "bounces": 0, "finalGather": False}
RENDER_PM = {"type": "photonmapping", "bounces": 1, "photons": 2000,
             "diffuseRadius": RADIUS, "fg_samples": 2, "fg_bounces": 2}


def T(a):
    return torch.from_numpy(np.array(a))


def _off_the_walls(b):
    """A zero-area triangle below and left of the box: the grid's origin
    leaves the walls (no ray can hit the triangle)."""
    b.create_object("grid_origin")
    ids = [b.add_vertex(-0.05, -0.05, -0.05) for _ in range(3)]
    b.add_triangle(*ids)
    return b


def _pair(light_kind="area", res=RES):
    jb = _off_the_walls(JS.cornell_builder(light_kind=light_kind))
    jb.cameras["cam"]["resx"] = jb.cameras["cam"]["resy"] = res
    js = jb.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def _to_port(jmap):
    return PH.map_from_numpy({f: np.asarray(getattr(jmap, f))
                              for f in PH.MAP_FIELDS})


def _bounds(js):
    v = np.asarray(js.geom.vertices)
    return v.min(0), v.max(0)


@pytest.fixture(scope="module")
def cornell():
    return _pair()


@pytest.fixture(scope="module")
def shot(cornell):
    """The JAX package's photons (3,000 of 3 bounces, seed 0) as numpy."""
    js, _ = cornell
    with _pallas_path():
        out = jax.jit(lambda s: JPH.shoot_photons(s, N_PHOTONS, PM_BOUNCES,
                                                  0))(js)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_maps(cornell, shot):
    """The JAX package's maps of `shot`: (diffuse, caustic, radiance
    cache), as make_maps builds them."""
    js, _ = cornell
    pos, dir_, pw, caus, ind, valid, nrm, alb = shot
    smin, smax = _bounds(js)
    build = jax.jit(lambda *a: JPH.build_photon_map(*a, RADIUS, smin, smax))
    dmap = build(pos, dir_, pw, valid & ind & ~caus)
    cmap = build(pos, dir_, pw, valid & caus)
    gmap = build(pos, dir_, pw, valid)
    cache = jax.jit(lambda g, *a: JPH.build_radiance_cache(
        g, *a, RADIUS, smin, smax, N_PHOTONS))(gmap, pos, nrm, alb, valid)
    return dmap, cmap, cache, gmap


def _photon_data(jax_maps):
    d, c, r, _ = jax_maps
    return (JPhotonData(diffuse=d, caustic=c, radiance=r,
                        n_emitted=N_PHOTONS),
            PhotonData(diffuse=_to_port(d), caustic=_to_port(c),
                       radiance=_to_port(r), n_emitted=N_PHOTONS))


# --------------------------------------------------------- photon shooting

def test_shooting_matches_jax(cornell, shot):
    _, ts = cornell
    got = [x.numpy() for x in PH.shoot_photons(ts, N_PHOTONS, PM_BOUNCES, 0)]
    pos, _, pw, caus, ind, valid, nrm, alb = shot
    for name, g, w in (("caustic", got[3], caus), ("indirect", got[4], ind),
                       ("valid", got[5], valid)):
        np.testing.assert_array_equal(g, w, err_msg=name)
    both = got[5] & valid
    assert both.sum() > N_PHOTONS
    for name, g, w in (("pos", got[0], pos), ("power", got[2], pw),
                       ("normal", got[6], nrm), ("albedo", got[7], alb)):
        np.testing.assert_allclose(g[both], w[both], rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_caustic_scene_shooting_matches_jax():
    """The glass caustic scene (BASELINE config 4, 8x8): photons that pass
    the glass are stored as caustics; the deposit masks equal the JAX
    package's, the positions within 1e-5, and the caustic map built from
    the JAX package's photons equal to its own."""
    jb = JS.caustic_grad_builder(8, 8)
    js = jb.compile("cam")
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    with _pallas_path():
        want = [np.asarray(x) for x in jax.jit(lambda s: JPH.shoot_photons(
            s, N_PHOTONS, PM_BOUNCES, 0))(js)]
    got = [x.numpy() for x in PH.shoot_photons(ts, N_PHOTONS, PM_BOUNCES, 0)]
    for k in (3, 4, 5):
        np.testing.assert_array_equal(got[k], want[k])
    caustic = want[5] & want[3]
    assert caustic.sum() > 50
    np.testing.assert_allclose(got[0][caustic], want[0][caustic], rtol=1e-5,
                               atol=1e-5)
    smin, smax = _bounds(js)
    jmap = jax.jit(lambda *a: JPH.build_photon_map(*a, RADIUS, smin, smax))(
        want[0], want[1], want[2], caustic)
    tmap = PH.build_photon_map(*(T(a) for a in (want[0], want[1], want[2],
                                                caustic)), RADIUS, T(smin),
                               T(smax))
    for f in ("cell_slots", "cell_counts", "num_stored"):
        np.testing.assert_array_equal(getattr(tmap, f).numpy(),
                                      np.asarray(getattr(jmap, f)))


# ----------------------------------------------------------- the map build

@pytest.mark.parametrize("which,radius", [
    ("diffuse", RADIUS), ("caustic", RADIUS), ("all", RADIUS),
    ("all", 0.3), ("all", "sqrt")],
    ids=["diffuse", "caustic", "all", "overflowing", "tensor-radius"])
def test_map_build_is_jax_exactly(cornell, shot, which, radius):
    """On the JAX package's photon arrays, every field of the port's map
    equals the JAX one: the slots (cells of 0.6 hold hundreds of photons,
    and all but 8 of each go to the dump slot) and the counts bit for bit. A
    traced radius (SPPM's sqrt(max r^2)) builds the same map as a float."""
    js, _ = cornell
    pos, dir_, pw, caus, ind, valid = shot[:6]
    mask = {"diffuse": valid & ind & ~caus, "caustic": valid & caus,
            "all": valid}[which]
    smin, smax = _bounds(js)
    r2 = np.full(4, 0.0123, np.float32)
    if radius == "sqrt":
        want = jax.jit(lambda r, *a: JPH.build_photon_map(
            *a, jnp.sqrt(jnp.max(r)), smin, smax))(r2, pos, dir_, pw, mask)
        radius = torch.sqrt(torch.amax(T(r2)))
    else:
        want = jax.jit(lambda *a: JPH.build_photon_map(*a, radius, smin,
                                                       smax))(
            pos, dir_, pw, mask)
    got = PH.build_photon_map(T(pos), T(dir_), T(pw), T(mask), radius,
                              T(smin), T(smax))
    for f in PH.MAP_FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    if radius == 0.3:
        assert np.asarray(want.cell_counts).max() > 20 * PH.MAX_PER_CELL


def test_the_grid_counts_its_edge_cells_twice():
    """A fault of both packages: the grid starts one cell below the
    scene's least vertex, and a point a rounding below that vertex falls
    in the first cell, whose neighbour offsets clip to it: a query there
    gathers the first cell's photons twice (four times at an edge of the
    grid, eight at a corner)."""
    pos = np.asarray([[-1e-7, 0.5, 0.5], [1e-7, 0.5, 0.5]], np.float32)
    dirs = np.tile(np.float32([[-1.0, 0.0, 0.0]]), (2, 1))
    pw = np.ones((2, 3), np.float32)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    build = jax.jit(lambda *a: JPH.build_photon_map(*a, 0.1, lo, hi))
    for keep, want in (([True, False], [2.0, 1.0]),
                       ([False, True], [1.0, 1.0])):
        ok = np.asarray(keep)
        jm = build(pos, dirs, pw, ok)
        tm = PH.build_photon_map(T(pos), T(dirs), T(pw), T(ok), 0.1, T(lo),
                                 T(hi))
        _, jc = jax.jit(JPH.gather_flux)(jm, pos)
        _, tc = PH.gather_flux(tm, T(pos))
        np.testing.assert_array_equal(np.asarray(jc), want)
        np.testing.assert_array_equal(tc.numpy(), want)


# ------------------------------------------------------ gather and lookup

def _close_to(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("kind", ["normal", "no-normal", "per-query-r2"])
def test_gather_flux_matches_jax(rng, cornell, shot, jax_maps, kind):
    """Flux and count at the deposits and at random points, on the JAX
    package's diffuse map (and per-query radii under the map's)."""
    dmap = jax_maps[0]
    pos, nrm = shot[0], shot[6]
    q = np.concatenate([pos[:1500], rng.uniform(-0.1, 1.1, (500, 3))
                        .astype(np.float32)])
    n = np.concatenate([nrm[:1500], np.tile(np.float32([[0, 0, 1]]),
                                            (500, 1))])
    r2 = (rng.uniform(0.2, 1.0, len(q)) * RADIUS ** 2).astype(np.float32)
    kw = dict(n_hemi=n) if kind == "normal" else (
        dict(n_hemi=n, r2=r2) if kind == "per-query-r2" else {})
    jf, jc = jax.jit(lambda m, q, **k: JPH.gather_flux(m, q, **k))(
        dmap, q, **kw)
    tf, tc = PH.gather_flux(_to_port(dmap), T(q),
                            **{k: T(v) for k, v in kw.items()})
    assert float(np.asarray(jc).sum()) > 100
    _close_to(tf.numpy(), np.asarray(jf))
    _close_to(tc.numpy(), np.asarray(jc))


def test_chunked_gather_is_the_same(monkeypatch, cornell, shot, jax_maps):
    """Queries in chunks of 7 give the whole batch's flux, count and
    lookup bit for bit."""
    dmap, cache = _to_port(jax_maps[0]), _to_port(jax_maps[2])
    q, n = T(shot[0][:600]), T(shot[6][:600])
    whole = PH.gather_flux(dmap, q, n) + (PH.lookup_radiance(cache, q, n),)
    monkeypatch.setattr(PH, "_CHUNK", 7)
    parts = PH.gather_flux(dmap, q, n) + (PH.lookup_radiance(cache, q, n),)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_radiance_cache_and_lookup_match_jax(rng, cornell, shot, jax_maps):
    """The cache built from the JAX package's map of every deposit, and
    lookups at the deposits and at random points on the walls."""
    js, _ = cornell
    pos, _, _, _, _, valid, nrm, alb = shot
    smin, smax = _bounds(js)
    gmap, jcache = jax_maps[3], jax_maps[2]
    cache = PH.build_radiance_cache(_to_port(gmap), T(pos), T(nrm), T(alb),
                                    T(valid), RADIUS, T(smin), T(smax),
                                    N_PHOTONS)
    _close_to(cache.power.numpy(), np.asarray(jcache.power))
    for f in ("cell_slots", "cell_counts", "pos", "dir", "valid"):
        np.testing.assert_array_equal(getattr(cache, f).numpy(),
                                      np.asarray(getattr(jcache, f)))
    q = rng.uniform(0.0, 1.0, (400, 3)).astype(np.float32)
    q[:200, 0] = 1.0                   # the green wall
    q[200:, 2] = 0.0                   # the floor
    n = np.zeros_like(q)
    n[:200, 0] = -1.0
    n[200:, 2] = 1.0
    q = np.concatenate([q, pos[:800]])
    n = np.concatenate([n, nrm[:800]])
    want = np.asarray(jax.jit(JPH.lookup_radiance)(jcache, q, n))
    got = PH.lookup_radiance(_to_port(jcache), T(q), T(n)).numpy()
    assert (want.max(-1) > 0).mean() > 0.5
    _close_to(got, want)


# -------------------------------------------------------------- map files

def test_map_files_cross_load(tmp_path, jax_maps):
    """A file the JAX package writes loads in the port with equal arrays,
    and the reverse."""
    jdata, tdata = _photon_data(jax_maps)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JPH.save_maps(jdata, jpath)
    loaded = PH.load_maps(jpath, device="cpu")
    PH.save_maps(tdata, tpath)
    jloaded = JPH.load_maps(tpath)
    assert loaded.n_emitted == jloaded.n_emitted == N_PHOTONS
    for prefix in ("diffuse", "caustic", "radiance"):
        for f in PH.MAP_FIELDS:
            want = np.asarray(getattr(getattr(jdata, prefix), f))
            got = getattr(getattr(loaded, prefix), f).numpy()
            back = np.asarray(getattr(getattr(jloaded, prefix), f))
            assert got.dtype == want.dtype == back.dtype, (prefix, f)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(back, want)


@pytest.fixture(scope="module")
def generated(cornell, tmp_path_factory):
    """The port's 8x8 render under photon mapping with its own maps
    ("generate-save"), and the file it wrote."""
    _, ts = cornell
    path = str(tmp_path_factory.mktemp("maps") / "maps.npz")
    img = F.resolve(render(ts, make_integrator(RENDER_PM), 8, 8, spp=1,
                           photon_maps_processing="generate-save",
                           photon_map_path=path, device="cpu"))
    return img, path


@pytest.mark.parametrize("mode", ["generate", "load", "reuse-previous",
                                  "reuse-previous-without-file"])
def test_processing_modes(cornell, generated, mode, tmp_path):
    """generate-save writes the maps it renders with (equal to make_maps'
    own); load and reuse-previous read them back (the same image bit for
    bit); generate, and reuse-previous without a file, shoot anew."""
    _, ts = cornell
    img, path = generated
    cfg = make_integrator(RENDER_PM)
    if mode == "reuse-previous-without-file":
        mode, path = "reuse-previous", str(tmp_path / "none.npz")
    got = F.resolve(render(ts, cfg, 8, 8, spp=1,
                           photon_maps_processing=mode,
                           photon_map_path=path, device="cpu"))
    assert torch.equal(got, img) and float(img[..., :3].mean()) > 0
    if mode == "generate":
        saved = PH.load_maps(generated[1], device="cpu")
        dmap, cmap, cache = PH.make_maps(ts, cfg.n_photons, cfg.pm_bounces,
                                         cfg.pm_radius, final_gather=True)
        assert saved.n_emitted == cfg.n_photons == 2000
        for have, want in ((saved.diffuse, dmap), (saved.caustic, cmap),
                           (saved.radiance, cache)):
            for f in PH.MAP_FIELDS:
                assert torch.equal(getattr(have, f), getattr(want, f)), f


def test_a_jax_map_file_renders_in_the_port(cornell, jax_maps, tmp_path):
    """render "load" of a file the JAX package wrote gives the render with
    the JAX package's maps set on the scene, bit for bit."""
    _, ts = cornell
    jdata, tdata = _photon_data(jax_maps)
    path = str(tmp_path / "jax.npz")
    JPH.save_maps(jdata, path)
    cfg = make_integrator(RENDER_PM)
    got = F.resolve(render(ts, cfg, 8, 8, spp=1,
                           photon_maps_processing="load",
                           photon_map_path=path, device="cpu"))
    want = F.resolve(render(dataclasses.replace(ts, photons=tdata), cfg, 8,
                            8, spp=1, device="cpu"))
    assert torch.equal(got, want)


# --------------------------------------------------------------- images

def _rays(ts, res=RES):
    pid = np.arange(res * res)
    o, d, valid = shoot_rays(ts.camera, T((pid % res) + 0.5).float(),
                             T((pid // res) + 0.5).float())
    return o, d, valid, pid


def _both(js, ts, jdata, tdata, pm, layers=("adv-radiance",)):
    """(JAX, port) (rgb, adv-radiance) of one sample at the pixel
    centres, each package with its copy of the same maps."""
    o, d, valid, pid = _rays(ts)
    jcfg = dataclasses.replace(jmake_integrator(pm), aov_layers=layers)
    with _pallas_path():
        jout = jax.jit(lambda s, o, d, v, p: jintegrate(
            s, jcfg, o, d, v, p, jnp.uint32(0)))(
            js.replace(photons=jdata), o.numpy(), d.numpy(), valid.numpy(),
            pid.astype(np.uint32))
    cfg = dataclasses.replace(make_integrator(pm), aov_layers=layers)
    out = integrate(dataclasses.replace(ts, photons=tdata), cfg, o, d, valid,
                    T(pid), 0)
    return ((np.asarray(jout[0]), np.asarray(jout[2]["adv-radiance"])),
            (out[0].numpy(), out[2]["adv-radiance"].numpy()))


def _slice_bound(got, want):
    assert np.isfinite(got).all() and want.mean() > 0
    _assert_mostly_close(got, want)
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()


@pytest.mark.parametrize("pm", [FG_NEAR, FG_FAR, NO_FG],
                         ids=["fg-min-pathlen", "fg-one-bounce", "no-fg"])
def test_photon_image_matches_jax(cornell, jax_maps, pm):
    """rgb and adv-radiance at the slice bound, with the JAX package's
    maps: the final gather whose near hits bounce on, the one-bounce
    final gather, and the diffuse map's estimate."""
    js, ts = cornell
    jdata, tdata = _photon_data(jax_maps)
    (jrgb, jadv), (rgb, adv) = _both(js, ts, jdata, tdata, pm)
    _slice_bound(rgb, jrgb)
    _slice_bound(adv, jadv)
    # the photon estimate adds to direct light: against directlighting
    direct = integrate(ts, make_integrator(dict(pm, type="directlighting")),
                       *_rays(ts)[:3], T(_rays(ts)[3]), 0)[0].numpy()
    assert rgb.mean() > direct.mean() * 1.05


def test_point_light_photon_image_matches_jax():
    """The box lit by a point light: the port's own photons and maps
    against the JAX package's (the deposit masks and the counts equal, the
    powers within 1e-5), and the no-final-gather image on the JAX maps at
    the slice bound."""
    js, ts = _pair("point")
    with _pallas_path():
        jm = jax.jit(lambda s: JPH.make_maps(s, N_PHOTONS, N_PHOTONS,
                                             PM_BOUNCES, RADIUS))(js)
    got = PH.make_maps(ts, N_PHOTONS, PM_BOUNCES, RADIUS)
    assert int(jm[0].num_stored) > 0 and int(jm[1].num_stored) == 0
    for have, want in zip(got[:2], jm[:2]):
        valid = np.asarray(want.valid)
        np.testing.assert_array_equal(have.valid.numpy(), valid)
        np.testing.assert_array_equal(have.cell_counts.numpy(),
                                      np.asarray(want.cell_counts))
        np.testing.assert_allclose(have.power.numpy()[valid],
                                   np.asarray(want.power)[valid], rtol=1e-5)
    jdata = JPhotonData(diffuse=jm[0], caustic=jm[1], n_emitted=N_PHOTONS)
    tdata = PhotonData(diffuse=_to_port(jm[0]), caustic=_to_port(jm[1]),
                       n_emitted=N_PHOTONS)
    (jrgb, jadv), (rgb, adv) = _both(js, ts, jdata, tdata, NO_FG)
    _slice_bound(rgb, jrgb)
    _slice_bound(adv, jadv)


def test_adv_radiance_layer_through_render(cornell, jax_maps):
    """render fills the adv-radiance layer under photon mapping (the final
    gather's estimate at the first hit), and leaves it empty under the
    path tracer."""
    _, ts = cornell
    _, tdata = _photon_data(jax_maps)
    scene = dataclasses.replace(ts, photons=tdata)
    layers = ("combined", "adv-radiance")
    film = render(scene, make_integrator(FG_NEAR), 8, 8, spp=1,
                  layer_names=layers, device="cpu")
    adv = F.resolve(film, "adv-radiance")
    assert float(adv.mean()) > 0 and torch.isfinite(adv).all()
    assert (F.resolve(film)[..., :3] >= adv - 1e-6).all()
    pt = render(scene, make_integrator({"type": "pathtracing", "bounces": 1}),
                8, 8, spp=1, layer_names=layers, device="cpu")
    assert float(F.resolve(pt, "adv-radiance").abs().max()) == 0.0
