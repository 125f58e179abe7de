"""The rest of the volume path of the port against the JAX package: every
region type's table, density and sigma_st (`volume_regions_builder`:
exponential, noise, grid and sky regions in config 5's room, and a scene
of grids of two sizes); the march toward the lights (`light_tau`), the
attenuation grid of "optimize" and its lookup; `in_scatter` with adaptive
substeps, and JAX's own error-ratio check of them (tests/test_subsystems.py
::test_single_scatter_adaptive_substeps) on the port; the emission
integrator; the sky integrator's coefficients, its Mie table
interpolation at every knot, its transmittance and in-scattering; and a
16x16 render under each volume-integrator arm.

The JAX volume functions run eagerly or jitted whole where they are small;
the renders integrate the port's camera rays in both packages with the
JAX package's surface, light and BSDF pieces jitted and its brute-force
queries through the Pallas kernel in interpret mode, as
tests/test_torch_materials_slice.py does.

Tolerances, each observed worst case in brackets:
  * tables equal, tensors bit for bit;
  * densities, sigma_st and the emission integrator within rtol 1e-4 (exp
    and pow) plus atol 1e-6 [3.0e-7 relative; the noise, grid and sky
    regions equal];
  * light_tau, the attenuation grid and its lookup within rtol 1e-4 plus
    atol 1e-6 [4.0e-7 relative];
  * in_scatter with substeps, every lane within rtol = atol = 1e-4 [7e-9
    absolute];
  * the Mie interpolation equal to jnp.interp on every knot and every
    lane; the sky's transmittance and in-scattering within rtol 1e-4 plus
    atol 1e-7 [4.2e-7 relative];
  * renders: at least 98% of pixels within rtol = atol = 1e-4 and the
    mean within 1e-3 relative (the slice bound) [every pixel within
    3.0e-7 under every arm].
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import lights as JL
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu import volumes as JV
from libyafaray_tpu.integrators import volume as JVI
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.materials import bsdf as JB
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu_torch import make_integrator
from libyafaray_tpu_torch import volumes as V
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators import volume as VI
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.ops import intersect as I
from libyafaray_tpu_torch.scenes import (cornell_builder, density_grid,
                                         volume_regions_builder)
from scenes import cornell_builder as jcornell_builder
from test_torch_caustic import _equal_tables
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path
from test_torch_render import _assert_mostly_close

KINDS = ("exp", "noise", "grid", "sky")
RES = 16
STEPS = 4


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def regions():
    """{kind: (JAX scene, the port's scene)} of volume_regions_builder."""
    return {k: (volume_regions_builder(k, RES, builder=JSceneBuilder())
                .compile("cam"),
                volume_regions_builder(k, RES).compile("cam", device="cpu"))
            for k in KINDS}


def _points(rng, n=2048):
    """Points in the room and a little outside the regions' box."""
    return rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)


# ----------------------------------------------------------------- regions

@pytest.mark.parametrize("kind", KINDS)
def test_region_tables_match_jax(regions, kind):
    js, ts = regions[kind]
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    for table in ("geom", "materials", "lights", "volumes", "textures"):
        if getattr(ts, table) is None:
            assert getattr(want, table) is None
            continue
        _equal_tables(getattr(ts, table), getattr(want, table))
    assert ts.volumes.kinds == (V._VOL_BY_NAME[
        {"exp": "ExpDensityVolume", "noise": "NoiseVolume",
         "grid": "GridVolume", "sky": "SkyVolume"}[kind]],)


@pytest.mark.parametrize("kind", KINDS)
def test_region_density_matches_jax(rng, regions, kind):
    """density and sigma_st at 2,048 points; the densities vary inside the
    box (but the sky's, which is 1 as in the JAX package) and are 0
    outside it."""
    js, ts = regions[kind]
    p = _points(rng)
    dens = V.density(ts, T(p)).numpy()
    _close(dens, JV.density(js, jnp.asarray(p)))
    for g, w in zip(V.sigma_st(ts, T(p)), JV.sigma_st(js, jnp.asarray(p))):
        _close(g.numpy(), w)
    inside = ((p >= 0) & (p <= 1)).all(-1)
    assert (dens[~inside] == 0).all()
    if kind == "sky":
        assert (dens[inside] == 1).all()
    else:
        assert dens[inside].std() > 0.05 and dens[inside].max() > 0.2


def _grids(b):
    """Two grid regions of different sizes (16^3 and 8x4x12) and one
    without grid_data, in the Cornell box."""
    b = b
    small = np.random.default_rng(2).random((8, 4, 12)).astype(np.float32)
    for name, grid, lo in (("a", density_grid(16, 3), 0.0),
                           ("b", small, 0.5), ("c", None, 0.2)):
        pm = {"type": "GridVolume", "minX": lo, "minY": lo, "minZ": lo,
              "maxX": lo + 0.5, "maxY": lo + 0.5, "maxZ": lo + 0.5}
        if grid is not None:
            pm["grid_data"] = grid
        b.create_volume_region(name, pm)
    return b


def test_grid_pool_pads_and_scales_as_jax(rng):
    """Grids of several sizes share one zero-padded pool and each lookup
    scales to the pool's size (a fault of both packages, ROADMAP section
    3): the small grid's far corner reads the padding's zeros, not its own
    last voxel. A region without grid_data reads grid 0."""
    js = _grids(jcornell_builder()).compile("cam")
    ts = _grids(cornell_builder()).compile("cam", device="cpu")
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    _equal_tables(ts.volumes, want.volumes)
    assert tuple(ts.volumes.grids.shape) == (2, 16, 16, 16)
    p = _points(rng)
    _close(V.density(ts, T(p)).numpy(), JV.density(js, jnp.asarray(p)))
    corner = V.density(ts, torch.tensor([[0.999, 0.999, 0.999]])).numpy()
    assert corner[0, 1] == 0.0
    np.testing.assert_allclose(
        V.density(ts, torch.tensor([[0.2, 0.2, 0.2]])).numpy()[0, 2],
        ts.volumes.grids[0, 0, 0, 0].numpy(), rtol=1e-6)


# ------------------------------------------------ march toward the lights

def test_light_tau_and_attenuation_grid_match_jax(rng, regions):
    """light_tau toward each light, the 36^3 grid per light built from it
    over all of lights.position (for the mesh light that column is 0, so
    its grid marches toward the origin, in both packages: ROADMAP section
    3), and the trilinear lookup."""
    js, ts = regions["exp"]
    p = _points(rng, 1024)
    lp = np.asarray(ts.lights.position)[np.arange(1024) % 2]
    _close(VI.light_tau(ts, T(p), T(lp)).numpy(),
           JVI.light_tau(js, jnp.asarray(p), jnp.asarray(lp)))
    grid = VI.build_attenuation_grid(ts)
    jatten, jbmin, jbmax = jax.jit(JVI.build_attenuation_grid)(js)
    assert tuple(grid.atten.shape) == (2, 36, 36, 36, 3)
    _close(grid.atten.numpy(), jatten)
    _close(grid.bmin.numpy(), jbmin, rtol=0, atol=0)
    li = (np.arange(1024) % 2).astype(np.int32)
    _close(VI.lookup_attenuation(grid, T(p), T(li)).numpy(),
           JVI.lookup_attenuation((jnp.asarray(grid.atten.numpy()), jbmin,
                                   jbmax), jnp.asarray(p), jnp.asarray(li)))
    # the mesh light's row: exp(-tau) toward the origin
    cell = torch.tensor([[0.5 / 36 * 31, 0.5, 0.5]])
    np.testing.assert_allclose(
        VI.lookup_attenuation(grid, cell, torch.tensor([1])).numpy(),
        torch.exp(-VI.light_tau(ts, cell, torch.zeros(1, 3))).numpy(),
        rtol=2e-2)


# -------------------------------------------------------------- in_scatter

def _camera_segments(ts, rng, n=128):
    px, py = (T(rng.random(n).astype(np.float32) * RES) for _ in range(2))
    o, d, _ = shoot_rays(ts.camera, px, py)
    t_hit = I.closest_hit(ts, o, d, ts.ray_min_dist, 1e30).t
    pid = T(rng.integers(0, RES * RES, n))
    return o, d, t_hit, pid


def _jargs(o, d, t_hit, pid):
    return [jnp.asarray(x.numpy()) for x in (o, d, t_hit)] + [
        jnp.asarray(pid.numpy().astype(np.uint32)), jnp.uint32(3)]


@pytest.mark.parametrize("kind", ["exp", "grid"])
def test_in_scatter_substeps_match_jax(rng, regions, kind):
    """in_scatter with 4 steps of 4 substeps on 128 camera segments."""
    js, ts = regions[kind]
    o, d, t_hit, pid = _camera_segments(ts, rng)
    got = VI.in_scatter(ts, o, d, t_hit, pid, 3, steps=STEPS, substeps=4)
    with _pallas_path():
        want = JVI.in_scatter(js, *_jargs(o, d, t_hit, pid), STEPS,
                              substeps=4)
    assert float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _slab(builder):
    """tests/test_subsystems.py's scene: a thin dense grid slab (z bin 7 of
    16 at density 8) in the Cornell box lit by a point light."""
    g = np.zeros((16, 16, 16), np.float32)
    g[7:8, :, :] = 8.0
    b = builder()
    b.create_light("lamp", {"type": "pointlight", "from": (0.5, 0.5, 0.9),
                            "color": (1.0, 0.9, 0.8), "power": 1.0})
    b.create_volume_region("fog", {
        "type": "GridVolume", "grid_data": g, "sigma_s": 0.6,
        "sigma_a": 0.4, "g": 0.0, "minX": 0.0, "maxX": 1.0, "minY": 0.0,
        "maxY": 1.0, "minZ": 0.0, "maxZ": 1.0})
    return b


def test_adaptive_substeps_error_ratio():
    """The JAX package's own check on the port: 4 coarse steps with 32
    density substeps track a 128-step march at least 5x better than the
    same 4 steps without substeps (the coarse midpoints miss the slab)."""
    ts = _slab(cornell_builder).compile("cam", device="cpu")
    n = 64
    o = torch.from_numpy(np.stack([np.linspace(0.2, 0.8, n),
                                   np.full(n, 0.5), np.full(n, 0.02)],
                                  -1).astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    t_hit = torch.full((n,), 0.95)
    pid = torch.arange(n, dtype=torch.int64)
    args = (ts, o, d, t_hit, pid, 0)
    fine = VI.in_scatter(*args, steps=128).numpy()
    coarse = VI.in_scatter(*args, steps=4).numpy()
    adapt = VI.in_scatter(*args, steps=4, substeps=32).numpy()
    err_c = np.abs(coarse - fine).mean()
    err_a = np.abs(adapt - fine).mean()
    assert np.isfinite(adapt).all()
    assert err_a < 0.2 * err_c, (err_a, err_c)


def test_emission_integrator_matches_jax(rng, regions):
    """apply_volumetric under the EmissionIntegrator: the regions' emission
    (l_e 0.5 on the exponential fog) over the segment, attenuated."""
    js = volume_regions_builder("exp", RES, builder=JSceneBuilder(),
                                emit=0.5).compile("cam")
    ts = volume_regions_builder("exp", RES, emit=0.5).compile("cam",
                                                              device="cpu")
    o, d, t_hit, pid = _camera_segments(ts, rng)
    pm = {"type": "pathtracing", "volume_integrator": "EmissionIntegrator",
          "volume_steps": STEPS}
    radiance = T(rng.random((len(pid), 3)).astype(np.float32))
    got = VI.apply_volumetric(ts, make_integrator(pm), radiance, o, d,
                              t_hit, pid, 3)
    want = JVI.apply_volumetric(js, jmake_integrator(pm),
                                jnp.asarray(radiance.numpy()),
                                *_jargs(o, d, t_hit, pid))
    _close(got.numpy(), want)
    em = VI.emission(ts, o, d, t_hit, STEPS)
    assert float(em.min()) >= 0 and float(em.max()) > 0.01


# --------------------------------------------------------------------- sky

def test_sky_coeffs_match_jax():
    for alpha, turb in ((0.5, 3.0), (1.2, 2.0), (0.1, 8.0)):
        assert VI.sky_coeffs(alpha, turb) == JVI.sky_coeffs(alpha, turb)


def test_mie_interpolation_equals_jnp_interp(rng):
    """The jnp.interp counterpart over the Mie table: equal on every knot
    (0, 1, 4, ..., 180 degrees), just off each knot, outside the table and
    on random angles."""
    xp, fp = VI._MIE_DEG, VI._MIE_VAL
    x = np.concatenate([xp, np.nextafter(xp, -np.inf, dtype=np.float32),
                        np.nextafter(xp, np.inf, dtype=np.float32),
                        [-5.0, 200.0],
                        rng.uniform(0, 180, 4096)]).astype(np.float32)
    got = VI.interp(T(x), T(xp), T(fp)).numpy()
    want = np.asarray(jnp.interp(jnp.asarray(x), JVI._MIE_DEG,
                                 JVI._MIE_VAL))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:len(xp) - 1], fp[:-1])


@pytest.fixture(scope="module")
def sky():
    """(JAX scene, the port's scene) of the Cornell box under a constant
    background, as tests/test_subsystems.py::test_sky_integrator_atmosphere
    sets it up."""
    def build(b):
        b.create_background({"type": "constant", "color": (2.0, 2.0, 2.5)})
        b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
        return b
    return (build(jcornell_builder()).compile("cam"),
            build(cornell_builder()).compile("cam", device="cpu"))


SKY_PM = {"type": "directlighting", "volume_integrator": "SkyIntegrator",
          "alpha": 0.5, "turbidity": 3.0, "sigma_t": 0.4}


def test_sky_transmittance_and_in_scatter_match_jax(rng, sky):
    js, ts = sky
    cfg, jcfg = make_integrator(SKY_PM), jmake_integrator(SKY_PM)
    assert (cfg.sky_alpha, cfg.sky_turbidity, cfg.sky_scale) == (
        jcfg.sky_alpha, jcfg.sky_turbidity, jcfg.sky_scale)
    o, d, t_hit, pid = _camera_segments(ts, rng, 512)
    t_hit[3::11] = -1.0          # no hit: the 1000-unit default segment
    jargs = _jargs(o, d, t_hit, pid)
    _close(VI.sky_transmittance(cfg, o, d, t_hit).numpy(),
           JVI.sky_transmittance(jcfg, *jargs[:3]), atol=1e-7)
    got = VI.sky_in_scatter(ts, cfg, o, d, t_hit, pid, 3).numpy()
    _close(got, JVI.sky_in_scatter(js, jcfg, *jargs), atol=1e-7)
    assert got.min() >= 0 and got.max() > 1e-4


def test_sky_in_scatter_of_escaping_rays_is_nan(sky):
    """A fault of both packages (ROADMAP section 3): integrate leaves a
    camera ray that hits nothing at t = 1e30, which is > 0, so the sky
    integrator marches 1e30 units instead of its 1000-unit default. On a
    ray that points down, exp(-alpha (h0 + pos cos_t)) overflows to inf
    while the transmittance is 0: NaN (the Cornell box is closed, so its
    renders have no such ray)."""
    js, ts = sky
    cfg, jcfg = make_integrator(SKY_PM), jmake_integrator(SKY_PM)
    o = torch.tensor([[0.5, -1.35, 0.5]] * 2)
    d = torch.tensor([[0.0, 0.6, 0.8], [0.0, 0.6, -0.8]])
    t_hit = torch.full((2,), 1e30)
    pid = torch.arange(2)
    got = VI.sky_in_scatter(ts, cfg, o, d, t_hit, pid, 0).numpy()
    want = np.asarray(JVI.sky_in_scatter(js, jcfg, *_jargs(o, d, t_hit,
                                                          pid)[:4],
                                         jnp.uint32(0)))
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# ------------------------------------------------------------------ renders

@contextlib.contextmanager
def _jax_pieces():
    with _pallas_path(), pytest.MonkeyPatch.context() as mp:
        for mod, name in ((JS, "make_surface"), (JB, "sample_bsdf"),
                          (JL, "sample_light")):
            mp.setattr(mod, name, jax.jit(getattr(mod, name)))
        mp.setattr(JB, "eval_bsdf",
                   jax.jit(JB.eval_bsdf, static_argnames=("split",)))
        mp.setattr(JI, "closest_hit", jax.jit(JI.closest_hit))
        yield


def _image(integrate_fn, scene, cfg, ts):
    yy, xx = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    pid = (yy * RES + xx).reshape(-1)
    o, d, valid = shoot_rays(ts.camera, T((xx.reshape(-1) + 0.5).astype(
        np.float32)), T((yy.reshape(-1) + 0.5).astype(np.float32)))
    if integrate_fn is integrate:
        return integrate(scene, cfg, o, d, valid, T(pid), 0)[0].numpy()
    return np.asarray(integrate_fn(
        scene, cfg, *(jnp.asarray(x.numpy()) for x in (o, d, valid)),
        jnp.asarray(pid.astype(np.uint32)), jnp.uint32(0))[0])


ARMS = {
    "single_scatter": ("grid", {}),
    "optimize": ("exp", {"optimize": True}),
    "adaptive": ("grid", {"adaptive": True, "adaptive_substeps": 3}),
    "emission": ("noise", {"volume_integrator": "EmissionIntegrator"}),
    "sky": (None, SKY_PM),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_volume_arm_render_matches_jax(arm, regions, sky):
    """The room at 16x16, 1 spp, 1 bounce and 4 volume steps under each
    arm (the sky: the Cornell box under a constant background); the
    volume changes the image against the same scene without it."""
    kind, extra = ARMS[arm]
    js, ts = sky if kind is None else regions[kind]
    pm = dict({"type": "pathtracing", "bounces": 1,
               "volume_steps": STEPS}, **extra)
    cfg = make_integrator(pm)
    if cfg.vol_optimize:      # the grid render() builds before its passes
        ts = ts.__class__(**{**ts.__dict__,
                             "vol_atten": VI.build_attenuation_grid(ts)})
        js = js.replace(vol_atten=jax.jit(JVI.build_attenuation_grid)(js))
    img = _image(integrate, ts, cfg, ts)
    with _jax_pieces():
        want = _image(jintegrate, js, jmake_integrator(pm), ts)
    assert np.isfinite(img).all() and img.mean() > 0
    _assert_mostly_close(img, want)
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    bare = _image(integrate, ts, make_integrator(
        dict(pm, volume_integrator="none")), ts)
    assert np.abs(img - bare).max() > 1e-3
