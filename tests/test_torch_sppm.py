"""SPPM against the JAX package: the eye walk, one pass's statistics,
PM_IRE's initial radii and `render_sppm`, and the fault that `render` with
type "SPPM" runs the path tracer in both packages; and the photon fields
of `make_integrator` (photon mapping's and SPPM's) against the JAX
parser. (This file holds the parser's cases so that each new file keeps
fewer tests than tests/test_render.py: pytest-xdist queues files by
their test count, and one more file ahead of it would start the suite's
longest file later.)

The JAX references are jitted JAX pieces, once per module: `_eye_walk`
at the pixel centres, `sppm_pass` (2,000 photons a pass), and
`estimate_initial_radius`; the JAX side's brute-force queries go through
its Pallas kernel in interpret mode (`_pallas_path`). The scene is the
Cornell box with the grid's origin moved off its walls
(tests/test_torch_photon.py's `_off_the_walls`: a hit on the left wall or
the floor that rounds below 0 falls in the grid's first cell, which the
gather counts twice, and XLA's CPU code and torch round such hits
differently).

Tolerances (worst case observed in brackets):
  * the eye walk: the settled masks equal; positions, throughput and
    direct light within 1e-5 [2e-7];
  * a pass's state: within 1e-5 relative to the largest value of each
    field [4e-7] (the gathers' sums: XLA's CPU reduction need not add in
    torch's order);
  * PM_IRE's radii^2, from photons each package shoots: at least 98% of
    pixels within 1e-5 relative [143 of 144 equal: a photon whose position
    differs in its last bit sits on the other pixel's gather radius];
  * render_sppm's image: the slice bound, at least 98% of pixels within
    rtol = atol = 1e-4 and the mean within 1e-3 relative [1e-6]; with
    PM_IRE, the port against itself bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.integrators import sppm as JSP
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu_torch import make_integrator
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.integrators import sppm as SP
from libyafaray_tpu_torch.integrators.mc import integrate
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path
from test_torch_photon import _pair
from test_torch_render import _assert_mostly_close

RES = 12
# one specular bounce of the eye walk; the photons' 5 bounces (the JAX
# parser's fixed pm_bounces for SPPM) cut to 2 on both sides, for the JAX
# side's compile time
PM = {"type": "SPPM", "bounces": 1}
PHOTONS, R0, PASSES = 2000, 0.1, 2


def T(a):
    return torch.from_numpy(np.array(a))


def _cfgs():
    return (dataclasses.replace(jmake_integrator(PM), pm_bounces=2),
            dataclasses.replace(make_integrator(PM), pm_bounces=2))


@pytest.fixture(scope="module")
def cornell():
    return _pair(res=RES)


def _close_to(got, want, rel=1e-5):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _centres(ts):
    pid = np.arange(RES * RES)
    o, d, valid = shoot_rays(ts.camera, T((pid % RES) + 0.5).float(),
                             T((pid // RES) + 0.5).float())
    return o, d, valid, pid


@pytest.mark.parametrize("pm", [
    {"type": "photonmapping"},
    {"type": "photonmapping", "bounces": 3, "photons": 5000,
     "diffuseRadius": 0.2, "finalGather": False, "fg_samples": 4},
    {"type": "photonmapping", "causticRadius": 0.3, "fg_bounces": 1},
    {"type": "photonmapping", "diffuseRadius": 0.1, "fg_min_pathlen": 0.5,
     "caustic_type": "both"},
    {"type": "SPPM", "bounces": 3},
    {"type": "pathtracing", "bounces": 2, "causticRadius": 0.3}],
    ids=["defaults", "set", "caustic-radius", "fg-min-pathlen", "sppm",
         "pathtracing"])
def test_photon_params_parse_as_jax(pm):
    """The photon fields of the config, with the JAX package's fallbacks:
    diffuseRadius to causticRadius to 0.05, fg_min_pathlen to
    diffuseRadius, pm_bounces to bounces under photon mapping only."""
    cfg, jcfg = make_integrator(pm), jmake_integrator(pm)
    for f in ("kind", "bounces", "n_photons", "pm_radius", "pm_bounces",
              "caustic_type", "final_gather", "fg_samples", "fg_bounces",
              "fg_min_pathlen"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_eye_walk_matches_jax(cornell):
    """The specular chains to the first diffuse hit, with emission and
    NEE along the way, at the pixel centres."""
    js, ts = cornell
    o, d, valid, pid = _centres(ts)
    jcfg, cfg = _cfgs()
    with _pallas_path():
        jsp, jwo, jthr, jdirect, jsettled = jax.jit(
            lambda s, *a: JSP._eye_walk(s, jcfg, *a, jnp.uint32(3)))(
            js, o.numpy(), d.numpy(), valid.numpy(), pid.astype(np.uint32))
    sp, wo, thr, direct, settled = SP._eye_walk(ts, cfg, o, d, valid, T(pid),
                                                3)
    np.testing.assert_array_equal(settled.numpy(), np.asarray(jsettled))
    assert settled.numpy().mean() > 0.9
    s = settled.numpy()
    for got, want in ((sp.p, jsp.p), (sp.n, jsp.n), (wo, jwo), (thr, jthr)):
        np.testing.assert_allclose(got.numpy()[s], np.asarray(want)[s],
                                   rtol=1e-5, atol=1e-5)
    _close_to(direct.numpy(), np.asarray(jdirect))


@pytest.fixture(scope="module")
def passes(cornell):
    """(JAX, port) states after passes 0 .. PASSES-1 from the uniform
    radius R0, as numpy dicts."""
    js, ts = cornell
    jcfg, cfg = _cfgs()
    with _pallas_path():
        step = jax.jit(lambda st, p: JSP.sppm_pass(js, jcfg, st, RES, RES, p,
                                                   PHOTONS))
        jst = JSP.init_state(RES * RES, R0)
        for p in range(PASSES):
            jst = step(jst, jnp.uint32(p))
    st = SP.init_state(RES * RES, R0, device="cpu")
    for p in range(PASSES):
        st = SP.sppm_pass(ts, cfg, st, RES, RES, p, PHOTONS)
    return ({f.name: np.asarray(getattr(jst, f.name))
             for f in dataclasses.fields(SP.SppmState)},
            {k: v.numpy() for k, v in dataclasses.asdict(st).items()})


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(
    SP.SppmState)])
def test_pass_state_matches_jax(passes, field):
    """Each field of the state after two passes: the radii shrink where
    photons were gathered, the flux and counts accumulate."""
    want, got = passes
    assert got[field].shape == want[field].shape
    _close_to(got[field], want[field])
    if field == "radius2":
        assert (got[field] < R0 * R0 * 0.999).mean() > 0.3


def test_pm_ire_radii_match_jax(cornell):
    """PM_IRE's per-pixel initial radius^2 from one throwaway map and eye
    walk (8 photons sought, so that the 2,000 photons shrink some): dense
    pixels below r0^2, none above."""
    js, ts = cornell
    jcfg, cfg = _cfgs()
    with _pallas_path():
        want = np.asarray(jax.jit(lambda s: JSP.estimate_initial_radius(
            s, jcfg, RES, RES, PHOTONS, 0.15, n_search=8))(js))
    got = SP.estimate_initial_radius(ts, cfg, RES, RES, PHOTONS, 0.15,
                                     n_search=8).numpy()
    # each package shoots the throwaway photons itself: a photon whose
    # position differs in its last bit can sit on a pixel's gather radius
    close = np.isclose(got, want, rtol=1e-5, atol=0)
    assert close.mean() >= 0.98, close.mean()
    assert (got <= 0.15 ** 2 + 1e-9).all() and got.min() < 0.9 * 0.15 ** 2


def test_render_sppm_matches_jax(cornell, passes):
    """render_sppm's image at the slice bound against the JAX package's
    resolve of the same passes, with the Cornell box's red and green
    walls; with PM_IRE it is the resolve of the passes from
    estimate_initial_radius's radii."""
    js, ts = cornell
    jcfg, cfg = _cfgs()
    jstate, _ = passes
    want = np.asarray(JSP.resolve_sppm(JSP.SppmState(**jstate), RES, RES))
    got = SP.render_sppm(ts, cfg, RES, RES, passes=PASSES,
                         photons_per_pass=PHOTONS, initial_radius=R0,
                         device="cpu").numpy()
    assert got.shape == want.shape == (RES, RES, 3)
    _assert_mostly_close(got.reshape(-1, 3), want.reshape(-1, 3))
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    left, right = got[:, :2].mean((0, 1)), got[:, -2:].mean((0, 1))
    assert left[0] > left[1] and right[1] > right[0]
    ire = SP.render_sppm(ts, cfg, RES, RES, passes=PASSES,
                         photons_per_pass=PHOTONS, initial_radius=R0,
                         pm_ire=True, device="cpu")
    st = SP.init_state(RES * RES, R0, device="cpu")
    st = dataclasses.replace(st, radius2=SP.estimate_initial_radius(
        ts, dataclasses.replace(cfg, pm_radius=R0), RES, RES, PHOTONS, R0))
    for p in range(PASSES):
        st = SP.sppm_pass(ts, cfg, st, RES, RES, p, PHOTONS)
    assert torch.equal(ire, SP.resolve_sppm(st, RES, RES))


def test_point_light_render_sppm_matches_jax():
    """The box lit by a point light: render_sppm against the JAX
    package's resolve of the same two passes, at the slice bound."""
    js, ts = _pair("point", res=RES)
    jcfg, cfg = _cfgs()
    with _pallas_path():
        step = jax.jit(lambda st, p: JSP.sppm_pass(js, jcfg, st, RES, RES, p,
                                                   PHOTONS))
        jst = JSP.init_state(RES * RES, R0)
        for p in range(PASSES):
            jst = step(jst, jnp.uint32(p))
    want = np.asarray(JSP.resolve_sppm(jst, RES, RES)).reshape(-1, 3)
    got = SP.render_sppm(ts, cfg, RES, RES, passes=PASSES,
                         photons_per_pass=PHOTONS, initial_radius=R0,
                         device="cpu").numpy().reshape(-1, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    _assert_mostly_close(got, want)
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()


def test_render_with_type_sppm_runs_the_path_tracer(cornell):
    """A fault of both packages: `integrate` has no SPPM arm (only
    render_sppm runs SPPM), so `render` with type "SPPM" renders the path
    tracer's image, in the JAX package and in the port."""
    js, ts = cornell
    o, d, valid, pid = _centres(ts)
    args = (o.numpy(), d.numpy(), valid.numpy(), pid.astype(np.uint32))
    out = {}
    with _pallas_path():
        for kind in ("SPPM", "pathtracing"):
            jcfg = jmake_integrator(dict(PM, type=kind, bounces=1))
            out[kind] = np.asarray(jax.jit(lambda s, *a: jintegrate(
                s, jcfg, *a, jnp.uint32(0))[0])(js, *args))
    np.testing.assert_array_equal(out["SPPM"], out["pathtracing"])
    got = {kind: integrate(ts, make_integrator(dict(PM, type=kind,
                                                    bounces=1)), o, d,
                           valid, T(pid), 0)[0] for kind in out}
    assert torch.equal(got["SPPM"], got["pathtracing"])
    _assert_mostly_close(got["SPPM"].numpy(), out["SPPM"])
