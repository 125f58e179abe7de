"""The bidirectional path tracer against the JAX package: the eye and
light subpaths' vertices, the MIS weights, the light-tracing splats (their
pixels and values), the image with an area light and with a point light,
and the splats' normalisation on a compacted wavefront.

The JAX references are one jitted JAX function per light kind, run once
per module, that walks both subpaths and integrates the pixel-centre rays
of the Cornell box (12x12, 2 bounces), its brute-force queries through its
Pallas kernel in interpret mode (`_pallas_path`); and `_mis_weight` on
random pdfs.

Tolerances (worst case observed in brackets):
  * vertices: the masks (valid, connectible) equal; positions, throughputs
    and pdfs within rtol 1e-4, atol 1e-5 on the valid lanes [7e-6];
  * MIS weights on the same random pdfs: within 1e-6 [6e-8];
  * the splats: the pixels of the lanes that splat within 1e-4 [2e-6], the
    values within the slice's tolerance;
  * the images: the slice bound, at least 98% of lanes within rtol = atol =
    1e-4 and the mean within 1e-3 relative [every lane within 7e-6];
  * the port against itself: the splat accumulator and its path count bit
    for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.integrators import bidir as JBD
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators import bidir as BD
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.render import _render_ids
import scenes as JS
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_gradients import _pallas_path
from test_torch_render import _assert_mostly_close

RES = 12
PM = {"type": "bidirectional", "bounces": 2}
VERT = ("p", "beta", "pdf_fwd", "pdf_rev", "connectible", "valid")
ORG = ("p", "nrm", "pdf_pos", "pdf_dir", "d0", "pdf_rev", "delta_pos",
       "has_normal", "valid")


def T(a):
    return torch.from_numpy(np.array(a))


def _vert(v):
    return {k: (v.sp.p if k == "p" else getattr(v, k)) for k in VERT}


def _rays(ts):
    pid = np.arange(RES * RES)
    o, d, valid = shoot_rays(ts.camera, T((pid % RES) + 0.5).float(),
                             T((pid // RES) + 0.5).float())
    return o, d, valid, pid


def _run_jax(js, o, d, valid, pid):
    """The JAX package's subpaths and integrate, in one jitted call."""
    cfg = jmake_integrator(PM)
    max_t, max_s = cfg.bounces + 1, max(cfg.bounces, 1)

    def run(s, o, d, v, p):
        sid = jnp.uint32(0)
        eye = JBD._walk_eye(s, cfg, o, d, v, p, sid, max_t)[0]
        org, lv = JBD._walk_light(s, cfg, p, sid, max_s, lane_valid=v)
        rgb, alpha, aux = JBD.integrate_bidir(s, cfg, o, d, v, p, sid)
        return ([_vert(x) for x in eye], [_vert(x) for x in lv],
                {k: getattr(org, k) for k in ORG}, rgb, alpha, aux)

    with _pallas_path():
        out = jax.jit(run)(js, o, d, valid, pid)
    return jax.tree_util.tree_map(np.asarray, out)


def _run_port(ts, o, d, valid, pid):
    cfg = make_integrator(PM)
    max_t, max_s = cfg.bounces + 1, max(cfg.bounces, 1)
    eye = BD._walk_eye(ts, cfg, o, d, valid, pid, 0, max_t)[0]
    org, lv = BD._walk_light(ts, cfg, pid, 0, max_s, valid)
    rgb, alpha, aux = integrate(ts, cfg, o, d, valid, pid, 0)
    as_np = lambda x: x.numpy()
    return ([{k: as_np(v) for k, v in _vert(x).items()} for x in eye],
            [{k: as_np(v) for k, v in _vert(x).items()} for x in lv],
            {k: as_np(getattr(org, k)) for k in ORG}, rgb.numpy(),
            alpha.numpy(), {k: as_np(v) for k, v in aux.items()})


@pytest.fixture(scope="module", params=["area", "point"])
def both(request):
    """(light kind, scene pair, JAX results, port results)."""
    b = JS.cornell_builder(light_kind=request.param)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    js = b.compile("cam")
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    o, d, valid, pid = _rays(ts)
    want = _run_jax(js, o.numpy(), d.numpy(), valid.numpy(),
                    pid.astype(np.uint32))
    return request.param, (js, ts), want, _run_port(ts, o, d, valid, T(pid))


def _hold_vertex(got, want, mask_key="valid"):
    m = want[mask_key]
    for k in ("valid", "connectible", "delta_pos", "has_normal"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, w in want.items():
        if w.dtype != bool:
            np.testing.assert_allclose(got[k][m], w[m], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_eye_vertices_match_jax(both):
    _, _, (jeye, *_), (eye, *_) = both
    assert len(eye) == len(jeye) == PM["bounces"] + 1
    for got, want in zip(eye, jeye):
        _hold_vertex(got, want)
    assert jeye[0]["valid"].mean() > 0.9


def test_light_vertices_match_jax(both):
    kind, _, (_, jlv, jorg, *_), (_, lv, org, *_) = both
    _hold_vertex(org, jorg)
    assert org["delta_pos"].all() == (kind == "point")
    assert org["valid"].all()
    for got, want in zip(lv, jlv):
        _hold_vertex(got, want)
    assert jlv[0]["valid"].mean() > 0.5


def test_image_matches_jax(both):
    """rgb and alpha at the slice bound, the walls red and green."""
    _, _, (*_, jrgb, jalpha, _), (*_, rgb, alpha, _) = both
    assert np.isfinite(rgb).all() and rgb.mean() > 0
    _assert_mostly_close(rgb, jrgb)
    assert abs(rgb.mean() - jrgb.mean()) <= 1e-3 * jrgb.mean()
    np.testing.assert_array_equal(alpha, jalpha)
    img = rgb.reshape(RES, RES, 3)
    left, right = img[:, :2].mean((0, 1)), img[:, -2:].mean((0, 1))
    assert left[0] > left[1] and right[1] > right[0]


def test_splats_match_jax(both):
    """The t = 0 splats: N * max_s of them, s-major; the pixels of the
    lanes that splat and every value. Where a lane cannot splat the port
    puts its 0 at pixel (0, 0), the JAX package at the projection, which
    may lie off the film."""
    _, _, (*_, jaux), (*_, aux) = both
    n = RES * RES * max(PM["bounces"], 1)
    for k in ("splat_px", "splat_py", "splat_rgb"):
        assert aux[k].shape[0] == jaux[k].shape[0] == n
    made = jaux["splat_rgb"].max(-1) > 0
    assert made.sum() > RES * RES // 4
    np.testing.assert_array_equal(aux["splat_rgb"].max(-1) > 0, made)
    for k in ("splat_px", "splat_py"):
        np.testing.assert_allclose(aux[k][made], jaux[k][made], rtol=1e-4,
                                   atol=1e-4)
    _assert_mostly_close(aux["splat_rgb"], jaux["splat_rgb"])
    assert abs(aux["splat_rgb"].sum() - jaux["splat_rgb"].sum()) <= \
        1e-3 * jaux["splat_rgb"].sum()


def _random_paths(rng, n, pkg):
    """Eye and light subpaths of 3 and 2 vertices with random pdfs and
    flags (some zero, some delta), as the named package's records."""
    f = lambda *s: rng.uniform(0.0, 4.0, s).astype(np.float32)
    zero = lambda a: np.where(rng.random(a.shape) < 0.2, 0.0, a).astype(
        np.float32)
    flag = lambda: rng.random(n) < 0.8
    asarr = (lambda a: T(a)) if pkg is BD else jnp.asarray
    mk = lambda: pkg._Vertex(sp=None, wo=None, beta=None,
                             pdf_fwd=asarr(zero(f(n))),
                             pdf_rev=asarr(zero(f(n))),
                             connectible=asarr(flag()), valid=asarr(flag()),
                             d2_prev=None, cos_prev=None)
    eye, lv = [mk() for _ in range(3)], [mk() for _ in range(2)]
    org = pkg._LightOrigin(li=None, p=None, nrm=None, has_normal=None,
                           pdf_pos=asarr(f(n)), pdf_dir=None, d0=None,
                           delta_pos=asarr(rng.random(n) < 0.3),
                           valid=asarr(flag()))
    org.pdf_rev = asarr(zero(f(n)))
    revs = [asarr(zero(f(n))) for _ in range(4)]
    return eye, lv, org, revs, asarr(flag()), asarr(flag())


# (t, s, with the light-tracing strategy): t = 0 is that strategy itself
_MIS_CASES = [(t, s, splat) for t, s in ((1, 0), (3, 0), (1, 1), (2, 2),
                                         (3, 1), (0, 1), (0, 2), (2, 3))
              for splat in (True, False) if t > 0 or splat]


@pytest.mark.parametrize("t,s,splat", _MIS_CASES, ids=[
    f"t{t}-s{s}{'' if splat else '-no-t0'}" for t, s, splat in _MIS_CASES])
def test_mis_weights_match_jax(t, s, splat):
    """_mis_weight of strategy (s, t) on the same random pdfs and flags,
    with and without the light-tracing strategy (and, for s = 0, the light
    point's sampleability)."""
    ports, jaxs = (_random_paths(np.random.default_rng(7), 64, pkg)
                   for pkg in (BD, JBD))
    kw = lambda x: dict(t0_ok=x[4] if splat else None,
                        conn_zt=x[5] if s == 0 else None)
    got = BD._mis_weight(*ports[:3], 0.5, t, s, *ports[3], **kw(ports))
    want = JBD._mis_weight(*jaxs[:3], 0.5, t, s, *jaxs[3], **kw(jaxs))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    # (s = 0, t = 1) without light tracing has no other strategy
    assert (got.numpy() < 1.0).any() == (t + s > 1 or splat)


def test_splats_count_the_traced_paths_on_a_compacted_wavefront(both):
    """_render_ids adds the splats to the film's accumulator with n_paths
    = the lanes traced (the sum of the lane weights), not H x W: a
    wavefront of 20 ids with 3 masked out counts 17 paths, and its splat
    sum is the integrator's."""
    _, (_, ts), *_ = both
    cfg = make_integrator(PM)
    film = F.make_film(RES, RES, device="cpu")
    ids = torch.arange(40, 60)
    live = torch.ones(20, dtype=torch.bool)
    live[[2, 9, 15]] = False
    film = _render_ids(ts, cfg, film, 0, ids, live)
    assert float(film.splat_paths) == 17.0
    assert float(film.splat.sum()) > 0
    # a full pass counts every lane, and resolve divides by the paths
    full = render(ts, cfg, RES, RES, spp=2, device="cpu")
    assert float(full.splat_paths) == 2 * RES * RES
    base = dataclasses.replace(full, splat=None, splat_paths=None)
    np.testing.assert_allclose(
        (F.resolve(full) - F.resolve(base))[..., :3].numpy(),
        (full.splat / full.splat_paths).numpy(), rtol=1e-5, atol=1e-6)
