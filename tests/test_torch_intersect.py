"""The port's intersection against the JAX package: the packed table, the
kernel's plain PyTorch version against the Pallas kernel in interpret mode,
the CPU routing of the kernel wrapper, and the scene-level queries.

Tolerance: at least 99.9% of rays agree, a ray agreeing when its prim id is
equal and its t, u, v are within rtol 1e-5 (atol 1e-6 near 0). XLA's CPU
code may contract products and sums into FMAs, so a ray grazing a triangle
edge can land on the other side of it, and a thin triangle can move u or v
by more than rtol; the port's plain version rounds every operation on its
own (as its CUDA kernel does, built with --fmad=false).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from libyafaray_tpu.accel import pallas_intersect as JP
from libyafaray_tpu.ops import intersect as JI
from libyafaray_tpu_torch.accel import mt_intersect as MT
from libyafaray_tpu_torch.accel import spheres as SP
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.csrc_build import launch_counts
from libyafaray_tpu_torch.ops import intersect as TI
from scenes import cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401


def T(a):
    return torch.from_numpy(np.array(a))


def _tris(rng, f):
    vtx = rng.standard_normal((f * 3, 3)).astype(np.float32)
    vis = np.full(f, 3, np.int32)
    vis[::7] = 2    # invisible to camera rays
    vis[::11] = 1   # casts no shadow
    return vtx[0::3], vtx[1::3], vtx[2::3], vis


def _rays(rng, n):
    o = rng.standard_normal((n, 3)).astype(np.float32) * 2
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::13] = rng.uniform(0.5, 3.0, t_max[::13].shape)
    excl = np.full(n, -1, np.int32)
    excl[::5] = rng.integers(0, 300, excl[::5].shape)
    return o, d, t_min, t_max, excl


def _agree(p, wp, pairs):
    """Rays whose prim ids are equal and whose (got, want) pairs agree to
    rtol 1e-5 (atol 1e-6 for values near 0)."""
    same = np.asarray(p) == np.asarray(wp)
    for a, b in pairs:
        same &= np.isclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    return same


def _assert_hits_match(got, want):
    """At least 99.9% of rays agree; returns the number of agreeing hits."""
    same = _agree(got[1], want[1], zip((got[0], got[2], got[3]),
                                       (want[0], want[2], want[3])))
    assert same.mean() >= 0.999, f"rays agree on {same.mean():.5f}"
    return int((same & (np.asarray(got[1]) >= 0)).sum())


@pytest.mark.parametrize("f", [1, 2, 31, 32, 33, 36, 127, 128, 129, 300, 1000])
def test_table_rows_and_pack_tris_equal(rng, f):
    assert MT.table_rows(f) == JP.table_rows(f)
    v0, v1, v2, vis = _tris(rng, f)
    want = np.asarray(jax.jit(JP.pack_tris)(v0, v1, v2, vis))
    got = MT.pack_tris(T(v0), T(v1), T(v2), T(vis)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shadow", [False, True])
def test_plain_version_matches_pallas_kernel(rng, shadow):
    f, n = 300, 2048
    v0, v1, v2, vis = _tris(rng, f)
    o, d, t_min, t_max, excl = _rays(rng, n)
    tab = np.asarray(JP.pack_tris(v0, v1, v2, vis))
    want = JP.mt_closest(jnp.asarray(tab), o, d, t_min, t_max, excl,
                         shadow=shadow, interpret=True)
    got = MT.mt_closest_ref(T(tab), T(o), T(d), T(t_min), T(t_max), T(excl),
                            shadow=shadow)
    assert got[1].dtype == torch.int32
    assert _assert_hits_match(got, want) > 200


@pytest.mark.parametrize("motion", [1, 2])
def test_plain_version_matches_pallas_kernel_motion(rng, motion):
    f, n = 200, 1024
    v0, v1, v2, vis = _tris(rng, f)
    keys = [(v0, v1, v2)]
    for _ in range(motion):
        keys.append(tuple(v + rng.standard_normal(v.shape).astype(np.float32)
                          * 0.3 for v in (v0, v1, v2)))
    tabs = [np.asarray(JP.pack_tris(*k, vis)) for k in keys]
    o, d, t_min, t_max, excl = _rays(rng, n)
    time = rng.random(n).astype(np.float32)
    t2 = tabs[2] if motion == 2 else None
    want = JP.mt_closest(jnp.asarray(tabs[0]), o, d, t_min, t_max, excl,
                         time=time, tris_t1=jnp.asarray(tabs[1]),
                         tris_t2=None if t2 is None else jnp.asarray(t2),
                         interpret=True)
    got = MT.mt_closest_ref(T(tabs[0]), T(o), T(d), T(t_min), T(t_max),
                            T(excl), time=T(time), tris_t1=T(tabs[1]),
                            tris_t2=None if t2 is None else T(t2))
    assert _assert_hits_match(got, want) > 100


@pytest.mark.parametrize("case", range(7), ids=[
    "no-shadow-casters", "planes-camera", "planes-shadow", "tie-camera",
    "tie-shadow", "dead-rays-camera", "dead-rays-shadow"])
def test_plain_version_matches_pallas_kernel_edge_cases(rng, case):
    """The cases of the CUDA kernel's design (chip_smoke.mt_edge_cases,
    which the card's check runs too): no shadow casters, visible and
    invisible rows interleaved across the 128-row chunk boundary, an exact
    tie across an invisible row, dead rays among live ones and whole dead
    warps and blocks. Both answers miss on every dead ray and give the
    named prim ids."""
    name, tab, rays, shadow, want = chip_smoke.mt_edge_cases(
        rng, "cpu", 1024)[case]
    got = MT.mt_closest_ref(tab, *rays, shadow=shadow)
    jgot = JP.mt_closest(jnp.asarray(tab.numpy()),
                         *(jnp.asarray(x.numpy()) for x in rays),
                         shadow=shadow, interpret=True)
    _assert_hits_match(got, jgot)
    chip_smoke.assert_mt_case(name, got, rays, want)
    chip_smoke.assert_mt_case(
        name, tuple(torch.from_numpy(np.array(x)) for x in jgot), rays, want)
    if name.startswith("stacked planes"):
        assert (got[1] >= 100).all()


def test_tie_takes_lowest_prim_and_its_barycentrics():
    """A ray through the shared edge of two triangles: prim 0 wins, with
    u/v from triangle 0, as in the Pallas kernel."""
    v0 = np.array([[0.0, -1.0, 1.0], [0.0, -1.0, 1.0]], np.float32)
    v1 = np.array([[0.0, 1.0, 1.0], [1.0, -1.0, 1.0]], np.float32)
    v2 = np.array([[-1.0, -1.0, 1.0], [0.0, 1.0, 1.0]], np.float32)
    tab = MT.pack_tris(T(v0), T(v1), T(v2), torch.tensor([3, 3]))
    args = (torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, 1.0]]),
            torch.tensor([1e-4]), torch.tensor([1e30]),
            torch.tensor([-1], dtype=torch.int32))
    t, p, u, v = MT.mt_closest_ref(tab, *args)
    want = JP.mt_closest(jnp.asarray(tab.numpy()),
                         *(jnp.asarray(a.numpy()) for a in args),
                         interpret=True)
    assert int(p[0]) == int(want[1][0]) == 0
    np.testing.assert_allclose(
        [float(t[0]), float(u[0]), float(v[0])],
        [float(want[0][0]), float(want[2][0]), float(want[3][0])], atol=1e-6)
    np.testing.assert_allclose([float(t[0]), float(u[0]), float(v[0])],
                               [1.0, 0.5, 0.0], atol=1e-6)


def test_wrapper_routes_cpu_tensors_to_the_plain_version(rng):
    v0, v1, v2, vis = _tris(rng, 64)
    tab = MT.pack_tris(T(v0), T(v1), T(v2), T(vis))
    args = [T(a) for a in _rays(rng, 500)]
    before = launch_counts["kernel.mt_closest.launches"]
    got = MT.mt_closest(tab, *args, shadow=True)
    want = MT.mt_closest_ref(tab, *args, shadow=True)
    assert launch_counts["kernel.mt_closest.launches"] == before == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "rows",
                                 "exclude", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(rng, bad):
    v0, v1, v2, vis = _tris(rng, 8)
    tab = MT.pack_tris(T(v0), T(v1), T(v2), T(vis))
    o, d, t_min, t_max, excl = [T(a) for a in _rays(rng, 16)]
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        d = d[:, :2].contiguous()
    elif bad == "contiguous":
        o = torch.cat([o, o], 1)[:, ::2]
    elif bad == "rows":
        tab = tab[:20].contiguous()
    elif bad == "exclude":
        excl = excl.long()
    else:
        tab = tab.to("meta")
    with pytest.raises(ValueError):
        MT.mt_closest(tab, o, d, t_min, t_max, excl)


def test_moller_trumbore_and_sphere_match(rng):
    v0, v1, v2, _ = _tris(rng, 50)
    o, d, *_ = _rays(rng, 256)
    jmt = jax.jit(lambda *a: JI.moller_trumbore(*a, 1e-4, 1e30))(
        o[:, None], d[:, None], v0[None], v1[None], v2[None])
    tmt = TI.moller_trumbore(T(o)[:, None], T(d)[:, None], T(v0)[None],
                             T(v1)[None], T(v2)[None], 1e-4, 1e30)
    hit = tmt[0].numpy()
    same = _agree(hit, jmt[0], [(np.where(hit, a.numpy(), 0.0),
                                 np.where(hit, np.asarray(b), 0.0))
                                for a, b in zip(tmt[1:], jmt[1:])])
    assert same.mean() >= 0.999 and hit.any()
    c = rng.standard_normal((1, 8, 3)).astype(np.float32)
    r = rng.uniform(0.2, 1.0, (1, 8)).astype(np.float32)
    jh, jt = jax.jit(lambda *a: JI.intersect_sphere(*a, 1e-4, 1e30))(
        o[:, None], d[:, None], c, r)
    th, tt = SP.intersect_sphere(T(o)[:, None], T(d)[:, None], T(c), T(r),
                                 1e-4, 1e30)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    m = np.asarray(jh)
    np.testing.assert_allclose(tt.numpy()[m], np.asarray(jt)[m], rtol=1e-5)


@pytest.fixture(scope="module")
def cornell_pair():
    """The Cornell box (lamp hidden from camera rays, so camera_hit traces
    past it) compiled by the JAX package, and the same tables in the port."""
    b = cornell_builder()
    b.lights["lamp"]["visibility"] = "invisible"
    js = b.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def _box_rays(rng, n):
    o = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    o[: n // 4] = [0.5, -1.35, 0.5]          # from the camera position
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 4, 1] = np.abs(d[: n // 4, 1]) * 4
    o[-64:] = rng.uniform(0.4, 0.6, (64, 3))   # straight up at the lamp
    d[-64:] = [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_scene_queries_match(rng, cornell_pair):
    """closest_hit, any_hit and camera_hit on the Cornell box."""
    js, ts = cornell_pair
    n = 2048
    o, d = _box_rays(rng, n)
    excl = np.where(np.arange(n) % 3 == 0, rng.integers(0, 36, n), -1
                    ).astype(np.int32)
    t_max = np.where(np.arange(n) % 7 == 0, -1.0, 1e30).astype(np.float32)
    excl[-64:], t_max[-64:] = -1, 1e30

    @jax.jit
    def jq(s, o, d, excl, t_max):
        ch = JI.closest_hit(s, o, d, s.ray_min_dist, t_max, exclude_prim=excl)
        ah = JI.any_hit(s, o, d, 0.0, t_max, exclude_prim=excl)
        cam = JI.camera_hit(s, o, d, s.ray_min_dist, t_max)
        return ch, ah, cam

    jch, jah, jcam = jq(js, o, d, excl, t_max)
    tch = TI.closest_hit(ts, T(o), T(d), ts.ray_min_dist, T(t_max),
                         exclude_prim=T(excl))
    tah = TI.any_hit(ts, T(o), T(d), 0.0, T(t_max), exclude_prim=T(excl))
    tcam = TI.camera_hit(ts, T(o), T(d), ts.ray_min_dist, T(t_max))
    assert (np.asarray(jah) == tah.numpy()).mean() >= 0.999
    assert ts.has_cam_invisible
    for jh, th in ((jch, tch), (jcam, tcam)):
        same = _agree(th.prim.numpy(), jh.prim, [
            (th.valid.numpy(), jh.valid), (th.t.numpy(), jh.t),
            (th.uv.numpy()[:, 0], jh.uv[:, 0]),
            (th.uv.numpy()[:, 1], jh.uv[:, 1])])
        assert same.mean() >= 0.999, same.mean()
    # camera rays pass through the hidden lamp quad (faces 34, 35) to the
    # ceiling behind it
    lamp = (tch.prim.numpy() >= 34) & tch.valid.numpy()
    assert lamp[-64:].all()
    assert not ((tcam.prim.numpy() >= 34) & tcam.valid.numpy()).any()
    assert np.isin(tcam.prim.numpy()[-64:], [2, 3]).all()
