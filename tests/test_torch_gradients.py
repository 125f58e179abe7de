"""Gradients of the port against the JAX package: `take`'s one-hot backward,
torch autograd through the Cornell path tracer against `jax.grad` of the same
code and against central finite differences of the port's own loss, the
glossy material (BASELINE config 2) forward, and the one-device
inverse-rendering step.

The JAX side runs once for the module: one `jax.jit` computes every JAX
gradient (`jax_grads`). Its brute-force queries go through the JAX
package's Pallas kernel in interpret mode (`_pallas_path`), the path it
takes on the TPU and the one the port's `mt_closest_ref` reproduces: on the
CPU the JAX package otherwise takes a scan whose fused multiply-adds send
the ray of pixel (7, 7), which meets the seam of the floor and the green
wall, to the other face. The port's scenes come from
`convert.scene_from_numpy`, so both packages read the same tables, and both
trace the same camera rays (the 8x8 grid of `tests/test_render.py`).

Tolerances: forward rgb within 1e-4 on every ray; AD against AD within
rtol 1e-3, atol 1e-7 (observed worst case: see `test_ad_matches_jax_ad`);
finite differences as the JAX package's own gradient tests; per-lane glossy
functions within 1e-5; the glossy render as `tests/test_torch_render.py`
holds the forward render.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import film as JF
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.cameras import shoot_rays as jshoot_rays
from libyafaray_tpu.accel import pallas_intersect as JPI
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.materials import bsdf as JB
from libyafaray_tpu.materials import microfacet as JM
from libyafaray_tpu.ops import fast_grad as JFG
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu.scene_types import MAT_GLOSSY
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import csrc_build, make_integrator, make_train_step
from libyafaray_tpu_torch import render
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.materials import bsdf as B
from libyafaray_tpu_torch.materials import microfacet as M
from libyafaray_tpu_torch.ops import fast_grad as FG
from scenes import _box, cornell_builder, glossy_cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_render import _assert_mostly_close, _hits, _port_sp

RES = 8      # the ray grid of tests/test_render.py and test_gradients.py


def T(a):
    return torch.from_numpy(np.array(a))


def _glossy_slab():
    """The scene of tests/test_gradients.py::test_grad_glossy_exponent."""
    b = cornell_builder(extras=[
        ("gl", {"type": "glossy", "exponent": 25.0,
                "glossy_reflect": 0.6, "diffuse_reflect": 0.3,
                "color": (0.7, 0.7, 0.7)})])
    b.create_object("slab")
    b.set_current_material("gl")
    _box(b, (0.35, 0.35, 0.2), (0.3, 0.2, 0.35))
    return b


@contextlib.contextmanager
def _pallas_path():
    """JAX brute-force queries through the Pallas kernel in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPI, "use_pallas", lambda: True)
        mp.setattr(JPI, "mt_closest",
                   functools.partial(JPI.mt_closest, interpret=True))
        yield


def _pair(builder):
    js = builder.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def _ray_batch(js):
    """The 8x8 grid of primary rays at pixel spacing 8, lens at its centre."""
    n = RES * RES
    yy, xx = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    pid = (yy * RES + xx).reshape(-1).astype(np.uint32)
    px = xx.reshape(-1).astype(np.float32) * 8 + 4.0
    py = yy.reshape(-1).astype(np.float32) * 8 + 4.0
    half = np.full(n, 0.5, np.float32)
    o, d, valid = jax.jit(jshoot_rays)(js.camera, px, py, half, half)
    return np.asarray(o), np.asarray(d), np.asarray(valid), pid


# (name, scene, bounces, table, column): the gradients of mean(rgb)
CASES = {"diffuse_color": ("cornell", 2, "materials", "diffuse_color"),
         "lights.color": ("cornell", 2, "lights", "color"),
         "exponent": ("slab", 3, "materials", "exponent")}


@pytest.fixture(scope="module")
def scenes():
    return {"cornell": _pair(cornell_builder()), "slab": _pair(_glossy_slab())}


@pytest.fixture(scope="module")
def jax_grads(scenes):
    """Every JAX forward and gradient of the module, in one jax.jit."""
    jc, jg = scenes["cornell"][0], scenes["slab"][0]
    rays = {k: _ray_batch(js) for k, (js, _) in scenes.items()}
    cfg2 = jmake_integrator({"type": "pathtracing", "bounces": 2})
    cfg3 = jmake_integrator({"type": "pathtracing", "bounces": 3})

    def cornell_loss(dc, lc, o, d, valid, pid):
        sc = jc.replace(materials=jc.materials.replace(diffuse_color=dc),
                        lights=jc.lights.replace(color=lc))
        rgb, _, _ = jintegrate(sc, cfg2, o, d, valid, pid, jnp.uint32(0))
        return jnp.mean(rgb), rgb

    def slab_loss(e, o, d, valid, pid):
        sc = jg.replace(materials=jg.materials.replace(
            exponent=e, exp_u=e, exp_v=e))
        rgb, _, _ = jintegrate(sc, cfg3, o, d, valid, pid, jnp.uint32(0))
        return jnp.mean(rgb), rgb

    @jax.jit
    def run(rc, rg):
        (_, rgb_c), (g_dc, g_lc) = jax.value_and_grad(
            cornell_loss, argnums=(0, 1), has_aux=True)(
                jc.materials.diffuse_color, jc.lights.color, *rc)
        (_, rgb_g), g_e = jax.value_and_grad(slab_loss, has_aux=True)(
            jg.materials.exponent, *rg)
        return rgb_c, g_dc, g_lc, rgb_g, g_e

    with _pallas_path():
        out = run(rays["cornell"], rays["slab"])
    rgb_c, g_dc, g_lc, rgb_g, g_e = map(np.asarray, out)
    return {"rays": rays,
            "rgb": {"cornell": rgb_c, "slab": rgb_g},
            "grad": {"diffuse_color": g_dc, "lights.color": g_lc,
                     "exponent": g_e}}


def _port_loss(scenes, jax_grads, case):
    """theta -> (mean(rgb), rgb) of the port on the case's scene and rays;
    and the scene's own value of theta."""
    scene_name, bounces, table, column = CASES[case]
    ts = scenes[scene_name][1]
    o, d, valid, pid = jax_grads["rays"][scene_name]
    cfg = make_integrator({"type": "pathtracing", "bounces": bounces})

    def loss(theta):
        cols = {column: theta}
        if case == "exponent":
            cols = {"exponent": theta, "exp_u": theta, "exp_v": theta}
        sc = dataclasses.replace(ts, **{table: dataclasses.replace(
            getattr(ts, table), **cols)})
        rgb, _, _ = integrate(sc, cfg, T(o), T(d), T(valid),
                           T(pid.astype(np.int64)), 0)
        return rgb.mean(), rgb

    return loss, getattr(getattr(ts, table), column)


def _port_grad(loss, theta):
    leaf = theta.detach().clone().requires_grad_(True)
    value, rgb = loss(leaf)
    grad, = torch.autograd.grad(value, leaf)
    return grad.numpy(), rgb.detach().numpy()


# ----------------------------------------------------------------- take

@pytest.mark.parametrize("rows", [5, 300])
def test_take_matches_jax_vjp(rng, rows):
    """Forward equal to indexing; backward equal to the VJP of the JAX
    package's `fast_grad.take` on 40,000 seeded lanes (three chunks of
    16,384, the last one padded), within rtol 1e-6. The incoming gradient
    is positive, as radiance is, so the sums do not cancel."""
    idx = rng.integers(0, rows, 40_000).astype(np.int32)
    arr = rng.standard_normal((rows, 3)).astype(np.float32)
    g = rng.random((40_000, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: JFG.take(a, jnp.asarray(idx)),
                     jnp.asarray(arr))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    leaf = T(arr).requires_grad_(True)
    out = FG.take(leaf, T(idx).long())
    np.testing.assert_array_equal(out.detach().numpy(), arr[idx])
    assert type(out.grad_fn).__name__ == "_TakeBackward"
    out.backward(T(g))
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=1e-6, atol=0)
    # a 1-D column reduces the same way
    col = T(arr[:, 0]).requires_grad_(True)
    FG.take(col, T(idx).long()).backward(T(g[:, 0]))
    np.testing.assert_allclose(col.grad.numpy(), want[:, 0], rtol=1e-6)


def test_take_keeps_plain_indexing_outside_its_range(rng):
    """Above 4096 rows, for other dtypes and for indices that are not 1-D,
    `take` is plain indexing, as in the JAX package."""
    idx = T(rng.integers(0, 5000, 1000)).long()
    big = torch.zeros((5000, 3), requires_grad=True)
    assert type(FG.take(big, idx).grad_fn).__name__ != "_TakeBackward"
    small = torch.zeros((5, 3), dtype=torch.float64, requires_grad=True)
    assert type(FG.take(small, idx % 5).grad_fn).__name__ != "_TakeBackward"
    f32 = torch.zeros((5, 3), requires_grad=True)
    out = FG.take(f32, (idx % 5).reshape(10, 100))
    assert out.shape == (10, 100, 3)
    assert type(out.grad_fn).__name__ != "_TakeBackward"
    out.sum().backward()
    assert float(f32.grad.sum()) == 3000.0


@pytest.mark.parametrize("cols", [1, 3, 4])
def test_take_grad_layout_fits_a_block(cols):
    """The kernel's launch shape for every table up to MATMUL_GRAD_ROWS
    rows: its warps' table copies within a block's 227 KB of shared memory,
    one wave of the H100's 132 SMs (each holding 32 warps and 228 KB),
    a block for every 128 lanes of a warp at most, and the second kernel's
    split a power of two up to a warp."""
    for rows in range(1, FG.MATMUL_GRAD_ROWS + 1):
        for lanes in (0, 37, 262_144, 2_073_600):
            warps, blocks, cw, split = FG.take_grad_layout(rows, cols, lanes)
            copies = warps * rows * cw * 4
            assert cw == min(cols, 4) and 1 <= warps <= 16
            assert copies <= 232_448
            per_sm = min(32 // warps, 233_472 // (copies + 1024))
            assert 1 <= blocks <= 132 * per_sm
            assert blocks == 1 or (blocks - 1) * warps * 128 < lanes
            assert split in (1, 2, 4, 8, 16, 32)


def test_take_grad_on_the_cpu_is_onehot_grad(rng, monkeypatch):
    """A CPU tensor takes the plain version, onehot_grad, and never the
    kernel; take's backward reduces through it."""
    def refuse(*_):
        raise AssertionError("the kernel's library was asked for")
    monkeypatch.setattr(csrc_build, "entry", refuse)
    idx = T(rng.integers(0, 7, 300)).long()
    g = T(rng.random((300, 3)).astype(np.float32))
    before = csrc_build.launch_counts["kernel.take_grad.launches"]
    assert torch.equal(FG.take_grad(idx, g, 7), FG.onehot_grad(idx, g, 7))
    calls, real = [], FG.onehot_grad
    monkeypatch.setattr(FG, "onehot_grad",
                        lambda *a: calls.append(a) or real(*a))
    leaf = torch.zeros((7, 3), requires_grad=True)
    FG.take(leaf, idx).backward(g)
    assert len(calls) == 1
    assert csrc_build.launch_counts["kernel.take_grad.launches"] == before
    assert torch.equal(leaf.grad, real(idx, g, 7))


def test_gather_mp_gathers_through_take(scenes):
    ts = scenes["slab"][1]
    leaf = ts.materials.diffuse_color.clone().requires_grad_(True)
    mats = dataclasses.replace(ts.materials, diffuse_color=leaf)
    mp = B.gather_mp(mats, torch.tensor([0, 3, 1, 3], dtype=torch.int32))
    assert type(mp.diffuse_color.grad_fn).__name__ == "_TakeBackward"
    mp.diffuse_color.sum().backward()
    np.testing.assert_array_equal(leaf.grad[:, 0].numpy(), [1, 1, 0, 2])


# ------------------------------------------------- AD through the tracer

@pytest.mark.parametrize("case", list(CASES))
def test_ad_matches_jax_ad(scenes, jax_grads, case):
    """The forward rgb agrees with the JAX package's on every ray within
    1e-4; then the gradient of mean(rgb) agrees with `jax.grad` within
    rtol 1e-3, atol 1e-7, and is finite. Observed worst case on this batch
    (CPU): rgb max |diff| 2.7e-7; gradient max |diff| / |grad| 2.4e-7
    (diffuse_color), 1.6e-7 (lights.color), 3.3e-7 (exponent)."""
    loss, theta = _port_loss(scenes, jax_grads, case)
    grad, rgb = _port_grad(loss, theta)
    want_rgb = jax_grads["rgb"][CASES[case][0]]
    np.testing.assert_allclose(rgb, want_rgb, rtol=1e-4, atol=1e-4)
    want = jax_grads["grad"][case]
    assert np.isfinite(grad).all()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(grad, want, rtol=1e-3, atol=1e-7)


# the picks, steps and tolerances of the JAX package's own tests
# (tests/test_render.py, tests/test_gradients.py)
FD = {"diffuse_color": ([(0, 0), (1, 1)], 1e-3, 5e-3, 1e-5),
      "lights.color": ([(0, 0), (0, 2)], 1e-2, 1e-3, 1e-5),
      "exponent": ([(3,)], 5e-2, 0.25, 1e-7)}


@pytest.mark.parametrize("case", list(CASES))
def test_ad_matches_finite_differences(scenes, jax_grads, case):
    """The port's AD gradient against central finite differences of its own
    loss. The exponent is held loosely (rel 0.25), as in the JAX package:
    it also shapes the sampled half vectors, which carry no gradient
    through the detached intersection, so AD leaves out a term that the
    finite difference measures."""
    loss, theta = _port_loss(scenes, jax_grads, case)
    grad, _ = _port_grad(loss, theta)
    picks, e, rel, abs_ = FD[case]
    if case == "exponent":
        assert int(scenes["slab"][1].materials.mat_type[3]) == MAT_GLOSSY
    hit = 0
    with torch.no_grad():
        for idx in picks:
            up, down = theta.clone(), theta.clone()
            up[idx] += e
            down[idx] -= e
            fd = (float(loss(up)[0]) - float(loss(down)[0])) / (2 * e)
            assert float(grad[idx]) == pytest.approx(fd, rel=rel, abs=abs_), \
                f"{case} at {idx}: ad {float(grad[idx])} fd {fd}"
            hit += abs(fd) > 10 * abs_
    assert hit > 0, "every finite difference is ~0"


# ------------------------------------------------------------------ glossy

def test_microfacet_matches_jax(rng):
    n = 4096
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    u1[:2] = [0.0, 1.0]
    e, eu, ev = (rng.uniform(1.0, 300.0, n).astype(np.float32)
                 for _ in range(3))
    h = rng.standard_normal((n, 3)).astype(np.float32)
    h[:, 2] = np.abs(h[:, 2])
    h[:4] = [[0, 0, 1], [1, 0, 0], [0, 0, 0], [0.6, 0, -0.8]]
    h /= np.maximum(np.linalg.norm(h, axis=1, keepdims=True), 1e-12)
    cos_h = h[:, 2].copy()

    @jax.jit
    def jfns(u1, u2, e, eu, ev, h, cos_h):
        return (JM.blinn_d(cos_h, e), JM.blinn_sample_h(u1, u2, e),
                JM.blinn_pdf_h(cos_h, e), JM.as_aniso_d(h, eu, ev),
                JM.as_aniso_sample_h(u1, u2, eu, ev),
                JM.as_aniso_pdf_h(h, eu, ev))

    want = jfns(u1, u2, e, eu, ev, h, cos_h)
    u1, u2, e, eu, ev, h, cos_h = map(T, (u1, u2, e, eu, ev, h, cos_h))
    got = (M.blinn_d(cos_h, e), M.blinn_sample_h(u1, u2, e),
           M.blinn_pdf_h(cos_h, e), M.as_aniso_d(h, eu, ev),
           M.as_aniso_sample_h(u1, u2, eu, ev), M.as_aniso_pdf_h(h, eu, ev))
    names = ("blinn_d", "blinn_sample_h", "blinn_pdf_h", "as_aniso_d",
             "as_aniso_sample_h", "as_aniso_pdf_h")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def _glossy_lanes():
    """The Cornell box with every wall glossy: Blinn on the white walls and
    boxes, Ashikhmin-Shirley on the red and green walls."""
    b = cornell_builder()
    b.create_material("white", {"type": "glossy", "color": (0.7, 0.6, 0.3),
                                "diffuse_color": (0.73, 0.73, 0.73),
                                "glossy_reflect": 0.8, "exponent": 120.0})
    b.create_material("red", {"type": "glossy", "anisotropic": True,
                              "exp_u": 20.0, "exp_v": 300.0,
                              "glossy_reflect": 0.4,
                              "diffuse_color": (0.65, 0.05, 0.05)})
    b.create_material("green", {"type": "shinydiffusemat",
                                "color": (0.12, 0.45, 0.15)})
    return b


def test_glossy_bsdf_matches_jax(rng):
    """Sampled lobes, validity and directions as the per-lane functions
    (1e-5). The glossy lobe's f, pdf and weight are held to rtol 1e-4: the
    half vector differs from the JAX package's in the last bit on some
    lanes (XLA's CPU rsqrt is not correctly rounded, and it contracts dot
    products into fused multiply-adds), and cos_h ** exponent, with
    exponents of 120 and 300 here, multiplies that relative difference by
    the exponent (observed: 6.0e-5 on the pdf, 2.1e-5 on f)."""
    js, ts = _pair(_glossy_lanes())
    assert ts.materials.has_aniso and ts.materials.present_types == (0, 1)
    o, d, jhit = _hits(rng, js)
    jsp = jax.jit(JS.make_surface)(js, jhit, o, d)
    n = o.shape[0]
    u1, u2, u3 = (rng.random(n).astype(np.float32) for _ in range(3))
    wo = -d
    wi = rng.standard_normal((n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)

    @jax.jit
    def jbsdf(s, sp, wo, wi, u1, u2, u3):
        ms = JB.sample_bsdf(s, sp, wo, u1, u2, u3)
        # the sampled direction evaluated as well: the glossy lobe's peak
        return ms, JB.eval_bsdf(s, sp, wo, wi), JB.eval_bsdf(s, sp, wo, ms.wi)

    jms, (jf, jpdf), (jf_s, jpdf_s) = jbsdf(js, jsp, wo, wi, u1, u2, u3)
    sp = _port_sp(jsp)
    ms = B.sample_bsdf(ts, sp, T(wo), T(u1), T(u2), T(u3))
    for name in ("is_delta", "is_transmit", "valid", "lobe"):
        np.testing.assert_array_equal(getattr(ms, name).numpy(),
                                      np.asarray(getattr(jms, name)),
                                      err_msg=name)
    lobes = ms.lobe.numpy()[sp.valid.numpy()]
    assert {2, 3} <= set(lobes.tolist())      # microfacet and diffuse
    for name, rtol in (("wi", 1e-5), ("weight", 1e-4), ("pdf", 1e-4)):
        np.testing.assert_allclose(getattr(ms, name).numpy(),
                                   np.asarray(getattr(jms, name)), rtol=rtol,
                                   atol=1e-5, err_msg=name)
    for w, jf_, jpdf_ in ((T(wi), jf, jpdf), (T(np.asarray(jms.wi)), jf_s,
                                              jpdf_s)):
        f, pdf = B.eval_bsdf(ts, sp, T(wo), w)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf_), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf_), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("builder", [glossy_cornell_builder, _glossy_slab],
                         ids=["config2", "slab"])
def test_glossy_render_matches_jax(builder):
    """16x16, 2 spp, 3 bounces through both packages' render(): BASELINE
    config 2 as the JAX package builds it (its glossy material is compiled
    but no face uses it), and the Cornell box with the glossy slab."""
    res, spp, bounces = 16, 2, 3
    b = builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    js, ts = _pair(b)
    assert MAT_GLOSSY in ts.materials.present_types
    cfg = {"type": "pathtracing", "bounces": bounces}
    want = np.asarray(JF.resolve(jrender(js, jmake_integrator(cfg), res, res,
                                         spp=spp)))
    img = F.resolve(render(ts, make_integrator(cfg), spp=spp,
                           device="cpu")).numpy()
    assert img.shape == want.shape == (res, res, 4)
    assert np.isfinite(img).all()
    _assert_mostly_close(img.reshape(-1, 4), want.reshape(-1, 4))
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())


# -------------------------------------------------------------- the step

def test_train_step_matches_jax(scenes):
    """Three SGD steps of the port's make_train_step against the JAX
    package's on a one-device CPU mesh (tests/test_render.py's setup: 8x8,
    1 bounce, target 0.25, fixed sample 0): params and losses within
    rtol 1e-4, and the loss decreases."""
    from libyafaray_tpu.parallel import make_mesh
    from libyafaray_tpu.parallel import make_train_step as jmake_train_step
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    js, ts = _pair(b)
    cfg = {"type": "pathtracing", "bounces": 1}
    mesh = make_mesh(1)
    jstep = jmake_train_step(jmake_integrator(cfg), RES, RES, mesh, lr=0.05)
    step = make_train_step(make_integrator(cfg), RES, RES, lr=0.05,
                           device="cpu")
    jparams = {"diffuse_color": js.materials.diffuse_color}
    params = {"diffuse_color": ts.materials.diffuse_color}
    jtarget = jnp.full((RES, RES, 3), 0.25, jnp.float32)
    target = torch.full((RES, RES, 3), 0.25)
    losses = []
    for _ in range(3):
        with mesh, _pallas_path():
            jparams, jloss = jstep(js, jparams, jtarget, jnp.uint32(0))
        params, loss = step(ts, params, target, 0)
        losses.append(float(loss))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
        np.testing.assert_allclose(params["diffuse_color"].numpy(),
                                   np.asarray(jparams["diffuse_color"]),
                                   rtol=1e-4)
        assert not params["diffuse_color"].requires_grad
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
