"""Glass and the caustic scene (BASELINE config 4) of the port against the
JAX package: `vec.refract`, the glass arm of `lobe_weights` and of
`_sample_single`, the compiled tables of `caustic_grad_builder`, the scene's
image and its gradients with respect to the IOR column and the floor
texture's texel pool against `jax.grad` of the same loss (bench.py's
`bench_caustic_grad`: pixel centres, lens samples 777/778, mean(rgb)), the
IOR gradient against central finite differences.

The per-lane functions are called on the JAX side eagerly (each op its own
computation, so XLA contracts nothing across them into fused multiply-adds,
as the port's ops on the card do not either); the image and gradients run
under one `jax.jit`.

Tolerances, each observed worst case in brackets:
  * refract: the total-internal-reflection flag equal on every lane, also
    against the jitted JAX function, on 5,000 lanes within 1e-6 of the
    critical angle; the direction within 1e-6 of the eager JAX function
    (1.5e-7; against the jitted one 1.1e-4 on near-critical lanes, where
    cos_t = sqrt(1 - sin2_t) magnifies the fused multiply-add's last bit);
  * lobes and sampled lobes, directions, weights and pdfs: flags equal,
    floats within 1e-6;
  * the image (8x8, 2 bounces, pixel centres): at least 98% of pixels
    within rtol = atol = 1e-4, the mean within 1e-3 relative (every pixel
    within 6.6e-7 observed);
  * gradients against `jax.grad` within rtol 1e-3, atol 1e-7 (the IOR's
    equal, the texels' largest difference 1.3e-8);
  * the IOR gradient against a central finite difference: the sign and
    rel 0.25, the bounds of tests/test_gradients.py:69-86 (AD 9.89e-5,
    the difference 1.09e-4). Both packages detach sampled directions, so
    AD carries the Fresnel weight's derivative and not the bending of the
    refracted ray, which the difference measures too: at 3 bounces the
    bending dominates here (AD -1.85e-6, the difference -1.34e-3, JAX's AD
    the port's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu import sampler as jsampler
from libyafaray_tpu.cameras import shoot_rays as jshoot_rays
from libyafaray_tpu.integrators.mc import integrate as jintegrate
from libyafaray_tpu.materials import bsdf as JB
from libyafaray_tpu.math import vec as JV
from libyafaray_tpu_torch import make_integrator
from libyafaray_tpu_torch.cameras import shoot_rays
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.integrators.mc import integrate
from libyafaray_tpu_torch.materials import bsdf as B
from libyafaray_tpu_torch.math import vec as V
from libyafaray_tpu_torch.scene_types import MAT_GLASS
from libyafaray_tpu_torch.scenes import caustic_grad_builder as port_caustic
from scenes import caustic_grad_builder
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_render import _assert_mostly_close

RES, BOUNCES = 8, 2   # glass -> glass -> floor, then NEE to the lamp
N_LANES = 4096


def T(a):
    return torch.from_numpy(np.array(a))


def _equal_tables(port, want):
    """Every field of two port tables equal (tensors bit for bit)."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.fixture(scope="module")
def caustic():
    """(JAX scene, the port's compile of its own builder) at RES x RES."""
    js = caustic_grad_builder(RES, RES).compile("cam")
    return js, port_caustic(RES, RES).compile("cam", device="cpu")


# ---------------------------------------------------------------- refract

def _refract_lanes(rng):
    """Random unit directions and relative IORs, with 5,000 lanes within
    1e-6 of the critical angle of light leaving glass (eta 1/1.5)."""
    wi = rng.standard_normal((N_LANES * 4, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    eta = rng.choice([1.5, 1 / 1.5, 1.33], len(wi)).astype(np.float32)
    k = 5000
    cos_c = np.sqrt(1 - (1 / 1.5) ** 2) + rng.uniform(-1e-6, 1e-6, k)
    sin_c = np.sqrt(1 - cos_c ** 2)
    phi = rng.uniform(0, 2 * np.pi, k)
    wi[:k] = np.stack([sin_c * np.cos(phi), sin_c * np.sin(phi), cos_c], -1)
    eta[:k] = np.float32(1.0) / np.float32(1.5)
    nrm = np.zeros_like(wi)
    nrm[:, 2] = rng.choice([1.0, -1.0], len(wi))
    nrm[:k, 2] = 1.0
    return wi, nrm, eta


def test_refract_matches_jax(rng):
    wi, nrm, eta = _refract_lanes(rng)
    wt, tir = V.refract(T(wi), T(nrm), T(eta))
    jwt, jtir = JV.refract(jnp.asarray(wi), jnp.asarray(nrm), jnp.asarray(eta))
    _, jtir_jit = jax.jit(JV.refract)(wi, nrm, eta)
    np.testing.assert_array_equal(tir.numpy(), np.asarray(jtir))
    np.testing.assert_array_equal(tir.numpy(), np.asarray(jtir_jit))
    assert 0 < int(tir[:5000].sum()) < 5000    # both sides of the angle
    np.testing.assert_allclose(wt.numpy(), np.asarray(jwt), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ glass lobes

def _lanes(rng, n_mats):
    """Material ids, local wo on both sides (from inside the glass too, with
    total internal reflection on many lanes) and three uniforms."""
    mat = rng.integers(0, n_mats, N_LANES).astype(np.int32)
    wo = rng.standard_normal((N_LANES, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0.6, 0, -0.8]]
    u = [rng.random(N_LANES).astype(np.float32) for _ in range(3)]
    u[2][:8] = [0.0, 1.0 - 2 ** -24, 0.5, 0.04, 0.96, 0.0, 0.5, 1e-7]
    return mat, wo, u


def test_glass_lobes_match_jax(rng, caustic):
    js, ts = caustic
    mat, wo, (u1, u2, u3) = _lanes(rng, int(ts.materials.mat_type.shape[0]))
    assert MAT_GLASS in ts.materials.present_types
    jmp = JB.gather_mp(js.materials, jnp.asarray(mat))
    mp = B.gather_mp(ts.materials, T(mat))
    cos_wo = np.abs(wo[:, 2])
    for got, want in zip(B.lobe_weights(mp, T(cos_wo)),
                         JB.lobe_weights(jmp, jnp.asarray(cos_wo))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    ms = B._sample_single(mp, T(wo), T(u1), T(u2), T(u3))
    jms = JB._sample_single(jmp, None, jnp.asarray(wo), jnp.asarray(u1),
                            jnp.asarray(u2), jnp.asarray(u3))
    for name in ("is_delta", "is_transmit", "valid", "lobe"):
        np.testing.assert_array_equal(getattr(ms, name).numpy(),
                                      np.asarray(getattr(jms, name)),
                                      err_msg=name)
    for name in ("wi", "weight", "pdf"):
        np.testing.assert_allclose(getattr(ms, name).numpy(),
                                   np.asarray(getattr(jms, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    glass = mat == int(np.argmax(ts.materials.mat_type.numpy() == MAT_GLASS))
    lobe = ms.lobe.numpy()
    tir = glass & (lobe == 1) & ~ms.is_transmit.numpy()
    refracted = glass & (lobe == 1) & ms.is_transmit.numpy()
    # glass lanes took both delta lobes, refraction and its TIR reflection
    assert (glass & (lobe == 0)).any() and refracted.any() and tir.any()
    np.testing.assert_allclose(ms.weight.numpy()[refracted], 0.97,
                               rtol=1e-6)
    np.testing.assert_allclose(ms.weight.numpy()[tir], 1.0, rtol=1e-6)
    # delta lobes evaluate to zero, as in the JAX package
    f, pdf = B._eval_single(mp, T(wo), ms.wi)
    assert not f.numpy()[glass].any() and not pdf.numpy()[glass].any()


# ---------------------------------------------------------------- compile

@pytest.mark.parametrize("table", ["geom", "materials", "lights", "textures",
                                   "nodes"])
def test_caustic_tables_match_jax(caustic, table):
    """The port's compile of its caustic_grad_builder equals the JAX
    package's compile of tests/scenes.py's (carried across by
    scene_from_numpy), table by table."""
    js, ts = caustic
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    _equal_tables(getattr(ts, table), getattr(want, table))
    if table == "materials":
        assert ts.materials.present_types == (0, MAT_GLASS)
        assert float(ts.materials.ior[3]) == 1.5
    if table == "textures":
        # well under fast_grad.MATMUL_GRAD_ROWS: take's one-hot backward
        assert ts.textures.texel_pool.shape == (1366, 4)


# --------------------------------------------------- image and gradients

def _pixels(res):
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    pid = (yy * res + xx).reshape(-1).astype(np.uint32)
    return ((xx.reshape(-1) + 0.5).astype(np.float32),
            (yy.reshape(-1) + 0.5).astype(np.float32), pid)


@pytest.fixture(scope="module")
def jax_caustic(caustic):
    """bench.py's caustic loss on the JAX side, jitted once: the image
    and the gradients with respect to (ior, texel_pool)."""
    js, _ = caustic
    cfg = jmake_integrator({"type": "pathtracing", "bounces": BOUNCES})

    def loss(theta, px, py, pid, sidx):
        ior, texels = theta
        sc = js.replace(materials=js.materials.replace(ior=ior),
                        textures=js.textures.replace(texel_pool=texels))
        lu = jsampler.rand1(pid, sidx, 0, 777)
        lv = jsampler.rand1(pid, sidx, 0, 778)
        o, d, valid = jshoot_rays(sc.camera, px, py, lu, lv)
        rgb, _, _ = jintegrate(sc, cfg, o, d, valid, pid, sidx)
        return jnp.mean(rgb), rgb

    f = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (_, rgb), grads = f((js.materials.ior, js.textures.texel_pool),
                        *_pixels(RES), jnp.uint32(0))
    return np.asarray(rgb), [np.asarray(g) for g in grads]


def _port_caustic_grads(ts):
    """The same loss through the port: shoot_rays -> integrate -> autograd
    (the lens samples do not enter: the camera has no aperture)."""
    ior = ts.materials.ior.clone().requires_grad_(True)
    texels = ts.textures.texel_pool.clone().requires_grad_(True)
    sc = dataclasses.replace(
        ts, materials=dataclasses.replace(ts.materials, ior=ior),
        textures=dataclasses.replace(ts.textures, texel_pool=texels))
    px, py, pid = _pixels(RES)
    o, d, valid = shoot_rays(sc.camera, T(px), T(py))
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    rgb, _, _ = integrate(sc, cfg, o, d, valid, T(pid.astype(np.int64)), 0)
    grads = torch.autograd.grad(rgb.mean(), [ior, texels])
    return rgb.detach().numpy(), [g.numpy() for g in grads]


def test_caustic_image_and_grads_match_jax(caustic, jax_caustic):
    """The 8x8 image as bench.py's forward computes it, then the gradients
    of its mean with respect to the IOR column and the texel pool."""
    _, ts = caustic
    want_rgb, want = jax_caustic
    rgb, got = _port_caustic_grads(ts)
    assert np.isfinite(rgb).all() and rgb.mean() > 0
    _assert_mostly_close(rgb, want_rgb)
    assert abs(rgb.mean() - want_rgb.mean()) <= 1e-3 * want_rgb.mean()
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-7)
    g_ior, g_tex = got
    assert g_ior[3] != 0 and not np.delete(g_ior, 3).any()   # glass row only
    assert int((g_tex != 0).any(-1).sum()) > 4               # many texels


def test_ior_grad_matches_finite_differences(caustic):
    """The port's AD gradient of the IOR against a central difference of
    its own loss (step 3e-3), with the picks and bounds of
    tests/test_gradients.py::test_grad_ior_through_specular_paths: the
    sign, and within rel 0.25."""
    _, ts = caustic
    px, py, pid = _pixels(RES)
    o, d, valid = shoot_rays(ts.camera, T(px), T(py))
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})

    def loss(ior):
        sc = dataclasses.replace(ts, materials=dataclasses.replace(
            ts.materials, ior=ior))
        return integrate(sc, cfg, o, d, valid, T(pid.astype(np.int64)),
                         0)[0].mean()

    leaf = ts.materials.ior.clone().requires_grad_(True)
    ad = float(torch.autograd.grad(loss(leaf), leaf)[0][3])
    e = 3e-3
    with torch.no_grad():
        up, down = ts.materials.ior.clone(), ts.materials.ior.clone()
        up[3] += e
        down[3] -= e
        fd = (float(loss(up)) - float(loss(down))) / (2 * e)
    assert abs(fd) > 1e-5
    assert ad == pytest.approx(fd, rel=0.25, abs=1e-6), (ad, fd)
