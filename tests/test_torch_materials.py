"""Every material type of the port against the JAX package, per lane: the
GGX functions of rough glass; `eval_bsdf`, `sample_bsdf` and
`transparency` for the coated-glossy, rough-glass, mirror, null, blend and
mask materials, the Oren-Nayar shiny-diffuse wall, the dispersive glass
with Beer absorption, the sss glass and the transparent shiny-diffuse of
`materials_cornell_builder`; the blend and mask factors a texture node
drives; the dispersed glass sample with `wl_to_rgb`.

The scene is compiled by the JAX package (with its own SceneBuilder filling
the port's `materials_cornell_builder`) and carried across with
`scene_from_numpy`; the shading points are made from seeded numpy lanes
(positions in the box, random frames, outgoing and incoming directions on
both sides). The JAX functions run eagerly (each op its own computation, so
XLA contracts nothing into fused multiply-adds), once over the lanes of
every material (`jax_per_material`).

Tolerances, each observed worst case in brackets: f, pdf, the sample's
direction, weight and pdf within atol 1e-5 [5.7e-7 on the glossy lobes'
weights], or rtol 1e-4 where a Blinn or GGX power amplifies XLA's rsqrt
(PERF.md section 2); lobe, delta, transmit, valid and dispersed flags equal
on every lane; the blend factor and the transparency filter within 1e-6;
GGX within rtol 1e-6, its sampled half vector within atol 1e-4 [4.4e-5:
XLA's CPU rsqrt, magnified by sqrt(1 - cos^2) where cos is near 1], and so
rough glass's sampled direction within atol 2e-4 [1.3e-4 on 2 of 2,048
lanes]; its sample's weight and pdf at the JAX package's direction (near
grazing or the critical angle f * cos / pdf magnifies a 4.5e-6 turn of
the direction to 4.7% on 8 of 2,048 lanes; at the same direction the
weight and pdf are within 1.9e-4 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import color as JC
from libyafaray_tpu.materials import bsdf as JB
from libyafaray_tpu.materials import microfacet as JMF
from libyafaray_tpu.ops import surface as JS
from libyafaray_tpu_torch.color import wl_to_rgb
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.materials import bsdf as B
from libyafaray_tpu_torch.materials import microfacet as MF
from libyafaray_tpu_torch.ops import surface as S
from libyafaray_tpu_torch.scene_types import (MAT_BLEND, MAT_COATED_GLOSSY,
                                              MAT_MASK, MAT_MIRROR, MAT_NULL,
                                              MAT_ROUGH_GLASS)
from libyafaray_tpu_torch.scenes import materials_cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401

N = 2048
ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, the port's scene carried across) of the materials
    Cornell box, and the material names by row."""
    b = materials_cornell_builder(8, 8, builder=JSceneBuilder())
    js = b.compile("cam")
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    return js, ts, list(b.material_order)


def _frame(rng, n):
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a = np.where(np.abs(nrm[:, :1]) > 0.9, [[0, 1, 0]], [[1, 0, 0]])
    nu = np.cross(nrm, a).astype(np.float32)
    nu /= np.linalg.norm(nu, axis=1, keepdims=True)
    nv = np.cross(nrm, nu).astype(np.float32)
    return nrm, nu, nv


def _surfaces(rng, mat_id):
    """The same shading points for both packages: (JAX SurfacePoint, the
    port's)."""
    n = len(mat_id)
    p = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    nrm, nu, nv = _frame(rng, n)
    ng = np.where(rng.random((n, 1)) < 0.8, nrm, -nrm).astype(np.float32)
    f = dict(valid=np.ones(n, bool), p=p, n=nrm, ng=ng, nu=nu, nv=nv,
             uv=rng.random((n, 2)).astype(np.float32),
             dp_du=np.zeros((n, 3), np.float32),
             dp_dv=np.zeros((n, 3), np.float32),
             mat_id=np.asarray(mat_id, np.int32),
             obj_id=np.zeros(n, np.int32), light_id=np.full(n, -1, np.int32),
             prim=np.zeros(n, np.int32), t=np.ones(n, np.float32),
             bary=np.zeros((n, 2), np.float32))
    jsp = JS.SurfacePoint(orco=jnp.asarray(p),
                          **{k: jnp.asarray(v) for k, v in f.items()})
    return jsp, S.SurfacePoint(**{k: T(v) for k, v in f.items()})


def _dirs(rng, n):
    w = rng.standard_normal((n, 3)).astype(np.float32)
    return w / np.linalg.norm(w, axis=1, keepdims=True)


def _lanes(rng, scenes, name):
    """Shading points of material `name` on every lane, wo and wi, and
    three uniforms (with edge values)."""
    _, _, names = scenes
    jsp, sp = _surfaces(rng, np.full(N, names.index(name)))
    u = [rng.random(N).astype(np.float32) for _ in range(3)]
    u[2][:6] = [0.0, 1.0 - 2 ** -24, 0.5, 0.04, 0.96, 1e-7]
    return jsp, sp, _dirs(rng, N), _dirs(rng, N), u


def _close(got, want, name, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=name)


# the materials this slice ports, with the tolerance of their floats
# (rtol for the lobes that raise a Blinn or GGX power)
MATERIALS = [("coated", 1e-4), ("rough", 1e-4), ("mirror", 0.0),
             ("nothing", 0.0), ("blend", 0.0), ("mask", 0.0), ("red", 0.0),
             ("prism", 0.0), ("jade", 0.0), ("veil", 0.0)]


def test_the_scene_holds_every_material_type(scenes):
    _, ts, _ = scenes
    m = ts.materials
    for ty in (MAT_COATED_GLOSSY, MAT_ROUGH_GLASS, MAT_MIRROR, MAT_NULL,
               MAT_BLEND, MAT_MASK):
        assert ty in m.present_types
    assert m.has_oren and m.has_blend and m.has_mask and m.has_dispersion
    assert m.has_beer and m.has_sss
    assert {"node_blend"} <= set(ts.nodes.bound)


# ------------------------------------------------------------------ GGX

def test_ggx_matches_jax(rng):
    n = 4096
    cos_h = rng.uniform(-0.2, 1.0, n).astype(np.float32)
    alpha = rng.uniform(0.02, 1.0, n).astype(np.float32)
    a2 = alpha * alpha
    u1, u2 = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    u1[:3] = [0.0, 1.0 - 2 ** -24, 0.5]
    cos_i = rng.uniform(-1, 1, n).astype(np.float32)
    pairs = [
        (MF.ggx_d(T(cos_h), T(a2)), JMF.ggx_d(cos_h, a2)),
        (MF.ggx_pdf_h(T(cos_h), T(a2)), JMF.ggx_pdf_h(cos_h, a2)),
        (MF.ggx_smith_g1(T(cos_i), T(a2)), JMF.ggx_smith_g1(cos_i, a2)),
        (MF.ggx_g(T(cos_i), T(cos_h), T(a2)), JMF.ggx_g(cos_i, cos_h, a2))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    # the sampled half vector: XLA's CPU rsqrt of 1 + tan^2 is not
    # correctly rounded, and sin = sqrt(1 - cos^2) magnifies its last bit
    # where cos is near 1
    np.testing.assert_allclose(
        MF.ggx_sample_h(T(u1), T(u2), T(alpha)).numpy(),
        np.asarray(JMF.ggx_sample_h(u1, u2, alpha)), rtol=0, atol=1e-4)
    h = MF.ggx_sample_h(T(u1), T(u2), T(alpha)).numpy()
    np.testing.assert_allclose(np.linalg.norm(h, axis=1), 1.0, rtol=1e-6)
    assert (h[:, 2] > 0).all()


# ------------------------------------------------------- per material

@pytest.fixture(scope="module")
def jax_per_material(scenes):
    """For each material, the JAX package's eval_bsdf, sample_bsdf (with
    the sample test's wavelengths) and transparency on the lanes that the
    tests draw (`_lanes` from the `rng` fixture's seed). Eager JAX costs
    per op, not per lane, so each function runs once, over the lanes of
    every material together; each lane's result is its own, so every
    material's slice is what its own call gives."""
    js = scenes[0]
    per = []
    for name, _ in MATERIALS:
        rng = np.random.default_rng(42)           # conftest's `rng`
        jsp, _, wo, wi, u = _lanes(rng, scenes, name)
        per.append((jsp, wo, wi, u, rng.random(N).astype(np.float32)))
    cat = lambda *xs: jnp.concatenate([jnp.asarray(x) for x in xs])
    jsp = jax.tree_util.tree_map(cat, *(p[0] for p in per))
    wo, wi = cat(*(p[1] for p in per)), cat(*(p[2] for p in per))
    u1, u2, u3 = (cat(*(p[3][k] for p in per)) for k in range(3))
    wl = cat(*(p[4] for p in per))
    outs = (JB.eval_bsdf(js, jsp, wo, wi),
            JB.sample_bsdf(js, jsp, wo, u1, u2, u3, wl=wl),
            JB.transparency(js, jsp, wo))
    return {name: jax.tree_util.tree_map(lambda x: x[i * N:(i + 1) * N],
                                         outs)
            for i, (name, _) in enumerate(MATERIALS)}


@pytest.mark.parametrize("name,rtol", MATERIALS)
def test_eval_bsdf_matches_jax(rng, scenes, jax_per_material, name, rtol):
    js, ts, _ = scenes
    jsp, sp, wo, wi, _ = _lanes(rng, scenes, name)
    f, pdf = B.eval_bsdf(ts, sp, T(wo), T(wi))
    jf, jpdf = jax_per_material[name][0]
    _close(f, jf, "f", rtol)
    _close(pdf, jpdf, "pdf", rtol)
    if name not in ("mirror", "nothing", "prism", "jade"):
        assert float(f.abs().max()) > 0      # a non-delta lobe is lit


@pytest.mark.parametrize("name,rtol", MATERIALS)
def test_sample_bsdf_matches_jax(rng, scenes, jax_per_material, name, rtol):
    js, ts, _ = scenes
    jsp, sp, wo, _, (u1, u2, u3) = _lanes(rng, scenes, name)
    wl = rng.random(N).astype(np.float32)
    ms = B.sample_bsdf(ts, sp, T(wo), T(u1), T(u2), T(u3), wl=T(wl))
    jms = jax_per_material[name][1]
    for flag in ("is_delta", "is_transmit", "valid", "lobe", "dispersed"):
        np.testing.assert_array_equal(getattr(ms, flag).numpy(),
                                      np.asarray(getattr(jms, flag)),
                                      err_msg=flag)
    if name != "rough":
        for v in ("wi", "weight", "pdf"):
            _close(getattr(ms, v), getattr(jms, v), v, rtol)
    else:
        _rough_sample_matches(ts, sp, wo, ms, jms)
    if name != "nothing":       # null scatters nothing
        assert ms.valid.numpy().any()


def _rough_sample_matches(ts, sp, wo, ms, jms):
    """Rough glass: the sampled direction carries ggx_sample_h's rsqrt
    difference (within 2e-4), and near grazing or the critical angle
    f * cos / pdf magnifies a turn of 1e-5 to several percent. So the
    sample's weight and pdf are held at the JAX package's own direction:
    the port's eval there gives the JAX weight and pdf (rtol 5e-4: the
    JAX direction is the world-space rounding of its local sample, which
    the eval takes back to local; 1.9e-4 observed), and the port's sample
    weight is its own eval at its own direction (the same rtol, for the
    same rounding; 1.1e-4 observed)."""
    _close(ms.wi, jms.wi, "wi", 0.0, 2e-4)
    nd = (ms.valid & ~ms.is_delta).numpy()
    assert nd.mean() > 0.5
    for wi, want_w, want_pdf, rtol in (
            (T(np.asarray(jms.wi)), jms.weight, jms.pdf, 5e-4),
            (ms.wi, ms.weight, ms.pdf, 5e-4)):
        f, pdf = B.eval_bsdf(ts, sp, T(wo), wi)
        cos = torch.abs((wi * sp.n).sum(-1))
        w = f * (cos / torch.clamp_min(pdf, 1e-9))[..., None]
        _close(w[nd], np.asarray(want_w)[nd], "weight", rtol)
        _close(pdf[nd], np.asarray(want_pdf)[nd], "pdf", rtol)


@pytest.mark.parametrize("name", [m for m, _ in MATERIALS])
def test_transparency_matches_jax(rng, scenes, jax_per_material, name):
    js, ts, _ = scenes
    jsp, sp, wo, _, _ = _lanes(rng, scenes, name)
    tr = B.transparency(ts, sp, T(wo))
    _close(tr, jax_per_material[name][2], "transparency", atol=1e-6)
    want = {"nothing": 1.0, "veil": 0.5}.get(name)
    if want is not None:
        # null passes everything; the veil half, white-filtered
        np.testing.assert_allclose(tr.numpy(), want)
    elif name != "mask":
        assert not tr.numpy().any()


# ------------------------------------------------------- blend and mask

def test_node_driven_blend_and_mask_factors(rng, scenes):
    """The blend and mask factors come from the texture node on global
    coordinates: per lane equal to the JAX package's, varying over the
    box, and each mask lane resolves to the sub-material its factor
    picks."""
    js, ts, names = scenes
    ids = np.asarray([names.index(m) for m in ("blend", "mask")] * (N // 2))
    jsp, sp = _surfaces(rng, ids)
    bl = B.blend_factor(ts, sp)
    np.testing.assert_allclose(bl.numpy(), np.asarray(JB.blend_factor(js, jsp)),
                               rtol=0, atol=1e-6)
    assert float(bl.std()) > 0.05
    mp = B.resolve_mp(ts, sp)
    jmp = JB.resolve_mp(js, jsp)
    np.testing.assert_array_equal(mp.mat_type.numpy(),
                                  np.asarray(jmp.mat_type))
    is_mask = ids == names.index("mask")
    picked = np.where(bl.numpy() > 0.53, names.index("green"),
                      names.index("white"))
    white = ts.materials.mat_type[names.index("white")]
    assert (mp.mat_type.numpy()[is_mask] == int(white)).all()
    np.testing.assert_allclose(
        mp.diffuse_color.numpy()[is_mask],
        ts.materials.diffuse_color.numpy()[picked[is_mask]])
    # both sub-materials picked somewhere
    assert 0 < (picked[is_mask] == names.index("green")).mean() < 1


def test_blend_sample_picks_each_sub_material(rng, scenes):
    """u3 below the blend factor samples material 2 (the blue
    shiny-diffuse), above it material 1 (the mirror): delta lobes on one
    side, diffuse ones on the other."""
    _, ts, _ = scenes
    _, sp, wo, _, (u1, u2, _) = _lanes(rng, scenes, "blend")
    bl = B.blend_factor(ts, sp).numpy()
    u3 = np.where(np.arange(N) % 2 == 0, 0.9 * bl, 0.999999).astype(
        np.float32)
    ms = B.sample_bsdf(ts, sp, T(wo), T(u1), T(u2), T(u3))
    lobe = ms.lobe.numpy()
    mirror = (u3 >= bl)
    assert (lobe[mirror] == 0).all()
    assert set(np.unique(lobe[~mirror])) <= {0, 3}
    assert (lobe[~mirror] == 3).any()


# ------------------------------------------------------------ dispersion

def test_wl_to_rgb_matches_jax(rng):
    wl = rng.random(4096).astype(np.float32)
    wl[:3] = [0.0, 0.5, 1.0]
    got = wl_to_rgb(T(wl)).numpy()
    np.testing.assert_allclose(got, np.asarray(JC.wl_to_rgb(jnp.asarray(wl))),
                               rtol=1e-6, atol=1e-7)
    # close to white on average over the wavelengths
    mean = wl_to_rgb(torch.linspace(0, 1, 4097)).mean(0).numpy()
    np.testing.assert_allclose(mean, 1.0, atol=0.1)


@pytest.fixture(scope="module")
def prism():
    """The Cornell box with a dispersive glass box and no blend material
    (tests/scenes.py's cornell_builder, compiled by the JAX package and
    carried across)."""
    from scenes import _box, cornell_builder
    b = cornell_builder(extras=[("prism", {"type": "glass", "IOR": 1.5,
                                           "dispersion_power": 0.5})])
    b.create_object("prism")
    b.set_current_material("prism")
    _box(b, (0.3, 0.3, 0.1), (0.3, 0.2, 0.3))
    js = b.compile("cam")
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js)), \
        list(b.material_order)


def _prism_samples(rng, scenes, wls):
    js, ts, _ = scenes
    jsp, sp, wo, _, (u1, u2, _) = _lanes(rng, scenes, "prism")
    u3 = np.full(N, 0.999, np.float32)       # the transmit lobe
    out = []
    for wl in wls:
        w = np.full(N, wl, np.float32)
        ms = B.sample_bsdf(ts, sp, T(wo), T(u1), T(u2), T(u3), wl=T(w))
        jms = JB.sample_bsdf(js, jsp, jnp.asarray(wo), jnp.asarray(u1),
                             jnp.asarray(u2), jnp.asarray(u3),
                             wl=jnp.asarray(w))
        for flag in ("dispersed", "is_delta", "is_transmit"):
            np.testing.assert_array_equal(getattr(ms, flag).numpy(),
                                          np.asarray(getattr(jms, flag)))
        _close(ms.wi, jms.wi, "wi")
        _close(ms.weight, jms.weight, "weight")
        out.append(ms)
    return out


def test_dispersed_glass_sample(rng, prism):
    """The prism's refractions are marked dispersed and their direction
    follows the wavelength (the IOR shifts by (wl - 0.5) * 0.5); its
    reflections are not dispersed."""
    blue, red = _prism_samples(rng, prism, (0.0, 1.0))
    disp = blue.dispersed.numpy()
    assert disp.mean() > 0.5
    assert (disp == (blue.is_delta & blue.is_transmit).numpy()).all()
    bend = np.abs(blue.wi.numpy() - red.wi.numpy()).max(1)
    assert np.median(bend[disp]) > 1e-3


def test_blend_scenes_drop_the_dispersion_shift(rng, scenes):
    """In a scene with a blend material sample_bsdf re-resolves every
    lane's material, so the wavelength's IOR shift is lost: the prism of
    the materials Cornell box refracts the same way at both ends of the
    spectrum, while its refractions are still marked dispersed (and the
    path still tinted). The same in both packages (ROADMAP section 3)."""
    blue, red = _prism_samples(rng, scenes, (0.0, 1.0))
    assert blue.dispersed.numpy().mean() > 0.5
    np.testing.assert_array_equal(blue.wi.numpy(), red.wi.numpy())
