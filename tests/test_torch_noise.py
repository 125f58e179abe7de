"""The noise bases and the procedural textures of the port against the JAX
package: the lattice hash (as integers, on negative lattice points and on
hashes next to 2^32), its float conversion, perlin, value noise, cellnoise,
voronoi's four distances, every NOISE_* kind of basis_noise, turbulence,
each procedural type (and a colour ramp) through sample_texture on a pool
that both packages build from the same parameters, the whole pool of the
procedural Cornell box with a texture per lane, and the pool columns
(used_types, used_noise and max_octaves included).

The JAX functions run eagerly, as the JAX package's own texture tests run
them: jitted, XLA may contract a product and a sum into one rounding.

Tolerances, each observed worst case in brackets:
  * hashes equal as integers [equal];
  * noise values and texture colours within 1e-5 absolute (PERF.md section
    2's texture bound) [4.2e-7: sin and pow round differently in the last
    bit; the hash-only bases are equal];
  * pools equal, tensors bit for bit;
  * a lookup of one known texture (`static_tex`) within 1e-6 of the
    lookup over the whole pool, in the port and in the JAX package with
    its pool's static sets narrowed the same way [6e-8 on one lane of
    1,368: a last bit of a transcendental, see the test].
No lane here falls in another lattice cell in the two packages: both
floor the same float32 products.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu import textures as JT
from libyafaray_tpu.textures import noise as JNZ
from libyafaray_tpu.textures import procedural as JP
from libyafaray_tpu_torch.scene import SceneBuilder
from libyafaray_tpu_torch.scenes import procedural_cornell_builder
from libyafaray_tpu_torch.textures import noise as NZ
from libyafaray_tpu_torch.textures import procedural as P
from libyafaray_tpu_torch.textures import sample_texture
from libyafaray_tpu_torch.textures.build import build_pool
from libyafaray_tpu_torch.convert import scene_from_numpy
from test_torch_caustic import _equal_tables
from test_torch_foundations import one_torch_thread  # noqa: F401

N = 4096
M32 = 0xFFFFFFFF


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def points():
    """4,096 seeded points in [-2, 2]^3."""
    return np.random.default_rng(11).uniform(-2, 2, (N, 3)).astype(
        np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ------------------------------------------------------------------ hashes

def _unmix(h: int) -> int:
    """The lattice sum whose mixed hash is h: the inverse of the hash's
    xorshift-multiply-xorshift finish."""
    h ^= h >> 16
    h = (h * pow(0x85EBCA6B, -1, 2 ** 32)) & M32
    return h ^ (h >> 13) ^ (h >> 26)


def _to_i32(x: int) -> int:
    return x - 2 ** 32 if x >= 2 ** 31 else x


def _lattice(rng):
    """Lattice points: random ones of either sign, the axes' extremes, and
    points whose hash (seed 0) is within 300 of 2^32."""
    pts = rng.integers(-2 ** 20, 2 ** 20, (2048, 3))
    pts[:8] = [(0, 0, 0), (-1, -1, -1), (2 ** 31 - 1, 0, 0),
               (-2 ** 31, 0, 0), (0, -2 ** 31, 2 ** 31 - 1), (1, -1, 1),
               (-7, 3, -2 ** 20), (2 ** 24, -2 ** 24, 5)]
    near = []
    for k, target in enumerate((M32, M32 - 1, M32 - 127, M32 - 128,
                                M32 - 129, M32 - 300)):
        iy, iz = int(rng.integers(-50, 50)), k
        s = (_unmix(target) - iy * 0xD8163841 - iz * 0xCB1AB31F) & M32
        ix = (s * pow(0x8DA6B343, -1, 2 ** 32)) & M32
        near.append((_to_i32(ix), iy, iz))
    return np.concatenate([pts, near]).astype(np.int32), len(near)


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_hashes_equal_as_integers(rng, seed):
    """_hash3 held in int64 and masked with M32 equals the JAX package's
    wrapping uint32 hash on every lattice point, negative ones included."""
    pts, n_near = _lattice(rng)
    want = np.asarray(JNZ._hash3(*(jnp.asarray(pts[:, k]) for k in range(3)),
                                 seed)).astype(np.int64)
    got = NZ._hash3(*(T(pts[:, k]) for k in range(3)), seed).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= M32
    if seed == 0:
        assert (got[-n_near:] >= M32 - 300).all()


def test_hash_unit_rounds_as_xla(rng):
    """The hash's float: a uint32 rounded to float32 and scaled by 2^-32.
    Hashes within 128 of 2^32 round up to exactly 1.0 (not clamped below
    1, unlike the sampler's draws), in both packages."""
    pts, n_near = _lattice(rng)
    args = [pts[:, k] for k in range(3)]
    want = np.asarray(JNZ._hash_unit(*(jnp.asarray(a) for a in args)))
    got = NZ._hash_unit(*(T(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    h = NZ._hash3(*(T(a) for a in args)).numpy()
    ones = got == 1.0
    assert ones.sum() >= 3 and (h[ones] >= M32 - 128).all()
    assert (got[h < M32 - 128] < 1.0).all()


# ------------------------------------------------------------ noise bases

@pytest.mark.parametrize("name", ["perlin", "value_noise", "cellnoise"])
def test_lattice_noise_matches_jax(points, name):
    p = points * 3.0
    for seed in (0, 5):
        got = getattr(NZ, name)(T(p), seed)
        want = getattr(JNZ, name)(jnp.asarray(p), seed)
        _close(got, want)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    assert float(got.std()) > 0.05


def test_voronoi_distances_match_jax(points):
    p = points * 2.0
    got = NZ.voronoi_f(T(p), 3)
    want = JNZ.voronoi_f(jnp.asarray(p), 3)
    for g, w in zip(got, want):
        _close(g, w)
    f = np.stack([g.numpy() for g in got])
    assert (np.diff(f, axis=0) >= 0).all()      # f1 <= f2 <= f3 <= f4


def test_basis_noise_every_kind_matches_jax(points):
    """basis_noise with every NOISE_* kind per lane, and static_basis_noise
    with each kind alone."""
    p = points * 2.5
    kind = np.arange(N, dtype=np.int32) % 9
    got = NZ.basis_noise(T(kind), T(p), 2).numpy()
    _close(got, JNZ.basis_noise(jnp.asarray(kind), jnp.asarray(p), 2))
    for k in range(9):
        sel = kind == k
        np.testing.assert_array_equal(
            NZ.static_basis_noise(k, T(p[sel]), 2).numpy(), got[sel])
    assert NZ.noise_type_id("voronoi_crackle") == JNZ.noise_type_id(
        "voronoi_crackle") == 8
    assert NZ.noise_type_id("nonsense") == JNZ.noise_type_id("nonsense")


@pytest.mark.parametrize("hard,kind", [(False, 0), (True, 1), (True, 2),
                                       (False, 4)])
def test_turbulence_matches_jax(points, hard, kind):
    size = np.float32(0.7)
    got = NZ.turbulence(T(points), 3, T(size), hard, kind, seed=1)
    want = JNZ.turbulence(jnp.asarray(points), 3, jnp.asarray(size), hard,
                          kind, seed=1)
    _close(got, want)


# ------------------------------------------------------- procedural types

TYPES = {
    "blend_quad": {"type": "blend", "stype": "quad"},
    "blend_sphere_flip": {"type": "blend", "stype": "sphere",
                          "use_flip_axis": True},
    "clouds_hard": {"type": "clouds", "size": 2.0, "depth": 3, "hard": True,
                    "bias": "negative", "noise_type": "stdperlin"},
    "marble_saw": {"type": "marble", "size": 2.0, "depth": 2,
                   "turbulence": 3.0, "sharpness": 2.0, "shape": "saw"},
    "wood_ringnoise": {"type": "wood", "wood_type": "ringnoise",
                       "shape": "tri", "turbulence": 2.0,
                       "noise_type": "voronoi_f2"},
    "voronoi": {"type": "voronoi", "size": 1.3, "weight1": 0.8,
                "weight2": 0.4, "weight3": -0.3, "weight4": 0.2,
                "intensity": 1.5},
    "musgrave_multifractal": {"type": "musgrave",
                              "musgrave_type": "multifractal",
                              "octaves": 3.5, "H": 0.6, "lacunarity": 2.2,
                              "noise_type": "voronoi_crackle"},
    "distorted_noise": {"type": "distorted_noise", "distort": 2.0,
                        "size": 1.5, "noise_type1": "stdperlin",
                        "noise_type2": "cellnoise"},
    "rgb_cube": {"type": "rgb_cube"},
    "clouds_ramp_hsl": {"type": "clouds", "size": 1.0, "depth": 1,
                        "use_color_ramp": True, "ramp_color_mode": "hsl",
                        "ramp_items": [
                            {"position": 0.2, "color": (0.9, 0.1, 0.1, 1)},
                            {"position": 0.5, "color": (0.1, 0.9, 0.3, 1)},
                            {"position": 0.8, "color": (0.2, 0.2, 0.9, 1)}],
                        "adj_contrast": 1.3, "adj_hue": 0.1},
}


def _one_texture(b, pm):
    b.create_texture("t", dict(pm, color1=(0.1, 0.2, 0.3),
                               color2=(0.9, 0.7, 0.5)))
    return b


@pytest.mark.parametrize("name", list(TYPES))
def test_procedural_type_matches_jax(points, name):
    """Each type alone in a pool both packages build: the pools equal, and
    sample_texture's rgba at 4,096 points in [-2, 2]^3 within 1e-5."""
    from libyafaray_tpu.textures.build import build_pool as jbuild_pool
    jpool = jbuild_pool(_one_texture(JSceneBuilder(), TYPES[name]))
    pool = build_pool(_one_texture(SceneBuilder(), TYPES[name]))

    class _S:        # the JAX SceneData fields sample_texture reads
        textures = jpool

    class _P:
        textures = pool
    from libyafaray_tpu_torch.convert import _textures
    _equal_tables(pool, _textures(jpool))
    tid = np.zeros(N, np.int32)
    want = np.asarray(JT.sample_texture(_S, jnp.asarray(tid),
                                        jnp.asarray(points),
                                        jnp.asarray(points[:, :2])))
    got = sample_texture(_P, T(tid), T(points), T(points[:, :2])).numpy()
    _close(got, want)
    assert np.isfinite(got).all() and got[:, :3].std() > 1e-3


def test_floor_modulo_wraps():
    """rgb cube's |p| % 1 and the saw band's (x / 2 pi) % 1 are floor
    modulo, as jnp's %: on negative bands torch.fmod would give negative
    values."""
    x = torch.tensor([-7.5, -0.25, -1e-8, 0.0, 3.25], dtype=torch.float32)
    saw = P._waveform(x, torch.ones_like(x)).numpy()
    want = np.asarray(JP._waveform(jnp.asarray(x.numpy()), 1))
    np.testing.assert_array_equal(saw, want)
    assert (saw >= 0).all() and (saw <= 1).all()


@pytest.fixture(scope="module")
def box_pools():
    """(JAX scene, the port's scene) of the procedural Cornell box: its
    pool holds all eight types, newperlin, stdperlin and cellnoise."""
    js = procedural_cornell_builder(
        16, 16, builder=JSceneBuilder()).compile("cam")
    return js, procedural_cornell_builder(16, 16).compile("cam",
                                                          device="cpu")


def test_box_pool_columns_match_jax(box_pools):
    import jax
    js, ts = box_pools
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    _equal_tables(ts.textures, want.textures)
    assert ts.textures.used_types == tuple(js.textures.used_types)
    assert ts.textures.used_noise == tuple(js.textures.used_noise) \
        == (0, 1, 2, 3)
    assert ts.textures.max_octaves == js.textures.max_octaves == 4


def test_box_pool_per_lane_matches_jax(points, box_pools):
    """The whole pool with a texture per lane (the multi-basis loops), and
    each texture looked up alone with its own static sets: in the port
    and in the JAX package (its pool's sets narrowed the same way) within
    1e-6 of the per-lane lookup. Not bit for bit: on the CPU torch's
    transcendentals round a lane in a vector body and in a scalar tail
    differently, and the two lookups lay the lanes out differently."""
    js, ts = box_pools
    n_tex = ts.textures.num_textures
    tid = (np.arange(N) % n_tex).astype(np.int32)
    want = np.asarray(JT.sample_texture(js, jnp.asarray(tid),
                                        jnp.asarray(points),
                                        jnp.asarray(points[:, :2])))
    got = sample_texture(ts, T(tid), T(points), T(points[:, :2])).numpy()
    _close(got, want)
    for t in range(n_tex):
        sel = tid == t
        alone = sample_texture(ts, T(tid[sel]), T(points[sel]),
                               T(points[sel, :2]), static_tex=t).numpy()
        _close(alone, got[sel], 1e-6)
        ty, noise, octs, _ = ts.textures.statics[t]
        narrow = js.replace(textures=js.textures.replace(
            used_types=(ty,), used_noise=noise or (0,), max_octaves=octs))
        jalone = np.asarray(JT.sample_texture(
            narrow, jnp.asarray(tid[sel]), jnp.asarray(points[sel]),
            jnp.asarray(points[sel, :2])))
        _close(jalone, want[sel], 1e-6)
