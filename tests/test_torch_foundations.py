"""The port's foundations against the JAX package: the counter-based sampler
bit for bit, the vector helpers to 1e-6, the ParamMap, a package that
imports and builds a scene without JAX, and the one boundary between the
kernels' wrappers and their C entry points (`csrc_build`: the device rule,
the launch call and its counter).

Inputs are made with numpy from a seed and fed to both packages.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import params as JP
from libyafaray_tpu import sampler as JS
from libyafaray_tpu.math import vec as JV
from libyafaray_tpu_torch import csrc_build
from libyafaray_tpu_torch import params as TP
from libyafaray_tpu_torch import sampler as TS
from libyafaray_tpu_torch.math import vec as TV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process for the port's test modules (they
    import this fixture): the port's tensors here are small, and when the
    suite runs in parallel workers the idle OpenMP threads of torch's pool
    spin on the cores that the JAX side of every test needs (measured on
    the two instancing and motion files with 5 workers: 132 s with the
    default pool, 38 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# uint32 values at the edges of the range and of the hash constants
EDGES = np.array([0, 1, 2, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**32 - 2,
                  2**32 - 1, 0x9E3779B9, 0x9E3779B8, 0x9E3779BA, 1664525,
                  1013904223, 0x6C50B47C, 0x8D22F6E6], np.uint64)


def _u32(rng, n):
    """n uint32 values (as uint64) with the edge values up front."""
    v = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    v[:len(EDGES)] = EDGES
    return v


def _jax_u32(a):
    return jnp.asarray(np.asarray(a, np.uint64).astype(np.uint32))


def _torch_u32(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def test_pcg4d_bit_exact(rng):
    v = np.stack([_u32(rng, 4096) for _ in range(4)], -1)
    v[:len(EDGES)] = EDGES[:, None]          # all four lanes at each edge
    v[len(EDGES):2 * len(EDGES), 1] = EDGES[::-1]
    want = np.asarray(jax.jit(JS.pcg4d)(_jax_u32(v))).astype(np.int64)
    got = TS.pcg4d(_torch_u32(v)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth,dim", [(0, 2), (3, 10), (7, 777),
                                       (2**32 - 1, 0x9E3779B9)])
def test_rand4_bit_exact(rng, depth, dim):
    pid, sidx = _u32(rng, 2048), _u32(rng, 2048)[::-1].copy()
    want = np.asarray(jax.jit(lambda p, s: JS.rand4(p, s, depth, dim))(
        _jax_u32(pid), _jax_u32(sidx)))
    got = TS.rand4(_torch_u32(pid), _torch_u32(sidx), depth, dim).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() <= np.float32(0.99999994) and got.min() >= 0.0


def test_u32_to_unit_float_rounds_like_jax():
    # float32 rounding of uint32 values: ties, values that round up to 2^32
    # (clamped below 1), and exact powers of two
    v = np.array([0, 1, 2**24 + 1, 2**24 + 3, 2**25 + 2, 2**31 + 128,
                  2**31 + 129, 2**32 - 129, 2**32 - 128, 2**32 - 1,
                  0x9E3779B9], np.uint64)
    want = np.asarray(jax.jit(JS._u32_to_unit_float)(_jax_u32(v)))
    got = TS._u32_to_unit_float(_torch_u32(v)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["reverse_bits", "owen_hash", "lp"])
def test_bit_helpers_exact(rng, fn):
    x, seed = _u32(rng, 4096), _u32(rng, 4096)[::-1].copy()
    if fn == "reverse_bits":
        want = jax.jit(JS._reverse_bits32)(_jax_u32(x))
        got = TS._reverse_bits32(_torch_u32(x))
    elif fn == "owen_hash":
        want = jax.jit(JS._owen_hash)(_jax_u32(x), _jax_u32(seed))
        got = TS._owen_hash(_torch_u32(x), _torch_u32(seed))
    else:
        want = jax.jit(JS.larcher_pillichshammer)(_jax_u32(x), _jax_u32(seed))
        got = TS.larcher_pillichshammer(_torch_u32(x), _torch_u32(seed))
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sample_idx", [0, 1, 15, 2**31, 2**32 - 1,
                                        0x9E3779B9])
def test_ld02_bit_exact(rng, sample_idx):
    key = _u32(rng, 4096)
    want = jax.jit(lambda k: JS.ld02(jnp.uint32(sample_idx), k))(_jax_u32(key))
    got = TS.ld02(sample_idx, _torch_u32(key))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _vecs(rng, n=1024, unit=False):
    a = rng.standard_normal((n, 3)).astype(np.float32)
    if unit:
        a /= np.linalg.norm(a, axis=-1, keepdims=True)
    return a


def test_vec_helpers_match(rng):
    """dot, cross, normalize, local frames and the samplers' warps, to 1e-6."""
    a, b = _vecs(rng), _vecs(rng)
    n = _vecs(rng, unit=True)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0.6, 0.8, 0.0]]
    u1, u2 = (rng.random(1024).astype(np.float32) for _ in range(2))
    pa, pb = (np.abs(rng.standard_normal(1024)).astype(np.float32)
              for _ in range(2))
    pb[:8] = 0.0
    pa[:4] = 0.0

    def jax_all(a, b, n, u1, u2, pa, pb):
        fu, fv = JV.orthonormal_basis(n)
        loc = JV.to_local(a, fu, fv, n)
        return dict(
            dot=JV.dot(a, b), cross=JV.cross(a, b), normalize=JV.normalize(a),
            basis_u=fu, basis_v=fv, to_local=loc,
            from_local=JV.from_local(loc, fu, fv, n),
            cosine=JV.cosine_sample_hemisphere(u1, u2),
            tri=jnp.stack(JV.sample_triangle_uniform(u1, u2), -1),
            power=JV.power_heuristic(pa, pb),
            fresnel=JV.fresnel_dielectric(u1 * 2 - 1, 1.0 + pa))

    want = jax.jit(jax_all)(a, b, n, u1, u2, pa, pb)
    t = [torch.from_numpy(x) for x in (a, b, n, u1, u2, pa, pb)]
    ta, tb, tn, tu1, tu2, tpa, tpb = t
    fu, fv = TV.orthonormal_basis(tn)
    loc = TV.to_local(ta, fu, fv, tn)
    got = dict(
        dot=TV.dot(ta, tb), cross=TV.cross(ta, tb), normalize=TV.normalize(ta),
        basis_u=fu, basis_v=fv, to_local=loc,
        from_local=TV.from_local(loc, fu, fv, tn),
        cosine=TV.cosine_sample_hemisphere(tu1, tu2),
        tri=torch.stack(TV.sample_triangle_uniform(tu1, tu2), -1),
        power=TV.power_heuristic(tpa, tpb),
        fresnel=TV.fresnel_dielectric(tu1 * 2 - 1, 1.0 + tpa))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_cross_keeps_the_fma_residual_sign():
    """A vertical face's normal has an analytically zero z. XLA's CPU code
    evaluates jnp.cross as fma(a_i, b_j, -(a_j*b_i)), which leaves the
    rounding residual there; the port's cross does the same, so the
    branchless frame picks the JAX package's side."""
    c, s = np.float32(np.cos(0.35)), np.float32(np.sin(0.35))
    e1 = np.array([[0.3 * c, 0.3 * s, 0.0]], np.float32)
    e2 = np.array([[0.3 * c, 0.3 * s, 0.6]], np.float32)
    want = np.asarray(jax.jit(jnp.cross)(e1, e2))
    got = TV.cross(torch.from_numpy(e1), torch.from_numpy(e2)).numpy()
    np.testing.assert_array_equal(got, want)


def test_parammap_getters_match():
    pm = {"i": 3.7, "b": 1, "f": "2.5", "s": 7, "v": [1, 2, 3],
          "c1": 0.5, "c3": (0.1, 0.2, 0.3), "c4": (0.1, 0.2, 0.3, 0.4)}
    j, t = JP.ParamMap(pm), TP.ParamMap(pm)
    assert t.get_int("i") == j.get_int("i")
    assert t.get_bool("b") == j.get_bool("b")
    assert t.get_float("f") == j.get_float("f")
    assert t.get_string("s") == j.get_string("s")
    assert t.get_string("missing", "x") == j.get_string("missing", "x")
    np.testing.assert_array_equal(t.get_vector("v"), j.get_vector("v"))
    for k in ("c1", "c3", "c4", "missing"):
        np.testing.assert_array_equal(t.get_color(k), j.get_color(k))


def test_package_imports_and_builds_without_jax():
    """The port never imports jax or flax: with both blocked, importing the
    package, compiling the Cornell box and rendering a few pixels works."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import libyafaray_tpu_torch as P\n"
        "from libyafaray_tpu_torch import convert, film, io\n"
        "from libyafaray_tpu_torch.accel import probe_smem\n"
        "from libyafaray_tpu_torch.scenes import forest_builder\n"
        "from libyafaray_tpu_torch.scenes import instances_builder\n"
        "true = {'instancing': 'true', 'scene_accelerator': 'blocks'}\n"
        "fb = forest_builder(n_inst=3, n_moving=1, grid=8)\n"
        "fb.set_render_params(true)\n"
        "fs = fb.compile('cam', device='cpu')\n"
        "assert fs.geom.has_motion and fs.blocks.blk_base is not None\n"
        "ib = instances_builder()\n"
        "ib.set_render_params(true)\n"
        "assert ib.compile('cam', device='cpu').geom.inst_mat is not None\n"
        "assert probe_smem.probe_smem('cpu')[0].sum() == 2048\n"
        "from libyafaray_tpu_torch.scenes import cornell_builder\n"
        "b = cornell_builder()\n"
        "b.cameras['cam']['resx'] = b.cameras['cam']['resy'] = 4\n"
        "scene = b.compile('cam', device='cpu')\n"
        "assert scene.geom.num_faces == 36, scene.geom.num_faces\n"
        "f = P.render(scene, P.make_integrator({'bounces': 1}), spp=1,\n"
        "             device='cpu')\n"
        "assert film.resolve(f).shape == (4, 4, 4)\n"
        "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'libyafaray_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_JAX_OK" in res.stdout


def test_no_module_of_the_port_names_jax():
    pkg = os.path.join(REPO, "libyafaray_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as fh:
                for line in fh:
                    words = line.split()
                    if words[:1] in (["import"], ["from"]):
                        mod = words[1].split(".")[0]
                        assert mod not in ("jax", "flax", "libyafaray_tpu"), \
                            f"{name}: {line.strip()}"


@pytest.mark.parametrize("device", ["cpu", "cuda", "meta"])
def test_the_device_rule_picks_the_plain_version_or_the_kernel(device):
    """A CPU device runs the plain version (`on_card` False), a CUDA device
    the kernel (True; a device, no card needed); any other device raises
    with today's text. `card`, for a kernel with no plain version, takes a
    CUDA device alone."""
    dev = torch.device(device)
    if device == "meta":
        with pytest.raises(ValueError, match="^wrap: no kernel for device "
                                             "meta$"):
            csrc_build.on_card("wrap", dev)
    else:
        assert csrc_build.on_card("wrap", dev) is (device == "cuda")
    if device == "cuda":
        assert csrc_build.card("wrap", device) == dev
    else:
        with pytest.raises(ValueError, match=f"^wrap: no kernel for device "
                                             f"{device}$"):
            csrc_build.card("wrap", dev)


class _Stream:
    cuda_stream = 7


def test_a_launch_counts_what_ran_and_raises_on_an_error(monkeypatch):
    """The launch call passes the stream last, counts a launch (and its
    arm) only when the entry returns 0, raises with the kernel's name on
    another code, and with check=False returns the code uncounted; on a
    device other than CUDA it raises before calling the entry. A fake
    entry stands in for the kernel."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream)
    monkeypatch.setattr(csrc_build, "launch_counts",
                        csrc_build.launch_counts.copy())
    calls, codes = [], [0, 0, 2, 3]

    def fake(*args):
        calls.append(args)
        return codes.pop(0)

    name = "kernel.fake.launches"
    assert csrc_build.launch("fake", fake, "cuda", 1, None) == 0
    assert csrc_build.launch("fake", fake, "cuda", 2, arm="static") == 0
    assert calls == [(1, None, 7), (2, 7)]
    with pytest.raises(RuntimeError, match=r"^fake kernel launch failed "
                                           r"\(CUDA error 2\)$"):
        csrc_build.launch("fake", fake, "cuda", 3, arm="static")
    assert csrc_build.launch("fake", fake, "cuda", 4, check=False) == 3
    with pytest.raises(ValueError, match="^fake: no kernel for device cpu$"):
        csrc_build.launch("fake", fake, "cpu", 5)
    assert len(calls) == 4 and not codes
    assert csrc_build.launch_counts[name] == 2
    assert csrc_build.launch_counts[name + ".static"] == 1
