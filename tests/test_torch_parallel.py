"""Multi-device rendering of the port against the JAX package: the sharded
wavefront, the sharded render, the sharded train step, `film.psum_merge`,
the two-process render farm, and the sampler's farm and low-discrepancy
helpers (`host_sample_offset`, `halton`, `van_der_corput`).

The port's ranks are spawned processes on gloo over the CPU, started once
for the module (`spawned`): two ranks render, train, merge and run the
farm; a group of three, initialized from torch's environment variables,
meets the 64-pixel image that does not divide by it. Each rank runs with
one torch thread and writes what it computed to an npz. The JAX references
come from `make_mesh(2)` over the conftest's virtual CPU devices, each
jitted once (`jax_refs`); the JAX brute-force queries go through its Pallas
kernel in interpret mode, the path the port's `mt_closest_ref` follows.

Tolerances: the wavefront as `tests/test_render.py` holds JAX's sharded
wavefront (rtol 1e-5, atol 1e-6); the sharded render and the farm against
JAX the slice bound (PERF.md section 2); the train step rtol 1e-4, as
`tests/test_torch_gradients.py` holds the one-device step; the port's two
ranks against its own one-process computations exactly where the sum is
the same (`psum_merge`, the gathered wavefront, the farm merge within
1e-5 as JAX's own farm test); the sampler bit for bit.
"""
import contextlib
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import film as JF
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu import sampler as JS
from libyafaray_tpu.accel import pallas_intersect as JPI
from libyafaray_tpu.parallel import make_mesh as jmake_mesh
from libyafaray_tpu.parallel import make_train_step as jmake_train_step
from libyafaray_tpu.parallel import render_sharded as jrender_sharded
from libyafaray_tpu.parallel import \
    render_wavefront_sharded as jrender_wavefront_sharded
from libyafaray_tpu.parallel.distributed import \
    render_node_film as jrender_node_film
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, sampler
from libyafaray_tpu_torch.parallel import (_pixel_shard_radiance, make_mesh,
                                           make_train_step)
from libyafaray_tpu_torch.parallel.distributed import render_node_film
from libyafaray_tpu_torch.render import pixel_jitter
from libyafaray_tpu_torch.scenes import caustic_grad_builder, cornell_builder
from scenes import cornell_builder as jcornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_render import _assert_mostly_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 8           # the sharded tests of tests/test_render.py
FARM_RES, FARM_SPP = 16, 2   # tests/test_multihost.py's farm
TRAIN_STEPS = 3
PT1 = {"type": "pathtracing", "bounces": 1}
DL = {"type": "directlighting"}

_RANK = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.parallel import (
        make_mesh, make_train_step, render_sharded, render_wavefront_sharded)
    from libyafaray_tpu_torch.parallel.distributed import (
        init_distributed, render_node_film)
    from libyafaray_tpu_torch.scenes import (caustic_grad_builder,
                                             cornell_builder)
    out, coord = {out!r}, {coord!r}
    if coord:
        rank, world = init_distributed(coord, 2, int(sys.argv[1]),
                                       device="cpu", backend="gloo")
    else:       # the group of three: torch's environment variables
        rank, world = init_distributed(device="cpu", backend="gloo")
    mesh = make_mesh(device="cpu")
    info = dict(rank=rank, world=world, mesh=list(mesh.ranks),
                index=mesh.index, device=str(mesh.device))
    arrs = {{}}

    def scene(res):
        b = cornell_builder()
        b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
        return b.compile("cam", device="cpu")

    pt1 = make_integrator({{"type": "pathtracing", "bounces": 1}})
    if world == 3:
        try:
            render_wavefront_sharded(scene({res}), pt1, {res}, {res}, 0, mesh)
        except ValueError as e:
            info["error"] = str(e)
    else:
        sc = scene({res})
        arrs["rgb"], arrs["alpha"] = render_wavefront_sharded(
            sc, pt1, {res}, {res}, 0, mesh)
        film = render_sharded(sc, pt1, {res}, {res}, 2, mesh)
        arrs["sharded_weights"] = film.weights
        arrs["sharded_combined"] = film.layers["combined"]
        step = make_train_step(pt1, {res}, {res}, mesh, lr=0.05)
        params = {{"diffuse_color": sc.materials.diffuse_color}}
        target = torch.full(({res}, {res}, 3), 0.25)
        losses = []
        for i in range({steps}):
            params, loss = step(sc, params, target, 0)
            losses.append(loss)
            arrs[f"params{{i}}"] = params["diffuse_color"]
        arrs["losses"] = torch.stack(losses)
        csc = caustic_grad_builder({res}, {res}).compile("cam", device="cpu")
        cstep = make_train_step(make_integrator(
            {{"type": "pathtracing", "bounces": 2}}), {res}, {res}, mesh,
            lr=0.05)
        cparams = {{"ior": csc.materials.ior,
                    "textures.texel_pool": csc.textures.texel_pool}}
        for i in range({steps}):
            cparams, closs = cstep(csc, cparams, target, i)
            arrs[f"caustic_loss{{i}}"] = closs
            for k, v in cparams.items():
                arrs[f"caustic_{{k}}{{i}}"] = v
        own = render(sc, pt1, spp=1, computer_node=rank, device="cpu")
        merged = F.psum_merge(own, mesh)
        for name, f in (("own", own), ("merged", merged)):
            arrs[name + "_weights"] = f.weights
            arrs[name + "_combined"] = f.layers["combined"]
            arrs[name + "_splat"] = f.splat
            arrs[name + "_splat_paths"] = f.splat_paths
        first = make_mesh(1, device="cpu")
        info["first_mesh"] = list(first.ranks)
        if rank == 0:
            arrs["rgb_first"] = render_wavefront_sharded(
                sc, pt1, {res}, {res}, 0, first)[0]
        else:
            try:
                first.index
            except ValueError as e:
                info["first_error"] = str(e)
        render_node_film(scene({farm_res}),
                         make_integrator({{"type": "directlighting"}}),
                         {farm_res}, {farm_res}, spp={farm_spp}, node=rank,
                         out_dir=os.path.join(out, "farm"), device="cpu")
    np.savez(os.path.join(out, f"rank{{rank}}.npz"),
             **{{k: v.numpy() for k, v in arrs.items()}})
    with open(os.path.join(out, f"rank{{rank}}.json"), "w") as fh:
        json.dump(info, fh)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(out, world, env_init):
    """`world` ranks of `_RANK` writing into `out`: initialized from the
    arguments, or (`env_init`) from MASTER_ADDR / MASTER_PORT / WORLD_SIZE
    / RANK."""
    os.makedirs(out, exist_ok=True)
    port = _free_port()
    script = _RANK.format(repo=REPO, out=out, res=RES, steps=TRAIN_STEPS,
                          farm_res=FARM_RES, farm_spp=FARM_SPP,
                          coord="" if env_init else f"127.0.0.1:{port}")
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        if env_init:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(r)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Starts the two ranks and the group of three (they run while the
    JAX references compile); returns {world: (out dir, processes)}."""
    groups = {}
    for world in (2, 3):
        out = str(tmp_path_factory.mktemp(f"ranks{world}"))
        groups[world] = (out, _start(out, world, env_init=world == 3))
    yield groups
    for _, procs in groups.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


def _wait(out, procs):
    ranks = []
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the spawned gloo ranks did not finish in 300 s")
        assert p.returncode == 0, f"rank {r} failed:\n" \
            f"{log.decode(errors='replace')[-3000:]}"
        with open(os.path.join(out, f"rank{r}.json")) as fh:
            info = json.load(fh)
        with np.load(os.path.join(out, f"rank{r}.npz")) as data:
            ranks.append((info, dict(data)))
    return ranks


@pytest.fixture(scope="module")
def ranks(spawned, jax_refs):
    """[(info, arrays)] of the two ranks, read once the JAX references are
    computed (the ranks run meanwhile)."""
    return _wait(*spawned[2])


@pytest.fixture(scope="module")
def three(spawned):
    return _wait(*spawned[3])


@contextlib.contextmanager
def _pallas_path():
    """JAX brute-force queries through the Pallas kernel in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPI, "use_pallas", lambda: True)
        mp.setattr(JPI, "mt_closest",
                   functools.partial(JPI.mt_closest, interpret=True))
        yield


def _jscene(res):
    b = jcornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    return b.compile("cam")


def _scene(res):
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    return b.compile("cam", device="cpu")


@pytest.fixture(scope="module")
def jax_refs(spawned):
    """The JAX package's sharded wavefront, sharded render, train steps and
    farm pair on a two-device mesh, computed once."""
    mesh = jmake_mesh(2)
    js = _jscene(RES)
    cfg = jmake_integrator(PT1)
    out = {}
    with mesh, _pallas_path():
        rgb, alpha = jax.jit(lambda s: jrender_wavefront_sharded(
            s, cfg, RES, RES, jnp.uint32(0), mesh))(js)
        out["rgb"], out["alpha"] = np.asarray(rgb), np.asarray(alpha)
        film = jrender_sharded(js, cfg, RES, RES, 2, mesh)
        out["sharded"] = np.asarray(JF.resolve(film, "combined"))
        step = jmake_train_step(cfg, RES, RES, mesh, lr=0.05)
        params = {"diffuse_color": js.materials.diffuse_color}
        target = jnp.full((RES, RES, 3), 0.25, jnp.float32)
        losses, steps = [], []
        for _ in range(TRAIN_STEPS):
            params, loss = step(js, params, target, jnp.uint32(0))
            losses.append(float(loss))
            steps.append(np.asarray(params["diffuse_color"]))
        out["losses"], out["params"] = np.asarray(losses), steps
        jf = _jscene(FARM_RES)
        nodes = [jrender_node_film(jf, jmake_integrator(DL), FARM_RES,
                                   FARM_RES, spp=FARM_SPP, node=n)
                 for n in (0, 1)]
        out["farm"] = np.asarray(JF.resolve(JF.merge(nodes), "combined"))
    return out


def _one_rank_rgba(res, s_idx):
    """The port's wavefront over every pixel in this process: the
    unsharded body, as JAX's sharded test holds its shard_map."""
    pid = torch.arange(res * res, dtype=torch.int64)
    px, py = pixel_jitter(pid, s_idx, res)
    rgb, alpha, _ = _pixel_shard_radiance(_scene(res), make_integrator(PT1),
                                          px, py, pid, s_idx)
    return rgb.numpy(), alpha.numpy()


# ------------------------------------------------------------- the mesh

def test_ranks_form_the_mesh(ranks):
    for r, (info, _) in enumerate(ranks):
        assert info == dict(info, rank=r, world=2, mesh=[0, 1], index=r,
                            device="cpu", first_mesh=[0])
    assert "not on the mesh" in ranks[1][0]["first_error"]


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device="cpu")


def test_indivisible_pixels_raise(three):
    """64 pixels over three ranks raise ValueError on every rank, as JAX's
    sharded wavefront does; the group came from torch's variables."""
    for r, (info, _) in enumerate(three):
        assert info["rank"] == r and info["world"] == 3
        assert info["error"] == "64 pixels not divisible by 3 devices"


# -------------------------------------------------------- the wavefront

def test_wavefront_sharded_matches_jax(ranks, jax_refs):
    for _, arrs in ranks:
        np.testing.assert_allclose(arrs["rgb"], jax_refs["rgb"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(arrs["alpha"], jax_refs["alpha"],
                                   rtol=1e-5, atol=1e-6)


def test_wavefront_sharded_equals_one_rank(ranks):
    """Every rank returns the whole image, gathered in pixel order, equal to
    the unsharded body over every pixel and to a mesh of one rank."""
    rgb, alpha = _one_rank_rgba(RES, 0)
    assert ranks[0][1]["rgb"].shape == (RES * RES, 3)
    for _, arrs in ranks:
        np.testing.assert_array_equal(arrs["rgb"], rgb)
        np.testing.assert_array_equal(arrs["alpha"], alpha)
    np.testing.assert_array_equal(ranks[0][1]["rgb_first"], rgb)


def test_render_sharded_matches_jax(ranks, jax_refs):
    for _, arrs in ranks:
        img = F.resolve(F.Film(
            weights=torch.from_numpy(arrs["sharded_weights"]),
            layers={"combined": torch.from_numpy(arrs["sharded_combined"])}),
            "combined").numpy()
        _assert_mostly_close(img.reshape(-1, 4),
                             jax_refs["sharded"].reshape(-1, 4))
        assert abs(img.mean() - jax_refs["sharded"].mean()) <= \
            1e-3 * abs(jax_refs["sharded"].mean())


def test_render_sharded_adds_at_the_pixel_centres(ranks):
    """Each rank's film is the gathered samples added at the pixel centres
    with weight 1: two passes, every weight 2."""
    film = F.make_film(RES, RES, device="cpu")
    pid = torch.arange(RES * RES)
    for s in range(2):
        rgb, alpha = (torch.from_numpy(a) for a in _one_rank_rgba(RES, s))
        film = F.add_samples(
            film, (pid % RES).float() + 0.5, (pid // RES).float() + 0.5,
            {"combined": torch.cat([rgb, alpha[:, None]], -1)},
            torch.ones(RES * RES))
    for _, arrs in ranks:
        np.testing.assert_array_equal(arrs["sharded_weights"],
                                      np.full((RES, RES), 2.0, np.float32))
        np.testing.assert_array_equal(arrs["sharded_combined"],
                                      film.layers["combined"].numpy())


# ------------------------------------------------------------ the step

def test_train_step_on_the_mesh_matches_jax(ranks, jax_refs):
    for _, arrs in ranks:
        np.testing.assert_allclose(arrs["losses"], jax_refs["losses"],
                                   rtol=1e-4)
        for i in range(TRAIN_STEPS):
            np.testing.assert_allclose(arrs[f"params{i}"],
                                       jax_refs["params"][i], rtol=1e-4)
    losses = ranks[0][1]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_train_step_is_the_same_on_every_rank(ranks):
    (_, a), (_, b) = ranks
    for k in ["losses"] + [f"params{i}" for i in range(TRAIN_STEPS)]:
        np.testing.assert_array_equal(a[k], b[k])


def test_train_step_two_ranks_against_one_device(ranks):
    """The mean of two block means against the whole image's mean: the
    same up to the order of the sums."""
    sc = _scene(RES)
    step = make_train_step(make_integrator(PT1), RES, RES, lr=0.05,
                           device="cpu")
    params = {"diffuse_color": sc.materials.diffuse_color}
    target = torch.full((RES, RES, 3), 0.25)
    arrs = ranks[0][1]
    for i in range(TRAIN_STEPS):
        params, loss = step(sc, params, target, 0)
        assert float(loss) == pytest.approx(float(arrs["losses"][i]),
                                            rel=1e-5)
        np.testing.assert_allclose(arrs[f"params{i}"],
                                   params["diffuse_color"].numpy(), rtol=1e-5)


def test_texel_leaf_train_step_two_ranks_against_one_device(ranks):
    """The IOR and the texel pool of the caustic scene as leaves: the two
    ranks' step gives the one-device step's parameters, up to the order of
    the sums."""
    sc = caustic_grad_builder(RES, RES).compile("cam", device="cpu")
    step = make_train_step(make_integrator({"type": "pathtracing",
                                            "bounces": 2}), RES, RES,
                           lr=0.05, device="cpu")
    params = {"ior": sc.materials.ior,
              "textures.texel_pool": sc.textures.texel_pool}
    target = torch.full((RES, RES, 3), 0.25)
    for _, arrs in ranks:
        p = dict(params)
        for i in range(TRAIN_STEPS):
            p, loss = step(sc, p, target, i)
            assert float(loss) == pytest.approx(
                float(arrs[f"caustic_loss{i}"]), rel=1e-5)
            for k, v in p.items():
                np.testing.assert_allclose(arrs[f"caustic_{k}{i}"],
                                           v.numpy(), rtol=1e-5, atol=1e-7,
                                           err_msg=k)
        moved = arrs[f"caustic_textures.texel_pool{TRAIN_STEPS - 1}"] \
            != params["textures.texel_pool"].numpy()
        assert moved.any()


# --------------------------------------------------------- the merges

def test_psum_merge_equals_merge(ranks):
    films = [F.Film(**{f: torch.from_numpy(arrs[f"own_{f}"]) for f in (
        "weights", "splat", "splat_paths")},
        layers={"combined": torch.from_numpy(arrs["own_combined"])})
        for _, arrs in ranks]
    want = F.merge(films)
    assert not np.array_equal(ranks[0][1]["own_combined"],
                              ranks[1][1]["own_combined"])
    for _, arrs in ranks:
        np.testing.assert_array_equal(arrs["merged_weights"],
                                      want.weights.numpy())
        np.testing.assert_array_equal(arrs["merged_combined"],
                                      want.layers["combined"].numpy())
        np.testing.assert_array_equal(arrs["merged_splat"],
                                      want.splat.numpy())
        np.testing.assert_array_equal(arrs["merged_splat_paths"],
                                      want.splat_paths.numpy())


@pytest.fixture(scope="module")
def farm(ranks, spawned):
    """(the two processes' films merged from their folder, the same two
    nodes rendered in this process, merged)."""
    merged, offset = F.load_all_in_folder(
        os.path.join(spawned[2][0], "farm"), device="cpu")
    sc = _scene(FARM_RES)
    nodes = [render_node_film(sc, make_integrator(DL), FARM_RES, FARM_RES,
                              spp=FARM_SPP, node=n, device="cpu")
             for n in (0, 1)]
    return merged, offset, nodes


def test_render_farm_merge_matches_the_in_process_merge(farm):
    merged, offset, nodes = farm
    assert offset == 100_000 + FARM_SPP
    np.testing.assert_allclose(F.resolve(merged).numpy(),
                               F.resolve(F.merge(nodes)).numpy(), atol=1e-5)
    # the nodes drew different sample streams
    a, b = (F.resolve(n).numpy() for n in nodes)
    assert np.abs(a - b).max() > 1e-4


def test_render_farm_matches_jax(farm, jax_refs):
    img = F.resolve(farm[0]).numpy()
    want = jax_refs["farm"]
    _assert_mostly_close(img.reshape(-1, 4), want.reshape(-1, 4))
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())


# ------------------------------------------------------------ sampler

U32_EDGES = np.array([0, 1, 2, 7, 1000, 0xFFFF, 0x10000, 42949, 42950,
                      2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64)


def _u32(rng, n=4096):
    x = np.concatenate([U32_EDGES, np.arange(n, dtype=np.uint64),
                        rng.integers(0, 2**32, n, dtype=np.uint64)])
    return x.astype(np.uint32)


def test_host_sample_offset_bit_for_bit(rng):
    host = _u32(rng, 256)
    for per in (100_000, 1, 2**31 + 7, 2**32 - 1):
        want = np.asarray(JS.host_sample_offset(jnp.asarray(host), per))
        got = sampler.host_sample_offset(torch.from_numpy(
            host.astype(np.int64)), per).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    assert int(sampler.host_sample_offset(3)) == 300_000


@pytest.mark.parametrize("base", [0, 1, 2, 5, 29])
def test_halton_bit_for_bit(rng, base):
    n = _u32(rng)
    want = np.asarray(JS.halton(jnp.asarray(n), base))
    got = sampler.halton(torch.from_numpy(n.astype(np.int64)), base).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_van_der_corput_bit_for_bit(rng):
    n = _u32(rng)
    scramble = rng.integers(0, 2**32, n.size, dtype=np.uint64).astype(
        np.uint32)
    for sc in (None, scramble):
        want = np.asarray(JS.van_der_corput(jnp.asarray(n)) if sc is None
                          else JS.van_der_corput(jnp.asarray(n),
                                                 jnp.asarray(sc)))
        t = torch.from_numpy(n.astype(np.int64))
        got = (sampler.van_der_corput(t) if sc is None else
               sampler.van_der_corput(t, torch.from_numpy(
                   sc.astype(np.int64))))
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- import

def test_import_does_not_initialize_cuda():
    """Importing the package and parallel.distributed in a fresh
    interpreter leaves CUDA uninitialized (the counterpart of
    tests/test_multihost.py::test_import_does_not_initialize_xla): a farm
    process sets its device first."""
    script = ("import sys; sys.path.insert(0, %r)\n"
              "import libyafaray_tpu_torch.parallel.distributed\n"
              "import libyafaray_tpu_torch\n"
              "import torch\n"
              "assert not torch.cuda.is_initialized(), 'CUDA initialized'\n"
              "print('ok')\n" % REPO)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, (
        out.stdout + out.stderr)[-3000:]
