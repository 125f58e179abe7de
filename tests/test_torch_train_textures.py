"""The inverse-rendering step on texture leaves: `make_train_step` with the
glass's IOR (a MaterialTable column) and the floor texture's texel pool
(`textures.texel_pool`) on the caustic scene (BASELINE config 4), against
`jax.value_and_grad` of the same loss in the JAX package, a texel-only
step, a key that names no parameter, and the backward's span and counts
under the program's `tracing()` (`grad.take`, `bsdf.*_lanes`).

Each gradient is the one the step keeps (`step.grads`), and the step's
new parameters are the old less the learning rate times it.

Tolerances: those of `tests/test_torch_caustic.py` for the gradients
(rtol 1e-3, atol 1e-7) and the image's mean (1e-3 relative), here on the
loss, the image MSE.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.parallel import _pixel_shard_radiance as jradiance
from libyafaray_tpu_torch import make_integrator, make_train_step
from libyafaray_tpu_torch.ops import fast_grad as FG
from libyafaray_tpu_torch.scene_types import MAT_GLASS
from libyafaray_tpu_torch.scenes import caustic_grad_builder as port_caustic
from libyafaray_tpu_torch.utils import profiling as PF
from scenes import caustic_grad_builder
from test_torch_foundations import one_torch_thread  # noqa: F401

RES, BOUNCES = 16, 5
LR = 0.05
CFG = {"type": "pathtracing", "bounces": BOUNCES}
LEAVES = ("ior", "textures.texel_pool")


def _target():
    rng = np.random.default_rng(24)
    return rng.uniform(0.0, 0.5, (RES, RES, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def caustic():
    return port_caustic(RES, RES).compile("cam", device="cpu")


def _params(sc, names=LEAVES):
    every = {"ior": sc.materials.ior,
             "textures.texel_pool": sc.textures.texel_pool}
    return {k: every[k].clone() for k in names}


def _grads(sc, names=LEAVES, sample=0):
    """(loss, {leaf: gradient}) of one step, as the step keeps them."""
    step = make_train_step(make_integrator(CFG), RES, RES, lr=LR,
                           device="cpu")
    p0 = _params(sc, names)
    p1, loss = step(sc, p0, torch.from_numpy(_target()), sample)
    assert set(step.grads) == set(names)
    for k in names:
        assert torch.equal(p1[k], p0[k] - LR * step.grads[k]), k
    return float(loss), {k: step.grads[k].numpy() for k in names}


@pytest.fixture(scope="module")
def jax_step():
    """`jax.value_and_grad` of the image MSE at the pixel centres with
    respect to (ior, texel_pool), jitted once."""
    js = caustic_grad_builder(RES, RES).compile("cam")
    cfg = jmake_integrator(CFG)
    yy, xx = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    pid = jnp.asarray((yy * RES + xx).reshape(-1).astype(np.uint32))
    px = jnp.asarray((xx.reshape(-1) + 0.5).astype(np.float32))
    py = jnp.asarray((yy.reshape(-1) + 0.5).astype(np.float32))
    target = jnp.asarray(_target().reshape(-1, 3))

    def loss(theta):
        ior, texels = theta
        sc = js.replace(materials=js.materials.replace(ior=ior),
                        textures=js.textures.replace(texel_pool=texels))
        rgb, _, _ = jradiance(sc, cfg, px, py, pid, jnp.uint32(0))
        return jnp.mean((rgb - target) ** 2)

    val, grads = jax.jit(jax.value_and_grad(loss))(
        (js.materials.ior, js.textures.texel_pool))
    return float(val), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def port_step(caustic):
    return _grads(caustic)


def test_ior_and_texel_step_matches_jax(port_step, jax_step):
    loss, got = port_step
    want_loss, want = jax_step
    assert loss == pytest.approx(want_loss, rel=1e-3)
    for k, w in zip(LEAVES, want):
        assert np.isfinite(got[k]).all() and np.abs(w).max() > 0
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-7,
                                   err_msg=k)


def test_ior_gradient_only_on_the_glass_row(caustic, port_step):
    _, got = port_step
    glass = (caustic.materials.mat_type == MAT_GLASS).numpy()
    assert got["ior"][glass].all() and not got["ior"][~glass].any()


def test_texel_only_step(caustic, port_step):
    """The texel pool alone: the same loss and texel gradient as beside
    the IOR, and a step at the cell's rate moves the texels alone."""
    loss, got = _grads(caustic, ("textures.texel_pool",))
    both_loss, both = port_step
    assert loss == both_loss
    np.testing.assert_array_equal(got["textures.texel_pool"],
                                  both["textures.texel_pool"])
    step = make_train_step(make_integrator(CFG), RES, RES, lr=LR,
                           device="cpu")
    p0 = _params(caustic, ("textures.texel_pool",))
    p1, _ = step(caustic, p0, torch.from_numpy(_target()), 0)
    assert set(p1) == {"textures.texel_pool"}
    moved = (p1["textures.texel_pool"] != p0["textures.texel_pool"])
    assert int(moved.any(-1).sum()) > 4


@pytest.mark.parametrize("key", ["textures.no_such_field", "no_such_column",
                                 "textures.", "texel_pool"])
def test_unknown_key_raises(caustic, key):
    step = make_train_step(make_integrator(CFG), RES, RES, device="cpu")
    with pytest.raises(KeyError, match="no parameter"):
        step(caustic, {key: caustic.textures.texel_pool},
             torch.from_numpy(_target()), 0)


def _tiny_take(label="texel_pool", lanes=37, rows=11):
    table = torch.rand((rows, 4)).requires_grad_(True)
    idx = torch.randint(0, rows, (lanes,))
    FG.take(table, idx, label).sum().backward()
    return table.grad


def test_take_backward_is_a_span_with_counts_under_tracing():
    with PF.tracing() as rec:
        _tiny_take()
    spans = [s for s in rec.spans if s.name == "grad.take"]
    assert len(spans) == 1 and spans[0].attrs == {"table": "texel_pool"}
    assert spans[0].end_ns >= spans[0].start_ns > 0
    assert rec.counts["grad.take.lanes.texel_pool"] == 37
    assert rec.counts["grad.take.rows.texel_pool"] == 11


def test_take_backward_records_nothing_with_tracing_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span entered the profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(PF.Recording, "_enter", refuse)
    grad = _tiny_take()
    assert PF._rec is None and torch.isfinite(grad).all()


def test_caustic_step_counts_delta_lanes(caustic):
    """Under tracing, a caustic step counts its BSDF samples, some of them
    the glass's delta lobes, and the backward's takes of the IOR column
    and of the texel pool."""
    step = make_train_step(make_integrator(CFG), RES, RES, device="cpu")
    with PF.tracing() as rec:
        step(caustic, _params(caustic), torch.from_numpy(_target()), 0)
    c = rec.counts
    assert 0 < c["bsdf.delta_lanes"] < c["bsdf.sampled_lanes"]
    rows = caustic.textures.texel_pool.shape[0]
    calls = sum(1 for s in rec.spans if s.name == "grad.take"
                and s.attrs == {"table": "texel_pool"})
    assert calls > 0 and c["grad.take.rows.texel_pool"] == calls * rows
    assert c["grad.take.lanes.ior"] > 0
    parents = {rec.spans[s.parent].name for s in rec.spans
               if s.name == "grad.take"}
    assert parents == {"train.backward"}
