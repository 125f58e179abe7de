"""The reduction of `take`'s backward on the card: the kernel
csrc/take_grad.cu (through `ops.fast_grad.take_grad`) against float64
sums, against its plain version `onehot_grad`, twice on the same inputs,
and on every `take` backward of one caustic train step at 512x512.

The grid: tables of 1, 5, 1,366 (the caustic's texel pool) and 4,096 rows
(`MATMUL_GRAD_ROWS`), 1, 3 and 4 columns, 37, 40,000, 262,144 (a 512x512
frame) and 2,073,600 lanes (a 1080p frame), the lanes spread uniformly
over the rows or all on one row.

Tolerance. A float32 sum taken by a tree of depth d, whatever the order
and the signs of its terms, lies within about d * u * sum|terms| of the
exact sum (u = 2^-24, each add rounding once; Higham, "Accuracy and
Stability of Numerical Algorithms", 4.2). The kernel's tree over one row
has depth at most 5 (the pairwise sum of a warp's lanes on the row, in
lane order) + the rounds a warp reduces (one add into its table copy a
round) + the block's warps (summed in order) + the blocks' partials (each
thread of the second kernel adds its share in order, then 5 shuffle
steps), all from the launch's layout (`take_grad_layout`). Each row is
held to twice that bound over its own lanes' sum|g| (room for the
second-order terms and the float64 sum's own rounding). A row with no
lanes must read exactly 0. With integer gradients every partial sum is an
integer below 2^24 and exact in float32, so there the kernel must equal
the float64 sum bit for bit: a lane dropped or added twice shows.

Marked `card`: each test skips without a CUDA card. The file imports no
JAX; on the card, where the JAX package is absent, run it as

    python3 -m pytest --noconftest -m card tests/test_torch_take_grad_card.py
"""
import pytest
import torch

from libyafaray_tpu_torch import make_integrator, make_train_step
from libyafaray_tpu_torch.csrc_build import launch_counts
from libyafaray_tpu_torch.ops import fast_grad as FG
from libyafaray_tpu_torch.scenes import caustic_grad_builder
from libyafaray_tpu_torch.utils import profiling as PF

pytestmark = pytest.mark.card
U = 2.0 ** -24
COLS = (1, 3, 4)
LANES = (37, 40_000, 262_144, 2_073_600)
CAUSTIC_RES, CAUSTIC_BOUNCES = 512, 5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _depth(rows, cols, lanes, dev):
    """Depth of the kernel's summation tree over one row at this shape."""
    warps, blocks, _, split = FG.take_grad_layout(
        rows, cols, lanes, FG._sm_count(dev))
    per_block = -(-(-(-lanes // blocks)) // 32) * 32
    rounds = -(-per_block // (32 * warps))
    return 5 + rounds + warps + -(-blocks // split) + 5


def _exact(idx, g, rows):
    """(the float64 sums, sum |g| of each row), f64[rows, cols]."""
    g2 = g.reshape(g.shape[0], -1).double()
    z = torch.zeros((rows, g2.shape[1]), dtype=torch.float64, device=g.device)
    return z.index_add(0, idx, g2), z.index_add(0, idx, g2.abs())


def _held(got, idx, g, rows, what):
    """The kernel's sums within the tree's bound of the float64 sums."""
    want, mag = _exact(idx, g, rows)
    got = got.reshape(rows, -1).double()
    bound = 2 * _depth(rows, got.shape[1], idx.shape[0], g.device) * U * mag
    err = (got - want).abs()
    worst = float((err - bound).max())
    assert worst <= 0.0, (f"{what}: {worst:.3g} beyond the bound (max err "
                          f"{float(err.max()):.3g})")
    assert bool((got[mag == 0] == 0).all()), f"{what}: an empty row is not 0"


def _inputs(rows, cols, lanes, spread, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if spread == "uniform":
        idx = torch.randint(0, rows, (lanes,), generator=gen, device=dev)
    else:
        idx = torch.full((lanes,), rows - 1, dtype=torch.int64, device=dev)
    shape = (lanes,) if cols == 1 else (lanes, cols)
    normal = torch.randn(shape, generator=gen, device=dev)
    whole = torch.randint(-4, 5, shape, generator=gen, device=dev).float()
    return idx, normal, whole


@pytest.mark.parametrize("spread", ["uniform", "one_row"])
@pytest.mark.parametrize("rows", [1, 5, 1366, 4096])
def test_kernel_holds_the_float64_sums(cuda, rows, spread):
    """Every column count and lane count of the grid: normal gradients
    within the bound, integer ones exact, the same bits twice, one
    reduction a call (the wrapper's launch counter), of the kernels the
    layout asks for (two when it splits the lanes over blocks), as the C
    entry reports them."""
    for cols in COLS:
        for lanes in LANES:
            what = f"{rows} rows, {cols} columns, {lanes} lanes, {spread}"
            idx, normal, whole = _inputs(rows, cols, lanes, spread,
                                         rows * 7919 + cols * 31 + lanes, cuda)
            before = launch_counts["kernel.take_grad.launches"]
            kernels = launch_counts["kernel.take_grad.kernels"]
            got = FG.take_grad(idx, normal, rows)
            again = FG.take_grad(idx, normal, rows)
            assert launch_counts["kernel.take_grad.launches"] == before + 2
            blocks = FG.take_grad_layout(rows, cols, lanes,
                                         FG._sm_count(cuda))[1]
            assert (launch_counts["kernel.take_grad.kernels"] - kernels
                    == 2 * (2 if blocks > 1 else 1)), what
            assert got.shape == (rows,) + normal.shape[1:]
            assert got.dtype == torch.float32
            assert torch.equal(got, again), f"{what}: two calls differ"
            _held(got, idx, normal, rows, what)
            exact, _ = _exact(idx, whole, rows)
            assert torch.equal(FG.take_grad(idx, whole, rows).reshape(
                rows, -1).double(), exact), f"{what}: integers not exact"


@pytest.mark.parametrize("rows,cols,lanes", [(5, 3, 40_000),
                                             (1366, 4, 262_144),
                                             (4096, 1, 40_000)])
def test_kernel_agrees_with_onehot_grad(cuda, rows, cols, lanes):
    """Against the plain version on the card, within rtol 1e-6, on
    positive gradients (as radiance is: the sums do not cancel)."""
    idx, normal, _ = _inputs(rows, cols, lanes, "uniform", 25, cuda)
    g = normal.abs()
    torch.testing.assert_close(FG.take_grad(idx, g, rows),
                               FG.onehot_grad(idx, g, rows),
                               rtol=1e-6, atol=0.0)


def test_kernel_takes_strided_and_expanded_gradients(cuda):
    """A gradient that is a column slice, or one value broadcast to every
    lane (stride 0), is read in place, as its contiguous copy would be."""
    idx, normal, _ = _inputs(1366, 4, 40_000, "uniform", 3, cuda)
    wide = torch.randn((40_000, 6), device=cuda)
    assert torch.equal(FG.take_grad(idx, wide[:, 1:5], 1366),
                       FG.take_grad(idx, wide[:, 1:5].contiguous(), 1366))
    ones = torch.ones((1, 4), device=cuda).expand(40_000, 4)
    counts = torch.bincount(idx, minlength=1366).float()
    assert torch.equal(FG.take_grad(idx, ones, 1366),
                       counts[:, None].expand(1366, 4))


def test_caustic_step_takes_match_the_plain_version(cuda):
    """Every `take` backward of one caustic train step at 512x512 (the
    grad cell's step), captured as it reaches `_Take.backward`: the
    kernel's sums within the bound of the float64 sums, within the bounds'
    sum of `onehot_grad`'s (whose tree is the GEMM's: any order of its m
    terms, depth m), and one kernel reduction for each `grad.take` span."""
    scene = caustic_grad_builder(CAUSTIC_RES, CAUSTIC_RES).compile(
        "cam", device=cuda)
    step = make_train_step(
        make_integrator({"type": "pathtracing", "bounces": CAUSTIC_BOUNCES}),
        CAUSTIC_RES, CAUSTIC_RES, lr=0.05, device=cuda)
    params = {"ior": scene.materials.ior.clone(),
              "textures.texel_pool": scene.textures.texel_pool.clone()}
    gen = torch.Generator(device=cuda).manual_seed(24)
    target = 0.5 * torch.rand((CAUSTIC_RES, CAUSTIC_RES, 3), generator=gen,
                              device=cuda)
    kept, real = [], FG.take_grad

    def keep(idx, g, rows):
        out = real(idx, g, rows)
        kept.append((idx.clone(), g.clone(), rows, out.clone()))
        return out

    FG.take_grad = keep
    try:
        with PF.tracing() as rec:
            step(scene, params, target, 0)
    finally:
        FG.take_grad = real
    torch.cuda.synchronize()
    spans = [s for s in rec.spans if s.name == "grad.take"]
    tables = {s.attrs["table"] for s in spans}
    assert {"ior", "texel_pool"} <= tables
    assert len(kept) == len(spans) == rec.counts["kernel.take_grad.launches"]
    assert rec.counts["kernel.take_grad.lanes"] == sum(
        k[0].shape[0] for k in kept)
    for i, (idx, g, rows, got) in enumerate(kept):
        what = f"take {i} ({rows} rows, {idx.shape[0]} lanes)"
        _held(got, idx, g, rows, what)
        want, mag = _exact(idx, g, rows)
        lanes_a_row = torch.bincount(idx, minlength=rows)[:rows, None]
        plain = FG.onehot_grad(idx, g, rows).reshape(rows, -1).double()
        bound = 2 * (_depth(rows, plain.shape[1], idx.shape[0], cuda)
                     + lanes_a_row) * U * mag
        assert bool(((got.reshape(rows, -1).double() - plain).abs()
                     <= bound).all()), f"{what}: differs from onehot_grad"
