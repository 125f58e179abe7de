"""The block prepass kernel (tile_candidates_kernel in
csrc/tiles_traverse.cu) against its plain version `tile_candidates_ref` on
the card: every list equal with torch.equal (cand, ent, count), front to
back and in cover order, on the nine queries of one pass of the textured
terrain at 720x720 (captured as they reach `tile_candidates`), on a dead
tile in a live chunk beside a dead chunk, on NaN, infinite and zero
components, and on more candidates a tile than the kernel's shared sort
holds.

Marked `card`: each test skips without a CUDA card. The file imports no
JAX; on the card, where the JAX package is absent, run it as

    python3 -m pytest --noconftest -m card tests/test_torch_prepass_card.py
"""
import pytest
import torch

from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.accel import tiles as TL
from libyafaray_tpu_torch.csrc_build import launch_counts
from libyafaray_tpu_torch.scenes import bigmesh_builder

pytestmark = pytest.mark.card
ORDERS = pytest.mark.parametrize("cover", [False, True],
                                 ids=["front", "cover"])


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def terrain_queries(cuda):
    """The arguments of each tile_candidates call of one pass of the
    textured terrain at 720x720, 2 bounces."""
    scene = bigmesh_builder(320).compile("cam")
    kept, real = [], TL.tile_candidates

    def keep(*a, **k):
        kept.append(tuple(x.clone() for x in a))
        return real(*a, **k)

    TL.tile_candidates = keep
    try:
        render(scene, make_integrator({"type": "pathtracing", "bounces": 2}),
               spp=1)
    finally:
        TL.tile_candidates = real
    return kept


def _boxes_and_rays(cuda, c, tiles, size, seed):
    """c random boxes up to `size` wide in [-2, 2]^3 and tiles * 128 random
    rays from inside [-0.5, 0.5]^3, every 7th dead."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=gen)
    ctr, ext = 4 * u(c, 3) - 2, 0.01 + (size - 0.01) * u(c, 3)
    n = tiles * TL.RAY_TILE
    d = torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((n,), 1e30)
    t_max[::7] = -1.0
    return [x.to(cuda) for x in (ctr - ext, ctr + ext, u(n, 3) - 0.5, d,
                                 torch.full((n,), 1e-4), t_max)]


def _equal(args, cover):
    """The kernel's lists (one launch) equal the plain version's."""
    before = launch_counts["kernel.tile_candidates.launches"]
    got = TL.tile_candidates(*args, any_hit=cover)
    assert launch_counts["kernel.tile_candidates.launches"] == before + 1
    want = TL.tile_candidates_ref(*args, any_hit=cover)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@ORDERS
def test_a_terrain_pass_lists_as_the_plain_version(terrain_queries, cover):
    assert len(terrain_queries) == 9
    assert terrain_queries[0][0].shape[0] == 1591
    for args in terrain_queries:
        _equal(args, cover)


@ORDERS
def test_a_dead_tile_in_a_live_chunk_and_a_dead_chunk(cuda, cover):
    """32 tiles over 1,591 blocks, in chunks of 26: tile 3's rays start
    inside blocks with t_max just below t_min and still list them; tiles
    26-31 are all dead and list none."""
    args = _boxes_and_rays(cuda, 1591, 32, 0.3, 5)
    bmin, bmax, o, _, t_min, t_max = args
    assert TL._chunk_tiles(32, 1591) == 26
    r = slice(3 * 128, 4 * 128)
    o[r] = 0.5 * (bmin[:128] + bmax[:128])
    t_min[r], t_max[r] = 0.0, -1e-3
    t_max[26 * 128:] = -1.0
    cand, ent, count = _equal(args, cover)
    assert count[3] > 0 and (count[26:] == 0).all()
    assert (cand[26:, :1591] == torch.arange(1591, device=cuda)).all()
    assert torch.isinf(ent[26:]).all()


@ORDERS
def test_nan_infinite_and_zero_components(cuda, cover):
    bmin, bmax, o, d, t_min, t_max = _boxes_and_rays(cuda, 700, 4, 1.0, 6)
    nan, inf = float("nan"), float("inf")
    bmin[5] = nan
    bmax[9, 1] = inf
    bmin[11] = -inf
    d[0] = torch.tensor([nan, 0.5, 0.5])
    d[1] = torch.tensor([0.0, 0.0, 1.0])
    d[2] = torch.tensor([-0.0, 1.0, -0.0])
    d[3] = torch.tensor([inf, 0.0, 0.0])
    d[6] = torch.tensor([1e-13, -1e-13, 1.0])
    o[4] = torch.tensor([inf, 0.0, 0.0])
    o[5] = torch.tensor([nan, 1.0, 1.0])
    o[12] = torch.tensor([-inf, 0.1, 0.1])
    t_min[7], t_max[8], t_min[9] = nan, inf, -inf
    _equal((bmin, bmax, o, d, t_min, t_max), cover)


@ORDERS
def test_more_candidates_than_the_shared_sort(cuda, cover):
    """5,000 boxes up to 3 wide: most tiles list more than the 4,096 entries
    the kernel sorts in shared memory, and sort in runs."""
    args = _boxes_and_rays(cuda, 5000, 6, 3.0, 7)
    count = _equal(args, cover)[2]
    assert int(count.max()) > 4096
