"""The port's spans and counters (`utils.profiling`: `span`, `tracing`,
`count`, `host_sync`, `host_read`): nesting and parents, nothing recorded
and no profiler range entered with tracing off, the spans in a chrome
trace with the same nesting, device counts read once when `tracing()`
exits, host syncs counted by site, the kernels' launches read from the
one counter, the layers' spans and counts of a tiny render and train step,
and the LBVH packed once per `render()` call. CPU only, tiny scenes."""
import ast
import json

import pytest
import torch

from libyafaray_tpu_torch import csrc_build, make_integrator, make_train_step
from libyafaray_tpu_torch import render
from libyafaray_tpu_torch.accel import lbvh as LB
from libyafaray_tpu_torch.scenes import bigmesh_builder, cornell_builder
from libyafaray_tpu_torch.utils import profiling as PF

PT = {"type": "pathtracing", "bounces": 2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cornell(res=8, accel=None):
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    if accel:
        b.set_render_params({"scene_accelerator": accel})
    return b.compile("cam", device="cpu")


def _parent(rec, s):
    return rec.spans[s.parent].name if s.parent >= 0 else None


def test_spans_nest_with_parents_ordinals_and_attrs():
    @PF.span("outer.fn")
    def fn(x):
        with PF.span("inner", depth=x):
            return x + 1

    with PF.tracing() as rec:
        with PF.span("render.image"):
            for i in range(2):
                with PF.span("render.pass", index=i):
                    assert fn(i) == i + 1
    names = [s.name for s in rec.spans]
    assert names == ["render.image", "render.pass", "outer.fn", "inner",
                     "render.pass", "outer.fn", "inner"]
    assert [_parent(rec, s) for s in rec.spans] == [
        None, "render.image", "render.pass", "outer.fn",
        "render.image", "render.pass", "outer.fn"]
    assert [s.pass_ for s in rec.spans] == [-1, 0, 0, 0, 1, 1, 1]
    assert {s.image for s in rec.spans} == {0} and rec.spans[0].step == -1
    assert [s.attrs for s in rec.spans if s.name == "inner"] == [
        {"depth": 0}, {"depth": 1}]
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_tracing_off_records_nothing_and_enters_no_profiler_range(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not PF.recording()
    # one span object a name: nothing is made per call
    assert PF.span("a.b") is PF.span("a.b")
    assert PF.span("a.b", depth=3) is PF.span("a.b")
    assert PF.host_sync("x") is PF.host_sync("x")
    with PF.span("a.b", depth=3):
        PF.count("n", 5)
        PF.count("m", torch.ones(3).sum())
        assert PF.host_read("x", torch.tensor([1, 2])) == [1, 2]
    film = render(_cornell(), make_integrator(PT), spp=1, device="cpu")
    assert float(film.weights.sum()) == 64
    assert PF._rec is None


def test_a_profiler_trace_holds_each_span_with_the_same_nesting(tmp_path):
    scene = _cornell()
    cfg = make_integrator(PT)
    act = torch.profiler.ProfilerActivity
    with PF.tracing() as rec:
        with torch.profiler.profile(activities=[act.CPU]) as prof:
            render(scene, cfg, spp=2, device="cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        ev = [e for e in json.load(fh)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("yafaray::")]
    ev.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in ev] == ["yafaray::" + s.name
                                       for s in rec.spans]
    span = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    for e, s in zip(ev, rec.spans):
        if s.parent >= 0:
            (a, b), (pa, pb) = span(e), span(ev[s.parent])
            assert pa <= a and b <= pb + 1e-3
    names = {s.name for s in rec.spans}
    assert {"render.image", "render.pass", "render.camera", "film.add",
            "integrator.bounce", "intersect.closest", "intersect.any",
            "accel.walk", "shade.surface", "shade.emission", "shade.nee",
            "shade.bsdf"} <= names
    walk = [s for s in rec.spans if s.name == "accel.walk"]
    assert {_parent(rec, s) for s in walk} == {"intersect.closest",
                                               "intersect.any"}


def test_device_counts_are_read_once_when_tracing_exits(monkeypatch):
    reads = []
    real = torch.Tensor.tolist

    def counted(self):
        reads.append(tuple(self.shape))
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    with PF.tracing() as rec:
        for k in range(3):
            PF.count("dev.a", torch.tensor([1, 0, 1]).sum())
            PF.count("dev.b", torch.tensor(k))
            PF.count("host", 2)
        assert reads == []
        assert "dev.a" not in rec.counts and rec.counts["host"] == 6
    assert reads == [(2,)]
    assert rec.counts["dev.a"] == 6 and rec.counts["dev.b"] == 3


def test_launches_reach_the_recording_from_the_one_counter(monkeypatch):
    """A launch counted in csrc_build's counter inside `tracing()` reaches
    the recording under its own name, arms too; one outside it does not;
    and `utils/profiling` imports no module of `accel/` or `ops/`."""
    monkeypatch.setattr(csrc_build, "launch_counts",
                        csrc_build.launch_counts.copy())
    counts = csrc_build.launch_counts
    counts["kernel.fake.launches"] += 5
    with PF.tracing() as rec:
        counts["kernel.fake.launches"] += 2
        counts["kernel.fake.launches.static"] += 1
    counts["kernel.fake.launches"] += 1
    assert rec.counts["kernel.fake.launches"] == 2
    assert rec.counts["kernel.fake.launches.static"] == 1
    with open(PF.__file__) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] + [a.name for a in node.names]
        elif isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        else:
            continue
        for mod in mods:
            assert not {"accel", "ops"} & set(mod.split(".")), mod


def test_host_syncs_are_counted_by_site():
    x = torch.tensor([[1.0, 2.0]])
    with PF.tracing() as rec:
        assert PF.host_read("site.a", x) == [[1.0, 2.0]]
        assert PF.host_read("site.a", torch.tensor(3)) == 3
        assert PF.host_read("site.b", x[0, 1]) == 2.0
        with PF.host_sync("site.c"):
            torch.zeros(2)
    assert {k: v for k, v in rec.counts.items() if k.startswith("sync.")} \
        == {"sync.site.a": 2, "sync.site.b": 1, "sync.site.c": 1}
    assert [s.name for s in rec.spans] == ["sync.site.a", "sync.site.a",
                                           "sync.site.b", "sync.site.c"]


def test_a_render_counts_its_syncs_lanes_and_prepass_by_site():
    """The block accelerator's terrain: the prepass's live-chunk read once
    a query, the sampler's keys, the shadow queries' t-range and the two
    axes of the pixel footprint; lanes and the prepass's tiles."""
    b = bigmesh_builder(res=40)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 24
    scene = b.compile("cam", device="cpu")
    assert scene.accel_kind == "blocks"
    with PF.tracing() as rec:
        render(scene, make_integrator(PT), spp=1, device="cpu")
    c = rec.counts
    queries = sum(s.name.startswith("intersect.") for s in rec.spans)
    prepass = sum(s.name == "accel.prepass" for s in rec.spans)
    assert prepass == queries > 0
    assert c["sync.tiles.live_chunks"] == prepass
    # three integer keys a sampler draw past the pixel id
    assert c["sync.sampler.key"] % 3 == 1          # + ld02's one
    assert c["sync.intersect.t_range"] == sum(
        s.name == "intersect.any" for s in rec.spans)
    assert c["sync.surface.axes"] == 2
    assert 0 < c["lanes.live"] < c["lanes.total"]
    assert c["lanes.total"] == 24 * 24 * queries
    assert c["prepass.tiles"] >= c["prepass.live_tiles"] > 0
    assert c["prepass.candidates"] > 0


def test_the_lbvh_is_packed_once_per_render(monkeypatch):
    """`render()` moves the scene, and the move gives the tree a new
    object: its packed records are made again for each image. The card's
    wrapper packs; here the CPU walk is given the same step."""
    real = LB.lbvh_traverse

    def packing(bvh, geom, *a, **k):
        LB.packed(bvh, geom)
        return real(bvh, geom, *a, **k)

    monkeypatch.setattr(LB, "lbvh_traverse", packing)
    scene = _cornell(accel="bvh")
    assert scene.accel_kind == "bvh"
    with PF.tracing() as rec:
        for _ in range(2):
            render(scene, make_integrator(PT), spp=2, device="cpu")
    assert rec.counts["table_builds.pack_lbvh"] == 2
    assert rec.counts["sync.lbvh.pack_inner"] == 2
    packs = [s for s in rec.spans if s.name == "accel.pack"]
    assert [s.image for s in packs] == [0, 1]


def test_a_train_step_has_its_phases():
    scene = _cornell()
    step = make_train_step(make_integrator(PT), 8, 8, device="cpu")
    params = {"diffuse_color": scene.materials.diffuse_color.clone()}
    with PF.tracing() as rec:
        step(scene, params, torch.zeros(8, 8, 3), 0)
    top = [s.name for s in rec.spans if _parent(rec, s) == "train.step"]
    assert top == ["train.forward", "train.loss", "train.backward",
                   "train.update"]
    assert rec.spans[0].name == "train.step" and rec.spans[0].step == 0
    bounces = [s for s in rec.spans if s.name == "integrator.bounce"]
    assert {_parent(rec, s) for s in bounces} == {"train.forward"}
    assert [s.attrs["depth"] for s in bounces] == [0, 1, 2]


def test_scene_compile_has_its_stages():
    b = cornell_builder()
    with PF.tracing() as rec:
        b.compile("cam", device="cpu")
    assert rec.spans[0].name == "scene.compile"
    stages = [s.name for s in rec.spans if s.parent == 0]
    assert stages == ["compile.materials", "compile.textures",
                      "compile.geometry", "compile.lights",
                      "compile.geometry"]


def test_tracing_is_not_reentrant_and_closes_open_spans():
    with PF.tracing() as rec:
        with pytest.raises(RuntimeError):
            with PF.tracing():
                pass
        PF.span("left.open").__enter__()
    assert not PF.recording()
    assert rec.spans[0].end_ns >= rec.spans[0].start_ns > 0


def test_render_stats_run_on_the_monotonic_clock(monkeypatch):
    """A wall clock set back does not make a pass negative."""
    import time
    st = PF.RenderStats()
    clock = iter([100.0, 90.0, 80.0, 70.0])
    monkeypatch.setattr(time, "time", lambda: next(clock))
    st.begin_pass()
    st.start("rendert")
    st.end_pass(10)
    assert st.stop("rendert") >= 0.0 and st.pass_times[0] >= 0.0
