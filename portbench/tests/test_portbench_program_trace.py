"""The program window's reduction (`program_trace.reduce_events`) on a
hand-made trace: busy time by the span a launch was made inside (through
correlation ids, a thread without spans read on the window's thread),
idle gaps by the innermost span at their midpoints, "outside the program",
and both sums equal to the window's; and the readers' arithmetic."""
from types import SimpleNamespace

import pytest

from portbench import program_trace as PT


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x(PT.WINDOW, "user_annotation", 0, 100),
    _x("yafaray::render.pass", "user_annotation", 0, 90),
    _x("yafaray::intersect.closest", "user_annotation", 10, 30),
    _x("yafaray::accel.walk", "user_annotation", 20, 10),
    _x("yafaray::shade.nee", "user_annotation", 50, 30),
    _x("aten::mul", "cpu_op", 51, 2),
    _x("cudaLaunchKernel", "cuda_runtime", 22, 1, corr=1),
    _x("cudaLaunchKernel", "cuda_runtime", 55, 1, corr=2),
    # autograd's thread has no spans: the window's thread's span counts
    _x("cudaLaunchKernel", "cuda_runtime", 60, 1, tid=2, corr=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 95, 1, corr=4),
    _x("k1", "kernel", 25, 20, tid=7, corr=1),
    _x("k2", "kernel", 40, 10, tid=7, corr=2),        # overlaps k1
    _x("k3", "kernel", 60, 10, tid=7, corr=3),
    _x("Memcpy DtoH", "gpu_memcpy", 96, 14, tid=7, corr=4),   # clipped
    _x("k5", "kernel", 85, 3, tid=7, corr=99),        # no launch seen
]
WALK = "render.pass/intersect.closest/accel.walk"
NEE = "render.pass/shade.nee"


def test_busy_and_idle_by_innermost_span():
    r = PT.reduce_events(EVENTS)
    assert r.window_ms == pytest.approx(0.1)
    assert r.busy == pytest.approx({WALK: 0.020, NEE: 0.015,
                                    PT.OUTSIDE: 0.007})
    assert r.idle == pytest.approx({"render.pass/intersect.closest": 0.025,
                                    NEE: 0.025, PT.OUTSIDE: 0.008})
    assert r.kernels == {WALK: 1, NEE: 2, PT.OUTSIDE: 1}
    # every interval counted once: the sums are the window's
    assert r.busy_ms == pytest.approx(0.042) == r.union_ms
    assert r.idle_ms == pytest.approx(r.window_ms - r.union_ms)


def test_the_readers_arithmetic():
    r = PT.reduce_events(EVENTS)
    r.units = 2
    r.counts = {"sync.a": 3, "sync.b": 1, "lanes.live": 5}
    assert PT.ms_per_unit(r, "busy", "intersect.") == pytest.approx(0.010)
    assert PT.ms_per_unit(r, "busy", "render.pass", "intersect.") == \
        pytest.approx(0.0075)
    assert PT.ms_per_unit(r, "idle", "accel.walk") == 0.0
    assert PT.ms_per_unit(r, "idle", "render.pass", "intersect.") == \
        pytest.approx(0.0125)
    assert PT.count_sum(r, "sync.") == 4
    assert PT.ms_per_unit(None, "busy", "x") is None


def test_off_the_card_nothing_runs():
    ctx = SimpleNamespace(kind="render", cell=None, spans=None,
                          trace=SimpleNamespace(busy_s=0.0))
    assert PT.read(ctx) is None and ctx.program is None


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        PT.reduce_events(EVENTS[1:])
