"""Render profiling and tracing: counterpart of
`libyafaray_tpu/utils/profiling.py`.

The reference has no profiler, only named Timer events ("rendert",
src/integrator/surface/integrator_tiled.cc:149-150, 228), a render-stats
string (ImageFilm::printRenderStats, include/render/imagefilm.h:153) and
kd-tree build counters. This module gives:

  - `RenderStats`: per-pass wall times, ray counts and rays/s with a
    printable summary (printRenderStats); `render(..., stats=)` fills it,
    synchronising the film's device before each pass's end;
  - `trace(log_dir)`: a context manager around `torch.profiler.profile`
    (CPU and, on the card, CUDA activities) that writes a chrome trace
    (`*.pt.trace.json`) under `log_dir`;
  - `device_op_summary(log_dir)`: the heaviest device events of those
    traces by total time, the kernels under their CUDA function names;
  - spans and counts inside the program, recorded only inside a
    `tracing()` context (off by default): `span(name, **attrs)` around a
    layer's work (a context manager or a decorator), `count(name, n)` of
    host or device quantities, and `host_sync(site)` around each statement
    of the render and train paths that makes the host wait for the device
    (`host_read(site, x)`, the one way those paths read a device value on
    the host, is one). While a `torch.profiler` trace runs, each span is
    also a `record_function("yafaray::<name>")` range, so the trace holds
    the program's layers on its own clock beside the device's events.

Spans (name: where):

  - `render.image`, `render.pass` (`index`: the sample), `render.camera`,
    `film.add`: `render.render` and `render._render_ids`;
  - `integrator.bounce` (`depth`) and inside it `shade.surface`,
    `shade.emission`, `shade.nee`, `shade.bsdf`: `integrators.mc.integrate`;
  - `intersect.closest`, `intersect.any`, `intersect.shadow_surface`: the
    queries of `ops.intersect` (`camera_hit` nests `intersect.closest`);
  - `accel.prepass` (`tiles.tile_candidates`), `accel.sort` (the block
    accelerator's ray sort), `accel.walk` (each kernel's wrapper:
    `mt_closest`, `tile_walk`, `lbvh_traverse`), `accel.pack` (`lbvh.packed`
    when it packs);
  - `train.step` with `train.forward`, `train.loss`, `train.backward`,
    `train.update`: `parallel.make_train_step`;
  - `grad.take` (`table`: the gathered table's name, a material column or
    `texel_pool`): the backward of `ops.fast_grad.take`, opened on
    autograd's thread while the step's thread waits inside
    `train.backward`, so its record's parent is that span;
  - `scene.compile` with `compile.materials`, `compile.textures`,
    `compile.geometry`, `compile.lights`, `compile.accel`:
    `SceneBuilder.compile`;
  - `sync.<site>`: the host's wait at a synchronising statement
    (`host_sync`, `host_read`).

Counts: `sync.<site>` (one a synchronising statement), `lanes.total` and `lanes.live`
(lanes whose t-range is not empty, at each intersection query),
`prepass.tiles`, `prepass.live_tiles` and `prepass.candidates` (the
candidate blocks of all tiles), `grad.take.lanes.<table>` and
`grad.take.rows.<table>` (the lanes and the table rows of each
`grad.take`), `bsdf.sampled_lanes` and `bsdf.delta_lanes` (the live lanes
at each bounce's BSDF sample, and those whose sampled lobe is delta),
`table_builds.<table>` (tables that a
render or a train step builds for itself: `pack_lbvh`, `vol_atten`,
`photon_maps`), `kernel.<kernel>.rays` and `kernel.<kernel>.any_hit_rays`
at each walk's launch, `kernel.tile_candidates.tiles` (the prepass
kernel's tiles) and `kernel.take_grad.lanes` (the lanes of `take`'s
backward kernel), counted where the wrappers launch them, and, from the
one launch counter `csrc_build.launch_counts` (read at the recording's
end, not counted again), `kernel.<kernel>.launches` of every kernel
(`mt_closest`, `tile_walk`, `tile_candidates`, `lbvh_traverse`, and
`take_grad`: one a reduction), `kernel.tile_walk.launches.<arm>` of each
of the walk's specialisations and `kernel.take_grad.kernels` (the kernels
of those reductions: one each, or two with the combine).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import glob
import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import csrc_build

# the chrome-trace categories of work on the device: kernels, copies and
# fills (every other category is the host's: operators, Python frames,
# CUDA API calls, annotations)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class RenderStats:
    """Accumulates render timings (Timer "rendert" and printRenderStats),
    on the monotonic `time.perf_counter` clock."""
    pass_times: List[float] = field(default_factory=list)
    pass_rays: List[int] = field(default_factory=list)
    events: Dict[str, float] = field(default_factory=dict)
    _t0: Optional[float] = None

    # --- named events (the reference's common/timer.h addEvent/start/stop)
    def start(self, name: str = "rendert") -> None:
        self.events[name + ".__start"] = time.perf_counter()

    def stop(self, name: str = "rendert") -> float:
        t0 = self.events.pop(name + ".__start", None)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        self.events[name] = self.events.get(name, 0.0) + dt
        return dt

    def get_time(self, name: str = "rendert") -> float:
        return self.events.get(name, 0.0)

    # --- per-pass accounting
    def begin_pass(self) -> None:
        self._t0 = time.perf_counter()

    def end_pass(self, rays: int) -> None:
        if self._t0 is None:
            return
        self.pass_times.append(time.perf_counter() - self._t0)
        self.pass_rays.append(int(rays))
        self._t0 = None

    @property
    def total_time(self) -> float:
        return sum(self.pass_times)

    @property
    def total_rays(self) -> int:
        return sum(self.pass_rays)

    @property
    def rays_per_sec(self) -> float:
        t = self.total_time
        return self.total_rays / t if t > 0 else 0.0

    def summary(self) -> str:
        """printRenderStats: one human-readable line per metric."""
        lines = [
            f"passes: {len(self.pass_times)}",
            f"total render time: {self.total_time:.3f} s",
            f"camera rays: {self.total_rays}",
            f"rays/sec: {self.rays_per_sec:,.0f}",
        ]
        if self.pass_times:
            lines.append(
                f"per-pass time: min {min(self.pass_times):.3f} s, "
                f"max {max(self.pass_times):.3f} s, "
                f"mean {self.total_time / len(self.pass_times):.3f} s")
        for k, v in sorted(self.events.items()):
            if not k.endswith(".__start"):
                lines.append(f"timer '{k}': {v:.3f} s")
        return "\n".join(lines)


class trace:
    """Context manager capturing a torch profiler trace into `log_dir`.

    On the card (`device` "cuda", the default) it records the host and the
    device (CUPTI); with `device="cpu"` the host alone. Usage:

        with profiling.trace("/tmp/mytrace"):
            film = render(scene, cfg, spp=1)
        top = profiling.device_op_summary("/tmp/mytrace")
    """

    def __init__(self, log_dir: str, device="cuda"):
        self.log_dir = log_dir
        self.device = torch.device(device)
        self.path: Optional[str] = None
        self._prof = None

    def __enter__(self):
        act = torch.profiler.ProfilerActivity
        activities = [act.CPU]
        if self.device.type == "cuda":
            activities.append(act.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns()}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        return out


def device_op_summary(log_dir: str, top: int = 20,
                      exclude_host: bool = True
                      ) -> List[Tuple[str, float, int]]:
    """The heaviest events of the chrome traces that `trace` wrote under
    `log_dir`, as (name, total_ms, count), heaviest first. With
    `exclude_host` only the device's events count (kernels, copies and
    fills, `DEVICE_CATEGORIES`); a trace of the CPU alone then has none."""
    totals: Dict[str, float] = collections.Counter()
    counts: Dict[str, int] = collections.Counter()
    for path in glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                          recursive=True):
        with open(path) as fh:
            data = json.load(fh)
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            if exclude_host and e.get("cat") not in DEVICE_CATEGORIES:
                continue
            name = e.get("name", "?")
            totals[name] += float(e["dur"])
            counts[name] += 1
    return [(n, t / 1000.0, counts[n])
            for n, t in collections.Counter(totals).most_common(top)]


# ---------------------------------------------------------------------------
# Spans and counts inside the program
# ---------------------------------------------------------------------------

# the open `tracing()` context's recording; None while tracing is off, so a
# span or a count then costs this one check
_rec: Optional["Recording"] = None


@dataclass
class SpanRecord:
    """One span: its name, the index of its parent's record (-1 at the
    top), its start and end on `time.perf_counter_ns`, the ordinals of the
    image, pass and train step it ran in (-1 outside one) and its
    attributes."""
    name: str
    parent: int
    start_ns: int
    end_ns: int
    image: int
    pass_: int
    step: int
    attrs: Optional[Dict[str, Any]]


# the spans whose opening advances the image, pass or step ordinal
_ORDINALS = {"render.image": "image", "render.pass": "pass_",
             "train.step": "step"}


class Recording:
    """What one `tracing()` context recorded: `spans` (SpanRecord, in the
    order they opened) and `counts` (name -> int; the device's counts are
    added when the context exits)."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counts: Dict[str, int] = collections.Counter()
        self._device_counts: Dict[str, torch.Tensor] = {}
        self._open: List[Tuple[int, str, Any]] = []
        self._at = {"image": -1, "pass_": -1, "step": -1}

    def _enter(self, name: str, attrs) -> None:
        which = _ORDINALS.get(name)
        if which is not None:
            self._at[which] += 1
        parent = self._open[-1][0] if self._open else -1
        rf = torch.profiler.record_function("yafaray::" + name)
        self.spans.append(SpanRecord(name, parent, time.perf_counter_ns(), -1,
                                     self._at["image"], self._at["pass_"],
                                     self._at["step"], attrs))
        rf.__enter__()
        self._open.append((len(self.spans) - 1, name, rf))

    def _exit(self, name: str) -> None:
        # a span opened before tracing began closes unrecorded
        if not self._open or self._open[-1][1] != name:
            return
        i, _, rf = self._open.pop()
        rf.__exit__(None, None, None)
        self.spans[i].end_ns = time.perf_counter_ns()

    def _count_device(self, name: str, n: torch.Tensor) -> None:
        n = n.detach().to(torch.int64)
        prev = self._device_counts.get(name)
        self._device_counts[name] = n if prev is None else prev + n

    def _finish(self, launches_before: Dict[str, int]) -> None:
        while self._open:
            self._exit(self._open[-1][1])
        # the device's counts, read once: one host read a device
        by_dev: Dict[torch.device, List[str]] = collections.defaultdict(list)
        for name, t in self._device_counts.items():
            by_dev[t.device].append(name)
        for names in by_dev.values():
            vals = torch.stack([self._device_counts[k] for k in names])
            for k, v in zip(names, vals.tolist()):
                self.counts[k] += int(v)
        self._device_counts = {}
        for k, v in csrc_build.launch_counts.items():
            if v - launches_before.get(k, 0):
                self.counts[k] += v - launches_before.get(k, 0)


@contextlib.contextmanager
def tracing():
    """Record the program's spans and counts inside the `with` body; yields
    the Recording, complete once the body has exited (the device's counts
    are read then, in one host read a device). Not re-entrant."""
    global _rec
    if _rec is not None:
        raise RuntimeError("tracing() is already on")
    rec = Recording()
    before = dict(csrc_build.launch_counts)
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        rec._finish(before)


def recording() -> bool:
    """Whether a `tracing()` context is open: sites whose count costs device
    work (a reduction) test it before computing the count."""
    return _rec is not None


class _Span:
    """A named span; see `span`."""
    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        rec = _rec
        if rec is not None:
            rec._enter(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        rec = _rec
        if rec is not None:
            rec._exit(self.name)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            rec = _rec
            if rec is None:
                return fn(*args, **kwargs)
            rec._enter(name, None)
            try:
                return fn(*args, **kwargs)
            finally:
                rec._exit(name)
        return spanned


# one span object a name, for the spans without attributes
_NAMED: Dict[str, _Span] = {}


def span(name: str, **attrs) -> _Span:
    """A span named `name`: `with span("shade.nee"): ...`, or as a
    decorator, `@span("intersect.closest")` (a decorator's span takes no
    attributes). Inside a `tracing()` context it records a SpanRecord and
    enters `torch.profiler.record_function("yafaray::<name>")`; outside
    one it records nothing and makes no call into torch."""
    if attrs and _rec is not None:
        return _Span(name, attrs)
    s = _NAMED.get(name)
    if s is None:
        s = _NAMED[name] = _Span(name, None)
    return s


def count(name: str, n=1) -> None:
    """Add `n` to the count `name` inside a `tracing()` context: a host
    number, or a device tensor (a 0-d count), summed on its device and read
    when the context exits, so that no pass waits to count."""
    rec = _rec
    if rec is None:
        return
    if isinstance(n, torch.Tensor):
        rec._count_device(name, n)
    else:
        rec.counts[name] += int(n)


class _Sync(_Span):
    """A span that also counts itself; see `host_sync`."""
    __slots__ = ()

    def __enter__(self):
        rec = _rec
        if rec is not None:
            rec.counts[self.name] += 1
            rec._enter(self.name, None)
        return self


# one sync object a site
_SYNCS: Dict[str, _Sync] = {}


def host_sync(site: str) -> _Sync:
    """The span and count `sync.<site>` around a statement that makes the
    host wait for the device: a read of a device value (`host_read`), a
    copy of a host value to the device (a pageable copy waits for the
    stream), or an operation whose output size the host reads (`nonzero`).
    Counted on any device; on the card each one drains the launch queue."""
    s = _SYNCS.get(site)
    if s is None:
        s = _SYNCS[site] = _Sync("sync." + site, None)
    return s


def host_read(site: str, x: torch.Tensor):
    """`x.tolist()` (a Python number for a 0-d tensor): the one way the
    render and train paths read a device value on the host, under
    `host_sync(site)`."""
    with host_sync(site):
        return x.tolist()
