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
    traces by total time, the kernels under their CUDA function names.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

# the chrome-trace categories of work on the device: kernels, copies and
# fills (every other category is the host's: operators, Python frames,
# CUDA API calls, annotations)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class RenderStats:
    """Accumulates render timings (Timer "rendert" and printRenderStats)."""
    pass_times: List[float] = field(default_factory=list)
    pass_rays: List[int] = field(default_factory=list)
    events: Dict[str, float] = field(default_factory=dict)
    _t0: Optional[float] = None

    # --- named events (the reference's common/timer.h addEvent/start/stop)
    def start(self, name: str = "rendert") -> None:
        self.events[name + ".__start"] = time.time()

    def stop(self, name: str = "rendert") -> float:
        t0 = self.events.pop(name + ".__start", None)
        if t0 is None:
            return 0.0
        dt = time.time() - t0
        self.events[name] = self.events.get(name, 0.0) + dt
        return dt

    def get_time(self, name: str = "rendert") -> float:
        return self.events.get(name, 0.0)

    # --- per-pass accounting
    def begin_pass(self) -> None:
        self._t0 = time.time()

    def end_pass(self, rays: int) -> None:
        if self._t0 is None:
            return
        self.pass_times.append(time.time() - self._t0)
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
