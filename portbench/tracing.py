"""The profiled window: `torch.profiler` (CPU and CUDA activities) around a
fixed amount of work, its chrome trace written to a temporary directory
under TMPDIR, read back and reduced, and deleted.

The profiler costs the host microseconds a launch, and these paths are
host-bound: a traced window runs 1.5-2x slower than an untraced one, so
its idle share is higher than an untraced run's (PERF.md). Kernel times,
counts and the backward's device time are not affected.

From one trace (all times in seconds, clipped to the window, which is the
`portbench.window` annotation around the work and its final
synchronisation):

  - `busy_s`: the union of the device's events (kernels, copies, fills);
  - `window_s`: the window's length;
  - `kernels`: the number of kernel events;
  - `device_s_by_name`: device seconds by event name;
  - `backward_s`: device seconds of the work launched inside autograd's
    `evaluate_function` ranges (the backward pass), matched through the
    launches' correlation ids;
  - `breakdown`: the ten device operations that took most time, and the
    device's idle gaps summed by what the host was doing (the innermost
    host operator running at the gap's midpoint on the window's thread).
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import shutil
import tempfile
from types import SimpleNamespace
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_PREFIX = "autograd::engine::evaluate_function"


def profile(fn, device) -> SimpleNamespace:
    """Run fn() under the profiler and return the reduced trace."""
    import torch
    act = torch.profiler.ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[act.CPU] + ([act.CUDA] if cuda else [])) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize(device)
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return reduce_trace(events)


def _union(intervals: List[Tuple[float, float]]):
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events: list) -> SimpleNamespace:
    """The window's numbers from chrome-trace events (times in us)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")

    def clip(e):
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        return (a, b) if b > a else None

    dev = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            iv = clip(e)
            if iv is not None:
                dev.append((e, iv))
    busy = _union([iv for _, iv in dev])
    by_name: Dict[str, float] = collections.Counter()
    for e, (a, b) in dev:
        by_name[e.get("name", "?")] += (b - a) * 1e-6
    kernels = sum(1 for e, _ in dev if e.get("cat") == "kernel")

    # the backward pass: launches inside autograd's evaluate_function
    ranges: Dict[object, List[Tuple[float, float]]] = collections.defaultdict(
        list)
    for e in spans:
        if e.get("cat") == "cpu_op" and str(e.get("name", "")).startswith(
                BACKWARD_PREFIX):
            ranges[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    merged = {t: _union(r) for t, r in ranges.items()}
    starts = {t: [a for a, _ in r] for t, r in merged.items()}
    bw_corr = set()
    for e in spans:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        r = merged.get(e.get("tid"))
        if corr is None or not r:
            continue
        i = bisect.bisect_right(starts[e.get("tid")], float(e["ts"])) - 1
        if i >= 0 and float(e["ts"]) <= r[i][1]:
            bw_corr.add(corr)
    backward_s = sum((b - a) * 1e-6 for e, (a, b) in dev
                     if (e.get("args") or {}).get("correlation") in bw_corr)

    # idle gaps, by the host operator running at their midpoints
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("name", "?")) for e in spans
            if e.get("cat") == "cpu_op" and e.get("tid") == main_tid]
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    idle: Dict[str, float] = collections.Counter()
    # host operators of one thread nest: sweep them with a stack of the
    # open ones, whose top is the innermost at each (ascending) midpoint
    host.sort(key=lambda h: (h[0], -h[1]))
    stack: list = []
    i = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "(python between operators)"
        idle[label] += (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    top = lambda c: [[n, s] for n, s in collections.Counter(c).most_common(10)]
    return SimpleNamespace(
        busy_s=busy_s, window_s=(w1 - w0) * 1e-6, kernels=kernels,
        device_s_by_name=dict(by_name), backward_s=backward_s,
        breakdown={"device_ops": top(by_name), "idle_gaps": top(idle)},
        units=None, queries=None)
