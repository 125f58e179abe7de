"""The program's own spans and counters: a third window of a traced run.

The program (`libyafaray_tpu_torch.utils.profiling`) records spans and
counts inside its layers while its `tracing()` context is open, and each
span is a `record_function("yafaray::<name>")` range in a `torch.profiler`
trace. This window, run once a traced run's spans and profiled windows have
closed and the program's scene has been let go, compiles the cell's scene
again with the program's tracing on (its `scene.compile` spans), warms it
with one pass or step, and then runs the mix's `trace_passes` passes (one
`render`) or `trace_steps` train steps under `torch.profiler` with the
program's tracing on. The first per-layer metric that reads it runs it;
the others read its result, kept on `ctx.program`. It changes nothing that
the check or the other metrics read: the checked image or steps come from
the earlier windows. Off the card, or with a program that records no
spans, it runs nothing and its metrics read None.

The trace is reduced (`reduce_events`) into, for each innermost program
span (its path of span names, outermost first; "" for no span):

  - busy ms: the device's busy time (the union of its events) given to the
    span the work was launched inside, matched through the launches'
    correlation ids; a launch from a thread with no span open (autograd's
    backward thread) goes to the span open on the window's thread then;
    where events overlap, the time goes to the event that began first;
  - idle ms: each idle gap of the device given to the innermost span open
    on the window's thread at the gap's midpoint;
  - kernels: the kernel events launched inside it.

So the busy ms of all paths sum to the window's busy ms, and the idle ms to
its idle ms, exactly; `union_ms`, the union of the device's events as
`tracing` takes it, checks the first sum. The program's counts of the
window (`counts`) and a table by span name (calls and host ms from the
program's records, busy and idle ms and kernels from the trace; each a
pass or a step) are printed on standard error, before the check's lines.
"""
from __future__ import annotations

import bisect
import collections
import gc
import json
import math
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from portbench.tracing import _union

WINDOW = "portbench.program_window"
PREFIX = "yafaray::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = ""


def profiling_module():
    """The program's profiling module where it records spans, else None."""
    try:
        from libyafaray_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, n) for n in ("tracing", "host_sync",
                                                "span")):
        return None
    return profiling


def read(ctx) -> Optional[SimpleNamespace]:
    """The window's result for the run of `ctx`, run on the first read; None
    off the card (the profiled window saw no device work) or where the
    program records no spans."""
    if not hasattr(ctx, "program"):
        ctx.program = None
        if (ctx.trace is not None and ctx.trace.busy_s > 0
                and profiling_module() is not None):
            ctx.program = window(ctx.cell, ctx.kind, "cuda")
            _report(ctx.program)
    return ctx.program


# -------------------------------------------------------------- the window

def window(cell, kind: str, device) -> SimpleNamespace:
    """Compile the cell's scene with the program's tracing on, warm it, and
    profile the mix's traced passes or steps with the program's tracing on;
    returns the reduced trace with `counts`, `records` (the window's span
    records), `units` (passes or steps), `images` and `compile_s`."""
    import torch
    from portbench import harness
    from libyafaray_tpu_torch import make_integrator
    PF = profiling_module()
    icfg = make_integrator(cell.config.CONFIG["integrator"])
    with PF.tracing() as setup:
        scene = harness.compile_program_scene(cell, device)
    compile_s = 1e-9 * sum(s.end_ns - s.start_ns for s in setup.spans
                           if s.name == "scene.compile")
    # the window's samples: fixed, away from the other windows' (the
    # readers see no seed; nothing here is checked)
    first = (1 << 30) + (1 << 28)
    if kind == "train":
        train = harness.load_kind("train")
        trainer = train.Trainer(scene, cell, icfg, 0, first, device)
        units = int(cell.mix["trace_steps"])
        trainer.window(None, 1)

        def work():
            trainer.window(None, units)
    else:
        from libyafaray_tpu_torch import render
        units = int(cell.mix["trace_passes"])
        render(scene, icfg, cell.width, cell.height, spp=1,
               start_sample=first, device=device)

        def work():
            render(scene, icfg, cell.width, cell.height, spp=units,
                   start_sample=first + 1, device=device)
    harness.sync(device)
    with harness._quiet_host():
        with PF.tracing() as rec:
            events = profile_events(work, device)
    out = reduce_events(events)
    del scene, work
    if kind == "train":
        del trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out.counts = dict(rec.counts)
    out.records = rec.spans
    out.units = units
    out.images = sum(1 for s in rec.spans if s.name == "render.image")
    out.compile_s = compile_s
    return out


def profile_events(fn, device) -> list:
    """fn() under `torch.profiler` (CPU and, on the card, CUDA activities),
    inside the window's annotation and ending synchronised; the chrome
    trace's events (written to a temporary directory under TMPDIR, read
    back and deleted)."""
    import torch
    act = torch.profiler.ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    with torch.profiler.profile(
            activities=[act.CPU] + ([act.CUDA] if cuda else [])) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize(device)
    tmp = tempfile.mkdtemp(prefix="portbench-program-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ the reduction

def _timeline(spans: List[Tuple[float, float, str]]):
    """The innermost open span's path at each change point of one thread's
    nested spans: (times, paths), paths[i] holding from times[i] on."""
    times: List[float] = []
    paths: List[Tuple[str, ...]] = []
    stack: List[Tuple[float, float, str]] = []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            paths.append(tuple(s[2] for s in stack))

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        stack.append((a, b, name))
        times.append(a)
        paths.append(tuple(s[2] for s in stack))
    close_until(math.inf)
    return times, paths


def _at(line, t: float) -> Tuple[str, ...]:
    times, paths = line
    i = bisect.bisect_right(times, t) - 1
    return paths[i] if i >= 0 else ()


def reduce_events(events: list) -> SimpleNamespace:
    """Busy and idle ms and kernels by innermost program span (its path,
    "a/b/c"; OUTSIDE for none) from chrome-trace events (times in us)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no program window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main = win[0].get("tid")
    by_tid: Dict[object, list] = collections.defaultdict(list)
    for e in xs:
        name = str(e.get("name", ""))
        if e.get("cat") == "user_annotation" and name.startswith(PREFIX):
            a = float(e["ts"])
            by_tid[e.get("tid")].append((a, a + float(e["dur"]),
                                         name[len(PREFIX):]))
    lines = {tid: _timeline(s) for tid, s in by_tid.items()}
    empty = ([], [])
    main_line = lines.get(main, empty)

    def path_at(tid, t):
        p = _at(lines.get(tid, empty), t)
        if not p and tid != main:
            p = _at(main_line, t)
        return "/".join(p)

    launched: Dict[object, str] = {}
    for e in xs:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[corr] = path_at(e.get("tid"), float(e["ts"]))
    dev = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b, e))
    dev.sort(key=lambda x: (x[0], x[1]))
    busy: Dict[str, float] = collections.Counter()
    kernels: Dict[str, int] = collections.Counter()
    gaps: List[Tuple[float, float]] = []
    covered = w0
    for a, b, e in dev:
        path = launched.get((e.get("args") or {}).get("correlation"),
                            OUTSIDE)
        if a > covered:
            gaps.append((covered, a))
        if b > covered:
            busy[path] += (b - max(a, covered)) * 1e-3
            covered = b
        if e.get("cat") == "kernel":
            kernels[path] += 1
    if w1 > covered:
        gaps.append((covered, w1))
    idle: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        idle["/".join(_at(main_line, 0.5 * (a + b)))] += (b - a) * 1e-3
    return SimpleNamespace(window_ms=(w1 - w0) * 1e-3,
                           union_ms=1e-3 * sum(
                               b - a for a, b in _union(
                                   [(a, b) for a, b, _ in dev])),
                           busy_ms=sum(busy.values()),
                           idle_ms=sum(idle.values()),
                           busy=dict(busy), idle=dict(idle),
                           kernels=dict(kernels))


# ------------------------------------------------------------- the readers

def _under(path: str, prefix: str) -> bool:
    """Whether a span path holds a span named `prefix` or, for a prefix
    ending in ".", a span whose name starts with it."""
    return any(p.startswith(prefix) if prefix.endswith(".") else p == prefix
               for p in path.split("/")) if path else False


def ms_per_unit(prog, which: str, inside: str,
                outside: Optional[str] = None) -> Optional[float]:
    """The busy or idle ms (`which`) a pass or step whose innermost span
    lies under `inside` and not under `outside`."""
    if prog is None:
        return None
    table = getattr(prog, which)
    return sum(v for p, v in table.items() if _under(p, inside)
               and not (outside and _under(p, outside))) / prog.units


def count_sum(prog, prefix: str) -> Optional[int]:
    """The sum of the program's counts whose names start with `prefix`."""
    if prog is None:
        return None
    return sum(v for k, v in prog.counts.items() if k.startswith(prefix))


def span_table(prog) -> Dict[str, dict]:
    """By innermost span name: calls and host ms (the program's records,
    whole spans), busy and idle ms and kernels (the trace, the span's own
    share), each a pass or step."""
    rows: Dict[str, dict] = collections.defaultdict(
        lambda: dict(calls=0, host_ms=0.0, busy_ms=0.0, idle_ms=0.0,
                     kernels=0))
    for s in prog.records:
        rows[s.name]["calls"] += 1
        rows[s.name]["host_ms"] += (s.end_ns - s.start_ns) * 1e-6
    for key, field in (("busy", "busy_ms"), ("idle", "idle_ms"),
                       ("kernels", "kernels")):
        for path, v in getattr(prog, key).items():
            rows[path.rsplit("/", 1)[-1] or "(outside the program)"][
                field] += v
    return {name: {k: v / prog.units for k, v in r.items()}
            for name, r in rows.items()}


def _report(prog) -> None:
    """The window's totals, counts and span table on standard error."""
    line = {"window_ms": prog.window_ms, "union_ms": prog.union_ms,
            "busy_ms": prog.busy_ms, "idle_ms": prog.idle_ms,
            "units": prog.units, "compile_s": prog.compile_s,
            "counts": prog.counts, "spans": span_table(prog)}
    print("portbench: program spans " + json.dumps(line), file=sys.stderr,
          flush=True)
