"""The benchmark's general harness: one cell, one run.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own, found by the name that
`BENCHMARK.json` gives it:

  - a configuration `<config>`: `configs/<config>.py`, its `CONFIG` dict
    (sizes, integrator, render params, source) and `stage(builder, ...)`,
    which stages the scene on any builder;
  - a traffic mix `<traffic>`: `mixes/<traffic>.json`, data: its `kind`
    and the parameters that kind reads;
  - a traffic kind `<kind>`: `kinds/<kind>.py`, its set-up, its window
    (`measure`, or `traced` for the per-layer metrics) and what decides
    `correct` (`reference`, `compare`, `control_readings`);
  - a cell `<cell>`: its entry in `BENCHMARK.json` and `checks/<cell>.json`,
    the parameters of the check that decides `correct` and the limits of
    its numbers;
  - a per-layer metric `<metric>`: `metrics/<metric>.py`, whose
    `read(ctx)` returns the number or None.

A run sets up (imports, the kernels from the program's build cache, the
scene compiled once, a warm-up image or the first train steps), measures
for the given seconds, or with `trace` reads the per-layer metrics from a
spans window and a profiled window, and then checks what the timed path
produced against the plain reference (`check.py`). The program is
`libyafaray_tpu_torch`; nothing here imports its JAX counterpart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "libyafaray_tpu")


# ------------------------------------------------------------- the files

def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(bench: dict, name: str, root: str = ROOT):
    """The configuration module that BENCHMARK.json names `name`."""
    entry = next(c for c in bench["configs"] if c["name"] == name)
    mod = _load_module(os.path.join(root, entry["file"]),
                       "portbench_config_" + name.replace("-", "_")
                       .replace(".", "_"))
    mod.NAME = name
    return mod


def load_mix(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "portbench", "mixes", f"{name}.json")) as fh:
        return json.load(fh)


def load_check(cell: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "portbench", "checks", f"{cell}.json")) as fh:
        return json.load(fh)


def load_kind(kind: str, root: str = ROOT):
    """The traffic kind `kind`: `kinds/<kind>.py`."""
    return _load_module(os.path.join(root, "portbench", "kinds",
                                     f"{kind}.py"),
                        "portbench.kinds." + kind)


def load_reader(metric: str, root: str = ROOT):
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    return _load_module(path, "portbench_metric_" + metric.replace(".", "_")
                        .replace("-", "_")).read


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end_of(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics that cell `cell` reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_of(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics read in cell `cell`: those that list it, and
    those without a list whose moved metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def forbidden_modules() -> List[str]:
    """Names in sys.modules whose top-level name is forbidden, compared
    whole (`libyafaray_tpu_torch` is not `libyafaray_tpu`)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


# -------------------------------------------------------------- the run

@dataclasses.dataclass
class Cell:
    """What a run needs: the cell, its configuration and mix, and the
    sizes, which tests shrink through `overrides`."""
    name: str
    config: object
    mix: dict
    check: dict
    width: int
    height: int
    spp: int
    stage_kwargs: dict
    render_params: dict


def make_cell(bench: dict, name: str, root: str = ROOT,
              overrides: Optional[dict] = None) -> Cell:
    entry = cell_entry(bench, name)
    config = load_config(bench, entry["config"], root)
    mix = load_mix(entry["traffic"], root)
    ov = dict(overrides or {})
    cfg = config.CONFIG
    width = ov.pop("width", cfg["width"])
    height = ov.pop("height", cfg["height"])
    spp = ov.pop("spp", cfg["spp"])
    mix.update(ov.pop("mix", {}))
    check_over = ov.pop("check", {})
    stage_kwargs = dict(width=width, height=height, **ov.pop("stage", {}))
    if ov:
        raise KeyError(f"unknown overrides {sorted(ov)}")
    render_params = dict(cfg.get("render_params", {}))
    render_params.update(mix.get("render_params", {}))
    check = load_check(name, root)
    check.update(check_over)
    return Cell(name=name, config=config, mix=mix,
                check=check, width=width, height=height,
                spp=spp, stage_kwargs=stage_kwargs,
                render_params=render_params)


def generator(seed: int, salt: int, device):
    """A torch.Generator on `device` seeded from the run's seed and a salt
    (one salt a use, so that uses draw independent numbers)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) % (1 << 63))
    return g


def sample_base(seed: int) -> int:
    """The window's first sample index, from the seed (any whole number)."""
    return (int(seed) * 2654435761) % (1 << 30)


def compile_program_scene(cell: Cell, device):
    """The scene through the program's public builder, compiled once."""
    from libyafaray_tpu_torch import SceneBuilder
    b = cell.config.stage(SceneBuilder(), **cell.stage_kwargs)
    b.set_render_params(dict(cell.render_params))
    return b.compile(cell.config.CONFIG["camera"], device=device)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _setup_torch(device):
    import torch
    # full float32 in every product the program or the reference makes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.device(device).type == "cuda":
        torch.cuda.init()


def _build_kernels(device):
    import torch
    if torch.device(device).type != "cuda":
        return 0.0
    from libyafaray_tpu_torch import csrc_build
    return csrc_build.build("mt_intersect", "tiles_traverse",
                            "lbvh_traverse")


def run(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None,
        overrides: Optional[dict] = None, root: str = ROOT) -> dict:
    """One run of one cell; returns the result line as a dict, with under
    "_forbidden" the forbidden modules found once the window closed (for
    `run.py` to judge and take out)."""
    import torch
    from . import check, spans
    t_start = time.perf_counter() if t_start is None else t_start
    _setup_torch(device)
    cell = make_cell(bench, cell_name, root, overrides)
    kind = load_kind(cell.mix["kind"], root)
    build_s = _build_kernels(device)
    from libyafaray_tpu_torch import make_integrator
    out = SimpleNamespace(
        cell=cell, seed=seed, base=sample_base(seed), device=device,
        icfg=make_integrator(cell.config.CONFIG["integrator"]),
        compile_scene=lambda: compile_program_scene(cell, device),
        metrics={}, info={}, attempted=0, failed=0, check_input=None)
    kind.setup(out)
    sync(device)
    window_begin = time.perf_counter()
    setup_s = window_begin - t_start
    ctx = SimpleNamespace(kind=cell.mix["kind"], cell=cell, spans=None,
                          trace=None)
    with _quiet_host():
        if trace:
            kind.traced(out, ctx, spans, lambda work: _profile(work, device))
        else:
            kind.measure(out, seconds)
    out.metrics["setup_s"] = (setup_s, "s")
    if torch.device(device).type != "cuda":
        # a run off the card (the tests') reports no time under a metric
        out.metrics = {}
    out.build_s = build_s
    out.forbidden_after_window = forbidden_modules()
    if torch.device(device).type == "cuda":
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    else:
        out.memory_peak_bytes = 0
    # the program's state is freed before the reference runs
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        out.power_limit = _power_limit(device)
        out.busy_s, out.window_s = ctx.trace.busy_s, ctx.trace.window_s
        out.breakdown = ctx.trace.breakdown
        per = {}
        for m in per_layer_of(bench, cell_name):
            v = load_reader(m["name"], root)(ctx)
            if v is not None:
                per[m["name"]] = (v, m["unit"])
        out.metrics = per
    t_ref = time.perf_counter()
    out.checks = check.run_checks(kind, cell, seed, out.check_input, device)
    out.reference_s = time.perf_counter() - t_ref
    return _result_line(bench, cell_name, out, trace, device)


@contextlib.contextmanager
def _quiet_host():
    """The measured window without the cyclic garbage collector: what
    set-up made is frozen out of its sight, and it does not run inside the
    window (the window's tensors are freed by reference counting)."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def _profile(work, device):
    """The profiled window of a traced run (`tracing`) over `work`, with
    the rays of its kernel queries counted (`spans.counting`)."""
    from . import spans, tracing
    with spans.counting() as counts:
        trace = tracing.profile(work, device)
    trace.queries = counts.queries
    return trace


def _power_limit(device):
    """The card's power limit as nvidia-smi reports it ("700.00 W"), which
    the roofline shares are read beside; None where it cannot be read."""
    import subprocess
    import torch
    if torch.device(device).type != "cuda":
        return None
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i",
                            str(torch.cuda.current_device())],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip() or None


def _result_line(bench, cell_name, out, trace, device) -> dict:
    import torch
    correct = (out.checks["correct"] and out.failed == 0
               and out.attempted > 0)
    if torch.device(device).type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if trace:
        dev["busy_s"] = out.busy_s
        dev["window_s"] = out.window_s
    line = {"correct": bool(correct), "attempted": int(out.attempted),
            "failed": int(out.failed),
            "metrics": {k: {"value": v, "unit": u}
                        for k, (v, u) in out.metrics.items()},
            "device": dev}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["info"] = dict(out.info, build_s=out.build_s,
                        reference_s=out.reference_s,
                        power_limit=getattr(out, "power_limit", None))
    line["_forbidden"] = out.forbidden_after_window
    line["checks"] = out.checks["numbers"]
    return line
