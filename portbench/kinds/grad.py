"""Traffic kind "grad": inverse rendering with respect to a glass's IOR and
an image texture's texels, `make_train_step` SGD steps back to back on one
step object, its leaves `ior` (the material table's column) and
`textures.texel_pool` (the texture pool's texels).

Mix parameters: `params` (the two leaves), `lr`, `start_ior` and `target`
(the ranges the seed draws the glass rows' starting IOR and the target
image from; the texels start as the configuration stages them),
`checked_steps` (steps set-up takes and the check compares) and
`trace_steps` (steps of the traced run's profiled window).

End-to-end metric: `train_rays_per_s` (W x H x the steps completed in the
window, over the window's seconds; each step ends when its loss is read).

What decides `correct`: set-up drives the step object's first
`checked_steps` steps, and the window goes on from there with the same
object; the reference (`reference/glass.py`) takes those steps from the
same IOR, target and samples, and the texels as it stages them. Leaves
are compared element by element, the reference's image laid out as the
program's pool (level 0's rows, rgb; the mip levels and alpha take no
gradient), each over the reference leaf's own norm, worst leaf (the
train kind's scale, the larger of the leaf's norm and the median leaf's,
would divide the IOR's gap by the texels' norm). Compared:

  - `loss_gap`: the largest relative gap of a step's loss;
  - `grad_gap`: the first step's gradient, the program's as its step
    object keeps it (`step.grads`);
  - `change_gap`: the parameters' change after the checked steps, each
    element's gap less what float32 rounding of the updates can give
    (one ulp of the element a step): at the mix's rate the IOR moves a
    few dozen ulps in the checked steps, so a split rounding is no fault.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Optional

import torch

from portbench import harness, program_trace

_train = harness.load_kind("train")

# the program's leaves and the reference's names for them
LEAVES = {"ior": "ior", "textures.texel_pool": "texels"}


def _glass_rows(cell):
    """The material rows of the configuration's glass, as its staging
    records them."""
    from portbench.reference.scene import Stage
    st = cell.config.stage(Stage(), **cell.stage_kwargs)
    return [i for i, name in enumerate(st.material_order)
            if st.materials[name][0].get("type") == "glass"]


def draws(cell, seed: int, device):
    """(starting IOR of the glass rows, target image) from the seed, made
    on the device: the IOR uniform in the mix's `start_ior`, the target
    uniform in its `target`."""
    g = harness.generator(seed, 3, device)
    lo, hi = cell.mix["start_ior"]
    ior = lo + (hi - lo) * torch.rand((), generator=g, device=device)
    tlo, thi = cell.mix["target"]
    target = tlo + (thi - tlo) * torch.rand(
        (cell.height, cell.width, 3), generator=g, device=device)
    return ior, target


def program_inputs(scene, cell, seed: int, device):
    """The program's starting leaves (the compiled scene's IOR column with
    the glass rows at the seed's IOR, and its texel pool) and the target."""
    if list(cell.mix["params"]) != list(LEAVES):
        raise ValueError(f"the grad kind trains {list(LEAVES)}")
    ior, target = draws(cell, seed, device)
    col = scene.materials.ior.detach().clone().to(device)
    col[_glass_rows(cell)] = ior
    return {"ior": col, "textures.texel_pool":
            scene.textures.texel_pool.detach().clone().to(device)}, target


class GradTrainer(_train.Trainer):
    """The cell's one step object: `make_train_step` on the IOR and the
    texel pool, with its parameters, target and sample counter."""

    def __init__(self, scene, cell, icfg, seed: int, base: int, device):
        from libyafaray_tpu_torch import make_train_step
        self.scene = scene
        self.cell, self.base = cell, base
        self.params0, self.target = program_inputs(scene, cell, seed, device)
        self.lr = float(cell.mix["lr"])
        self.step = make_train_step(icfg, cell.height, cell.width,
                                    lr=self.lr, device=device)
        self.params = dict(self.params0)
        self.k = 0
        self.losses, self.states = [], []
        self.grads = None
        self.texel_row0 = int(scene.textures.img_offset[0])

    def _one(self) -> float:
        loss = super()._one()
        if self.grads is None:                  # the first step's
            self.grads = {k: g.detach().cpu()
                          for k, g in self.step.grads.items()}
        return loss

    def record(self) -> dict:
        name = lambda d: {LEAVES[k]: v for k, v in d.items()}
        return {"first": self.base, "losses": list(self.losses),
                "states": [name(s) for s in self.states],
                "grads": name(self.grads), "texel_row0": self.texel_row0,
                "params0": name({k: v.cpu()
                                 for k, v in self.params0.items()})}


# -------------------------------------------------------------- the run

def setup(run) -> None:
    """The step object, and its first `checked_steps` steps."""
    run.trainer = GradTrainer(run.compile_scene(), run.cell, run.icfg,
                              run.seed, run.base, run.device)
    run.trainer.first_steps()


def measure(run, seconds: float) -> None:
    _train.measure(run, seconds)


def traced(run, ctx, spans, profile) -> None:
    """The profiled window over `trace_steps` steps, then the program's
    spans window (`program_window`), kept on `ctx.program` for the
    readers."""
    _train.traced(run, ctx, spans, profile)
    ctx.program = None
    if ctx.trace.busy_s > 0 and program_trace.profiling_module() is not None:
        ctx.program = program_window(ctx.cell, run.icfg, "cuda")
        program_trace._report(ctx.program)


def program_window(cell, icfg, device):
    """`program_trace.window` for this kind: the scene compiled again with
    the program's tracing on, one warm step, then `trace_steps` steps
    under the profiler with the program's tracing on; each `grad.take`
    range of the trace is named by its table (`label_takes`)."""
    PF = program_trace.profiling_module()
    with PF.tracing() as setup_rec:
        scene = harness.compile_program_scene(cell, device)
    compile_s = 1e-9 * sum(s.end_ns - s.start_ns for s in setup_rec.spans
                           if s.name == "scene.compile")
    # fixed samples away from the other windows' (nothing here is checked)
    trainer = GradTrainer(scene, cell, icfg, 0, (1 << 30) + (1 << 28),
                          device)
    units = int(cell.mix["trace_steps"])
    trainer.window(None, 1)
    harness.sync(device)
    with harness._quiet_host():
        with PF.tracing() as rec:
            events = program_trace.profile_events(
                lambda: trainer.window(None, units), device)
    label_takes(events, rec.spans)
    out = program_trace.reduce_events(events)
    del scene, trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out.counts = dict(rec.counts)
    out.records = rec.spans
    out.units = units
    out.images = 0
    out.compile_s = compile_s
    return out


def label_takes(events: list, records) -> bool:
    """Name each `yafaray::grad.take` range of the trace
    `yafaray::grad.take.<table>`, from the program's records of the same
    spans (the n-th range in time is the n-th record: the backward opens
    them one after another on autograd's thread); False, naming nothing,
    where the two do not pair up."""
    name = program_trace.PREFIX + "grad.take"
    ranges = sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e.get("name") == name),
                    key=lambda e: float(e["ts"]))
    recs = [s for s in records if s.name == "grad.take"]
    if len(ranges) != len(recs) or not recs:
        return False
    for e, s in zip(ranges, recs):
        e["name"] = f"{name}.{(s.attrs or {}).get('table', '')}"
    return True


# -------------------------------------------------------------- the check

def reference(cell, seed: int, check_input, device, ref=None,
              control: Optional[str] = None, fault: Optional[str] = None):
    """The reference's checked steps (`control` "bf16": the radiance
    rounded to bfloat16; `fault`: one of `glass.GLASS_FAULTS`), with its
    starting leaves under "params0"."""
    from portbench.reference import glass as G
    ref = ref or G.GlassReference(cell.config, cell.stage_kwargs,
                                  cell.render_params, device)
    ior, target = draws(cell, seed, device)
    params0 = ref.leaves0()
    params0["ior"] = torch.where(ref.scene.glass, ior, params0["ior"])
    first = check_input["first"]
    n = int(cell.mix["checked_steps"])
    out = G.train_steps(ref, params0, target, [first + i for i in range(n)],
                        float(cell.mix["lr"]), bf16=control == "bf16",
                        fault=fault)
    out["params0"] = {k: v.cpu() for k, v in params0.items()}
    return out


def _as_program(ref: torch.Tensor, like: torch.Tensor,
                row0: int) -> torch.Tensor:
    """A reference leaf in the layout of `like`: as it is where the shapes
    agree; else the texels (f32[H, W, 3]) as the program's pool's level 0
    from row `row0`, rgb, and 0 in the mip levels and alpha."""
    if ref.shape == like.shape:
        return ref
    out = torch.zeros_like(like)
    out[row0:row0 + ref.shape[0] * ref.shape[1], :3] = ref.reshape(-1, 3)
    return out


def _gap(prog: torch.Tensor, ref: torch.Tensor, norm: float,
         slack: float | torch.Tensor = 0.0) -> float:
    """The norm of the elements' gaps, each less `slack`, over the
    reference's norm `norm` (0 where both are 0)."""
    gap = torch.clamp_min((prog.double() - ref.double()).abs() - slack, 0.0)
    a = float(torch.linalg.vector_norm(gap))
    if norm > 0:
        return a / norm
    return 0.0 if a == 0 else math.inf


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at |x|, in float64."""
    a = x.float().abs()
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()


def compare(cell, prog: dict, ref: dict) -> dict:
    row0 = int(prog.get("texel_row0", 0))
    n = len(prog["states"])
    out = {"loss_gap": max(abs(p - r) / abs(r) if r else abs(p - r)
                           for p, r in zip(prog["losses"], ref["losses"])),
           "grad_gap": 0.0, "change_gap": 0.0}
    for k in LEAVES.values():
        g, rg = prog["grads"][k], ref["grads"][k]
        norm = float(torch.linalg.vector_norm(rg.double()))
        out["grad_gap"] = max(out["grad_gap"], _gap(
            g, _as_program(rg, g, row0), norm))
        p0, p1 = prog["params0"][k], prog["states"][-1][k]
        rc = ref["states"][-1][k] - ref["params0"][k]
        norm = float(torch.linalg.vector_norm(rc.double()))
        slack = n * _ulp(torch.maximum(p0.abs(), p1.abs()))
        out["change_gap"] = max(out["change_gap"], _gap(
            p1 - p0, _as_program(rc, p0, row0), norm, slack))
    return out


def control_readings(cell, seeds, device, base_of):
    """For each seed, the control (the reference in the program's place,
    its radiance rounded to bfloat16) and each planted fault, against the
    reference."""
    from portbench.reference import glass as G
    ref = G.GlassReference(cell.config, cell.stage_kwargs, cell.render_params,
                           device)
    for seed in seeds:
        first = {"first": base_of(seed)}
        t0 = time.perf_counter()
        want = reference(cell, seed, first, device, ref)
        ref_s = time.perf_counter() - t0
        for what, kw in [("control", dict(control="bf16"))] + [
                (f, dict(fault=f)) for f in G.GLASS_FAULTS]:
            got = reference(cell, seed, first, device, ref, **kw)
            yield dict(seed=seed, what=what, reference_s=ref_s,
                       **compare(cell, got, want))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
