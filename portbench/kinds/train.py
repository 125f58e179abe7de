"""Traffic kind "train": inverse rendering, `make_train_step` SGD steps
back to back on one step object.

Mix parameters: `params` (the material columns trained), `lr`,
`start_color` and `target` (the ranges the seed draws the starting
parameters and the target image from), `checked_steps` (steps set-up
takes and the check compares) and `trace_steps` (steps of the traced
run's profiled window).

End-to-end metric: `train_rays_per_s` (W x H x the steps completed in the
window, over the window's seconds; each step ends when its loss is read).

What decides `correct`: set-up drives the step object's first
`checked_steps` steps, and the window goes on from there with the same
object; the reference takes those steps from the same parameters, target
and samples. Compared:

  - `loss_gap`: the largest relative gap of a step's loss;
  - `grad_gap`: the gap between the norms of the first gradient (the
    program's worked out from its parameters after one SGD step), over the
    larger of the reference's norm and the median leaf's, worst leaf;
  - `change_gap`: the same for the parameters' change after the checked
    steps.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from portbench import harness


def train_inputs(cell, seed: int, shapes: dict, device):
    """The starting parameters and the target, from the seed, made on the
    device: each parameter uniform in the mix's `start_color`, the target
    image uniform in its `target`."""
    g = harness.generator(seed, 3, device)
    lo, hi = cell.mix["start_color"]
    params0 = {k: lo + (hi - lo) * torch.rand(shapes[k], generator=g,
                                              device=device)
               for k in cell.mix["params"]}
    tlo, thi = cell.mix["target"]
    target = tlo + (thi - tlo) * torch.rand(
        (cell.height, cell.width, 3), generator=g, device=device)
    return params0, target


def _shapes(cell):
    """The trained columns' shapes: one row a material, in the order the
    configuration creates them (as its staging records them)."""
    from portbench.reference.scene import Stage
    st = cell.config.stage(Stage(), **cell.stage_kwargs)
    return {k: (len(st.material_order), 3) for k in cell.mix["params"]}


class Trainer:
    """The cell's one step object: `make_train_step` with its parameters,
    target and sample counter."""

    def __init__(self, scene, cell, icfg, seed: int, base: int, device):
        from libyafaray_tpu_torch import make_train_step
        self.scene = scene
        self.cell, self.base = cell, base
        self.params0, self.target = train_inputs(cell, seed, _shapes(cell),
                                                 device)
        self.lr = float(cell.mix["lr"])
        self.step = make_train_step(icfg, cell.height, cell.width,
                                    lr=self.lr, device=device)
        self.params = dict(self.params0)
        self.k = 0
        self.losses, self.states = [], []

    def _one(self) -> float:
        self.params, loss = self.step(self.scene, self.params, self.target,
                                      self.base + self.k)
        self.k += 1
        return float(loss)                  # reads the loss: synchronises

    def first_steps(self) -> None:
        for _ in range(int(self.cell.mix["checked_steps"])):
            self.losses.append(self._one())
            self.states.append({k: v.detach().cpu()
                                for k, v in self.params.items()})

    def window(self, deadline: Optional[float], steps: Optional[int] = None):
        """Steps back to back until `deadline` (perf_counter, checked after
        each step) or `steps` steps: (steps, failed, start, end); a step
        whose loss is not finite failed."""
        start = time.perf_counter()
        n = failed = 0
        while True:
            loss = self._one()
            n += 1
            failed += int(not math.isfinite(loss))
            end = time.perf_counter()
            if ((deadline is not None and end >= deadline)
                    or (steps is not None and n >= steps)):
                return n, failed, start, end

    def record(self) -> dict:
        return {"first": self.base, "losses": list(self.losses),
                "states": list(self.states),
                "params0": {k: v.cpu() for k, v in self.params0.items()}}


# -------------------------------------------------------------- the run

def setup(run) -> None:
    """The step object, and its first `checked_steps` steps."""
    run.trainer = Trainer(run.compile_scene(), run.cell, run.icfg, run.seed,
                          run.base, run.device)
    run.trainer.first_steps()


def measure(run, seconds: float) -> None:
    steps, failed, start, end = run.trainer.window(
        time.perf_counter() + float(seconds))
    run.metrics["train_rays_per_s"] = (
        steps * run.cell.width * run.cell.height / (end - start), "rays/s")
    _finish(run, steps, failed)


def traced(run, ctx, spans, profile) -> None:
    units = int(run.cell.mix["trace_steps"])
    res = []
    ctx.trace = profile(lambda: res.append(run.trainer.window(None, units)))
    ctx.trace.units = units
    _finish(run, *res[0][:2])


def _finish(run, steps, failed) -> None:
    run.attempted, run.failed = steps, failed
    run.check_input = run.trainer.record()
    run.trainer = None


# -------------------------------------------------------------- the check

def reference(cell, seed: int, check_input, device, ref=None,
              control: Optional[str] = None, fault: Optional[str] = None):
    """The reference's checked steps (`control` "bf16": the radiance
    rounded to bfloat16; `fault`: one of `reference.TRAIN_FAULTS`)."""
    from portbench import reference as R
    ref = ref or R.Reference(cell.config, cell.stage_kwargs,
                             cell.render_params, device)
    params0, target = train_inputs(cell, seed, _shapes(cell), device)
    first = check_input["first"]
    n = int(cell.mix["checked_steps"])
    return R.train_steps(ref, params0, target, [first + i for i in range(n)],
                         float(cell.mix["lr"]), bf16=control == "bf16",
                         fault=fault)


def _leaf_gaps(prog: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's gap between the norms of two sets of tensors, over
    the larger of the reference leaf's norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k, v in prog.items():
        gap = abs(float(torch.linalg.vector_norm(v.double())) - norms[k])
        scale = max(norms[k], med)
        worst = max(worst, gap / scale if scale > 0 else math.inf * gap)
    return worst


def compare(cell, prog: dict, ref: dict) -> dict:
    lr = float(cell.mix["lr"])
    loss_gap = max(abs(p - r) / abs(r) if r else abs(p - r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    p0 = prog["params0"]
    grad = lambda st: {k: (p0[k] - st[0][k]) / lr for k in p0}
    change = lambda st: {k: st[-1][k] - p0[k] for k in p0}
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gaps(grad(prog["states"]),
                                   grad(ref["states"])),
            "change_gap": _leaf_gaps(change(prog["states"]),
                                     change(ref["states"]))}


def control_readings(cell, seeds, device, base_of):
    """For each seed, the control (the reference in the program's place,
    its radiance rounded to bfloat16) and each planted fault, against the
    reference."""
    from portbench import reference as R
    ref = R.Reference(cell.config, cell.stage_kwargs, cell.render_params,
                      device)
    for seed in seeds:
        first = {"first": base_of(seed)}
        t0 = time.perf_counter()
        want = reference(cell, seed, first, device, ref)
        ref_s = time.perf_counter() - t0
        params0, _ = train_inputs(cell, seed, _shapes(cell), device)
        for what, kw in [("control", dict(control="bf16"))] + [
                (f, dict(fault=f)) for f in R.TRAIN_FAULTS]:
            got = reference(cell, seed, first, device, ref, **kw)
            got["params0"] = {k: v.cpu() for k, v in params0.items()}
            yield dict(seed=seed, what=what, reference_s=ref_s,
                       **compare(cell, got, want))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
