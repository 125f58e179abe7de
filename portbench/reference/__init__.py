"""The benchmark's plain reference: a path tracer of its own for the
benchmark's configurations, written from the scene's meaning and the
estimator's definition (`tracer.py`), with its own scene recorder
(`scene.py`), ray queries (`rays.py`) and sample counters
(`counters.py`).

It imports torch and numpy, never the program, and takes nothing the
program made: it stages the configuration on its own recorder and lays
out its own triangles, lights and texture. Program and reference draw the
same samples (the counters are the shared input, as a seed is), so they
trace the same paths and are compared pixel by pixel. It runs on the card
after the program's state is freed, in blocks of rays.

  - `render_pixels`: the film values of chosen pixels after the samples
    [first, first + spp) of an image, tracing just the samples that land
    in those pixels (under the box filter a sample lands in the pixel that
    holds its film position: its own or, rounding up, the next one);
  - `train_steps`: SGD steps on every material's colour from the same
    parameters, target and sample indices: the whole frame, one sample at
    each pixel's centre, the mean squared error against the target.

Both take the control's knob: the radiance rounded to bfloat16 (before
the film, or before the loss), the next precision below float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import counters as C
from . import rays as RY
from . import scene as SC
from . import tracer as T

Tensor = torch.Tensor

# train-step faults that `train_steps` can plant: the step returns the
# parameters unchanged; the loss is the mean over half the pixels; the
# loss is altered where it is produced
TRAIN_FAULTS = ("unchanged", "half_batch", "altered_loss")

# rays traced at once
BLOCK = 1 << 18


class Reference:
    """A configuration's scene, staged and laid out for the reference."""

    def __init__(self, config, stage_kwargs: dict, render_params: dict,
                 device):
        st = config.stage(SC.Stage(), **stage_kwargs)
        st.set_render_params(dict(render_params))
        self.scene = SC.build(st, device)
        self.tris = RY.Triangles(self.scene.tri, self.scene.tri_shadow)
        icfg = dict(config.CONFIG["integrator"])
        if icfg.get("type", "pathtracing") != "pathtracing":
            raise NotImplementedError(f"integrator {icfg}")
        self.bounces = int(icfg.get("bounces", 4))
        self.rr_min = int(icfg.get("russian_roulette_min_bounces", 2))

    def radiance(self, colour, px, py, pixel, sample):
        o, d = T.camera_rays(self.scene, px, py)
        return T.radiance(self.scene, self.tris, colour, self.bounces,
                          self.rr_min, o, d, pixel, sample)


def render_pixels(ref: Reference, ids: Tensor, first: int, spp: int,
                  bf16: bool = False) -> Tensor:
    """f32[n, 5]: the sums of rgba and the sample count of the pixels
    `ids` (int64, on the scene's device) over samples first .. first +
    spp - 1. With `bf16` each sample's rgba is rounded to bfloat16 first
    (the control)."""
    sc = ref.scene
    w, h = sc.width, sc.height
    dev = ids.device
    wanted = torch.zeros(h * w, dtype=torch.bool, device=dev)
    wanted[ids] = True
    x, y = ids % w, ids // w
    # a sample lands in its pixel or, rounding up, the next column or row
    near = torch.unique(torch.cat([
        ids, torch.where(x > 0, ids - 1, ids),
        torch.where(y > 0, ids - w, ids),
        torch.where((x > 0) & (y > 0), ids - w - 1, ids)]))
    acc = torch.zeros((h * w, 5), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for s in range(first, first + spp):
            idx = (int(s)) & C.MASK
            for blk in torch.split(near, BLOCK):
                px, py = C.film_position(blk, idx, w)
                ix, iy = torch.floor(px).long(), torch.floor(py).long()
                inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                land = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
                keep = inside & wanted[land]
                blk, px, py, land = blk[keep], px[keep], py[keep], land[keep]
                if blk.numel() == 0:
                    continue
                rgb, alpha = ref.radiance(sc.colour, px, py, blk, idx)
                vals = torch.cat([rgb, alpha[:, None]], -1)
                if bf16:
                    vals = vals.to(torch.bfloat16).to(torch.float32)
                acc.index_add_(0, land, torch.cat(
                    [vals, torch.ones_like(alpha[:, None])], -1))
    return acc[ids]


def train_steps(ref: Reference, params0: Dict[str, Tensor], target: Tensor,
                samples: List[int], lr: float, bf16: bool = False,
                fault: Optional[str] = None) -> dict:
    """SGD steps on {"diffuse_color": f32[M, 3]} (material rows in the
    order the configuration creates them) from `params0`, one at each
    sample index of `samples`: the whole frame, one sample at each pixel's
    centre, the mean squared error against `target` (f32[H, W, 3]).
    Returns {"losses": [float], "states": [params after each step, on the
    CPU]}. `bf16` rounds the radiance to bfloat16 before the loss, and its
    gradient with it (the control); `fault` plants one of TRAIN_FAULTS."""
    if fault is not None and fault not in TRAIN_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if set(params0) != {"diffuse_color"}:
        raise NotImplementedError(f"parameters {sorted(params0)}")
    sc = ref.scene
    w, h = sc.width, sc.height
    dev = target.device
    n = h * w
    tgt = target.reshape(-1, 3)
    # the half-batch fault takes the mean over the first half of the pixels
    n_used = n // 2 if fault == "half_batch" else n
    color = params0["diffuse_color"].to(dev)
    losses, states = [], []
    for s in samples:
        leaf = color.detach().clone().requires_grad_(True)
        total = torch.zeros((), dtype=torch.float64, device=dev)
        grad = torch.zeros_like(leaf)
        for lo in range(0, n_used, BLOCK):
            pid = torch.arange(lo, min(n_used, lo + BLOCK), device=dev)
            px = (pid % w).to(torch.float32) + 0.5
            py = (pid // w).to(torch.float32) + 0.5
            rgb, _ = ref.radiance(leaf, px, py, pid, int(s) & C.MASK)
            if bf16:
                rgb = rgb.to(torch.bfloat16).to(torch.float32)
            err = ((rgb - tgt[pid]) ** 2).sum() / (3.0 * n_used)
            g, = torch.autograd.grad(err, leaf, retain_graph=False)
            grad += g
            total += err.detach().double()
        loss = float(total)
        if fault == "altered_loss":
            loss = loss * (1.0 + 1e-3)
        if fault != "unchanged":
            color = (leaf - lr * grad).detach()
        losses.append(loss)
        states.append({"diffuse_color": color.cpu()})
    return {"losses": losses, "states": states}
