"""Traffic kind "render": images back to back, each `render(spp=<config
spp>)` from its own first sample, on the scene compiled once.

Mix parameters: `render_params` (merged over the configuration's),
`span_images` (images of the traced run's spans window) and
`trace_passes` (passes of its profiled window). Check parameters
(`checks/<cell>.json`): `check_pixels` (pixels compared, in squares of
16 x 16 placed by the seed) and `pixel_tol`.

End-to-end metrics: `camera_rays_per_s` (W x H x the passes completed in
the window, over the window's seconds) and `pass_p90_ms` (the 90th
percentile, nearest rank, of every pass of the window, each synchronised).

What decides `correct`: the film of one image that the window completed,
drawn from the seed, at the compared pixels; the reference traces the
same samples of those pixels. Compared:

  - `pixels_off_pct`: the share of those pixels, in %, whose resolved
    rgba differs from the reference's by more than `pixel_tol` of the
    reference's value (at least 1e-3 absolute), or whose sample count
    differs.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional

import torch

from portbench import harness

SQUARE = 16


class _Control:
    """The render loop's control object: it ends the loop at a pass
    boundary once `canceled` is set."""

    def __init__(self):
        self.canceled = False

    def set_started(self):
        pass

    def set_progress(self, _frac):
        pass

    def set_finished(self):
        pass

    def set_resumed(self):
        pass


def render_images(scene, icfg, cell, device, first_sample: int,
                  deadline: Optional[float] = None,
                  images: Optional[int] = None, keep_ids=None):
    """Render image after image until `deadline` (a perf_counter time,
    checked at every pass end) or `images` images. Every pass ends
    synchronised and is timed on the host. Returns (pass seconds, [(first
    sample, kept values)] of the completed images, start, end): the kept
    values are the combined layer and the weight of the pixels
    `keep_ids`."""
    from libyafaray_tpu_torch import render
    passes: List[float] = []
    done = []
    ctl = _Control()
    start = time.perf_counter()
    last = [start]
    k = 0
    while True:
        first = first_sample + k * cell.spp
        times: List[float] = []

        def on_pass(_s, _total):
            harness.sync(device)
            now = time.perf_counter()
            times.append(now - last[0])
            last[0] = now
            # the window closes at the first pass end past the deadline,
            # once an image is complete
            if (deadline is not None and now >= deadline
                    and (done or len(times) == cell.spp)):
                ctl.canceled = True

        film = render(scene, icfg, cell.width, cell.height, spp=cell.spp,
                      start_sample=first, progress_cb=on_pass,
                      render_control=ctl, device=device)
        passes.extend(times)
        if len(times) == cell.spp and keep_ids is not None:
            done.append((first, torch.cat(
                [film.layers["combined"].reshape(-1, 4)[keep_ids],
                 film.weights.reshape(-1, 1)[keep_ids]], dim=1)))
        del film
        k += 1
        if ctl.canceled or (images is not None and k >= images):
            break
        last[0] = time.perf_counter()
    return passes, done, start, last[0]


def p90(values: List[float]) -> float:
    """The 90th percentile, nearest rank: at least a tenth of the values
    lie at or above it."""
    s = sorted(values)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


def check_pixel_ids(cell, seed: int, device):
    """The pixels compared (sorted ids): the cell's `check_pixels` //
    SQUARE^2 squares of SQUARE x SQUARE pixels at places drawn from the
    seed (overlaps count once)."""
    width, height = cell.width, cell.height
    side = min(SQUARE, width, height)
    n_sq = max(1, int(cell.check["check_pixels"]) // (side * side))
    g = harness.generator(seed, 1, device)
    x0 = torch.randint(width - side + 1, (n_sq,), generator=g, device=device)
    y0 = torch.randint(height - side + 1, (n_sq,), generator=g,
                       device=device)
    d = torch.arange(side, device=device)
    xs = x0[:, None, None] + d[None, None, :]
    ys = y0[:, None, None] + d[None, :, None]
    return torch.unique((ys * width + xs).reshape(-1))


# -------------------------------------------------------------- the run

def setup(run) -> None:
    """The scene compiled once, the compared pixels, and one warm-up image
    at the cell's shape before the window's samples."""
    run.scene = run.compile_scene()
    run.keep_ids = check_pixel_ids(run.cell, run.seed, run.device)
    render_images(run.scene, run.icfg, run.cell, run.device,
                  run.base + (1 << 29), images=1)


def measure(run, seconds: float) -> None:
    cell = run.cell
    passes, done, start, end = render_images(
        run.scene, run.icfg, cell, run.device, run.base,
        deadline=time.perf_counter() + float(seconds), keep_ids=run.keep_ids)
    run.metrics["camera_rays_per_s"] = (
        len(passes) * cell.width * cell.height / (end - start), "rays/s")
    run.metrics["pass_p90_ms"] = (1e3 * p90(passes), "ms")
    # each image's first pass also pays render()'s own set-up
    med = lambda v: 1e3 * sorted(v)[len(v) // 2] if v else None
    run.info.update(passes=len(passes),
                    beyond_p90=sum(p > p90(passes) for p in passes),
                    pass_ms={"p50": med(passes),
                             "first_p50": med(passes[::cell.spp]),
                             "other_p50": med([p for i, p in
                                               enumerate(passes)
                                               if i % cell.spp])})
    _finish(run, passes, done)


def traced(run, ctx, spans, profile) -> None:
    """The spans window (`span_images` images under `spans.installed`),
    then the profiled window (`trace_passes` passes)."""
    cell = run.cell
    with spans.installed(run.device) as sp:
        passes, done, _, _ = render_images(
            run.scene, run.icfg, cell, run.device, run.base,
            images=int(cell.mix["span_images"]), keep_ids=run.keep_ids)
    ctx.spans = sp.summary(passes)
    first = run.base + int(cell.mix["span_images"]) * cell.spp

    def work():
        from libyafaray_tpu_torch import render
        render(run.scene, run.icfg, cell.width, cell.height,
               spp=int(cell.mix["trace_passes"]), start_sample=first,
               device=run.device)

    ctx.trace = profile(work)
    ctx.trace.units = int(cell.mix["trace_passes"])
    _finish(run, passes, done)


def _finish(run, passes, done) -> None:
    """attempted, failed and the image the check compares; the program's
    scene is let go."""
    run.attempted = len(passes)
    # an image fails when its film holds a value that is not finite
    run.failed = sum(int(not torch.isfinite(v).all()) for _, v in done)
    pick = done[int(torch.randint(len(done), (1,), generator=harness.generator(
        run.seed, 2, "cpu")))] if done else None
    run.check_input = None if pick is None else (pick[0], pick[1].cpu())
    run.scene = None


# -------------------------------------------------------------- the check

def reference(cell, seed: int, check_input, device, ref=None,
              control: Optional[str] = None):
    """The reference's values of the compared pixels of the checked image
    (`control` "bf16": the radiance rounded to bfloat16)."""
    from portbench import reference as R
    ref = ref or R.Reference(cell.config, cell.stage_kwargs,
                             cell.render_params, device)
    ids = check_pixel_ids(cell, seed, device)
    return R.render_pixels(ref, ids, check_input[0], cell.spp,
                           bf16=control == "bf16")


def compare(cell, check_input, ref) -> dict:
    prog = check_input[1].double().cpu()
    ref = ref.double().cpu()
    a = prog[:, :4] / prog[:, 4:].clamp_min(1e-12)
    b = ref[:, :4] / ref[:, 4:].clamp_min(1e-12)
    gap = ((a - b).abs() / b.abs().clamp_min(1e-3)).amax(dim=1)
    off = (gap > float(cell.check["pixel_tol"])) | (prog[:, 4] != ref[:, 4])
    off |= ~torch.isfinite(a).all(dim=1)
    return {"pixels_off_pct": 100.0 * float(off.double().mean())}


def control_readings(cell, seeds, device, base_of):
    """For each seed, the control (the reference in the program's place,
    its radiance rounded to bfloat16) against the reference, on the first
    image of a window from that seed."""
    from portbench import reference as R
    ref = R.Reference(cell.config, cell.stage_kwargs, cell.render_params,
                      device)
    for seed in seeds:
        first = base_of(seed)
        t0 = time.perf_counter()
        want = reference(cell, seed, (first,), device, ref)
        ref_s = time.perf_counter() - t0
        ctl = reference(cell, seed, (first,), device, ref, control="bf16")
        yield dict(seed=seed, what="control", reference_s=ref_s,
                   **compare(cell, (first, ctl), want))
