#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (libyafaray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own line:
  1. environment: torch and CUDA versions, nvcc, the card's name and power
     limit;
  2. build: compiles the CUDA kernels from the package's sources;
  3. kernel against its plain PyTorch version on the card: mt_closest vs
     mt_closest_ref on a random 300-triangle table and the Cornell table
     (closest and shadow, excluded ids, a ray count that is not a multiple
     of the block), the exact-tie case and both motion-blur arms; prim ids
     must be equal on every ray and t, u, v within rtol 1e-6;
  4. the slice: the Cornell box at 1920x1080, 16 spp, 4 bounces through
     `render(..., device="cuda")`, with every intersection query counted on
     the kernel, plausibility checks on the image, ms per pass, camera
     rays/s and the kernel's share of a pass (CUDA events);
  5. kernel path against plain path end to end: 256x256, 2 spp, 4 bounces,
     once through the kernel and once with the plain version swapped in.

Then one JSON line listing the kernels, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; the
script never falls back to the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

DEVICE = "cuda"
WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 16, 4   # the main path
SMALL = 256                                      # phase 5 image side
N_RANDOM, N_CORNELL, N_MOTION = 65_537, 2_073_601, 10_001
LAMP = 12.0   # radiance of the Cornell lamp (power 12, colour max 1)


def _cmd(*args: str) -> str:
    return subprocess.run(list(args), capture_output=True, text=True,
                          check=True).stdout.strip()


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _random_table(rng, f, motion=0):
    """Packed table of f random triangles with mixed visibility bits (and
    motion keyframes), as in tests/test_pallas_intersect.py."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch.accel.mt_intersect import pack_tris
    vtx = rng.standard_normal((f * 3, 3)).astype(np.float32)
    vis = np.full(f, 3, np.int32)
    vis[::7] = 2    # invisible to camera rays
    vis[::11] = 1   # casts no shadow
    vis_t = torch.from_numpy(vis)
    tabs = [pack_tris(*(torch.from_numpy(vtx[k::3]) for k in range(3)), vis_t)]
    for _ in range(motion):
        vk = vtx + rng.standard_normal(vtx.shape).astype(np.float32) * 0.3
        tabs.append(pack_tris(*(torch.from_numpy(vk[k::3]) for k in range(3)),
                              vis_t))
    return [t.to(DEVICE) for t in tabs]


def _rays(rng, n, lo=None, hi=None):
    import numpy as np
    import torch
    if lo is None:
        o = rng.standard_normal((n, 3)).astype(np.float32) * 2
    else:
        o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = np.full(n, -1, np.int32)
    excl[::5] = rng.integers(0, 36, excl[::5].shape)
    dev = lambda a: torch.from_numpy(a).to(DEVICE)
    return (dev(o), dev(d), torch.full((n,), 1e-4, device=DEVICE),
            torch.full((n,), 1e30, device=DEVICE), dev(excl))


def _compare(name, got, want, max_err):
    """Kernel outputs against the plain version's: prim ids equal on every
    ray, t/u/v within rtol 1e-6. Returns the running max abs error."""
    import torch
    t, p, u, v = got
    rt, rp, ru, rv = want
    torch.cuda.synchronize()
    mism = int((p != rp).sum())
    if mism:
        raise AssertionError(f"{name}: prim ids differ on {mism} rays")
    for label, a, b in (("t", t, rt), ("u", u, ru), ("v", v, rv)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0,
                                   msg=lambda m: f"{name} {label}: {m}")
        max_err = max(max_err, float((a - b).abs().max()))
    print(f"phase 3: {name}: {p.numel()} rays, {int((p >= 0).sum())} hits, "
          f"prim ids equal, max |diff| {max_err:.3g}")
    return max_err


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.cameras import shoot_rays
    from libyafaray_tpu_torch.scenes import cornell_builder

    # ---- phase 1: environment
    smi = _cmd("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader")
    nvcc = _cmd(MT._nvcc(), "--version").splitlines()[-1]
    print(f"phase 1: torch {torch.__version__}, torch CUDA "
          f"{torch.version.cuda}, nvcc: {nvcc}")
    print(smi)

    # ---- phase 2: build
    print(f"phase 2: built mt_intersect.cu in {MT.build():.2f} s "
          f"({' '.join(MT.NVCC_FLAGS)})")

    # ---- phase 3: kernel against its plain version on the card
    rng = np.random.default_rng(7)
    max_err = 0.0
    cornell = cornell_builder().compile("cam").to(DEVICE)
    tab_c = cornell.geom.tri_table
    tab_r, = _random_table(rng, 300)
    for shadow in (False, True):
        args = _rays(rng, N_RANDOM)
        max_err = _compare(f"random 300 tris shadow={shadow}",
                           MT.mt_closest(tab_r, *args, shadow=shadow),
                           MT.mt_closest_ref(tab_r, *args, shadow=shadow),
                           max_err)
        args = _rays(rng, N_CORNELL, 0.02, 0.98)
        max_err = _compare(f"cornell table shadow={shadow}",
                           MT.mt_closest(tab_c, *args, shadow=shadow),
                           MT.mt_closest_ref(tab_c, *args, shadow=shadow),
                           max_err)
    # exact tie: two triangles sharing the edge x=0 in the plane z=1
    v0 = torch.tensor([[0.0, -1.0, 1.0], [0.0, -1.0, 1.0]])
    v1 = torch.tensor([[0.0, 1.0, 1.0], [1.0, -1.0, 1.0]])
    v2 = torch.tensor([[-1.0, -1.0, 1.0], [0.0, 1.0, 1.0]])
    tab_tie = MT.pack_tris(v0, v1, v2, torch.tensor([3, 3])).to(DEVICE)
    tie = (torch.zeros((1, 3), device=DEVICE),
           torch.tensor([[0.0, 0.0, 1.0]], device=DEVICE),
           torch.tensor([1e-4], device=DEVICE),
           torch.tensor([1e30], device=DEVICE),
           torch.tensor([-1], dtype=torch.int32, device=DEVICE))
    got = MT.mt_closest(tab_tie, *tie)
    max_err = _compare("tie", got, MT.mt_closest_ref(tab_tie, *tie), max_err)
    if int(got[1][0]) != 0 or abs(float(got[2][0]) - 0.5) > 1e-6:
        raise AssertionError(f"tie: want prim 0 with u 0.5, got {got}")
    for motion in (1, 2):
        tabs = _random_table(rng, 200, motion)
        args = _rays(rng, N_MOTION)
        tt = torch.from_numpy(rng.random(N_MOTION).astype(np.float32)).to(DEVICE)
        kw = dict(time=tt, tris_t1=tabs[1],
                  tris_t2=tabs[2] if motion == 2 else None)
        max_err = _compare(f"motion={motion}",
                           MT.mt_closest(tabs[0], *args, **kw),
                           MT.mt_closest_ref(tabs[0], *args, **kw), max_err)

    # kernel and plain times at the main path's shape: 1080p camera rays
    # against the Cornell table
    width, height, spp, bounces = WIDTH, HEIGHT, SPP, BOUNCES
    n = width * height
    pid = torch.arange(n, device=DEVICE)
    px = (pid % width).float() + 0.5
    py = (pid // width).float() + 0.5
    o, d, _ = shoot_rays(cornell.camera, px, py)
    q = (o.contiguous(), d.contiguous(), torch.full((n,), 5e-5, device=DEVICE),
         torch.full((n,), 1e30, device=DEVICE),
         torch.full((n,), -1, dtype=torch.int32, device=DEVICE))
    times = {}
    for shadow in (False, True):
        times[shadow] = (
            _cuda_ms(lambda: MT.mt_closest(tab_c, *q, shadow=shadow), 20),
            _cuda_ms(lambda: MT.mt_closest_ref(tab_c, *q, shadow=shadow), 3))
        print(f"phase 3: time at N={n}, 64-row table, shadow={shadow}: "
              f"mt_closest {times[shadow][0]:.4f} ms, "
              f"mt_closest_ref {times[shadow][1]:.4f} ms")

    # ---- phase 4: the slice at full width
    b = cornell_builder()
    b.cameras["cam"]["resx"] = width
    b.cameras["cam"]["resy"] = height
    scene = b.compile("cam").to(DEVICE)
    cfg = make_integrator({"type": "pathtracing", "bounces": bounces})
    render(scene, cfg, spp=1, device=DEVICE)        # warm-up pass
    torch.cuda.synchronize()
    MT.launches = 0
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=spp, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = MT.launches
    want = spp * (bounces + 1) * 2
    if launches < want:
        raise AssertionError(f"mt_closest launched {launches} times, want at "
                             f"least {want} (closest + shadow per bounce)")
    img = F.resolve(film)[..., :3].cpu().numpy()
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"bad image: shape {img.shape}, finite "
                             f"{np.isfinite(img).all()}")
    band = width * 12 // 64
    left = img[:, :band].reshape(-1, 3).mean(0)
    right = img[:, -band:].reshape(-1, 3).mean(0)
    if not (left[0] > left[1] and left[0] > left[2]):
        raise AssertionError(f"left wall not red-dominant: {left}")
    if not (right[1] > right[0] and right[1] > right[2]):
        raise AssertionError(f"right wall not green-dominant: {right}")
    # at 16:9 the ceiling lamp lies above the vertical field of view: no
    # pixel may exceed its radiance (12); phase 5's square image sees it
    if not 0.0 < float(img.max()) <= LAMP + 1e-3:
        raise AssertionError(f"max {img.max()} outside (0, {LAMP}]")
    ms_pass = seconds * 1e3 / spp
    # the kernel's share of one pass, from CUDA events around its launches
    real = MT.mt_closest
    events = []

    def timed(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*a, **k)
        ev[1].record()
        events.append(ev)
        return out

    pass_ev = (torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
    MT.mt_closest = timed
    try:
        pass_ev[0].record()
        render(scene, cfg, spp=1, device=DEVICE, start_sample=spp)
        pass_ev[1].record()
        torch.cuda.synchronize()
    finally:
        MT.mt_closest = real
    kernel_ms = sum(a.elapsed_time(z) for a, z in events)
    pass_ms = pass_ev[0].elapsed_time(pass_ev[1])
    print(f"phase 4: cornell {width}x{height} {spp} spp {bounces} bounces: "
          f"{ms_pass:.2f} ms/pass, {n * spp / seconds:.4g} camera rays/s, "
          f"{launches} kernel launches; instrumented pass {pass_ms:.2f} ms, "
          f"kernel {kernel_ms:.2f} ms ({100 * kernel_ms / pass_ms:.1f}%); "
          f"walls left {left.round(4).tolist()} right "
          f"{right.round(4).tolist()}, max {float(img.max())}, mean "
          f"{float(img.mean()):.6f}")

    # ---- phase 5: kernel path against plain path, end to end
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = SMALL
    small = b.compile("cam")
    img_k = F.resolve(render(small, cfg, spp=2, device=DEVICE)).cpu().numpy()
    before = MT.launches
    MT.mt_closest = lambda *a, **k: MT.mt_closest_ref(*a, **k)
    try:
        img_p = F.resolve(render(small, cfg, spp=2, device=DEVICE)).cpu().numpy()
    finally:
        MT.mt_closest = real
    if MT.launches != before:
        raise AssertionError("the plain-path render launched the kernel")
    close = np.isclose(img_k, img_p, rtol=1e-4, atol=1e-4).all(-1).mean()
    rel_mean = abs(img_k.mean() - img_p.mean()) / abs(img_p.mean())
    print(f"phase 5: {SMALL}x{SMALL} 2 spp: {100 * close:.3f}% of pixels within "
          f"1e-4, mean rel diff {rel_mean:.3g}, max |diff| "
          f"{np.abs(img_k - img_p).max():.3g}")
    if close < 0.98 or rel_mean > 1e-3:
        raise AssertionError("kernel path and plain path renders disagree")
    if abs(float(img_k[..., :3].max()) - LAMP) > 1e-3:
        raise AssertionError(f"max {img_k[..., :3].max()} of the square "
                             f"render is not the lamp's radiance {LAMP}")

    print(json.dumps({"kernels": [{
        "name": "mt_closest", "route": "cuda",
        "source": "libyafaray_tpu_torch/csrc/mt_intersect.cu",
        "replaces": "libyafaray_tpu/accel/pallas_intersect.py:49",
        "launches": launches, "max_abs_err": max_err,
        "ms": times[False][0], "plain_ms": times[False][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
