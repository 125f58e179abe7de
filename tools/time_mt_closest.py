#!/usr/bin/env python3
"""Time builds of the port's brute-force closest-hit kernel against each
other on one GPU.

    python3 tools/time_mt_closest.py NAME=SOURCE ...

for example, the kernel of the previous commit against this one:

    git show HEAD~1:libyafaray_tpu_torch/csrc/mt_intersect.cu > parent.cu
    python3 tools/time_mt_closest.py parent=parent.cu \\
        new=libyafaray_tpu_torch/csrc/mt_intersect.cu

Each NAME=SOURCE is an `mt_intersect.cu` (this one or another version of
it, with the same C entry point) built with the port's nvcc flags, all
builds in parallel, into the ignored `libyafaray_tpu_torch/_build/variants/`.
For each build and each motion arm it prints the registers, static shared
memory, spilled (local) bytes, threads per block and resident blocks per
SM, as the CUDA driver reports them for a cubin of the same source and
flags.

Then it takes the queries of `chip_smoke.mt_queries`: the ten mt_closest
calls of one Cornell pass at 1920x1080 (sample 0, 4 bounces) and the ten
of one pass of the golden's baked cubes at that size, captured as they reach
mt_closest, random tables of 300, 2,047 and 16,384 triangles and both
motion arms at 200 triangles. Every build is held against mt_closest_ref
bit for bit on all of them and on `chip_smoke.mt_edge_cases`; then every
build is timed on every query with CUDA events, in turns (the builds in
order, then in reverse), beside the query's live rays, the rows its
visibility bit keeps and its bound (`chip_smoke.mt_bound`); last, whole
Cornell passes at 1920x1080 per build, in turns. Prints the card's name
and power limit first; exits non-zero without a CUDA device or when a
build disagrees.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

REPS, PASSES = 10, 3
ARM = re.compile(rb"_Z\w*mt_closest_kernelILi(\d)E\w*")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_mt_closest: no CUDA device")
    import chip_smoke as C
    from time_tile_walk import builds, kernel_attributes
    from libyafaray_tpu_torch import csrc_build, make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    specs = [tuple(arg.split("=", 1)) for arg in sys.argv[1:]]
    if not specs:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    paths = builds(specs)
    print(f"built {len(specs)} sources (a library and a cubin each) in "
          f"{time.perf_counter() - t0:.2f} s")
    fns = {}
    for name, src in specs:
        for (motion,), (regs, smem, local, threads, blocks) in \
                kernel_attributes(paths[name][1], ARM).items():
            print(f"{name} ({src}) motion{int(motion)}: {regs} registers, "
                  f"{smem} B static shared memory, {local} B local, "
                  f"{threads} threads a block, {blocks} resident blocks "
                  f"per SM")
        csrc_build._libs["mt_intersect"] = ctypes.CDLL(paths[name][0])
        csrc_build._entries.pop("mt_closest_launch", None)
        fns[name] = csrc_build.entry("mt_intersect", "mt_closest_launch",
                                     MT.C_ARGS)
    names = [s[0] for s in specs]

    cornell_hd, cubes_hd = C.hd_scenes()
    queries = C.mt_queries(cornell_hd, cubes_hd)
    checks = [(label, a, k) for label, a, k in queries]
    checks += [(name, (tab, *rays), dict(shadow=shadow))
               for name, tab, rays, shadow, _ in C.mt_edge_cases(
                   np.random.default_rng(7), C.DEVICE, C.N_RANDOM)]
    for label, a, k in checks:
        want = MT.mt_closest_ref(*a, **k)
        for name in names:
            csrc_build._entries["mt_closest_launch"] = fns[name]
            C._compare(f"{name} {label}", MT.mt_closest(*a, **k), want, 0.0,
                       phase="-", exact=True)
    del checks
    header = " | ".join(f"{n} ms (share)" for n in names)
    print(f"query | rays | live | rows | bound ms | {header}")
    for label, a, k in queries:
        live, rows, bound_ms, by = C.mt_bound(a, k)
        ms = {n: [] for n in names}
        for name in names + names[::-1]:
            csrc_build._entries["mt_closest_launch"] = fns[name]
            ms[name].append(C._cuda_ms(lambda: MT.mt_closest(*a, **k), REPS))
        cells = " | ".join(
            f"{sum(ms[n]) / 2:.4f} ({100 * bound_ms * 2 / sum(ms[n]):.1f}%)"
            for n in names)
        print(f"{label} | {a[1].shape[0]} | {live} | {rows} | "
              f"{bound_ms:.4f} ({by}) | {cells}")
    cfg = make_integrator({"type": "pathtracing", "bounces": C.BOUNCES})
    passes = {n: [] for n in names}
    for name in names + names[::-1]:
        csrc_build._entries["mt_closest_launch"] = fns[name]
        render(cornell_hd, cfg, spp=1)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(cornell_hd, cfg, spp=PASSES)
        torch.cuda.synchronize()
        passes[name].append((time.perf_counter() - t0) * 1e3 / PASSES)
    print("cornell pass 1920x1080, 4 bounces, ms (two turns of "
          f"{PASSES} passes): " + ", ".join(
              f"{n} {' / '.join(f'{x:.2f}' for x in passes[n])}"
              for n in names))
    csrc_build._entries.pop("mt_closest_launch", None)
    csrc_build._libs.pop("mt_intersect", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
