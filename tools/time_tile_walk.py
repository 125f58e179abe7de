#!/usr/bin/env python3
"""Time builds of the port's tile-walk kernel against each other on one GPU.

    python3 tools/time_tile_walk.py NAME=SOURCE ...

for example, the kernel of the previous commit against this one:

    git show HEAD~1:libyafaray_tpu_torch/csrc/tiles_traverse.cu > parent.cu
    python3 tools/time_tile_walk.py parent=parent.cu \\
        new=libyafaray_tpu_torch/csrc/tiles_traverse.cu

Each NAME=SOURCE is a `tiles_traverse.cu` (this one or another version of
it, with the same C entry point) built with the port's nvcc flags, all
builds in parallel, into the ignored `libyafaray_tpu_torch/_build/variants/`. For each build and each
specialisation of the kernel (motion 0/1/2 x instanced) it prints the
registers, static shared memory, spilled bytes, threads per block and
resident blocks per SM, as the CUDA driver reports them for a cubin of the
same source and flags.

Then it captures the tile_walk calls of one pass (sample 0, 2 bounces) of
the terrain (BASELINE config 3, untextured, 720x720) and of the forest
(2,000 true instances and 16 moving ones over it), nine each, and builds
the random 2.4M-triangle query of `chip_smoke.py` phase 3b (blocks of
1024). Every build is held against tile_walk_ref on the terrain's camera
query, the forest's background-light shadow query at depth 0 and its first
bounce, and the 2.4M-triangle query (prim ids, t, u, v equal on closest
hits; hit/miss on any hits); then every build is timed on all twenty
queries with CUDA events, in turns (the builds in order, then in reverse),
beside each query's needed pair tests and bound (`chip_smoke._walk_bound`).
Prints the card's name and power limit first; exits non-zero without a
CUDA device or when a build disagrees.
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

REPS = 5
ARM = re.compile(rb"_Z\w*tiles_traverse_kernelILi(\d)ELb([01])E\w*")
# cuFuncGetAttribute attributes
MAX_THREADS, SHARED, LOCAL, NUM_REGS = 0, 1, 3, 4


def builds(specs):
    """Compile each (name, source) into a shared library and a cubin, all
    nvcc processes at once; returns {name: (so path, cubin path)}."""
    from libyafaray_tpu_torch import csrc_build
    out_dir = os.path.join(csrc_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    cubin_flags = [f for f in csrc_build.NVCC_FLAGS
                   if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs, paths = [], {}
    for name, src in specs:
        so = os.path.join(out_dir, f"{name}.so")
        cubin = os.path.join(out_dir, f"{name}.cubin")
        paths[name] = (so, cubin)
        for cmd in ([csrc_build.nvcc(), *csrc_build.NVCC_FLAGS, "-o", so,
                     src],
                    [csrc_build.nvcc(), *cubin_flags, "-cubin", "-o", cubin,
                     src]):
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
    return paths


def kernel_attributes(cubin, pattern):
    """{the groups of `pattern`: (registers, static shared bytes, local
    bytes, threads per block, resident blocks per SM)} of every kernel in a
    cubin whose mangled name matches `pattern` (a bytes regex)."""
    import torch
    torch.cuda.init()
    torch.empty(1, device="cuda")       # the primary context is current
    cu = ctypes.CDLL("libcuda.so.1")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args in (("cuModuleLoadData", [vp, ctypes.c_char_p]),
                     ("cuModuleGetFunction", [vp, vp, ctypes.c_char_p]),
                     ("cuFuncGetAttribute", [vp, ci, vp]),
                     ("cuOccupancyMaxActiveBlocksPerMultiprocessor",
                      [vp, vp, ci, ctypes.c_size_t])):
        getattr(cu, fn).argtypes = args
        getattr(cu, fn).restype = ci
    with open(cubin, "rb") as fh:
        image = fh.read()
    mod = ctypes.c_void_p()
    err = cu.cuModuleLoadData(ctypes.byref(mod), image)
    if err != 0:
        print(f"cuModuleLoadData failed on {cubin} (CUDA error {err})")
        return {}
    out = {}
    for name in sorted({m.group(0) for m in pattern.finditer(image)}):
        fn = ctypes.c_void_p()
        if cu.cuModuleGetFunction(ctypes.byref(fn), mod, name) != 0:
            continue        # a name that is not an entry point

        def attr(a):
            v = ctypes.c_int()
            cu.cuFuncGetAttribute(ctypes.byref(v), a, fn)
            return v.value

        threads = attr(MAX_THREADS)
        blocks = ctypes.c_int()
        cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(blocks), fn, threads, 0)
        out[pattern.match(name).groups()] = (
            attr(NUM_REGS), attr(SHARED), attr(LOCAL), threads, blocks.value)
    return out


def _queries():
    """[(label, (rays, cand, ent, count, tab), keywords)]: the nine queries
    of a terrain pass, the nine of a forest pass, and the 2.4M-triangle
    random query of chip_smoke phase 3b."""
    import numpy as np
    import chip_smoke as C
    from libyafaray_tpu_torch.accel import blocks as BL
    from libyafaray_tpu_torch.scenes import (bigmesh_builder, bigmesh_grid,
                                             forest_builder)
    kinds = ("closest", "sun shadow", "background shadow")
    out = []
    for scene_name, builder in (
            ("terrain", lambda: bigmesh_builder(C.TERRAIN_GRID,
                                                textured=False)),
            ("forest", lambda: forest_builder(C.FOREST_INST, C.FOREST_MOVING,
                                              C.TERRAIN_GRID))):
        scene = builder().compile("cam")
        for i, (prep, kw) in enumerate(C._capture_walks(scene, range(9))):
            out.append((f"{scene_name} {i} (depth {i // 3} {kinds[i % 3]})",
                        prep, kw))
        del scene
    verts, faces, _, _ = bigmesh_grid(C.BIG_GRID)
    vis = np.full(len(faces), 3, np.int32)
    vis[::7] = 2
    vis[::11] = 1
    big = BL.build_blocks(C._mesh(verts, faces, vis))
    rng = np.random.default_rng(11)
    o, d, t_min, t_max, excl = C._rays(rng, C.N_BIG, [0, 0, 0.3],
                                       [4, 4, 1.5], len(faces), 7)
    d[: C.N_BIG // 2, 2] = -d[: C.N_BIG // 2, 2].abs()
    _, *prep = C._sorted_query(big, o, d, t_min, t_max, excl)
    out.append(("big terrain (closest, blocks of 1024)", (*prep, big.tab),
                {}))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_tile_walk: no CUDA device")
    import chip_smoke as C
    from libyafaray_tpu_torch import csrc_build
    from libyafaray_tpu_torch.accel import tiles as TL
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
        for (motion, inst), (regs, smem, local, threads, blocks) in \
                kernel_attributes(paths[name][1], ARM).items():
            arm = TL.arm(int(motion), inst == b"1")
            print(f"{name} ({src}) {arm}: {regs} registers, "
                  f"{smem} B static shared memory, {local} B local, "
                  f"{threads} threads a block, {blocks} resident blocks "
                  f"per SM")
        csrc_build._libs["tiles_traverse"] = ctypes.CDLL(paths[name][0])
        csrc_build._entries.pop("tiles_traverse_launch", None)
        fns[name] = csrc_build.entry("tiles_traverse",
                                     "tiles_traverse_launch", TL.WALK_C_ARGS)
    names = [s[0] for s in specs]

    queries = _queries()
    checked = {q[0] for q in queries
               if q[0].startswith(("terrain 0 ", "forest 2 ", "forest 3 ",
                                   "big"))}
    for label, prep, kw in queries:
        if label not in checked:
            continue
        want = TL.tile_walk_ref(*prep, **kw)
        for name in names:
            csrc_build._entries["tiles_traverse_launch"] = fns[name]
            got = TL.tile_walk(*prep, **kw)
            torch.cuda.synchronize()
            if kw.get("any_hit"):
                mism = int(((got[1] >= 0) != (want[1] >= 0)).sum())
                if mism:
                    raise AssertionError(f"{name} {label}: hit/miss differs "
                                         f"on {mism} rays")
                print(f"{name} {label}: hit/miss equal")
            else:
                C._compare(f"{name} {label}", got, want, 0.0, phase="-")
    header = " | ".join(f"{n} ms (share)" for n in names)
    print(f"query | pair tests | bound ms | {header}")
    for label, prep, kw in queries:
        csrc_build._entries["tiles_traverse_launch"] = fns[names[0]]
        got = TL.tile_walk(*prep, **kw)
        pairs, bound_ms, _ = C._walk_bound(prep, got, kw)
        ms = {n: [] for n in names}
        for name in names + names[::-1]:
            csrc_build._entries["tiles_traverse_launch"] = fns[name]
            ms[name].append(C._cuda_ms(lambda: TL.tile_walk(*prep, **kw),
                                       REPS))
        cells = " | ".join(
            f"{sum(ms[n]) / 2:.4f} ({100 * bound_ms * 2 / sum(ms[n]):.1f}%)"
            for n in names)
        print(f"{label} | {pairs} | {bound_ms:.4f} | {cells}")
    csrc_build._entries.pop("tiles_traverse_launch", None)
    csrc_build._libs.pop("tiles_traverse", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
