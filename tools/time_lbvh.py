#!/usr/bin/env python3
"""Time builds of the port's LBVH walk kernel against each other on one GPU.

    python3 tools/time_lbvh.py NAME=SOURCE[@MODE] ...

for example, the kernel of the previous commit against this one (the chip
machine's copy of the repository is not a git checkout, so save the
parent's source into the ignored `_proof/` first):

    git show HEAD~1:libyafaray_tpu_torch/csrc/lbvh_traverse.cu \\
        > _proof/lbvh_parent.cu
    python3 tools/time_lbvh.py parent=_proof/lbvh_parent.cu \\
        new=libyafaray_tpu_torch/csrc/lbvh_traverse.cu

Each NAME=SOURCE is a version of `lbvh_traverse.cu` built with the port's
nvcc flags, all builds in parallel, into the ignored
`libyafaray_tpu_torch/_build/variants/`. The C entry point a build exports
says which arguments it takes: `lbvh_packed_launch` this package's (the
packed records of `lbvh.pack_lbvh`), `lbvh_traverse_launch` the node
tables, `prim_order` and the geometry as the kernel's first version took
them, `lbvh_nodes_launch` the packed node records beside those leaf
tables (a design step between the two). MODE, for a build with this
package's entry point, reorders each query's rays before the launch and
scatters the results back: `compact` moves the live rays to the front (a
stable sort on the dead flag), `sort` orders them by a morton code of the
origin under the direction's octant, dead rays last.

For each build and each motion arm it prints the registers, static shared
memory, spilled (local) bytes, threads per block and resident blocks per
SM, as the CUDA driver reports them for a cubin of the same source and
flags. Then it captures the lbvh_traverse calls of one pass of the
textured terrain at 720x720 (2 bounces) and of the Cornell box at
1920x1080 (4 bounces) on the LBVH, as `chip_smoke.py` phase 31 does, every
call of one 128x128 pass of the linear and the b-spline motion scenes and
of the instanced spheres and curves (sphere leaves), and the walk's edge
cases (`chip_smoke.lbvh_edge_cases`). Every build is held bit for bit
against lbvh_traverse_ref on all of them; then every build is timed on
the terrain's and the Cornell box's queries and the 128x128 ones, in turns
(the builds in order, then in reverse): the kernel alone (its entry point
launched in a loop, the arguments bound once) and the wrapper between CUDA
events, beside each query's live rays, box and leaf tests a live ray and bound
(`chip_smoke._lbvh_bound`, from the scene's own tables). Last, whole LBVH
passes of both scenes per build, in turns. Prints the card's name and
power limit first; exits non-zero without a CUDA device or when a build
disagrees.
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

REPS, PASSES = 10, 2
ARM = re.compile(rb"_Z\w*lbvh_traverse_kernelILi(\d)E\w*")
ENTRIES = ("lbvh_packed_launch", "lbvh_nodes_launch", "lbvh_traverse_launch")


def _entry(lib):
    """(entry name, the loaded function with its argument types)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    types = {
        "lbvh_packed_launch": [vp] * 3 + [ci] * 5 + [vp] * 6 + [ci]
        + [vp] * 5,
        "lbvh_nodes_launch": [vp] * 2 + [ci] + [vp] * 8 + [ci] + [vp] * 3
        + [ci] * 4 + [vp] * 6 + [ci] + [vp] * 5,
        "lbvh_traverse_launch": [vp] * 6 + [ci] + [vp] * 5 + [ci] + [vp] * 3
        + [ci] * 4 + [vp] * 6 + [ci] + [vp] * 5,
    }
    for name in ENTRIES:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = types[name]
            fn.restype = ci
            return name, fn
    raise SystemExit(f"time_lbvh: {lib._name} exports none of {ENTRIES}")


def _order(mode, bvh, o, d, t_min, t_max):
    """The permutation a MODE applies to a query's rays."""
    import torch
    from libyafaray_tpu_torch.accel.morton import morton3d
    live = (t_max > t_min) & ~torch.isnan(o).any(1) & ~torch.isnan(d).any(1)
    if mode == "compact":
        return torch.sort((~live).to(torch.uint8), stable=True).indices
    lo, hi = bvh.node_min[0], bvh.node_max[0]
    unit = torch.clamp((o - lo) / torch.clamp_min(hi - lo, 1e-12), 0, 1)
    octant = ((d[:, 0] < 0).long() << 2) | ((d[:, 1] < 0).long() << 1) \
        | (d[:, 2] < 0).long()
    key = (octant << 30) | morton3d(torch.nan_to_num(unit)).long()
    return torch.sort(torch.where(live, key, 1 << 40)).indices


def make_prepare(entry, fn, mode):
    """A stand-in for `lbvh.prepare` that launches this build's entry
    point, with its argument list, under MODE."""
    import torch
    from libyafaray_tpu_torch.accel import lbvh as LB

    def prepare(bvh, geom, o, d, t_min, t_max, exclude, time=None,
                shadow=False, any_hit=False):
        # the checks and the packing of this package's wrapper
        motion = LB._motion(geom, time)
        LB._check_query(bvh, geom, o, d, t_min, t_max, exclude, time,
                        motion)
        rays = (o, d, t_min, t_max, exclude, time if motion else None)
        perm = None
        if mode:
            perm = _order(mode, bvh, o, d, t_min, t_max)
            rays = tuple(None if x is None else x[perm].contiguous()
                         for x in rays)
        n = o.shape[0]
        dev = o.device
        out = (torch.empty((n,), dtype=torch.float32, device=dev),
               torch.empty((n,), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.float32, device=dev),
               torch.empty((n,), dtype=torch.float32, device=dev))
        p = lambda x: None if x is None else x.data_ptr()
        f, s = geom.num_faces, geom.num_spheres
        g = (p(geom.vertices), p(geom.vertices_t1) if motion else None,
             p(geom.vertices_t2) if motion == 2 else None, p(geom.faces),
             p(geom.face_vis), f, p(geom.sph_center) if s else None,
             p(geom.sph_radius) if s else None, p(geom.sph_vis) if s else None,
             s, 2 if shadow else 1, int(bool(any_hit)), motion)
        tail = (*(p(x) for x in rays), n, *(x.data_ptr() for x in out),
                torch.cuda.current_stream(dev).cuda_stream)
        rec = LB.packed(bvh, geom)
        if entry == "lbvh_packed_launch":
            leaves = rec.keyframes if motion else rec.leaves
            args = (rec.nodes.data_ptr(), rec.root.data_ptr(),
                    leaves.data_ptr(), f, s, 2 if shadow else 1,
                    int(bool(any_hit)), motion) + tail
        elif entry == "lbvh_nodes_launch":
            n_int = int(bvh.node_left.shape[0] - bvh.prim_order.shape[0])
            args = (rec.nodes.data_ptr(), rec.root.data_ptr(), n_int,
                    p(bvh.node_min), p(bvh.node_max),
                    p(bvh.prim_order)) + g + tail
        else:
            args = (p(bvh.node_min), p(bvh.node_max), p(bvh.node_left),
                    p(bvh.node_right), p(bvh.node_is_leaf),
                    p(bvh.prim_order), int(bvh.prim_order.shape[0])) + g \
                + tail
        final = tuple(torch.empty_like(x) for x in out) if mode else out

        def launch():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"launch failed (CUDA error {err})")
            if mode:
                for y, x in zip(final, out):
                    y[perm] = x
            return final
        return launch
    return prepare


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_lbvh: no CUDA device")
    import chip_smoke as C
    from time_tile_walk import builds, kernel_attributes
    from libyafaray_tpu_torch import make_integrator
    from libyafaray_tpu_torch.accel import lbvh as LB
    from libyafaray_tpu_torch.scenes import (accel_instances_builder,
                                             motion_cornell_builder)
    specs = []
    for arg in sys.argv[1:]:
        name, src = arg.split("=", 1)
        src, _, mode = src.partition("@")
        if mode not in ("", "compact", "sort"):
            raise SystemExit(f"time_lbvh: unknown mode {mode}")
        specs.append((name, src, mode))
    if not specs:
        raise SystemExit(__doc__)
    print(C._cmd("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"), flush=True)
    t0 = time.perf_counter()
    paths = builds([(name, src) for name, src, _ in specs])
    print(f"built {len(specs)} sources (a library and a cubin each) in "
          f"{time.perf_counter() - t0:.2f} s")
    preps = {}
    for name, src, mode in specs:
        for (motion,), (regs, smem, local, threads, blocks) in \
                kernel_attributes(paths[name][1], ARM).items():
            print(f"{name} ({src}) motion{int(motion)}: {regs} registers, "
                  f"{smem} B static shared memory, {local} B local, "
                  f"{threads} threads a block, {blocks} resident blocks "
                  f"per SM")
        entry, fn = _entry(ctypes.CDLL(paths[name][0]))
        preps[name] = make_prepare(entry, fn, mode)
        print(f"{name}: entry point {entry}"
              + (f", rays reordered ({mode})" if mode else ""), flush=True)
    names = [s[0] for s in specs]
    real = LB.prepare

    def use(name):
        LB.prepare = preps[name]

    cfg = make_integrator({"type": "pathtracing", "bounces": C.BOUNCES})
    cfg_t = make_integrator({"type": "pathtracing",
                             "bounces": C.TERRAIN_BOUNCES})
    render = C._render_module().render
    terrain = C._terrain("bvh")
    cornell = C._cornell_builder(C.WIDTH, C.HEIGHT, "bvh").compile("cam")
    groups = []
    for label, scene, c in (
            (f"textured terrain {C.TERRAIN_RES}x{C.TERRAIN_RES}", terrain,
             cfg_t),
            (f"cornell {C.WIDTH}x{C.HEIGHT}", cornell, cfg),
            ("linear motion 128x128",
             motion_cornell_builder(1, C.ACCEL_SMALL).compile("cam"), cfg),
            ("b-spline motion 128x128",
             motion_cornell_builder(2, C.ACCEL_SMALL).compile("cam"), cfg),
            ("sphere leaves 128x128",
             accel_instances_builder(C.ACCEL_SMALL, "bvh").compile("cam"),
             cfg)):
        with C._all_calls(LB, "lbvh_traverse") as kept:
            render(scene, c, spp=1)
        groups.append((label, [(a, k) for a, k, _ in kept]))
    edges = [(a, k) for _, a, k in C.lbvh_edge_cases(C.DEVICE)]
    bad = 0
    for label, calls in groups + [("edge cases", edges)]:
        for i, (a, k) in enumerate(calls):
            want = LB.lbvh_traverse_ref(*a, **k)
            for name in names:
                use(name)
                try:
                    C._exact(f"{name} {label} query {i}",
                             LB.lbvh_traverse(*a, **k), want)
                except AssertionError as err:
                    print(err)
                    bad += 1
    LB.prepare = real
    print(f"held every build bit for bit on {sum(len(c) for _, c in groups)}"
          f" pass queries and {len(edges)} edge cases: {bad} disagreements",
          flush=True)
    if bad:
        return 1

    cells = " | ".join(f"{n} kernel / events ms" for n in names)
    print(f"query | kind | rays | live | box / leaf tests a live ray | "
          f"bound ms | {cells}")
    means = {}
    for label, calls in groups:
        for i, (a, k) in enumerate(calls):
            stats = {}
            LB.lbvh_traverse_ref(*a, **k, stats=stats)
            bound, by = C._lbvh_bound(a, k, stats)
            live = int((a[5] > a[4]).sum())
            ms = {n: [[], []] for n in names}
            for name in names + names[::-1]:
                use(name)
                ms[name][0].append(C._cuda_ms(LB.prepare(*a, **k), REPS))
                ms[name][1].append(C._cuda_ms(
                    lambda: LB.lbvh_traverse(*a, **k), REPS))
            row = " | ".join(f"{sum(ms[n][0]) / 2:.4f} / "
                             f"{sum(ms[n][1]) / 2:.4f}" for n in names)
            print(f"{label} {i} | {C._lbvh_kind(k)} | {a[2].shape[0]} | "
                  f"{live} | {stats['boxes'] / max(live, 1):.1f} / "
                  f"{(stats['faces'] + stats['spheres']) / max(live, 1):.1f} | "
                  f"{bound:.4f} ({by}) | {row}", flush=True)
            for n in names:
                means.setdefault((label, n), []).append(
                    (sum(ms[n][0]) / 2, sum(ms[n][1]) / 2, bound))
    for label, _ in groups:
        print(f"{label}, mean per query: " + ", ".join(
            f"{n} {sum(x[0] for x in means[label, n]) / len(means[label, n]):.4f}"
            f" kernel / {sum(x[1] for x in means[label, n]) / len(means[label, n]):.4f}"
            f" events ms ({100 * sum(x[2] for x in means[label, n]) / sum(x[0] for x in means[label, n]):.1f}% of the bound)"
            for n in names))
    del groups, edges

    for label, scene, c in ((f"textured terrain {C.TERRAIN_RES}x"
                             f"{C.TERRAIN_RES}", terrain, cfg_t),
                            (f"cornell {C.WIDTH}x{C.HEIGHT}", cornell, cfg)):
        passes = {n: [] for n in names}
        for name in names + names[::-1]:
            use(name)
            render(scene, c, spp=1)                 # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(scene, c, spp=PASSES)
            torch.cuda.synchronize()
            passes[name].append((time.perf_counter() - t0) * 1e3 / PASSES)
        print(f"{label} pass on the LBVH, ms (two turns of {PASSES} "
              "passes): " + ", ".join(
                  f"{n} {' / '.join(f'{x:.2f}' for x in passes[n])}"
                  for n in names), flush=True)
    LB.prepare = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
