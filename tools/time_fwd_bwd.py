#!/usr/bin/env python3
"""Time versions of the port's render paths against each other on one GPU.

    python3 tools/time_fwd_bwd.py [--phases=4,11,13] NAME=TREE ...

for example, the previous commit against this one, in turns:

    mkdir -p _proof/parent
    git archive HEAD~1 | tar -x -C _proof/parent
    python3 tools/time_fwd_bwd.py parent=_proof/parent new=. new=. \\
        parent=_proof/parent

Each TREE is a checkout of the repo. For each NAME=TREE, in the order
given, a fresh process builds that tree's `mt_intersect.cu` and runs its
`chip_smoke.py` phases 4 (the Cornell forward at 1920x1080, 16 spp, 4
bounces), 11 (the headline forward + backward at that size, in chunks of
270 rows) and 13 (the glossy Cornell, BASELINE config 2, 512x512, 16 spp),
or those `--phases` names (14 is the train step), with their own checks.
Each run prints its phases' output; at the end one line per run gives the
phase 4 and 13 ms per pass, the phase 11 ms per 16-spp image, forward and
backward ms per chunk and peak memory, and the phase 14 ms per step.
Prints the card's name and power limit first; exits non-zero without a
CUDA device or when a run fails.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

CHILD = """
import sys, time
sys.path.insert(0, {tree!r})
import chip_smoke as C
from libyafaray_tpu_torch import csrc_build
csrc_build.build("mt_intersect")
for phase in {phases!r}:
    dict(p4=C.phase4_cornell, p11=C.phase11_fwd_bwd, p13=C.phase13_glossy,
         p14=C.phase14_train)["p" + phase]()
"""

NUMBERS = {
    "phase 4 ms/pass": r"phase 4: cornell .*?: ([0-9.]+) ms/pass",
    "phase 11 ms/image": r"phase 11: cornell .*?: ([0-9.]+) ms per image",
    "phase 11 fwd ms/chunk": r"CUDA events: forward ([0-9.]+) ms",
    "phase 11 bwd ms/chunk": r"\+ backward ([0-9.]+) ms per chunk",
    "phase 11 peak GiB": r"peak device memory ([0-9.]+) GiB\n",
    "phase 13 ms/pass": r"phase 13: glossy .*?: ([0-9.]+) ms/pass",
    "phase 14 ms/step": r"phase 14: .*?ms per step \[([^\]]*)\]",
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_fwd_bwd: no CUDA device")
    args = sys.argv[1:]
    phases = ["4", "11", "13"]
    if args and args[0].startswith("--phases="):
        phases = args.pop(0).split("=", 1)[1].split(",")
    specs = [tuple(arg.split("=", 1)) for arg in args]
    if not specs:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rows = []
    for name, tree in specs:
        tree = os.path.abspath(tree)
        child = CHILD.format(tree=tree, phases=phases)
        out = subprocess.run([sys.executable, "-c", child], cwd=tree,
                             capture_output=True, text=True)
        print(f"---- {name} ({tree})\n{out.stdout}{out.stderr[-4000:]}",
              flush=True)
        if out.returncode:
            raise SystemExit(f"time_fwd_bwd: {name} failed "
                             f"(rc {out.returncode})")
        found = {k: re.search(p, out.stdout) for k, p in NUMBERS.items()}
        rows.append((name, {k: m.group(1) for k, m in found.items() if m}))
    for name, nums in rows:
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in nums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
