#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (`libyafaray_tpu_torch`)
beside `portbench/` and `BENCHMARK.json`. It needs a CUDA card: without one,
or with fewer cards than the cell asks for, it prints no result and exits
with 2. With `--trace 0` the result's metrics are the cell's end-to-end
metrics, measured over a window of `--seconds`; with `--trace 1` its
per-layer metrics, read from a spans window and a profiled window. Either
way the run ends with the check against the plain reference: the numbers
compared and their limits are the last lines on standard error and the
last key of the result line, which is the last line on standard output.
It exits with 3 and prints no result if a JAX module or the JAX package is
loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process with one host thread for numerical work: the card does the
# work, and idle OpenMP threads would only compete with the dispatching one
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    bench = harness.load_benchmark(ROOT)
    chips = harness.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    line = harness.run(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", t_start=T_START)
    found = sorted(set(line.pop("_forbidden")) | set(
        harness.forbidden_modules()))
    if found:
        print(f"portbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
