#!/usr/bin/env python3
"""The control of `correct`, and the planted faults: the readings that the
limits in `checks/<cell>.json` are set from.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

For each seed it computes what a run of the cell checks (the first image
of the window at the seed's pixels, or the train cell's checked steps), on
the card at the cell's own size, twice through the plain reference: in
the configuration's precision, and put in the program's place one step
below it: the control, the radiance rounded to bfloat16 (before the film
for a render cell, before the loss for a train cell). A train cell also
reads each planted fault (`reference.TRAIN_FAULTS`). Each reading is
printed as one JSON line: {"seed", "what", numbers...}. The program's own
readings come from its runs (`run.py`), which print the same numbers.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell_name: str, seeds, device="cuda", overrides=None,
             root: str = ROOT):
    """Yield one dict of numbers per (seed, what): the cell's traffic kind
    says what its control and faults are (`kinds/<kind>.py`,
    `control_readings`)."""
    from portbench import harness
    harness._setup_torch(device)
    bench = harness.load_benchmark(root)
    cell = harness.make_cell(bench, cell_name, root, overrides)
    kind = harness.load_kind(cell.mix["kind"], root)
    yield from kind.control_readings(cell, seeds, device, harness.sample_base)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for r in readings(args.workload, args.seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
