"""What decides `correct`: the program's output held against the plain
reference (`reference/`), number by number, each against its limit in
`checks/<cell>.json`, which also holds the check's parameters.

What a cell compares, and how, is its traffic kind's (`kinds/<kind>.py`:
`reference` gives the reference's readings for what the run kept,
`compare` the numbers); here they are judged.
"""
from __future__ import annotations

import math


def judge(numbers: dict, limits: dict) -> dict:
    """{"correct", "numbers": {name: {"value", "limit"}}}: correct when
    every number is finite and at most its limit."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = bool(numbers) and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return {"correct": ok, "numbers": out}


def run_checks(kind, cell, seed: int, check_input, device) -> dict:
    """Decide `correct` for a run of `cell`, whose traffic kind is the
    module `kind`: `check_input` is what the run kept for the check, or
    None when the window completed nothing to check."""
    if check_input is None:
        return {"correct": False, "numbers": {}}
    ref = kind.reference(cell, seed, check_input, device)
    return judge(kind.compare(cell, check_input, ref), cell.check["limits"])
