"""The grad cell (`caustic-512.grad`) at a tiny size on the CPU: a sound run
is `correct` against the glass reference (`reference/glass.py`), the
reference's bfloat16 control and each planted fault fail a limit, the
traced path runs, the frozen staging is the program's caustic scene, and
the glass reference imports nothing of the program and no JAX."""
import ast
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import control, harness

CELL = "caustic-512.grad"
SMALL = {"width": 24, "height": 24}
SEED = 2 ** 31 + 11


def _run(seed=SEED, trace=False):
    return harness.run(harness.load_benchmark(), CELL, seed, 0.1, trace,
                       device="cpu", overrides=dict(SMALL))


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    line = _run(trace=trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    # off the card no time is reported, and the traced readers read None
    assert line["metrics"] == {}


@pytest.fixture(scope="module")
def readings():
    return {r["what"]: r for r in control.readings(
        CELL, [SEED], device="cpu", overrides=dict(SMALL))}


@pytest.mark.parametrize("what", ["control", "unchanged", "half_batch",
                                  "altered_loss", "ior_133", "half_step"])
def test_control_and_faults_fail_a_limit(readings, what):
    limits = harness.load_check(CELL)["limits"]
    r = readings[what]
    assert set(limits) <= set(r)
    assert any(r[k] > v for k, v in limits.items()), (what, r)


def test_staging_is_the_programs_caustic_scene():
    """The frozen staging compiles to the tables of the program's
    `caustic_grad_builder`."""
    import dataclasses
    import torch
    from libyafaray_tpu_torch import SceneBuilder
    from libyafaray_tpu_torch.scenes import caustic_grad_builder
    cfg = harness.load_config(harness.load_benchmark(), "caustic-512")
    a = cfg.stage(SceneBuilder(), 16, 12).compile("cam", device="cpu")
    b = caustic_grad_builder(16, 12).compile("cam", device="cpu")
    for table in ("materials", "textures", "geom", "lights"):
        ta, tb = getattr(a, table), getattr(b, table)
        for f in dataclasses.fields(ta):
            x, y = getattr(ta, f.name), getattr(tb, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (table, f.name)


def test_label_takes_pairs_ranges_with_records():
    from portbench.kinds import grad
    ev = lambda ts: {"ph": "X", "cat": "user_annotation", "ts": ts,
                     "dur": 1, "name": "yafaray::grad.take"}
    events = [ev(30), ev(10), ev(20)]
    recs = [SimpleNamespace(name="grad.take", attrs={"table": t})
            for t in ("texel_pool", "ior", "texel_pool")]
    assert grad.label_takes(events, recs)
    assert [e["name"] for e in sorted(events, key=lambda e: e["ts"])] == [
        "yafaray::grad.take.texel_pool", "yafaray::grad.take.ior",
        "yafaray::grad.take.texel_pool"]
    assert not grad.label_takes([ev(1)], recs)


def test_the_glass_reference_imports_nothing_of_the_program():
    path = os.path.join(harness.HERE, "reference", "glass.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in ("torch", "numpy", "math",
                                          "dataclasses", "typing",
                                          "__future__"), name
    code = ("import sys; import portbench.reference.glass; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libyafaray_tpu', 'libyafaray_tpu_torch')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                   check=True, timeout=120)
