"""`correct` at tiny sizes on the CPU: sound runs of every cell pass, and a
run with the timed path broken underneath fails, once for each fault the
cell can have (a step or pass that leaves its state unchanged, half the
batch left out with the mean over the rest, an answer altered where it is
produced; one card, so no exchange between cards to leave out). The
control (the reference one precision step below the configuration's, in
the program's place: radiance rounded to bfloat16) fails the limits too.
The reference imports nothing of the program."""
import dataclasses
import importlib

import pytest
import torch

from _small import small
from portbench import control, harness

def _run(cell, seed=11, trace=False):
    return harness.run(harness.load_benchmark(), cell, seed, 0.1, trace,
                       device="cpu", overrides=small(cell))


@pytest.mark.parametrize("cell", ["cornell-1080p.train",
                                  "cornell-1080p.render",
                                  "terrain-textured-720.blocks",
                                  "terrain-textured-720.bvh"])
def test_sound_runs_are_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import os
    ref = os.path.join(os.path.dirname(harness.HERE), "portbench",
                       "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] in ("torch", "numpy", "math",
                                              "dataclasses", "typing",
                                              "__future__"), (f, name)


def _render_module():
    return importlib.import_module("libyafaray_tpu_torch.render")


def _unchanged_pass(real):
    return lambda scene, cfg, film, s: film


def _half_pass(real):
    R = _render_module()

    def half(scene, cfg, film, s):
        n = film.height * film.width
        ids = torch.arange(n // 2, dtype=torch.int64, device=film.device)
        return R._render_ids(scene, cfg, film, s, ids,
                             torch.ones_like(ids, dtype=torch.bool))
    return half


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "altered_answer"])
def test_a_broken_render_is_not_correct(monkeypatch, fault):
    R = _render_module()
    if fault == "altered_answer":
        real = R.integrate

        def altered(*a, **k):
            rgb, alpha, aux = real(*a, **k)
            return rgb * (1.0 + 1e-3), alpha, aux
        monkeypatch.setattr(R, "integrate", altered)
    else:
        make = _unchanged_pass if fault == "unchanged" else _half_pass
        monkeypatch.setattr(R, "render_pass_fn", make(R.render_pass_fn))
    line = _run("cornell-1080p.render")
    assert not line["correct"]


def _broken_train_step(fault):
    import libyafaray_tpu_torch as pkg
    P = importlib.import_module("libyafaray_tpu_torch.parallel")
    real_make = pkg.make_train_step

    def make(cfg, height, width, lr=0.05, *, device="cuda"):
        real = real_make(cfg, height, width, lr=lr, device=device)
        if fault == "unchanged":
            return lambda scene, params, target, s: (
                params, real(scene, params, target, s)[1])
        if fault == "altered_loss":
            def altered(scene, params, target, s):
                new, loss = real(scene, params, target, s)
                return new, loss * (1.0 + 1e-3)
            return altered
        pid = torch.arange(height * width, dtype=torch.int64, device=device)
        px = (pid % width).to(torch.float32) + 0.5
        py = (pid // width).to(torch.float32) + 0.5

        def half(scene, params, target, s):
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in params.items()}
            sc = dataclasses.replace(scene, materials=dataclasses.replace(
                scene.materials, **leaves))
            rgb, _, _ = P._pixel_shard_radiance(sc, cfg, px, py, pid, s)
            err = (rgb - target.reshape(-1, 3)) ** 2
            loss = torch.mean(err[: err.shape[0] // 2])
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return ({k: (p - lr * g).detach() for (k, p), g in
                     zip(leaves.items(), grads)}, loss.detach())
        return half
    return make


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "altered_loss"])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    import libyafaray_tpu_torch as pkg
    monkeypatch.setattr(pkg, "make_train_step", _broken_train_step(fault))
    line = _run("cornell-1080p.train")
    assert not line["correct"]


@pytest.mark.parametrize("cell", ["cornell-1080p.train",
                                  "cornell-1080p.render",
                                  "terrain-textured-720.blocks"])
def test_the_control_and_the_faults_fail_the_limits(cell):
    limits = harness.make_cell(harness.load_benchmark(), cell).check[
        "limits"]
    rows = list(control.readings(cell, [21, 22], device="cpu",
                                 overrides=small(cell)))
    assert {r["what"] for r in rows} >= {"control"}
    for r in rows:
        assert any(r[k] > limits[k] for k in limits), r


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cornell-1080p.train",
                                  "cornell-1080p.render",
                                  "terrain-textured-720.blocks",
                                  "terrain-textured-720.bvh"])
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = harness.run(harness.load_benchmark(), cell, 41, 2.0, False,
                       device="cuda")
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
