"""The harness finds every piece by name, a cell added as files runs with
no edit, the byte counts, the trace reduction, and no CPU number under a
device metric."""
import json
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from _small import small
from portbench import harness, roofline, tracing

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return harness.load_benchmark(ROOT)


def test_every_piece_is_found_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.make_cell(bench, w["name"])
        kind = harness.load_kind(cell.mix["kind"])
        for fn in ("setup", "measure", "traced", "reference", "compare",
                   "control_readings"):
            assert callable(getattr(kind, fn))
        assert callable(cell.config.stage)
        assert cell.config.CONFIG["source"] == next(
            c["source"] for c in bench["configs"] if c["name"] == w["config"])
        assert set(cell.check["limits"]) == (
            {"pixels_off_pct"} if cell.mix["kind"] == "render" else
            {"loss_gap", "grad_gap", "change_gap"})
        assert harness.per_layer_of(bench, w["name"])
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        e2e = {m["name"] for m in harness.end_to_end_of(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  harness.end_to_end_of(bench, w)}
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"


def test_a_cell_added_as_files_runs_without_edits(tmp_path):
    """A new configuration, traffic kind, mix, metric, check file and
    cell, added as files and entries in a copy, run with no existing file
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    bench = _bench()
    src = root / "portbench" / "configs"
    (src / "cornell-small.py").write_text(
        (src / "cornell-1080p.py").read_text().replace(
            '"width": 1920', '"width": 40').replace(
            '"height": 1080', '"height": 20').replace('"spp": 16',
                                                       '"spp": 2'))
    kinds = root / "portbench" / "kinds"
    (kinds / "frames.py").write_text((kinds / "render.py").read_text())
    (root / "portbench" / "mixes" / "images-few.json").write_text(json.dumps(
        {"kind": "frames", "render_params": {}, "span_images": 1,
         "trace_passes": 1}))
    (root / "portbench" / "checks" / "cornell-small.few.json").write_text(
        json.dumps({"check_pixels": 50, "pixel_tol": 1e-4,
                    "limits": {"pixels_off_pct": 1.0}}))
    (root / "portbench" / "metrics" / "span_passes.py").write_text(
        "def read(ctx):\n"
        "    return None if ctx.spans is None else ctx.spans['passes']\n")
    bench["configs"].append(dict(bench["configs"][0], name="cornell-small",
                                 file="portbench/configs/cornell-small.py"))
    bench["workloads"].append({"name": "cornell-small.few",
                               "config": "cornell-small",
                               "traffic": "images-few", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "span_passes", "unit": "passes",
                               "better": "lower", "source": "program_counter",
                               "layer": "test", "moves": "camera_rays_per_s",
                               "workloads": ["cornell-small.few"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cornell-1080p.render" in m["workloads"]:
            m["workloads"].append("cornell-small.few")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = harness.run(bench, "cornell-small.few", 7, 0.1, True,
                       device="cpu", root=str(root))
    assert line["correct"]
    assert line["metrics"]["span_passes"]["value"] == 2
    for p, data in before.items():
        assert p.read_bytes() == data


def test_query_bytes_and_roofline_share():
    assert roofline.query_bytes(10, False) == 10 * (32 + 16)
    assert roofline.query_bytes(10, True) == 10 * (32 + 1)
    trace = SimpleNamespace(
        device_s_by_name={"void tiles_traverse_kernel<1>(WalkArgs)": 2e-3,
                          "other": 1.0},
        queries={"tile_walk": [(1000, False), (500, True)]})
    least = (1000 * 48 + 500 * 33) / 3.35e12
    assert roofline.roofline_pct(trace, "tile_walk") == pytest.approx(
        100 * least / 2e-3)
    assert roofline.roofline_pct(trace, "lbvh_traverse") is None


def test_trace_reduction():
    ev = [
        {"ph": "X", "name": tracing.WINDOW, "cat": "user_annotation",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "name": "aten::mul", "cat": "cpu_op", "ts": 0,
         "dur": 30, "tid": 1},
        {"ph": "X", "name": "aten::item", "cat": "cpu_op", "ts": 50,
         "dur": 40, "tid": 1},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 5, "dur": 1, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "name": tracing.BACKWARD_PREFIX + ": MulBackward0",
         "cat": "cpu_op", "ts": 60, "dur": 10, "tid": 2},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 62, "dur": 1, "tid": 2, "args": {"correlation": 2}},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 10, "dur": 20,
         "args": {"correlation": 1}},
        {"ph": "X", "name": "k2", "cat": "kernel", "ts": 25, "dur": 15,
         "args": {"correlation": 2}},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 95, "dur": 20,
         "args": {"correlation": 3}},
    ]
    t = tracing.reduce_trace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(35e-6)       # [10, 40] and [95, 100]
    assert t.kernels == 3
    assert t.backward_s == pytest.approx(15e-6)
    assert t.device_s_by_name["k1"] == pytest.approx(25e-6)
    gaps = dict(t.breakdown["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx(10e-6)   # [0, 10]
    assert gaps["aten::item"] == pytest.approx(55e-6)  # [40, 95]


def test_run_py_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "cornell-1080p.render", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cpu_run_writes_no_device_number(trace):
    cell = "terrain-textured-720.blocks"
    line = harness.run(_bench(), cell, 3, 0.1, bool(trace), device="cpu",
                       overrides=small(cell))
    assert line["device"]["platform"] == "cpu"
    assert line["metrics"] == {}
    assert line["correct"]
