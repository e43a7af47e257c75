"""The harness on the CPU at a small size: every file found by name, the
result line's keys, the refusal without a card, the module check, and a
cell and metric added as files alone."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
from conftest import ROOT, SMALL
from framebench.lib import bench, loader

CELL = "flagship-scan-1080p"
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_file_is_found_by_name(bench_json):
    for c in bench_json["configs"]:
        assert c["file"] == f"framebench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert hasattr(loader.module("scenes", c["name"]), "build")
        assert hasattr(loader.module("reference", c["name"]), "Reference")
    for w in bench_json["workloads"]:
        spec = loader.cell(bench_json, w["name"])
        assert spec["params"]["config"] == w["config"]
        assert spec["params"]["checks"]
        assert spec["end_to_end"] and spec["per_layer"]
    for m in bench_json["per_layer"]:
        assert callable(loader.module("metrics", m["name"]).read)


def _run(bench_json, base, trace, seed=2 ** 31 + 11, **kw):
    return bench.run(CELL, seed, 1.0, trace, "cpu", time.perf_counter(),
                     bench=bench_json, base=base, **kw)


def test_untraced_line(bench_json, small_base):
    r = _run(bench_json, small_base, False)
    assert list(r) == LINE_KEYS + ["checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in bench_json["end_to_end"]}
    json.dumps(r, allow_nan=False)


def test_traced_line(bench_json, small_base):
    r = _run(bench_json, small_base, True)
    assert list(r) == LINE_KEYS + ["breakdown", "checks"]
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # Off the card no device metric is read, and none reads 0 in its stead.
    assert "lighting_host_ms" in r["metrics"]
    assert "lighting_device_ms" not in r["metrics"]
    assert "k5_roofline" not in r["metrics"]


@pytest.mark.parametrize("cell", ["flagship-scan-1080p",
                                  "particles-collide-1080p"])
def test_the_frozen_reference_equals_the_port_on_the_cpu(bench_json,
                                                        small_base, cell):
    """At 96 x 160 the port's CPU path and the reference agree bit for bit
    on every compared result (the same operations in the same order), the
    splat's sums too (the port's plain splat adds in the reference's
    order)."""
    config = loader.cell(bench_json, cell)["entry"]["config"]
    assert SMALL[config]["height"] == 96
    r = bench.run(cell, 5, 1.0, False, "cpu", time.perf_counter(),
                  bench=bench_json, base=small_base)
    assert all(c["value"] == 0.0 for c in r["checks"].values()), r["checks"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "framebench", "run.py"),
         "--workload", CELL, "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def _loaded(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_module_check_compares_top_level_names_whole():
    from framebench.lib.bench import BANNED

    assert "illuminant_tpu_torch".split(".")[0] not in BANNED
    run_mods = _loaded(
        "import json, sys\n"
        "import framebench.run\n"
        "from framebench.lib import bench, loader\n"
        "loader.module('scenes', 'flagship-analytic-1080p')\n"
        "import illuminant_tpu_torch.scenes\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not run_mods & {"jax", "jaxlib", "flax", "illuminant_tpu"}
    assert "illuminant_tpu_torch" in run_mods
    ref_mods = _loaded(
        "import json, sys\n"
        "from framebench.lib import loader\n"
        "loader.module('reference', 'flagship-analytic-1080p')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not ref_mods & {"jax", "jaxlib", "flax", "illuminant_tpu",
                           "illuminant_tpu_torch"}


def test_a_cell_and_a_metric_added_as_files_alone(bench_json, small_base):
    """A later change adds a cell and a per-layer metric by adding files
    and BENCHMARK.json entries; the harness finds them by name."""
    with open(os.path.join(small_base, "workloads", f"{CELL}.json")) as f:
        params = json.load(f)
    params["why"] = "a second cell of the same configuration"
    with open(os.path.join(small_base, "workloads", "dummy-cell.json"),
              "w") as f:
        json.dump(params, f)
    with open(os.path.join(small_base, "metrics", "dummy_frames.py"),
              "w") as f:
        f.write("def read(trace):\n    return float(trace.frames)\n")
    b = json.loads(json.dumps(bench_json))
    entry = dict(b["workloads"][0], name="dummy-cell", traffic="dummy")
    b["workloads"].append(entry)
    b["per_layer"].append(dict(
        name="dummy_frames", unit="frames", better="higher",
        source="device_trace", layer="frame dispatch", moves="frame_ms",
        workloads=["dummy-cell"]))
    r = bench.run("dummy-cell", 9, 1.0, True, "cpu", time.perf_counter(),
                  bench=b, base=small_base)
    assert r["metrics"]["dummy_frames"]["value"] == float(
        params["trace_frames"])
    assert r["correct"]
