"""Fixtures of the benchmark's tests: a copy of the benchmark's folder whose
configurations are cut to a size the CPU runs in seconds, and the
checkout's BENCHMARK.json."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Each configuration's sizes for the CPU: the shapes the kernels' plain
# versions run in seconds.
SMALL = {
    "flagship-analytic-1080p": dict(height=96, width=160, n_lights=4,
                                    capacity=1 << 12, spawn_max=128,
                                    sdf_resolution_scale=0.5),
    "particles-config4-1080p": dict(height=96, width=160, capacity=1 << 12,
                                    spawn_max=128, sdf_resolution_scale=0.5),
}


@pytest.fixture
def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def small_base(tmp_path):
    """A copy of framebench/ under tmp_path with every configuration file
    cut to its SMALL sizes; -> the copy's path."""
    base = tmp_path / "framebench"
    shutil.copytree(os.path.join(ROOT, "framebench"), base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, sizes in SMALL.items():
        path = base / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config.update(sizes)
        path.write_text(json.dumps(config))
    return str(base)


@pytest.fixture
def cuda_card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
