"""The benchmark's 2.5D renderer cell (`renderer-25d-1080p`) on the card, at
its own size: K1 and K2 once a frame (the additive pass's scan) and
neither K12, its volume pack nor the column kernels K7; the new spans once
a frame each, inside their stages under torch.profiler (the G-buffer's
rasters in `update_fields`, the scan's readout and the AO sample in
`render_lighting`), holding device time; and a traced run that reads the
cell's three per-layer metrics.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_framebench_renderer_25d_cuda.py

Here, without a card, its cases skip.
"""

from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from framebench.lib import bench, loader  # noqa: E402

CELL = "renderer-25d-1080p"
SEED = 2 ** 31 + 505
UPDATE = "illuminant/renderer/update_fields"
RENDER = "illuminant/renderer/render_lighting"
# Each new span and the stage it lies in.
SPANS = {"illuminant/renderer/gbuffer/height_volumes": UPDATE,
         "illuminant/renderer/gbuffer/billboards": UPDATE,
         "illuminant/scan_shadows/readout": RENDER,
         "illuminant/sphere_lights/ao": RENDER}
NEW_METRICS = ("gbuffer_25d_device_ms", "scan_readout_device_ms",
               "sphere_ao_device_ms")
# The profiler's own event for a buffer of device records: it takes the id
# of the operator open when the buffer was asked for, and so holds that
# operator's kernels a second time, under it.
OVERHEAD = "Activity Buffer Request"


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU build")


@pytest.fixture(scope="module")
def cell():
    """The cell at its configuration's size, after its warm frames."""
    _needs_card()
    spec = loader.cell(loader.benchmark(), CELL)
    c = loader.module("scenes", spec["entry"]["config"]).build(
        spec["config"], spec["params"], SEED, torch.device("cuda"))
    for _ in range(spec["params"]["warm_frames"]):
        c.step()
    torch.cuda.synchronize()
    yield c
    c.release()


def _held_us(event) -> float:
    twice, stack = 0.0, list(event.cpu_children)
    while stack:
        child = stack.pop()
        if child.name == OVERHEAD:
            twice += child.device_time_total
        else:
            stack.extend(child.cpu_children)
    return event.device_time_total - twice


def _ancestors(event):
    out = []
    while event.cpu_parent is not None:
        event = event.cpu_parent
        out.append(event.name)
    return out


@pytest.mark.cuda
def test_cuda_k1_once_a_frame_no_march_no_columns(cell):
    from illuminant_tpu_torch.core import cuda_build

    before = cuda_build.launches()
    for _ in range(3):
        cell.step()
    torch.cuda.synchronize()
    after = cuda_build.launches()
    delta = {k: after[k] - before[k] for k in (
        "k1_scan_walk", "k2_scan_readout", "k12_cone_trace",
        "k12_volume_pack", "k7_column_query", "k7_column_pack",
        "k7_column_sample")}
    assert delta == dict(k1_scan_walk=3, k2_scan_readout=3,
                         k12_cone_trace=0, k12_volume_pack=0,
                         k7_column_query=0, k7_column_pack=0,
                         k7_column_sample=0), delta


@pytest.mark.cuda
def test_cuda_new_spans_lie_inside_their_stages(cell):
    """Two profiled frames: each new span twice, inside its stage, with
    device time no more than the stage's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            cell.step()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type != DeviceType.CUDA]
    stage_us = {stage: sum(_held_us(e) for e in events if e.name == stage)
                for stage in (UPDATE, RENDER)}
    for name, stage in SPANS.items():
        spans = [e for e in events if e.name == name]
        assert len(spans) == 2, (name, len(spans))
        for e in spans:
            assert stage in _ancestors(e), (name, _ancestors(e))
        held = sum(_held_us(e) for e in spans)
        assert 0.0 < held <= stage_us[stage], (name, held, stage_us)


@pytest.mark.cuda
def test_cuda_traced_run_reads_the_three_metrics():
    _needs_card()
    r = bench.run(CELL, SEED + 1, 3.0, True, "cuda", time.perf_counter())
    assert r["correct"], r["checks"]
    values = {name: r["metrics"][name]["value"] for name in NEW_METRICS}
    assert all(v is not None and v > 0.0 for v in values.values()), values
