"""The benchmark's renderer cell (`renderer-march-1080p`) on the card, at
its own size: K12 and its volume pack once a frame, neither the scan's
walk K1 nor the column kernels K7, K12's kernel inside its launch span
inside `render_lighting`'s span under torch.profiler, and a traced run
that reads the cell's four per-layer metrics, `k12_volume_roofline` in
(0, 100].

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_framebench_renderer_cuda.py

Here, without a card, its cases skip.
"""

from __future__ import annotations

import os
import re
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from framebench.lib import bench, loader  # noqa: E402

CELL = "renderer-march-1080p"
SEED = 2 ** 31 + 77
K12 = r"\bcone_trace_kernel\b"
K12_SPAN = "illuminant/kernel/k12_cone_trace"
RENDER = "illuminant/renderer/render_lighting"
NEW_METRICS = ("field_regen_device_ms", "update_fields_host_ms",
               "render_lighting_device_ms", "k12_volume_roofline")
# The profiler's own event for a buffer of device records: it takes the id
# of the operator open when the buffer was asked for, and so holds that
# operator's kernels a second time, under it.
OVERHEAD = "Activity Buffer Request"
TOLERANCE = 0.01


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K12 has no CPU build")


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
def test_cuda_k12_and_its_pack_once_a_frame_no_scan_no_columns(cell):
    from illuminant_tpu_torch.core import cuda_build

    before = cuda_build.launches()
    for _ in range(3):
        cell.step()
    torch.cuda.synchronize()
    after = cuda_build.launches()
    # Counters: a kernel whose wrapper was never imported reads 0.
    delta = {k: after[k] - before[k] for k in (
        "k12_cone_trace", "k12_volume_pack", "k1_scan_walk",
        "k7_column_query", "k7_column_pack", "k7_column_sample")}
    assert delta == dict(k12_cone_trace=3, k12_volume_pack=3,
                         k1_scan_walk=0, k7_column_query=0,
                         k7_column_pack=0, k7_column_sample=0), delta


@pytest.mark.cuda
def test_cuda_k12_lies_in_its_span_in_render_lighting(cell):
    """Two profiled frames: each frame's K12 span holds K12's kernel by
    name within 1% and lies inside `render_lighting`'s span, which holds
    it too; two `field_slab` spans a frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            cell.step()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and re.search(K12, e.name)]
    spans = [e for e in events if e.name == K12_SPAN
             and e.device_type != DeviceType.CUDA]
    assert len(kernels) == 2 and len(spans) == 2
    own = sum(e.time_range.end - e.time_range.start for e in kernels)
    held = sum(_held_us(e) for e in spans)
    assert own > 0.0 and abs(held - own) <= TOLERANCE * own, (held, own)
    for e in spans:
        assert RENDER in _ancestors(e)
    render = sum(_held_us(e) for e in events if e.name == RENDER
                 and e.device_type != DeviceType.CUDA)
    assert render >= held
    slabs = [e for e in events if e.name == "illuminant/renderer/field_slab"
             and e.device_type != DeviceType.CUDA]
    assert len(slabs) == 4


@pytest.mark.cuda
def test_cuda_traced_run_reads_the_four_metrics():
    _needs_card()
    r = bench.run(CELL, SEED + 1, 3.0, True, "cuda", time.perf_counter())
    assert r["correct"], r["checks"]
    values = {name: r["metrics"][name]["value"] for name in NEW_METRICS}
    assert all(v is not None and v > 0.0 for v in values.values()), values
    assert values["k12_volume_roofline"] <= 100.0, values
