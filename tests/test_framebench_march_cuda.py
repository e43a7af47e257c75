"""The benchmark's march cell (`flagship-march-1080p`) on the card, at its
own size: K12 once a frame and the scan's walk K1 never, the exposure's 4
host reads a frame, K12's kernel inside its launch span inside the
sphere lights' span under torch.profiler, and the traced run's
`k12_roofline` in (0, 100].

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_framebench_march_cuda.py

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

CELL = "flagship-march-1080p"
SEED = 2 ** 31 + 77
K12 = r"\bcone_trace_kernel\b"
K12_SPAN = "illuminant/kernel/k12_cone_trace"
SPHERE = "illuminant/sphere_lights"
READS = "aten::_local_scalar_dense"
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
def test_cuda_k12_once_a_frame_and_no_scan(cell):
    from illuminant_tpu_torch.core import cuda_build

    before = cuda_build.launches()
    for _ in range(3):
        cell.step()
    torch.cuda.synchronize()
    after = cuda_build.launches()
    assert after["k12_cone_trace"] - before["k12_cone_trace"] == 3
    assert after["k1_scan_walk"] - before["k1_scan_walk"] == 0
    assert after["k2_scan_readout"] - before["k2_scan_readout"] == 0


@pytest.mark.cuda
def test_cuda_k12_lies_in_its_span_in_the_sphere_lights(cell):
    """Two profiled frames: 4 host reads a frame; each frame's K12 span
    holds K12's kernel by name within 1% and lies inside the sphere
    lights' span, which holds it too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            cell.step()
        torch.cuda.synchronize()
    events = prof.events()
    reads = sum(e.name == READS for e in events)
    assert reads == 2 * 4
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and re.search(K12, e.name)]
    spans = [e for e in events if e.name == K12_SPAN
             and e.device_type != DeviceType.CUDA]
    assert len(kernels) == 2 and len(spans) == 2
    own = sum(e.time_range.end - e.time_range.start for e in kernels)
    held = sum(_held_us(e) for e in spans)
    assert own > 0.0 and abs(held - own) <= TOLERANCE * own, (held, own)
    for e in spans:
        assert SPHERE in _ancestors(e)
    sphere = sum(_held_us(e) for e in events if e.name == SPHERE
                 and e.device_type != DeviceType.CUDA)
    assert sphere >= held


@pytest.mark.cuda
def test_cuda_traced_run_reads_k12_roofline():
    _needs_card()
    r = bench.run(CELL, SEED + 1, 3.0, True, "cuda", time.perf_counter())
    assert r["correct"], r["checks"]
    roof = r["metrics"]["k12_roofline"]["value"]
    assert 0.0 < roof <= 100.0, roof
    assert r["metrics"]["sphere_lights_device_ms"]["value"] > 0.0
