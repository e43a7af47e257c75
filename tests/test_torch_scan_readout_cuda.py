"""The scan shadows' readout (K2, csrc/scan_readout.cu) on the card
against its plain version, `scan_shadows.scan_readout_reference`, run on
the same CUDA tensors.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_readout_cuda.py

(`tests/conftest.py` configures jax; `--noconftest` leaves it out). Here,
without a card, its cases skip.

Tolerance: none. The visibility must equal the plain version's bit for
bit: the benchmark's 2.5D cell allows no uint8 level off, and one ulp of
a lane's visibility moves a level where it sits on a rounding edge.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import scan_readout_cases as cases  # noqa: E402
from illuminant_tpu_torch.core import cuda_build  # noqa: E402
from illuminant_tpu_torch.core.config import QualitySettings  # noqa: E402
from illuminant_tpu_torch.lighting import (  # noqa: E402
    scan_readout_kernel as k2)
from illuminant_tpu_torch.lighting import scan_shadows  # noqa: E402


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


def _bits_equal(got, ref, what):
    """`got` equal to `ref` bit for bit (lane by lane in the message)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    g = got.contiguous().view(torch.int32)
    r = ref.contiguous().view(torch.int32)
    if not torch.equal(g, r):
        diff = (g != r).reshape(got.shape[0], -1).sum(-1).tolist()
        first = torch.nonzero(g != r)[:4].tolist()
        pairs = [(float(got[tuple(i)]), float(ref[tuple(i)]))
                 for i in first]
        raise AssertionError(f"{what}: pixels that differ, by lane: "
                             f"{diff}; first at {first}: {pairs}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(cases.CASES))
def test_cuda_readout_equals_plain_version(name):
    """K2 against the plain readout on the same CUDA tensors, bit for bit:
    every field kind, 0-3 candidates, 0-2 halvings, heights and offsets
    shared or per lane, the trace budget, a window, tiles cut by the
    grid's edges, a power; one launch a `scan_visibility` call."""
    _needs_card()
    case = cases.CASES[name]
    fld = cases.field(case["field"], "cuda", case.get("grid", cases.GRID))
    cuda_build.reset_launches()
    vis, (args, kw) = cases.port_scan(fld, case, "cuda")
    assert cuda_build.launches()["k2_scan_readout"] == 1
    assert cuda_build.launches()["k1_scan_walk"] == 1
    ref = scan_shadows.scan_readout_reference(*args, **kw)
    got = k2.scan_readout_cuda(*args, **kw)
    torch.cuda.synchronize()
    _bits_equal(vis, ref, name)
    _bits_equal(got, ref, name)
    # Not a flat image: the scene shadows part of the grid.
    assert (ref < 0.5).any() and (ref > 0.9).any()


@pytest.mark.cuda
def test_cuda_flagship_readout_equals_plain_version():
    """The analytic flagship's own readout at 1080p (8 lanes, 540 x 960
    from a 270 x 480 walk, its 4-primitive scene), bit for bit."""
    _needs_card()
    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(height=1080, width=1920, n_lights=8,
                           capacity=1 << 12, spawn_max=64, field="analytic",
                           device="cuda")
    calls = []
    real = scan_shadows.scan_readout

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    scan_shadows.scan_readout = spy
    try:
        rng = np.random.default_rng(0)
        draws = tuple(rng.random((64, 4), dtype=np.float32)
                      for _ in range(3))
        scene.frame(scene.system.state, torch.tensor(0.5, device="cuda"),
                    None, scene.volume, scene.gbuffer, scene.sphere_lights,
                    scene.environment.uniforms(device="cuda"),
                    scene.spawner.spawn_max, frame_index=3,
                    spawn_uniforms=draws)
    finally:
        scan_shadows.scan_readout = real
    assert len(calls) == 1
    args, kw = calls[0]
    assert tuple(args[1].shape[1:]) == (3, 8, 270, 480)
    got = k2.scan_readout_cuda(*args, **kw)
    ref = scan_shadows.scan_readout_reference(*args, **kw)
    torch.cuda.synchronize()
    _bits_equal(got, ref, "flagship")


@pytest.mark.cuda
def test_cuda_one_launch_a_scan_visibility_call():
    """Each scan_visibility call on CUDA tensors is one K1 and one K2
    launch, and no eager readout."""
    _needs_card()
    fld = cases.field("prisms", "cuda")
    pos = torch.as_tensor(cases.LIGHTS, device="cuda")
    rad = torch.as_tensor(cases.RADIUS, device="cuda")
    ramp = torch.as_tensor(cases.RAMP, device="cuda")
    plain = []
    real = scan_shadows.scan_readout_reference
    scan_shadows.scan_readout_reference = \
        lambda *a, **kw: plain.append(1) or real(*a, **kw)
    cuda_build.reset_launches()
    try:
        for n in range(1, 4):
            scan_shadows.scan_visibility(fld, 48, 80, pos, rad, ramp,
                                         QualitySettings())
            assert cuda_build.launches()["k2_scan_readout"] == n
            assert cuda_build.launches()["k1_scan_walk"] == n
    finally:
        scan_shadows.scan_readout_reference = real
    assert plain == []


@pytest.mark.cuda
def test_cuda_plan_reports_each_instance():
    """Every instance loads on the card within its block, without spills
    at the benchmark's instances (the 2.5D cell's staged scene and the
    flagship's, halved once)."""
    _needs_card()
    for name in k2.INSTANCES:
        for halvings in (0, 1, 2):
            plan = k2.block_plan(540, 960, 16, halvings, name,
                                 scene_floats=200)
            assert plan["threads"] == k2.THREADS
            assert plan["blocks_per_sm"] >= 1, plan
            if name == "analytic" and halvings == 1:
                assert plan["spill_bytes"] == 0, plan


@pytest.mark.cuda
def test_cuda_torch_rounds_as_the_kernel():
    """The forms of torch's operations on the card that K2 repeats: a
    tensor divided by a Python scalar is its product with the scalar's
    float32 reciprocal, and `s / t` is `t.reciprocal() * s`."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(1 << 20, device="cuda", generator=g) * 4 - 1
    s = 0.95 - 0.075
    inv = np.float32(1.0) / np.float32(s)
    assert torch.equal(x / s, x * float(inv))
    assert torch.equal(1.5 / x, torch.reciprocal(x) * 1.5)
    exact = (x.double().reciprocal() * 1.5).float()
    assert not torch.equal(1.5 / x, exact)
