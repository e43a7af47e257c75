"""The scan shadows' column walk (K1, csrc/scan_walk.cu) on the card
against its plain version, the eager loop of
`scan_shadows._bidirectional_scan` run on the same CUDA tensors.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_walk_cuda.py

(`tests/conftest.py` configures jax; `--noconftest` leaves it out). Here,
without a card, the `cuda` cases skip and the CPU cases check that the
inputs reach what the card cases are about.

Tolerance: none. Every channel of every sector (d, k, neg_k, f_min,
h_top, h_bot) must equal the eager loop's bit for bit: on a plateau of
the occlusion image one ulp of the resample moves the arg-min k, and the
readout's refine samples where k says.
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.lighting import scan_shadows
from illuminant_tpu_torch.lighting import scan_walk_kernel as k1
from illuminant_tpu_torch.lighting.environment import LightObstruction
from illuminant_tpu_torch.sdf import analytic

SMALL = dict(height=96, width=160, n_lights=4, capacity=1 << 10,
             spawn_max=128, sdf_resolution_scale=0.5)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


def _bits_equal(got, ref, what):
    """Every element of `got` equal to `ref` bit for bit (channel by
    channel in the message)."""
    assert got.shape == ref.shape, what
    g = got.contiguous().view(torch.int32)
    r = ref.contiguous().view(torch.int32)
    if not torch.equal(g, r):
        diff = (g != r).reshape(4, got.shape[1], -1).sum(-1).tolist()
        first = torch.nonzero(g != r)[:4].tolist()
        raise AssertionError(
            f"{what}: elements that differ, by sector and channel: {diff}; "
            f"first at {first}: "
            f"{[(float(got[tuple(i)]), float(ref[tuple(i)])) for i in first]}")


def _prism_scene(device):
    """Two boxes cut by the trace plane (z 0..12 under a plane at 10: a
    flat interior of -2), a cylinder and an ellipsoid below it."""
    obs = [LightObstruction.box((60.0, 40.0, 6.0), (20.0, 14.0, 6.0)),
           LightObstruction.box((130.0, 70.0, 6.0), (12.0, 25.0, 6.0)),
           LightObstruction.cylinder((40.0, 90.0, 4.0), (9.0, 9.0, 8.0)),
           LightObstruction.ellipsoid((150.0, 20.0, 3.0), (10.0, 6.0, 5.0))]
    return analytic.pack_scene(obs, group_capacity_round=1, device=device)


def _walk_args(case, device):
    """(occ, lx, ly, lr, band, extra, footprint) of a case, on `device`."""
    scene = _prism_scene(device)
    t = (lambda a: torch.tensor(a, dtype=torch.float32, device=device))
    shape = {"prism": (120, 200), "odd_rows": (45, 77),
             "tall": (1100, 70), "wide": (70, 1100),
             "windowed": (24, 40)}.get(case, (120, 200))
    h, w = shape
    scale = 1.0
    if case == "tall":
        scale = h / 120.0
    elif case == "wide":
        scale = w / 200.0
    offset = (t([50.0, 30.0]) if case == "windowed" else None)
    occ = scan_shadows.occlusion_image(scene, h, w, t(10.0), scale, offset)
    if case == "far":
        # A directional light's pseudo-center far outside the image, and
        # lights just outside each edge.
        lx, ly = t([-5000.0, 6200.0, -3.0, 205.0, 100.0]), \
            t([60.0, -800.0, 60.0, 130.0, -2.5])
        lr = t([2.0, 2.0, 1.0, 1.0, 0.5])
    elif case == "near_skip":
        # Lights inside their own near-skip radius.
        lx, ly, lr = t([60.0, 120.0, 30.0]), t([40.0, 60.0, 100.0]), \
            t([30.0, 45.0, 12.0])
    else:
        lx = t([0.3 * w, 0.8 * w, 0.5 * w, 0.1 * w])
        ly = t([0.4 * h, 0.2 * h, 0.9 * h, 0.55 * h])
        lr = t([3.0, 1.0, 6.0, 0.2])
    extra, fp = (), None
    if case in ("column_like", "tall", "wide", "odd_rows"):
        # The carried refine's images: a column's top and bottom and its
        # footprint, from the scene's closed-form column images.
        cols = analytic.scene_column_images(scene, h, w, scale)
        assert cols is not None
        extra, fp = (cols[0], cols[1]), cols[2]
    band = 0.5 if case != "tall" else 1.0
    return occ, lx, ly, lr, band, extra, fp


CASES = ("prism", "far", "near_skip", "column_like", "odd_rows", "tall",
         "wide", "windowed")


@pytest.mark.parametrize("case", CASES)
def test_inputs_reach_the_cases(case):
    """On the CPU: each case's walk nominates blockers, leaves rays clear,
    and the prism's plateau holds many equal values; the carried cases
    carry intervals; the plan takes each grid."""
    occ, lx, ly, lr, band, extra, fp = _walk_args(case, "cpu")
    out = scan_shadows.scan_walk_reference(occ, lx, ly, lr, band, extra, fp)
    d = out[:, 0]
    assert (d < 1e8).any() and (d >= 1e8).any()
    if case == "prism":
        vals, counts = torch.unique(occ, return_counts=True)
        assert int(counts.max()) >= 100 and float(vals[counts.argmax()]) < 0
    if extra:
        assert out.shape[1] == 6 and (out[:, 4] < 4096.0).any()
    plan = k1.launch_plan(*occ.shape, lx.shape[0], fp is not None,
                          bool(extra))
    assert plan["shape"] == tuple(out.shape)
    if case == "tall":
        assert plan["rows_per_thread"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_walk_equals_eager_loop(case):
    """K1 against the eager loop on the same CUDA tensors: every channel
    of every sector bit for bit, the arg-min k included; one launch."""
    _needs_card()
    args = _walk_args(case, "cuda")
    cuda_build.reset_launches()
    got = k1.scan_walk_cuda(*args)
    ref = scan_shadows.scan_walk_reference(*args)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k1_scan_walk"] == 1
    _bits_equal(got, ref, case)


def _flagship_walks(field, device="cuda"):
    """The walk arguments of one 1080p flagship frame (8 lights, a 270 x
    480 nomination grid; the voxel field's ColumnField takes the carried
    refine's extras and footprint)."""
    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(height=1080, width=1920, n_lights=8,
                           capacity=1 << 12, spawn_max=64, field=field,
                           device=device)
    calls = []
    real = scan_shadows.scan_walk

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    scan_shadows.scan_walk = spy
    try:
        scene.frame(scene.system.state, torch.tensor(0.5, device=device),
                    None, scene.volume, scene.gbuffer, scene.sphere_lights,
                    scene.environment.uniforms(device=device),
                    scene.spawner.spawn_max, frame_index=3,
                    spawn_uniforms=_draws(1, 64)[0])
    finally:
        scan_shadows.scan_walk = real
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["analytic", "voxel"])
def test_cuda_flagship_walk_equals_eager_loop(field):
    """The flagship's own walk at 1080p (270 x 480, 8 lights), K1 against
    the eager loop bit for bit."""
    _needs_card()
    calls = _flagship_walks(field)
    assert len(calls) == 1
    args, kw = calls[0]
    assert tuple(args[0].shape) == (270, 480) and args[1].shape[0] == 8
    assert (len(args[5]) == 2) == (field == "voxel")
    got = k1.scan_walk_cuda(*args, **kw)
    ref = scan_shadows.scan_walk_reference(*args, **kw)
    torch.cuda.synchronize()
    _bits_equal(got, ref, field)


@pytest.mark.cuda
def test_cuda_one_launch_a_scan_visibility_call():
    """Each scan_visibility call on CUDA tensors is one K1 launch."""
    _needs_card()
    from illuminant_tpu_torch.core.config import QualitySettings

    scene = _prism_scene("cuda")
    pos = torch.tensor([[30.0, 50.0, 40.0], [150.0, 30.0, 60.0]],
                       device="cuda")
    rad = torch.tensor([4.0, 3.0], device="cuda")
    ramp = torch.tensor([200.0, 150.0], device="cuda")
    cuda_build.reset_launches()
    for n in range(1, 4):
        scan_shadows.scan_visibility(scene, 96, 160, pos, rad, ramp,
                                     QualitySettings())
        assert cuda_build.launches()["k1_scan_walk"] == n


def _draws(n, spawn_max=SMALL["spawn_max"], seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(rng.random((spawn_max, 4), dtype=np.float32)
                  for _ in range(3)) for _ in range(n)]


def _small_frames(field, walk):
    """Three small flagship frames on the card with `scan_shadows.
    scan_walk` as `walk` -> (image, positions, avg_lum) of the last."""
    from illuminant_tpu_torch.scenes import build_flagship

    real = scan_shadows.scan_walk
    scan_shadows.scan_walk = walk
    try:
        scene = build_flagship(device="cuda", field=field, **SMALL)
        state, avg = scene.system.state, torch.tensor(0.5, device="cuda")
        env_u = scene.environment.uniforms(device="cuda")
        for i, draws in enumerate(_draws(3)):
            img, state, avg, _ = scene.frame(
                state, avg, None, scene.volume, scene.gbuffer,
                scene.sphere_lights, env_u, scene.spawner.spawn_max,
                frame_index=i, spawn_uniforms=draws)
        torch.cuda.synchronize()
    finally:
        scan_shadows.scan_walk = real
    return img, state.position, avg


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["analytic", "voxel"])
def test_cuda_small_frame_equals_eager_walk_frame(field):
    """Three small flagship frames through K1 equal the frames through
    the eager walk on the card bit for bit: image, particles, exposure."""
    _needs_card()
    cuda_build.reset_launches()
    got = _small_frames(field, scan_shadows.scan_walk)
    assert cuda_build.launches()["k1_scan_walk"] == 3
    ref = _small_frames(field, scan_shadows.scan_walk_reference)
    assert cuda_build.launches()["k1_scan_walk"] == 3
    for a, b in zip(got, ref):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_cuda_addcmul_rounds_as_the_kernel_resample():
    """torch.addcmul(a, b, c) on the card adds b * c to a in one fused
    multiply-add, one rounding: the form K1's `resample` computes (two
    rounded products would move the arg-min on plateaus). The fused
    reference: b * c exact in float64, the sum rounded to float64 and
    then to float32, which rounds twice only where the float64 sum lies
    on a float32 midpoint (none of these inputs)."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    a, b, c = (torch.rand(1 << 22, device="cuda", generator=g) * 4 - 2
               for _ in range(3))
    got = torch.addcmul(a, b, c)
    two_roundings = a + b * c
    fused = (a.double() + b.double() * c.double()).float()
    assert torch.equal(got, fused), int((got != fused).sum())
    assert not torch.equal(got, two_roundings)


@pytest.mark.cuda
def test_cuda_plan_reports_each_instance():
    """Every instance the plan can pick loads on the card, within its
    thread limit and without spills at the flagship's instances."""
    _needs_card()
    for shape, foot, extra in (((270, 480), False, False),
                               ((270, 480), True, True),
                               ((45, 77), True, False),
                               ((45, 77), False, True),
                               ((1100, 70), True, True),
                               ((2100, 40), False, False)):
        plan = k1.block_plan(*shape, 8, foot, extra)
        assert plan["threads"] <= plan["max_threads"]
        if shape == (270, 480):
            assert plan["spill_bytes"] == 0, plan
