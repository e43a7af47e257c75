"""The scan walk's dispatch, plan and layout on the CPU (K1's card tests
are tests/test_torch_scan_walk_cuda.py).

* `scan_walk_kernel.launch_plan` is pure and takes every grid shape and
  variant the callers ask for;
* `scan_shadows.scan_walk` on CPU tensors runs the plain loop,
  `_bidirectional_scan`, and returns its carries exactly, in the sector
  layout (4, C, L, H, W) with the reverse walks' flips and the N/S walk's
  transpose undone;
* that layout feeds `scan_visibility` to the same visibility, bit for
  bit, as the strided views the walk returned before.
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import scan_shadows
from illuminant_tpu_torch.lighting import scan_walk_kernel as k1
from illuminant_tpu_torch.lighting.environment import (LightingEnvironment,
                                                       LightObstruction)
from illuminant_tpu_torch.sdf import analytic
from illuminant_tpu_torch.sdf.columns import build_column_maps
from illuminant_tpu_torch.sdf.volume import SdfVolumeConfig, generate_volume

torch.set_num_threads(1)

SHAPES = [(270, 480), (45, 77), (1100, 70), (70, 1100), (24, 40), (1, 1),
          (2100, 40), (1080, 1920)]


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("footprint", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_launch_plan_covers_every_grid(shape, footprint, extra):
    """Every block has whole warps, enough threads for its rows at the
    fewest rows a thread, the most columns a tile that fit the shared
    memory a block may take, and the instance of its variant; the plan
    is a pure function of its arguments."""
    h, w = shape
    plan = k1.launch_plan(h, w, 8, footprint, extra)
    assert plan == k1.launch_plan(h, w, 8, footprint, extra)
    rows = max(h, w)
    per = plan["rows_per_thread"]
    assert plan["threads"] % 32 == 0 and plan["threads"] <= k1.MAX_THREADS
    assert plan["threads"] * per >= rows
    assert plan["threads"] - 32 < -(-rows // per)
    assert per == min(r for r in k1.ROWS_PER_THREAD
                      if -(-rows // r) <= k1.MAX_THREADS)
    carries = 4 if footprint else 3
    channels = carries + (2 if extra else 0)
    assert plan["channels"] == channels
    assert plan["shape"] == (4, channels, 8, h, w)
    assert plan["blocks"] == 32
    assert plan["smem_bytes"] <= k1.SMEM_MAX
    assert plan["tile_cols"] in k1.TILE_COLS
    bigger = [c for c in k1.TILE_COLS if c > plan["tile_cols"]]
    images = 1 + int(footprint) + 2 * int(extra)
    state = carries + 3 * int(extra)

    def smem(cols):
        pad = (lambda n: -(-n // 32) * 32 + 4)
        return max((2 * images + 2 * channels) * cols * pad(h) * 4,
                   2 * images * cols * pad(w) * 4) \
            + 2 * (plan["threads"] // 32) * 2 * state * 4

    assert plan["smem_bytes"] == smem(plan["tile_cols"])
    assert all(smem(c) > k1.SMEM_MAX for c in bigger)
    assert plan["instance"] == (k1.ROWS_PER_THREAD.index(per) * 4
                                + 2 * int(footprint) + int(extra))


@pytest.mark.parametrize("shape", [(0, 10), (10, 0), (4097, 8)])
def test_launch_plan_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        k1.launch_plan(*shape, 2)


def test_launch_plan_flagship():
    """The flagship's walk: 32 blocks of 480 threads, one row each, 8
    columns a tile."""
    plan = k1.launch_plan(270, 480, 8)
    assert (plan["blocks"], plan["threads"], plan["rows_per_thread"],
            plan["tile_cols"], plan["instance"]) == (32, 480, 1, 8, 0)


def _prism_scene():
    obs = [LightObstruction.box((60.0, 40.0, 6.0), (20.0, 14.0, 6.0)),
           LightObstruction.box((130.0, 70.0, 6.0), (12.0, 25.0, 6.0)),
           LightObstruction.cylinder((40.0, 90.0, 4.0), (9.0, 9.0, 8.0))]
    return analytic.pack_scene(obs, group_capacity_round=1, device="cpu")


def _walk_inputs(h, w, variant, seed=0):
    rng = np.random.default_rng(seed)
    t = (lambda a: torch.as_tensor(np.asarray(a, np.float32)))
    occ = scan_shadows.occlusion_image(_prism_scene(), h, w,
                                       torch.tensor(10.0), w / 200.0)
    lx = t(rng.uniform(-0.2 * w, 1.2 * w, 3))
    ly = t(rng.uniform(-0.2 * h, 1.2 * h, 3))
    lr = t(rng.uniform(0.0, 6.0, 3))
    extra = ()
    fp = None
    if variant in ("footprint", "both"):
        fp = t(rng.uniform(-4.0, 20.0, (h, w)))
    if variant in ("extra", "both"):
        extra = (t(rng.uniform(0.0, 30.0, (h, w))),
                 t(rng.uniform(-10.0, 5.0, (h, w))))
    return occ, lx, ly, lr, 0.5, extra, fp


@pytest.mark.parametrize("variant", ["plain", "footprint", "extra", "both"])
@pytest.mark.parametrize("shape", [(30, 50), (37, 23)])
def test_cpu_walk_is_the_plain_loop(shape, variant):
    """On CPU tensors `scan_walk` is `_bidirectional_scan` along both
    axes, its carries placed in the sector layout: east as walked, west
    flipped back, north and south transposed back; no kernel is
    touched."""
    occ, lx, ly, lr, band, extra, fp = _walk_inputs(*shape, variant)
    cuda_build.reset_launches()
    out = scan_shadows.scan_walk(occ, lx, ly, lr, band, extra, fp)
    assert cuda_build.launches()["k1_scan_walk"] == 0
    east, west = scan_shadows._bidirectional_scan(occ, lx, ly, lr, band,
                                                  extra, fp)
    north, south = scan_shadows._bidirectional_scan(
        occ.T, ly, lx, lr, band, tuple(e.T for e in extra),
        None if fp is None else fp.T)
    channels = 3 + (fp is not None) + 2 * bool(extra)
    assert out.shape == (4, channels, 3) + shape and out.is_contiguous()
    for s, sector in enumerate((east, west, north, south)):
        assert len(sector) == channels
        for c, ref in enumerate(sector):
            ref = ref.transpose(1, 2) if s >= 2 else ref
            assert torch.equal(out[s, c], ref), (s, c)


def _column_field():
    env = LightingEnvironment()
    env.obstructions += [
        LightObstruction.box((40.0, 30.0, 8.0), (10.0, 8.0, 8.0)),
        # Stacked with a gap: a column of two intervals, merged.
        LightObstruction.box((90.0, 40.0, 4.0), (12.0, 10.0, 4.0)),
        LightObstruction.box((90.0, 40.0, 30.0), (8.0, 6.0, 6.0)),
        LightObstruction.ellipsoid((60.0, 50.0, 12.0), (9.0, 7.0, 8.0))]
    cfg = SdfVolumeConfig(virtual_width=96, virtual_height=64,
                          virtual_depth=64, slice_count=16,
                          resolution_scale=0.5)
    return build_column_maps(generate_volume(
        cfg, env.pack_obstructions(device="cpu")))


def _strided_walk(occ, lx, ly, lr, band, extra=(), fp=None):
    """The walk's carries as the earlier layout held them: the plain
    loop's (W, C, 2, L, H) output permuted, west flipped and north /
    south transposed as strided views."""
    east, west = scan_shadows._bidirectional_scan(occ, lx, ly, lr, band,
                                                  extra, fp)
    north, south = scan_shadows._bidirectional_scan(
        occ.T, ly, lx, lr, band, tuple(e.T for e in extra),
        None if fp is None else fp.T)
    return (east, west, tuple(p.transpose(1, 2) for p in north),
            tuple(p.transpose(1, 2) for p in south))


SCENES = {
    "prism_96x160": (_prism_scene, 96, 160),
    "column_64x96": (_column_field, 64, 96),
}


@pytest.mark.parametrize("quality", [
    dict(), dict(scan_refine_samples=0), dict(scan_refine_samples=3),
    dict(scan_nomination_scale=1.0), dict(scan_refine_mode="carried_all")])
@pytest.mark.parametrize("scene", list(SCENES))
def test_sector_layout_gives_the_same_visibility(scene, quality,
                                                 monkeypatch):
    """`scan_visibility` on the contiguous sector layout equals, bit for
    bit, `scan_visibility` fed the strided views of the earlier layout
    (the ColumnField takes the carried refine's extras and footprint)."""
    make, h, w = SCENES[scene]
    field = make()
    q = QualitySettings(**quality)
    # The trace plane at 0.4 of the mean light height: z = 10, through
    # the prisms.
    pos = torch.tensor([[20.0, 15.0, 20.0], [80.0, 55.0, 30.0],
                        [150.0, 10.0, 25.0], [-300.0, 40.0, 25.0]])
    rad = torch.tensor([4.0, 3.0, 6.0, 2.0])
    ramp = torch.tensor([200.0, 150.0, 120.0, 500.0])
    pz = torch.linspace(0.0, 6.0, h * w).reshape(h, w)
    got = scan_shadows.scan_visibility(field, h, w, pos, rad, ramp, q,
                                       pixel_z=pz)
    monkeypatch.setattr(scan_shadows, "scan_walk", _strided_walk)
    ref = scan_shadows.scan_visibility(field, h, w, pos, rad, ramp, q,
                                       pixel_z=pz)
    assert torch.equal(got, ref)
    assert (ref < 0.5).any() and (ref > 0.9).any()
