"""The cone-trace march kernel (K12, csrc/cone_trace.cu) on the card
against its plain version.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cone_trace_cuda.py

Here, without a card, the `cuda` cases skip and the CPU cases check that
the inputs reach what the card cases are about (shadowed and clear rays,
rays that run out of steps, every field).

Bound (the family tests' march bound): mean |d| <= 1e-3 and 99% of the
rays within 1e-3 x (1 + the largest value). The kernel is compiled with
-fmad=false in the plain version's operation order, yet a few rays in
millions take another step count on the card. Beyond the bound: at most
0.1% of the rays take another step count, and every ray whose steps
agree is within 2.5e-4 x (1 + the largest value).
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting.cone_trace import (cone_trace,
                                                      cone_trace_reference)
from illuminant_tpu_torch.ops import sdf_primitives as sp
from illuminant_tpu_torch.sdf import height_volume as hv
from illuminant_tpu_torch.sdf.analytic import pack_scene
from illuminant_tpu_torch.sdf import volume as tvol
from illuminant_tpu_torch.sdf.columns import build_column_maps
from illuminant_tpu_torch.sdf.volume import SdfVolumeConfig, generate_volume

W, H = 160.0, 120.0
GRID = (60, 80)
TYPES = sorted(sp.PLANAR_EVALUATORS)


def _obstructions(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "stacked":
        return [tenv.LightObstruction.box((80.0, 60.0, 8.0),
                                          (16.0, 12.0, 6.0)),
                tenv.LightObstruction.box((80.0, 60.0, 40.0),
                                          (16.0, 12.0, 6.0)),
                tenv.LightObstruction.cylinder((40.0, 40.0, 20.0),
                                               (7.0, 7.0, 20.0))]
    n = 70 if kind == "many" else 10
    out = []
    for i in range(n):
        rot = (0.0, 0.0, 0.0, 1.0)
        if kind in ("rotated", "many") and i % 2 == 0:
            q = rng.normal(size=4)
            rot = tuple(q / np.linalg.norm(q))
        out.append(tenv.LightObstruction(
            type=TYPES[i % len(TYPES)],
            center=tuple(rng.uniform((10, 10, 6), (W - 10, H - 10, 28))),
            size=tuple(rng.uniform((3, 3, 4), (12, 12, 16))),
            rotation=rot))
    return out


def field(name, device):
    """A field of each kind and case on `device`."""
    if name.startswith("analytic"):
        kind = name.split("_")[1]
        vols = None
        if kind == "polygons":
            vols = [hv.HeightVolume(polygon=[(20.0, 90.0), (50.0, 84.0),
                                             (46.0, 112.0), (22.0, 108.0)],
                                    height=20.0),
                    hv.HeightVolume(polygon=[(110.0, 12.0), (140.0, 18.0),
                                             (124.0, 40.0)], height=30.0)]
        return pack_scene(_obstructions("types" if kind == "polygons"
                                        else kind),
                          height_volumes=vols, device=device)
    env = tenv.LightingEnvironment()
    env.obstructions += _obstructions(
        "stacked" if name == "column_stacked" else "types")
    cfg = SdfVolumeConfig(virtual_width=int(W), virtual_height=int(H),
                          virtual_depth=64, slice_count=16,
                          resolution_scale=0.5)
    vol = generate_volume(cfg, env.pack_obstructions(device=device))
    return vol if name == "volume" else build_column_maps(vol)


FIELDS = ["analytic_types", "analytic_rotated", "analytic_polygons",
          "analytic_many", "volume", "column", "column_stacked"]


def rays(device, per_point=False, lights=4, seed=0, grid=GRID):
    rng = np.random.default_rng(seed)
    h, w = grid
    ys, xs = np.meshgrid((np.arange(h) + 0.5) * H / h,
                         (np.arange(w) + 0.5) * W / w, indexing="ij")
    shaded = np.stack([xs, ys, np.full_like(xs, 1.6)], -1)[None]
    center = rng.uniform((0, 0, 30), (W, H, 50), (lights, 1, 1, 3))
    if per_point:
        center = center + rng.uniform(-20, 20, (lights, h, w, 3))
    radius = rng.uniform(3, 12, (lights, 1, 1))
    ramp = rng.uniform(40, 200, (lights, 1, 1))
    enable = rng.random((lights, h, w)) > 0.1
    return tuple(torch.as_tensor(a.astype(np.float32) if a.dtype != bool
                                 else a, device=device)
                 for a in (center, radius, ramp, shaded, enable))


def within_bound(out, ref):
    """The march bound: mean |d| <= 1e-3, 99% within 1e-3 (1 + max)."""
    d = (out - ref).abs()
    tol = 1e-3 * (1.0 + float(ref.abs().max()))
    return float(d.mean()) <= 1e-3 and float((d <= tol).float().mean()) \
        >= 0.99


@pytest.mark.parametrize("name", FIELDS)
def test_inputs_reach_the_cases(name):
    """On the CPU: the plain march on each case's rays shadows some rays,
    leaves some clear, and some take many steps."""
    f = field(name, "cpu")
    c, r, ramp, s, e = rays("cpu")
    vis, steps = cone_trace_reference(f, c, r, ramp, s, e, QualitySettings(),
                                      with_steps=True)
    assert (vis[e] < 0.2).any() and (vis[e] > 0.95).any()
    assert float((QualitySettings().max_step_count - steps[e]).max()) >= 8


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("name", FIELDS)
def test_cuda_matches_plain(name, per_point, raw):
    """One launch through `cone_trace` against the plain loop on the same
    CUDA tensors, under the march bound; the steps left compared too."""
    _needs_card()
    f = field(name, "cuda")
    args = rays("cuda", per_point, seed=FIELDS.index(name))
    q = QualitySettings()
    before = cuda_build.launches()["k12_cone_trace"]
    out = cone_trace(f, *args, q, raw=raw)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k12_cone_trace"] == before + 1
    ref = cone_trace_reference(f, *args, q, raw=raw)
    assert out.shape == ref.shape == (4,) + GRID
    assert within_bound(out, ref), float((out - ref).abs().max())
    _, steps = ctk.cone_trace_cuda(f, *args, q, raw=raw, with_steps=True)
    _, ref_steps = cone_trace_reference(f, *args, q, raw=raw,
                                        with_steps=True)
    agree = steps == ref_steps
    assert float((~agree).float().mean()) <= 1e-3
    tol = 2.5e-4 * (1.0 + float(ref.abs().max()))
    assert float(torch.where(agree, (out - ref).abs(), 0.0).max()) <= tol
    assert torch.equal(out[~args[4]], torch.ones_like(out[~args[4]]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scalar_light", "probes"])
def test_cuda_broadcast_patterns(case):
    """The projector's one light over an (h, w) grid and the probes' (L,
    1, 3) x (1, N, 3) pattern, each one launch."""
    _needs_card()
    f = field("analytic_types", "cuda")
    c, r, ramp, s, e = rays("cuda")
    if case == "scalar_light":
        args = (c[0, 0, 0], r[0, 0, 0], ramp[0, 0, 0], s[0], e[0])
    else:
        args = (c[:, 0], r[:, 0], ramp[:, 0], s[:, 0], e[:, 0, :])
    q = QualitySettings()
    out = cone_trace(f, *args, q)
    ref = cone_trace_reference(f, *args, q)
    torch.cuda.synchronize()
    assert within_bound(out, ref)


@pytest.mark.cuda
def test_cuda_is_repeatable_and_reports_its_plan():
    _needs_card()
    f = field("volume", "cuda")
    args = rays("cuda")
    a = cone_trace(f, *args, QualitySettings())
    b = cone_trace(f, *args, QualitySettings())
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    for name in ("volume", "analytic_types", "column"):
        plan = ctk.block_plan(field(name, "cuda"))
        assert plan["threads"] == 256 and plan["blocks_per_sm"] >= 1


def flat(args):
    """The rays of `rays` flattened from (L, H, W) to (L, H x W): the same
    rays, launched in order rather than in 16 x 16 tiles."""
    c, r, ramp, s, e = args
    return (c.flatten(1, 2), r.flatten(1), ramp.flatten(1), s.flatten(1, 2),
            e.flatten(1))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rays_in_order", "analytic_global"])
@pytest.mark.parametrize("name", FIELDS)
def test_cuda_paths_are_bit_equal(name, path, monkeypatch):
    """Every path of a field computes the same arithmetic: the rays in
    16 x 16 tiles and in order, the AnalyticScene staged in shared memory
    and read from device memory; outputs and steps equal bit for bit."""
    _needs_card()
    f = field(name, "cuda")
    args = rays("cuda", per_point=True, seed=3)
    q = QualitySettings()
    out, steps = ctk.cone_trace_cuda(f, *args, q, with_steps=True)
    if path == "rays_in_order":
        assert ctk.launch_plan(f, *flat(args), q)["image"] == (0, 0)
        other, other_steps = ctk.cone_trace_cuda(f, *flat(args), q,
                                                 with_steps=True)
        other, other_steps = other.reshape(out.shape), \
            other_steps.reshape(out.shape)
    else:
        default = ctk.launch_plan(f, *args, q)["instance"]
        monkeypatch.setattr(ctk, "ANALYTIC_SMEM_MAX", 0)
        if name.startswith("analytic"):
            assert (default, ctk.launch_plan(f, *args, q)["instance"]) == (
                ctk.INSTANCES["analytic"], ctk.INSTANCES["analytic_global"])
        other, other_steps = ctk.cone_trace_cuda(f, *args, q,
                                                 with_steps=True)
    torch.cuda.synchronize()
    assert torch.equal(out, other) and torch.equal(steps, other_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["volume", "analytic_polygons", "column"])
def test_cuda_odd_counts_and_partial_tiles(name):
    """An odd ray image (partial 16 x 16 tiles on two sides) and an odd
    ray count in order (the probes' (L, N) pattern) against the plain
    loop."""
    _needs_card()
    f = field(name, "cuda")
    q = QualitySettings()
    c, r, ramp, s, e = rays("cuda", grid=(37, 53), lights=3, seed=5)
    for args in ((c, r, ramp, s, e),
                 (c[:, 0], r[:, 0], ramp[:, 0], s[:, 0, :29],
                  e[:, 0, :29])):
        out = cone_trace(f, *args, q)
        ref = cone_trace_reference(f, *args, q)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and within_bound(out, ref)


@pytest.mark.cuda
def test_cuda_pack_follows_the_volume():
    """The volume's pack equals its plain version bit for bit, is built
    once a volume, again for the volume a budgeted update returns (and
    after an in-place write), and the march on it agrees with the plain
    loop on the new field."""
    _needs_card()
    vol = field("volume", "cuda")
    args = rays("cuda")
    q = QualitySettings()
    before = cuda_build.launches()["k12_volume_pack"]
    cone_trace(vol, *args, q)
    cone_trace(vol, *args, q)
    assert cuda_build.launches()["k12_volume_pack"] == before + 1
    assert torch.equal(ctk.packed_volume(vol),
                       ctk.pack_volume_reference(vol.data))
    env = tenv.LightingEnvironment()
    env.obstructions += _obstructions("rotated", seed=4)
    slab = tvol.generate_slab(vol.config, env.pack_obstructions(
        device="cuda"), 2, 2)
    new = tvol.update_slices(vol, 2, slab)
    out = cone_trace(new, *args, q)
    assert cuda_build.launches()["k12_volume_pack"] == before + 2
    assert torch.equal(ctk.packed_volume(new),
                       ctk.pack_volume_reference(new.data))
    ref = cone_trace_reference(new, *args, q)
    torch.cuda.synchronize()
    assert within_bound(out, ref)
    new.data[0].add_(1.0)  # in place: the pack is built again
    assert torch.equal(ctk.packed_volume(new),
                       ctk.pack_volume_reference(new.data))
    assert cuda_build.launches()["k12_volume_pack"] == before + 3
