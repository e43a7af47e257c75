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

from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting.cone_trace import (cone_trace,
                                                      cone_trace_reference)
from illuminant_tpu_torch.ops import sdf_primitives as sp
from illuminant_tpu_torch.sdf import height_volume as hv
from illuminant_tpu_torch.sdf.analytic import pack_scene
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


def rays(device, per_point=False, lights=4, seed=0):
    rng = np.random.default_rng(seed)
    h, w = GRID
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
    before = ctk.LAUNCHES
    out = cone_trace(f, *args, q, raw=raw)
    torch.cuda.synchronize()
    assert ctk.LAUNCHES == before + 1
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
