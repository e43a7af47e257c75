"""The fused tiled particle-light kernel (K10, csrc/tiled_lights.cu) on the
card against its plain version.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_tiled_lights_cuda.py

(`tests/conftest.py` configures jax; `--noconftest` leaves it out). Here,
without a card, the `cuda` cases skip and the CPU cases check that the
inputs reach what the card cases are about.

Tolerance: the bins (the debug lists), `dropped` and `window_deficit_px`
exactly. The image: the source is compiled with -fmad=false in the plain
version's operation order, with no division in the shading, but its
reciprocal square root (`rsqrtf`) and the normal ramp's base-2 logarithm
and power (the hardware's approximate lg2 / ex2) need not round as
torch's rsqrt, log2 and exp2 do, so K10 is held to 1e-5 x (1 + the
image's largest value).
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting import tiled_lights as ttl
from illuminant_tpu_torch.lighting import tiled_lights_kernel as tk

H, W = 100, 150


def _inputs(tile, capacity, ramp_mode=0, light_occlusion=0.0, n=160,
            pile=0, seed=0, edge_relief=False, mode="pix_f", device="cpu"):
    """A 2.5D G-buffer (random normals, a band of zero normals, relief,
    a fullbright strip folded into pix_f, or the fullbright plane), n
    lights over and past the frame plus `pile` on one spot, 15% of them
    off: the fused kernel's arguments. With `edge_relief` the relief
    reaches the partial last tile row and column."""
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal[..., 2] = np.abs(normal[..., 2]) + 0.3
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[40:48] = 0.0  # no normal: the factor is 1
    rel = np.zeros((H, W), np.float32)
    rel[60:, 30:90] = -12.0
    if edge_relief:
        rel[H - 5:, :] = -20.0
        rel[:, W - 7:] = 8.0
    z = rng.uniform(0.0, 6.0, (H, W)).astype(np.float32)
    if mode == "pix_f":
        factor = rng.uniform(0.4, 1.0, (H, W)).astype(np.float32)
        factor[:, 140:] = 0.0  # fullbright
    else:
        factor = np.zeros((H, W), np.float32)
        factor[:, 140:] = 1.0
    x = np.concatenate([rng.uniform(-12, W + 12, n), np.full(pile, 70.0)])
    y = np.concatenate([rng.uniform(-12, H + 12, n), np.full(pile, 50.0)])
    m = n + pile
    pos = np.stack([x, y, rng.uniform(2, 16, m), np.ones(m)],
                   1).astype(np.float32)
    active = rng.uniform(size=m) < 0.85
    col = rng.uniform(0.1, 1.0, (m, 4)).astype(np.float32)
    template = tenv.SphereLightSource(
        radius=2.0, ramp_length=14.0, falloff_y_factor=0.7,
        ramp_mode=ramp_mode, color=(1.0, 0.9, 0.8, 0.5),
        ambient_occlusion_radius=4.0, ambient_occlusion_opacity=0.6,
        cast_shadows=False)
    shading = ttl.shading_for(template, tile, capacity, 1.0, 12.0)
    t = (lambda a: torch.as_tensor(a, device=device))
    return (t(z), t(rel), t(normal), t(factor), t(pos), t(col), t(active),
            torch.tensor(light_occlusion, dtype=torch.float32,
                         device=device), shading, mode)


CASES = {
    "tile16": dict(tile=16, capacity=40),
    "tile32": dict(tile=32, capacity=64),
    "tile64": dict(tile=64, capacity=96),
    "exponential": dict(tile=32, capacity=64, ramp_mode=1),
    "no_falloff": dict(tile=32, capacity=64, ramp_mode=2),
    "occlusion": dict(tile=32, capacity=64, light_occlusion=3.0),
    "overflow": dict(tile=32, capacity=60, pile=80),
    "edge_relief": dict(tile=32, capacity=64, edge_relief=True,
                        mode="fullbright"),
}


def _with_alpha(args, with_alpha):
    import dataclasses

    return args[:8] + (dataclasses.replace(args[8], with_alpha=with_alpha),
                       ) + args[9:]


def test_inputs_reach_edges_overflow_and_empty_slots():
    """On the CPU: the frame ends inside a tile on both axes at every
    tile size, the overflow case drops lights, every case has tiles with
    empty slots and lights that are off, the relief case moves the
    partial tiles' bounds past the deficit window, and the plain version
    lights the frame but not the fullbright strip."""
    for name, kw in CASES.items():
        args = _inputs(**kw)
        tile = kw["tile"]
        assert H % tile and W % tile
        out, dropped, deficit, kept, count = tk.tiled_lights_fused(
            *args, debug=True)
        assert (int(dropped) > 0) == (name == "overflow"), name
        assert (count < args[8].capacity).any() and (count > 0).any()
        assert (~args[6]).any()
        assert (float(deficit) > 0) == (name == "edge_relief"), name
        assert out.shape == (H, W, 4) and float(out[..., 3].max()) > 0.1
        assert (out[:, 140:] == 0).all()


def test_plain_version_is_the_tiled_route_on_the_cpu():
    """The wrapper on CPU tensors is the plain version, alpha or not."""
    args = _inputs(32, 64)
    full = tk.tiled_lights_fused(*args)
    ref = tk.tiled_lights_fused_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(full, ref))
    rgb = tk.tiled_lights_fused(*_with_alpha(args, False))[0]
    assert rgb.shape == (H, W, 3) and torch.equal(rgb, full[0][..., :3])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


def _counts():
    """The launches of K10, the column query and the map pack."""
    counts = cuda_build.launches()
    return tuple(counts[k] for k in ("k10_tiled_lights", "k7_column_query",
                                     "k7_column_pack"))


def _held_to_plain(args, column=None):
    """Launch K10 once with its debug lists, run the plain version on the
    same inputs, and hold them to each other."""
    before = cuda_build.launches()["k10_tiled_lights"]
    out = tk.tiled_lights_fused(*args, column=column, debug=True)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k10_tiled_lights"] == before + 1
    ref = tk.tiled_lights_fused_reference(*args, column=column, debug=True)
    img, want = out[0], ref[0]
    assert img.shape == want.shape
    tol = 1e-5 * (1.0 + float(want.abs().max()))
    assert float((img - want).abs().max()) <= tol
    assert float(want.abs().max()) > 0.1
    for a, b in zip(out[1:], ref[1:]):
        assert torch.equal(a.cpu(), b.cpu())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("with_alpha", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_matches_plain(name, with_alpha):
    """Every case: the image within the bound, the kept lists, their
    counts, `dropped` and `window_deficit_px` exactly."""
    _needs_card()
    args = _with_alpha(_inputs(**CASES[name], device="cuda"), with_alpha)
    out = _held_to_plain(args)
    assert (int(out[1]) > 0) == (name == "overflow")


@pytest.mark.cuda
def test_cuda_column_ao_and_pix_f_modes():
    """The AO sampled in the kernel from a small ColumnField, and the
    pix_f mode with the factor of an AnalyticScene's AO."""
    _needs_card()
    from illuminant_tpu_torch.sdf.analytic import pack_scene
    from illuminant_tpu_torch.sdf.columns import build_column_maps
    from illuminant_tpu_torch.sdf.volume import (SdfVolumeConfig,
                                                 generate_volume)

    env = tenv.LightingEnvironment()
    boxes = [((60.0, 40.0, 6.0), (14.0, 10.0, 6.0)),
             ((120.0, 75.0, 9.0), (10.0, 12.0, 9.0))]
    env.obstructions += [tenv.LightObstruction.box(*b) for b in boxes]
    cfg = SdfVolumeConfig(virtual_width=W, virtual_height=H,
                          virtual_depth=64, slice_count=16,
                          resolution_scale=0.5)
    column = build_column_maps(generate_volume(
        cfg, env.pack_obstructions(device="cuda")))
    args = _inputs(32, 64, mode="column_ao", edge_relief=True,
                   device="cuda")
    out = _held_to_plain(args, column=column)
    no_ao = tk.tiled_lights_fused(*args[:9], "fullbright")[0]
    assert not torch.equal(out[0], no_ao)  # the AO darkens some pixels
    scene = pack_scene([tenv.LightObstruction.box(*b) for b in boxes],
                       device="cuda")
    z, rel, normal, fb = args[:4]
    pix_f = tk.pixel_factor(scene, z, rel, normal, fb, 1.0, 4.0, 0.6)
    _held_to_plain(args[:3] + (pix_f,) + args[4:9] + ("pix_f",))


@pytest.mark.cuda
def test_cuda_is_repeatable_and_reports_its_plan():
    _needs_card()
    args = _inputs(64, 96, device="cuda")
    a = tk.tiled_lights_fused(*args)[0]
    b = tk.tiled_lights_fused(*args)[0]
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plan = tk.launch_plan(args[8])
    assert plan["threads"] == 256 and plan["smem_bytes"] > 96 * 36
    assert plan["blocks_per_sm"] >= 1 and plan["registers"] > 0
    assert plan["spill_bytes"] == 0


@pytest.mark.cuda
def test_cuda_route_through_accumulate():
    """accumulate_sphere_lights_tiled on the card launches K10 once (and
    on a ColumnField the map pack once, the column query never) and
    agrees with the same call on the CPU."""
    _needs_card()
    from illuminant_tpu_torch.lighting.gbuffer import flat_ground
    from illuminant_tpu_torch.sdf.columns import build_column_maps
    from illuminant_tpu_torch.sdf.volume import (SdfVolumeConfig,
                                                 generate_volume)

    rng = np.random.default_rng(5)
    pos = np.zeros((64, 4), np.float32)
    pos[:, 0] = rng.uniform(-8, W + 8, 64)
    pos[:, 1] = rng.uniform(-8, H + 8, 64)
    pos[:, 2] = rng.uniform(4, 14, 64)
    col = rng.uniform(0.3, 1.0, (64, 4)).astype(np.float32)
    template = tenv.SphereLightSource(radius=3.0, ramp_length=20.0,
                                      cast_shadows=False,
                                      ambient_occlusion_radius=6.0,
                                      ambient_occlusion_opacity=0.5)
    cfg = SdfVolumeConfig(virtual_width=W, virtual_height=H,
                          virtual_depth=64, slice_count=16,
                          resolution_scale=0.5)
    outs = []
    for dev in ("cpu", "cuda"):
        lenv = tenv.LightingEnvironment()
        lenv.obstructions.append(tenv.LightObstruction.box(
            (70.0, 50.0, 6.0), (12.0, 9.0, 6.0)))
        column = build_column_maps(generate_volume(
            cfg, lenv.pack_obstructions(device=dev)))
        env = lenv.uniforms(device=dev)
        before = _counts()
        img, diag = ttl.accumulate_sphere_lights_tiled(
            column, flat_ground(H, W, env), torch.as_tensor(pos, device=dev),
            torch.as_tensor(col, device=dev),
            torch.ones(64, dtype=torch.bool, device=dev), template, env,
            tile=32, capacity=32)
        after = _counts()
        on_card = int(dev == "cuda")
        assert [b - a for a, b in zip(before, after)] == [on_card, 0,
                                                          on_card]
        outs.append((img.cpu(), int(diag["dropped"]),
                     float(diag["window_deficit_px"])))
    (ref, d0, w0), (out, d1, w1) = outs
    assert d0 == d1 and w0 == w1
    assert float((out - ref).abs().max()) <= 1e-5 * (1.0 + float(
        ref.abs().max()))
