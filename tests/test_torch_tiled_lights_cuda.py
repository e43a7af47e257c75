"""The tiled particle-light kernel (K10, csrc/tiled_lights.cu) on the card
against its plain version.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_tiled_lights_cuda.py

(`tests/conftest.py` configures jax; `--noconftest` leaves it out). Here,
without a card, the `cuda` cases skip and the CPU cases check that the
inputs reach what the card cases are about.

Tolerance: the source is compiled with -fmad=false in the plain version's
operation order, but its sqrtf is IEEE where torch's float32 sqrt on the
card is not everywhere, and powf (the normal ramp) may come from another
libdevice than torch's, so K10 is held to 1e-5 x (1 + the image's largest
value).
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.lighting import tiled_lights as ttl
from illuminant_tpu_torch.lighting import tiled_lights_kernel as tk

H, W = 100, 150


def _inputs(tile, capacity, ramp_mode=0, light_occlusion=0.0, n=160,
            pile=0, seed=0, device="cpu"):
    """A 2.5D G-buffer (random normals, a band of zero normals, relief,
    a fullbright strip folded into pix_f), n lights over and past the
    frame plus `pile` on one spot, their bins and records: the kernel's
    arguments. Every light is binned and 15% of the records are off, so
    that binned slots with no live light occur too."""
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal[..., 2] = np.abs(normal[..., 2]) + 0.3
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[40:48] = 0.0  # no normal: the factor is 1
    rel = np.zeros((H, W), np.float32)
    rel[60:, 30:90] = -12.0
    z = rng.uniform(0.0, 6.0, (H, W)).astype(np.float32)
    pix_f = rng.uniform(0.4, 1.0, (H, W)).astype(np.float32)
    pix_f[:, 140:] = 0.0  # fullbright
    x = np.concatenate([rng.uniform(-12, W + 12, n), np.full(pile, 70.0)])
    y = np.concatenate([rng.uniform(-12, H + 12, n), np.full(pile, 50.0)])
    m = n + pile
    pos = np.stack([x, y, rng.uniform(2, 16, m)], 1).astype(np.float32)
    active = rng.uniform(size=m) < 0.85
    col = rng.uniform(0.1, 1.0, (m, 3)).astype(np.float32)
    t = (lambda a: torch.as_tensor(a, device=device))
    radius, ramp_length, y_factor, rs = 2.0, 14.0, 0.7, 1.0
    reach = radius + (ramp_length if ramp_mode < 2 else 1.0)
    th, tw = -(-H // tile), -(-W // tile)
    ty0 = (torch.arange(th * tw, device=device) // tw * tile).float()
    idx, mask, dropped = ttl.bin_lights_to_tiles(
        t(x.astype(np.float32)), t(y.astype(np.float32)),
        t(np.ones(m, bool)), reach + 0.5, tile, th, tw, capacity,
        influence_y=reach / y_factor + 0.5, tile_y_lo=ty0 - 12.0,
        tile_y_hi=ty0 + tile, extra_y_window=12.0)
    records = torch.cat([t(pos), t(active.astype(np.float32))[:, None],
                         t(col), torch.ones((m, 1), device=device)], 1)
    args = (t(z), t(rel), t(normal), t(pix_f), idx, mask,
            records.contiguous(),
            torch.tensor(light_occlusion, dtype=torch.float32,
                         device=device), tile, radius, ramp_length,
            y_factor, ramp_mode, rs)
    return args, dropped


CASES = {
    "tile16": dict(tile=16, capacity=40),
    "tile32": dict(tile=32, capacity=64),
    "tile64": dict(tile=64, capacity=96),
    "exponential": dict(tile=32, capacity=64, ramp_mode=1),
    "no_falloff": dict(tile=32, capacity=64, ramp_mode=2),
    "occlusion": dict(tile=32, capacity=64, light_occlusion=3.0),
    "overflow": dict(tile=32, capacity=60, pile=80),
}


def test_inputs_reach_edges_overflow_and_empty_slots():
    """On the CPU: the frame ends inside a tile on both axes at every
    tile size, the overflow case drops lights, every case has masked and
    inactive slots, and the plain version lights the frame."""
    for name, kw in CASES.items():
        args, dropped = _inputs(**kw)
        tile = kw["tile"]
        assert H % tile and W % tile
        assert (int(dropped) > 0) == (name == "overflow"), name
        mask = args[5]
        assert (~mask).any() and mask.any()
        on = args[6][args[4].long(), 3]
        assert ((on == 0) & mask).any(), name
        out = tk.tiled_light_accumulate(*args)
        assert out.shape == (H, W, 4) and float(out[..., 3].max()) > 0.1
        assert (out[:, 140:] == 0).all()


def test_plain_version_is_the_tiled_route_on_the_cpu():
    """The wrapper on CPU tensors is the plain version, alpha or not."""
    args, _ = _inputs(32, 64)
    full = tk.tiled_light_accumulate(*args)
    assert torch.equal(full, tk.tiled_light_accumulate_reference(*args))
    rgb = tk.tiled_light_accumulate(*args, with_alpha=False)
    assert rgb.shape == (H, W, 3) and torch.equal(rgb, full[..., :3])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("with_alpha", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_matches_plain(name, with_alpha):
    _needs_card()
    args, _ = _inputs(**CASES[name], device="cuda")
    before = tk.LAUNCHES
    out = tk.tiled_light_accumulate(*args, with_alpha=with_alpha)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    ref = tk.tiled_light_accumulate_reference(*args, with_alpha=with_alpha)
    assert out.shape == ref.shape
    tol = 1e-5 * (1.0 + float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol
    assert float(ref.abs().max()) > 0.1


@pytest.mark.cuda
def test_cuda_is_repeatable_and_reports_its_plan():
    _needs_card()
    args, _ = _inputs(64, 96, device="cuda")
    a = tk.tiled_light_accumulate(*args)
    b = tk.tiled_light_accumulate(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plan = tk.launch_plan(64, 96)
    assert plan["threads"] == 256 and plan["smem_bytes"] == 96 * 32
    assert plan["blocks_per_sm"] >= 1 and plan["registers"] > 0


@pytest.mark.cuda
def test_cuda_route_through_accumulate():
    """accumulate_sphere_lights_tiled on the card launches K10 once and
    agrees with the same call on the CPU."""
    _needs_card()
    from illuminant_tpu_torch.lighting import environment as tenv
    from illuminant_tpu_torch.lighting.gbuffer import flat_ground

    rng = np.random.default_rng(5)
    pos = np.zeros((64, 4), np.float32)
    pos[:, 0] = rng.uniform(-8, W + 8, 64)
    pos[:, 1] = rng.uniform(-8, H + 8, 64)
    pos[:, 2] = rng.uniform(4, 14, 64)
    col = rng.uniform(0.3, 1.0, (64, 4)).astype(np.float32)
    template = tenv.SphereLightSource(radius=3.0, ramp_length=20.0,
                                      cast_shadows=False)
    outs = []
    for dev in ("cpu", "cuda"):
        env = tenv.LightingEnvironment().uniforms(device=dev)
        before = tk.LAUNCHES
        img, diag = ttl.accumulate_sphere_lights_tiled(
            None, flat_ground(H, W, env), torch.as_tensor(pos, device=dev),
            torch.as_tensor(col, device=dev),
            torch.ones(64, dtype=torch.bool, device=dev), template, env,
            tile=32, capacity=32)
        assert tk.LAUNCHES == before + (dev == "cuda")
        outs.append((img.cpu(), int(diag["dropped"])))
    (ref, d0), (out, d1) = outs
    assert d0 == d1
    assert float((out - ref).abs().max()) <= 1e-5 * (1.0 + float(
        ref.abs().max()))
