"""The additive splat kernel (K5, csrc/splat.cu) on the card against its
plain version.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_splat_cuda.py

Here, without a card, the `cuda` cases skip and the CPU cases check that
the inputs reach what the card cases are about.

Bound: K5 adds each tap with a float atomic and the plain version's
`index_add_` is atomic on the card too, so each pixel's sum is taken in
some order of its n terms. With non-negative colours, each order's sum
lies within (n - 1) 2^-24 S of the exact sum S, so two orders differ by
at most n x 2^-23 x S: the bound is the largest n (`tiled.splat_terms`)
x 2^-23 x the image's largest value. The weights themselves are the
plain version's bit for bit (-fmad=false, the profile in its order): a
single particle's image equals the plain one exactly.
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.raster import splat_kernel, tiled

KERNELS = ["point", "quad", "gauss", "round"]
H, W = 120, 200


def cloud(n, device, seed=0, pile=0):
    """n particles over and past the frame (some dead), sizes across the
    clamp, plus `pile` on one spot; x and y as columns of an (N, 4)
    state, colours (N, 4) non-negative."""
    rng = np.random.default_rng(seed)
    m = n + pile
    pos = np.zeros((m, 4), np.float32)
    pos[:n, 0] = rng.uniform(-8, W + 8, n)
    pos[:n, 1] = rng.uniform(-8, H + 8, n)
    pos[n:, :2] = (97.3, 61.6)
    color = rng.uniform(0.0, 2.0, (m, 4)).astype(np.float32)
    size = rng.uniform(0.5, 12.0, m).astype(np.float32)
    live = rng.random(m) > 0.1
    pos_t = torch.as_tensor(pos, device=device)
    return (pos_t[:, 0], pos_t[:, 1], torch.as_tensor(color, device=device),
            torch.as_tensor(size, device=device),
            torch.as_tensor(live, device=device))


def config(kernel, channels=4, tile=32, apron=4):
    return tiled.TiledRasterConfig(height=H, width=W, tile=tile, apron=apron,
                                   kernel=kernel, channels=channels)


def sum_bound(cfg, args, ref) -> float:
    """n_max x 2^-23 x max |image| (the module docstring)."""
    x, y, _, size, live = args
    n = int(tiled.splat_terms(cfg, x, y, size, live).max())
    return n * 2.0 ** -23 * float(ref.abs().max())


@pytest.mark.parametrize("kernel", KERNELS)
def test_inputs_reach_the_cases(kernel):
    """On the CPU: the cloud piles many terms on some pixels, clips
    footprints at tile windows and the frame, and the bound is small
    beside the image."""
    cfg = config(kernel)
    args = cloud(3000, "cpu", pile=200)
    img, _ = tiled.rasterize_tiled(cfg, *args)
    terms = tiled.splat_terms(cfg, args[0], args[1], args[3], args[4])
    assert int(terms.max()) >= 150  # the pile, 90% of it live
    assert 0.0 < sum_bound(cfg, args, img) < 1e-2 * float(img.max())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_matches_plain(kernel, channels):
    _needs_card()
    cfg = config(kernel, channels)
    args = cloud(20000, "cuda", seed=KERNELS.index(kernel), pile=500)
    before = splat_kernel.LAUNCHES
    out, diag = tiled.rasterize_tiled(cfg, *args)
    torch.cuda.synchronize()
    assert splat_kernel.LAUNCHES == before + 1 and diag["dropped"] == 0
    ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
    assert out.shape == ref.shape == (H, W, channels)
    err = float((out - ref).abs().max())
    assert err <= sum_bound(cfg, args, ref), err
    assert float(ref.max()) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_single_particle_is_bit_equal(kernel):
    """One term a pixel: the weights equal the plain version's exactly,
    at a tile corner (the window clips the footprint) and in the open."""
    _needs_card()
    cfg = config(kernel, tile=16, apron=2)
    for xy, s in (((31.7, 47.2), 9.0), ((100.45, 60.55), 3.3),
                  ((0.2, 119.9), 1.0)):
        args = (torch.tensor([xy[0]], device="cuda"),
                torch.tensor([xy[1]], device="cuda"),
                torch.tensor([[0.7, 1.3, 0.2, 0.9]], device="cuda"),
                torch.tensor([s], device="cuda"),
                torch.tensor([True], device="cuda"))
        out, _ = tiled.rasterize_tiled(cfg, *args)
        ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
        torch.cuda.synchronize()
        assert torch.equal(out, ref) and float(ref.max()) > 0.0


@pytest.mark.cuda
def test_cuda_reads_nothing_back():
    """The splat under set_sync_debug_mode("error"): a synchronizing op
    (a `nonzero`, an `amax` read, an `item`) would raise."""
    _needs_card()
    cfg = config("gauss", 3)
    args = cloud(5000, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = tiled.rasterize_tiled(cfg, *args, stipple_factor=0.5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref, _ = tiled.rasterize_tiled_reference(
        cfg, *args[:4], args[4] & torch.remainder(
            torch.arange(5000, device="cuda", dtype=torch.float32)
            * 0.6180339887, 1.0).lt(0.5))
    assert float((out - ref).abs().max()) <= sum_bound(cfg, args, ref)
    with pytest.raises(RuntimeError):
        torch.cuda.set_sync_debug_mode("error")
        try:
            tiled.rasterize_tiled_reference(cfg, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
