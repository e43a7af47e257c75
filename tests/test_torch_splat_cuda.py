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

from illuminant_tpu_torch.core import cuda_build
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
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_matches_plain(kernel, channels):
    _needs_card()
    cfg = config(kernel, channels)
    args = cloud(20000, "cuda", seed=KERNELS.index(kernel), pile=500)
    before = cuda_build.launches()["k5_splat"]
    out, diag = tiled.rasterize_tiled(cfg, *args)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k5_splat"] == \
        before + splat_kernel.LAUNCHES_PER_SPLAT
    assert diag["dropped"] == 0
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


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, None])
@pytest.mark.parametrize("kernel", ["quad", "gauss"])
def test_cuda_clustered_cloud_over_chunks(kernel, chunk, monkeypatch):
    """A cloud piled into one tile (5,000 particles on a few pixels), its
    list cut into chunks that several blocks accumulate: within the
    bound, and the kernels' bins equal `bin_plan`'s."""
    _needs_card()
    cfg = config(kernel, 3)
    args = cloud(4000, "cuda", seed=9, pile=5000)
    if chunk is not None:
        monkeypatch.setattr(splat_kernel, "CHUNK", chunk)
    out, bins = splat_kernel.splat_cuda(cfg, *args, debug=True)
    ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= sum_bound(cfg, args, ref)
    plan = splat_kernel.bin_plan(cfg, args[0], args[1], args[4], chunk)
    for key in ("counts", "offsets", "chunk_offsets"):
        assert torch.equal(bins[key].long(), plan[key]), key
    chunks = plan["chunks"].shape[0]
    assert torch.equal(bins["chunk_tiles"][:chunks].long(),
                       plan["chunks"][:, 0])
    assert int(plan["counts"].max()) >= 4000
    assert int(plan["chunk_offsets"][-1]) > plan["counts"].numel() // 2


@pytest.mark.cuda
def test_cuda_all_dead_and_all_off_screen():
    """No particle binned: the four launches run and the image is 0."""
    _needs_card()
    cfg = config("gauss", 4)
    x, y, color, size, live = cloud(3000, "cuda")
    before = cuda_build.launches()["k5_splat"]
    for args in ((x, y, color, size, torch.zeros_like(live)),
                 (x + 1e4, y, color, size, live)):
        out, bins = splat_kernel.splat_cuda(cfg, *args, debug=True)
        torch.cuda.synchronize()
        assert not bool(out.any()) and int(bins["offsets"][-1]) == 0
    assert cuda_build.launches()["k5_splat"] == before + 2 * \
        splat_kernel.LAUNCHES_PER_SPLAT


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_tile_edges_are_bit_equal(kernel):
    """One particle on each tile edge, at the frame's edges, at negative
    coordinates and just inside the on-screen band, one call each: a
    single term a pixel, so the image equals the plain one exactly."""
    _needs_card()
    cfg = config(kernel, 4, tile=16, apron=3)
    t = 16.0
    for xy in ((t, 2 * t), (t - 1e-3, t + 1e-3), (0.0, 0.0), (-0.5, -2.0),
               (-4.99, 50.0), (W - 1e-3, H - 1e-3), (W + 4.5, 30.0),
               (3 * t, H + 3.9)):
        args = (torch.tensor([xy[0]], device="cuda"),
                torch.tensor([xy[1]], device="cuda"),
                torch.tensor([[0.7, 1.3, 0.2, 0.9]], device="cuda"),
                torch.tensor([7.0], device="cuda"),
                torch.tensor([True], device="cuda"))
        out, _ = tiled.rasterize_tiled(cfg, *args)
        ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), xy


@pytest.mark.cuda
def test_cuda_reports_its_block():
    """The accumulation's block on the card: the window and profiles in
    shared memory, no spills, several blocks an SM at the flagship's
    window."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=1080, width=1920, channels=3)
    plan = splat_kernel.block_plan(cfg)
    assert plan["threads"] == splat_kernel.THREADS
    assert plan["smem_bytes"] == splat_kernel.accumulate_smem(
        splat_kernel.batch_size(cfg), splat_kernel.profile_taps(cfg), 40, 3)
    assert plan["spill_bytes"] == 0 and plan["blocks_per_sm"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_sparse_tiles_add_directly(kernel):
    """A tile of at most DIRECT particles adds its terms to the image
    directly, the others through their windows: a sparse cloud (every
    tile direct) and the sparse cloud beside a pile (both in one splat),
    within the bound, with the bins `bin_plan` gives."""
    _needs_card()
    cfg = config(kernel, 3)
    for pile in (0, 400):
        args = cloud(150, "cuda", seed=11, pile=pile)
        out, bins = splat_kernel.splat_cuda(cfg, *args, debug=True)
        ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
        torch.cuda.synchronize()
        assert float((out - ref).abs().max()) <= sum_bound(cfg, args, ref)
        plan = splat_kernel.bin_plan(cfg, args[0], args[1], args[4])
        for key in ("counts", "offsets", "chunk_offsets"):
            assert torch.equal(bins[key].long(), plan[key]), key
        dense = int((plan["counts"] > splat_kernel.DIRECT).sum())
        assert (dense == 0) == (pile == 0)


@pytest.mark.cuda
def test_cuda_many_tiles_rank_per_warp():
    """More tiles than a bin block counts in shared memory (8-px tiles at
    1080p: 32,400): each warp ranks its slots against the device counts;
    within the bound, with the bins `bin_plan` gives."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=1080, width=1920, tile=8, apron=2,
                                  kernel="gauss", channels=3)
    rng = np.random.default_rng(21)
    n = 30000
    args = (torch.as_tensor(rng.uniform(-4, 1924, n).astype(np.float32),
                            device="cuda"),
            torch.as_tensor(rng.uniform(-4, 1084, n).astype(np.float32),
                            device="cuda"),
            torch.as_tensor(rng.uniform(0, 2, (n, 3)).astype(np.float32),
                            device="cuda"),
            torch.as_tensor(rng.uniform(0.5, 6, n).astype(np.float32),
                            device="cuda"),
            torch.as_tensor(rng.random(n) > 0.1, device="cuda"))
    assert cfg.grid[0] * cfg.grid[1] > 12288
    out, bins = splat_kernel.splat_cuda(cfg, *args, debug=True)
    ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= sum_bound(cfg, args, ref)
    plan = splat_kernel.bin_plan(cfg, args[0], args[1], args[4])
    for key in ("counts", "offsets", "chunk_offsets"):
        assert torch.equal(bins[key].long(), plan[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(96, 128), (32, 385)])
def test_cuda_block_counts_at_the_shared_memory_limit(grid):
    """8-px tiles on a grid of 12,288 tiles, whose counts fill the 48 KB
    of shared memory a bin block may use without opting in, and of
    12,320, one past it (each warp ranks against the device counts): both
    launch and stay within the bound, with the bins `bin_plan` gives."""
    _needs_card()
    gy, gx = grid
    cfg = tiled.TiledRasterConfig(height=8 * gy, width=8 * gx, tile=8,
                                  apron=2, kernel="quad", channels=3)
    rng = np.random.default_rng(22)
    n = 20000
    args = (torch.as_tensor(rng.uniform(0, cfg.width, n).astype(np.float32),
                            device="cuda"),
            torch.as_tensor(rng.uniform(0, cfg.height, n)
                            .astype(np.float32), device="cuda"),
            torch.as_tensor(rng.uniform(0, 2, (n, 3)).astype(np.float32),
                            device="cuda"),
            torch.as_tensor(rng.uniform(0.5, 6, n).astype(np.float32),
                            device="cuda"),
            torch.ones(n, dtype=torch.bool, device="cuda"))
    out, bins = splat_kernel.splat_cuda(cfg, *args, debug=True)
    ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= sum_bound(cfg, args, ref)
    plan = splat_kernel.bin_plan(cfg, args[0], args[1], args[4])
    for key in ("counts", "offsets", "chunk_offsets"):
        assert torch.equal(bins[key].long(), plan[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_cuda_unaligned_rows_flush_whole(channels):
    """An image 203 px wide and an apron of 9 (the model cell's): window
    rows that start and end off the image's 16-byte boundaries, flushed
    partly float by float and partly four at a time, and direct adds at
    both pixel parities; a pile makes windowed tiles beside direct ones.
    Within the bound, and a single particle bit for bit."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=H, width=203, apron=9,
                                  kernel="quad", channels=channels)
    args = cloud(600, "cuda", seed=23, pile=700)
    out = splat_kernel.splat_cuda(cfg, *args)
    ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= sum_bound(cfg, args, ref)
    plan = splat_kernel.bin_plan(cfg, args[0], args[1], args[4])
    assert int(plan["counts"].max()) > splat_kernel.DIRECT
    for i in (3, 4):
        one = tuple(a[i:i + 1] for a in args[:4]) + (
            torch.ones(1, dtype=torch.bool, device="cuda"),)
        a, _ = tiled.rasterize_tiled_reference(cfg, *one)
        assert torch.equal(splat_kernel.splat_cuda(cfg, *one), a)
