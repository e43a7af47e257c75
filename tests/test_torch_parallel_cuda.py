"""The row-banded raster (parallel/raster.py) on the card: K5 on band
grids, and the mesh of one rank on NCCL.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Here, without a card, the `cuda` cases skip and the CPU case checks that
the inputs reach every band edge.

K5 on a band's grid sees what the unsharded splat never does: a height of
up to band_tiles + 2 tiles that need not be the frame's, y shifted by
whole tiles, and D x B received slots, most of them empty. Each band is
held to its plain version on the same band inputs, and the stitched bands
to the unsharded K5 image, within the reordered-sum bound of
tests/test_torch_splat_cuda.py (n x 2^-23 x the image's largest value).
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.parallel import mesh as pmesh
from illuminant_tpu_torch.parallel import raster as praster
from illuminant_tpu_torch.raster import splat_kernel, tiled

# (height, width): a short last band, fewer tile rows than ranks, one
# tile row a band at D = 4.
FRAMES = [(200, 160), (64, 96), (128, 64)]


def cloud(n, h, w, device, seed=0):
    """n particles over the frame and up to 8 px past it, 10% dead, a
    pile on one spot near a band seam."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-8, w + 8, n).astype(np.float32)
    y = rng.uniform(-8, h + 8, n).astype(np.float32)
    x[:n // 8] = rng.normal(w / 2, 3.0, n // 8)
    y[:n // 8] = rng.normal(min(64.0, h / 2), 3.0, n // 8)
    color = rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32)
    size = rng.uniform(1.0, 9.0, n).astype(np.float32)
    live = rng.uniform(size=n) > 0.1
    return [torch.as_tensor(a, device=device)
            for a in (x, y, color, size, live)]


def bands(cfg, d, args):
    """Every rank's route, the exchange as a transpose, every band."""
    x = args[0]
    n_loc = x.shape[0] // d
    budget = praster.send_budget(cfg, d, n_loc, float(d))
    sends = torch.stack([praster.route(
        cfg, d, *(a[r * n_loc:(r + 1) * n_loc] for a in args), budget)[0]
        for r in range(d)])
    recv = sends.transpose(0, 1).reshape(d, d * budget, 8)
    return recv, [praster.raster_band(cfg, d, r, recv[r]) for r in range(d)]


def bound(cfg, args, img):
    x, y, _, size, live = args
    n = int(tiled.splat_terms(cfg, x, y, size, live).max())
    return max(n, 1) * 2.0 ** -23 * float(img.abs().max())


def test_inputs_reach_every_band_edge():
    """On the CPU: particles above and below the frame, a rank with no
    rows, a particle with three owners."""
    cfg = tiled.TiledRasterConfig(height=128, width=64, channels=3)
    args = cloud(4096, 128, 64, "cpu")
    assert float(args[1].min()) < -4 and float(args[1].max()) > 132
    small = tiled.TiledRasterConfig(height=64, width=96)
    assert pmesh.band_rows(small, 4, 3) == (64, 64)
    lanes, counts, _ = praster.route(cfg, 4, *args, 4096 * 3)
    assert int(counts.sum()) > int((args[4]).sum())  # some go to 2-3 owners


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gauss", "round", "quad"])
@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("d", [2, 4, 8])
def test_cuda_bands_match_plain(d, frame, kernel):
    _needs_card()
    h, w = frame
    cfg = tiled.TiledRasterConfig(height=h, width=w, kernel=kernel,
                                  channels=3)
    args = cloud(4096, h, w, "cuda", seed=d)
    before = cuda_build.launches()["k5_splat"]
    recv, out = bands(cfg, d, args)
    torch.cuda.synchronize()
    with_rows = sum(1 for b in out if b.shape[0])
    assert cuda_build.launches()["k5_splat"] - before == \
        splat_kernel.LAUNCHES_PER_SPLAT * with_rows
    for r in range(d):
        if not out[r].shape[0]:
            continue
        row_lo, local = praster.band_grid(cfg, d, r)
        row0, row1 = pmesh.band_rows(cfg, d, r)
        local_args = [recv[r, :, 0], recv[r, :, 1] - float(row_lo),
                      recv[r, :, 4:8], recv[r, :, 2], recv[r, :, 3] > 0.5]
        ref, _ = tiled.rasterize_tiled_reference(
            local, *(a.cpu() for a in local_args))
        ref = ref[row0 - row_lo:row1 - row_lo]
        got = out[r].cpu()
        assert float((got - ref).abs().max()) <= bound(
            local, [a.cpu() for a in local_args], ref)
    whole, _ = tiled.rasterize_tiled(cfg, *args)
    stitched = torch.cat(out)
    assert stitched.shape == whole.shape
    assert float((stitched - whole).abs().max()) <= bound(
        cfg, [a.cpu() for a in args], whole.cpu())


def _frame_on_the_card(mesh):
    """A small mesh frame on the card: (backend, band, avg_lum)."""
    import torch.distributed as dist

    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(mesh=mesh, height=96, width=160, capacity=4096,
                           spawn_max=256, n_lights=2, spawn_sub_rings=1)
    state = pmesh.shard_particles(scene.system.state, mesh)
    band, state, avg, dropped = scene.frame(
        state, 0.5, torch.Generator(device=scene.device).manual_seed(0),
        scene.volume, scene.gbuffer, scene.sphere_lights,
        scene.environment.uniforms(device=scene.device), 256)
    return dist.get_backend(), band.cpu(), float(avg), int(dropped)


@pytest.mark.cuda
def test_cuda_mesh_of_one_runs_on_nccl():
    """make_mesh on the card is NCCL (a rank process of its own); the
    frame's band is the whole frame at D = 1."""
    _needs_card()
    (backend, band, avg, dropped), = pmesh.spawn_ranks(_frame_on_the_card,
                                                       1, device="cuda")
    assert backend == "nccl"
    assert band.shape == (96, 160, 3) and band.dtype == torch.uint8
    assert np.isfinite(avg) and dropped == 0
