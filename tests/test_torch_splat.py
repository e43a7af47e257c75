"""The additive splat's stipple against the JAX package, and K5's launch
plan and support on the CPU.

`rasterize_tiled(stipple_factor=)` masks `live` with StippleReject's
golden-ratio fraction before the splat, as the JAX package's
`rasterize_tiled` does (tiled.py:589-612). K5 (csrc/splat.cu, held to
the plain splat on the card by tests/test_torch_splat_cuda.py) walks
each particle's own support, `splat_kernel.support_taps`, where the
plain version walks the call's largest: every nonzero tap of the plain
version must lie inside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.raster import tiled as jtiled
from illuminant_tpu_torch.ops.coords import stipple_keep
from illuminant_tpu_torch.raster import splat_kernel, tiled
from test_torch_raster import _particles, _rel

torch.set_num_threads(1)

KERNELS = ["point", "quad", "gauss", "round"]


@pytest.mark.parametrize("factor", [0.25, 0.6])
def test_stipple_matches_jax(factor):
    """The stippled splat against the JAX one with float colours, under
    test_round_matches_jax_parity_preset's bounds (bf16 payload and
    coverage on the JAX side)."""
    h, w = 64, 96
    kw = dict(height=h, width=w, tile=32, bin_capacity=256, apron=4,
              kernel="round", rgba8_colors=False, channels=3,
              slots_per_row=16, stipple_offset=0.3)
    parts = _particles(400, h, w, seed=21)
    ref, diag = jtiled.rasterize_tiled_jit(
        jtiled.TiledRasterConfig(**kw), *(jnp.asarray(a) for a in parts),
        stipple_factor=factor)
    cfg = tiled.TiledRasterConfig(height=h, width=w, tile=32, apron=4,
                                  kernel="round", channels=3,
                                  stipple_offset=0.3)
    out, tdiag = tiled.rasterize_tiled(
        cfg, *(torch.as_tensor(a) for a in parts), stipple_factor=factor)
    out, ref = out.numpy().astype(np.float64), np.asarray(ref, np.float64)
    assert int(diag["dropped"]) == 0 and tdiag["dropped"] == 0
    assert _rel(out, ref, 0.25) < 0.08
    assert abs(out.sum() - ref.sum()) / ref.sum() < 0.01
    # The stipple is the live mask: the same as splatting the kept slots.
    x, y, color, size, live = (torch.as_tensor(a) for a in parts)
    keep = stipple_keep(x.shape[0], factor, 0.3)
    masked, _ = tiled.rasterize_tiled(cfg, x, y, color, size, live & keep)
    assert np.array_equal(masked.numpy(), out.astype(np.float32))
    full, _ = tiled.rasterize_tiled(cfg, x, y, color, size, live)
    assert full.sum() > masked.sum()


def test_stipple_factor_one_keeps_every_particle():
    parts = [torch.as_tensor(a) for a in _particles(300, 48, 64, seed=5)]
    cfg = tiled.TiledRasterConfig(height=48, width=64)
    a, _ = tiled.rasterize_tiled(cfg, *parts)
    b, _ = tiled.rasterize_tiled(cfg, *parts, stipple_factor=1.0)
    c, _ = tiled.rasterize_tiled(cfg, *parts,
                                 stipple_factor=torch.tensor(1.0))
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("kernel", KERNELS)
def test_support_taps_cover_every_nonzero_tap(kernel):
    """For radii across the clamp [0.5, apron + 0.5] and sub-pixel
    positions, every tap whose profile is nonzero lies within
    `support_taps` of the particle's floor."""
    rng = np.random.default_rng(3)
    radius = torch.as_tensor(np.concatenate([
        rng.uniform(0.5, 9.5, 2000), [0.5, 1.0, 4.5, 9.5]]).astype(
            np.float32))
    p = torch.as_tensor(rng.uniform(0, 1, radius.shape[0]).astype(
        np.float32)) + 40.0
    k = splat_kernel.support_taps(kernel, radius)
    off = torch.arange(-14, 15)
    pix = torch.floor(p).to(torch.int64)[:, None] + off
    w = tiled._profile(kernel, pix.to(torch.float32) + 0.5 - p[:, None],
                       radius[:, None])
    assert bool(((w != 0) <= (off.abs()[None] <= k[:, None])).all())
    # And never wider than the plain version's k for the same radius.
    for r in (0.5, 3.0, 9.5):
        plain_k = int(np.ceil(tiled._support(kernel, r))) + 1
        assert int(splat_kernel.support_taps(
            kernel, torch.tensor([r]))[0]) <= plain_k


def test_launch_plan():
    """The plan reads strided views in place: a column of an (N, 4)
    state, an (N, 4) colour for 3 channels; its ints are the config's."""
    n = 50
    pos = torch.rand(n, 4)
    color = torch.rand(n, 4)
    size = torch.rand(n)
    live = torch.rand(n) > 0.5
    cfg = tiled.TiledRasterConfig(height=40, width=70, tile=16, apron=3,
                                  kernel="round", channels=3)
    plan = splat_kernel.launch_plan(cfg, pos[:, 0], pos[:, 1], color, size,
                                    live)
    assert plan["strides"] == [4, 4, 1, 1, 4, 1]
    assert plan["ints"] == [n, 40, 70, 16, 3, 3, 5, 3,
                            splat_kernel.KERNELS["round"]]
    with pytest.raises(ValueError, match="color"):
        splat_kernel.launch_plan(cfg, pos[:, 0], pos[:, 1], color[:, :2],
                                 size, live)
    with pytest.raises(ValueError, match="live"):
        splat_kernel.launch_plan(cfg, pos[:, 0], pos[:, 1], color, size,
                                 live.float())
    with pytest.raises(ValueError, match="no kernel"):
        splat_kernel.splat_cuda(cfg, pos[:, 0], pos[:, 1], color, size,
                                live)


def test_splat_terms_counts_the_nonzero_footprint():
    """`splat_terms` of one interior particle is its footprint: the taps
    whose row and column profiles are both nonzero."""
    cfg = tiled.TiledRasterConfig(height=40, width=40, kernel="gauss")
    x = torch.tensor([20.3, 5.0])
    y = torch.tensor([18.7, 5.0])
    size = torch.tensor([3.0, 2.0])
    live = torch.tensor([True, False])
    count = tiled.splat_terms(cfg, x, y, size, live)
    img, _ = tiled.rasterize_tiled(cfg, x, y, torch.ones(2, 4), size, live)
    assert torch.equal(count > 0, img[..., 0] > 0)
    assert int(count.max()) == 1
    both = tiled.splat_terms(cfg, x, y, size, torch.ones(2, dtype=bool))
    assert int(both.sum()) > int(count.sum())
