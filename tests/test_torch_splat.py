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
    # The round profile reaches r + 0.5 <= 4: 2 x 5 + 1 taps at most; the
    # 22 rows of 22 pixels of 3 channels (and 4 floats a row) and a batch
    # of 256 particles in 256 x (40 + 8 x 11) bytes.
    assert plan["ints"] == [n, 40, 70, 16, 3, 3, 5, 3,
                            splat_kernel.KERNELS["round"], splat_kernel.CHUNK,
                            256, 11, splat_kernel.DIRECT,
                            splat_kernel.LANES["round"]]
    assert plan["smem_bytes"] == 4 * 22 * (22 * 3 + 4) + 256 * (40 + 8 * 11)
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


def _edge_particles(cfg):
    """Particles on tile edges, at negative coordinates, just inside and
    just outside the on-screen band, off-screen and dead."""
    t, a = cfg.tile, cfg.apron
    xs = [0.0, t - 1e-3, float(t), t + 1e-3, 2.0 * t, -0.5, -a - 0.99,
          -a - 1.0, cfg.width - 1e-3, cfg.width + a + 0.99,
          cfg.width + a + 1.0, 50.0, 50.0, 1e4, -1e4]
    ys = [0.0, float(t), t - 1e-3, 3.0 * t, -3.0, cfg.height + a + 0.5,
          10.0, 10.0, cfg.height - 0.5, 5.0, 5.0, -a - 0.99, 20.0, 20.0,
          20.0]
    live = [True] * 13 + [True, False]
    live[12] = False
    return (torch.tensor(xs, dtype=torch.float32),
            torch.tensor(ys, dtype=torch.float32), torch.tensor(live))


def _direct_bins(cfg, x, y, live):
    """Each slot's tile by a direct loop in Python: the on-screen band
    (-(A + 1), extent + A + 1), the tile by truncation toward zero,
    clipped to the grid."""
    gy, gx = cfg.grid
    a, t = cfg.apron, cfg.tile
    tiles = []
    for xi, yi, li in zip(x.tolist(), y.tolist(), live.tolist()):
        np_x, np_y = np.float32(xi), np.float32(yi)
        on = li and -(a + 1) < np_x < cfg.width + a + 1 and \
            -(a + 1) < np_y < cfg.height + a + 1
        if not on:
            tiles.append(-1)
            continue
        tx = min(max(int(np.float32(np_x / np.float32(t))), 0), gx - 1)
        ty = min(max(int(np.float32(np_y / np.float32(t))), 0), gy - 1)
        tiles.append(ty * gx + tx)
    return tiles


@pytest.mark.parametrize("chunk", [1, 3, 1024])
def test_bin_plan_matches_a_direct_count(chunk):
    """K5's bins (`splat_kernel.bin_plan`, the kernel's plan in PyTorch)
    against a direct count on edge cases and a hot tile: each slot's tile,
    the counts, the offsets, and a chunk table that covers each tile's
    list once in pieces of at most `chunk`."""
    cfg = tiled.TiledRasterConfig(height=70, width=100, tile=16, apron=3)
    ex, ey, el = _edge_particles(cfg)
    rng = np.random.default_rng(8)
    hot = torch.full((80,), 37.5)  # 80 particles in one tile
    x = torch.cat([ex, torch.as_tensor(rng.uniform(-6, 106, 300).astype(
        np.float32)), hot])
    y = torch.cat([ey, torch.as_tensor(rng.uniform(-6, 76, 300).astype(
        np.float32)), hot])
    live = torch.cat([el, torch.as_tensor(rng.random(300) > 0.2),
                      torch.ones(80, dtype=torch.bool)])
    plan = splat_kernel.bin_plan(cfg, x, y, live, chunk)
    want = _direct_bins(cfg, x, y, live)
    assert plan["tile"].tolist() == want
    nt = cfg.grid[0] * cfg.grid[1]
    counts = [sum(1 for t in want if t == k) for k in range(nt)]
    assert plan["counts"].tolist() == counts
    assert plan["offsets"].tolist() == [sum(counts[:k])
                                        for k in range(nt + 1)]
    per = [-(-c // chunk) for c in counts]
    assert plan["chunk_offsets"].tolist() == [sum(per[:k])
                                              for k in range(nt + 1)]
    covered = [0] * int(plan["offsets"][-1])
    for tile, first, end in plan["chunks"].tolist():
        assert plan["offsets"][tile] <= first < end <= \
            plan["offsets"][tile + 1] and end - first <= chunk
        for e in range(first, end):
            covered[e] += 1
    assert covered == [1] * len(covered)
    hot_tile = want[-1]
    assert counts[hot_tile] >= 80
    if chunk < 80:
        assert per[hot_tile] >= 2  # the hot tile splits over blocks
    assert want[:15].count(-1) == 5  # off the band, off-screen, dead


@pytest.mark.parametrize("chunk", [2, 64])
@pytest.mark.parametrize("kernel", KERNELS)
def test_binned_accumulation_matches_plain(kernel, chunk):
    """K5's accumulation in PyTorch (`splat_binned_reference`: particles in
    tile order, each chunk in its tile's window, windows added) against
    the plain splat, within the reordering bound n_max x 2^-23 x max, on
    a cloud with a hot tile split into chunks and partial edge tiles."""
    from test_torch_splat_cuda import cloud, config, sum_bound

    cfg = config(kernel, channels=3, tile=16, apron=3)
    args = cloud(1500, "cpu", seed=5, pile=300)
    ref, _ = tiled.rasterize_tiled_reference(cfg, *args)
    out = splat_kernel.splat_binned_reference(cfg, *args, chunk=chunk)
    assert out.shape == ref.shape
    err = float((out - ref).abs().max())
    assert err <= sum_bound(cfg, args, ref), err
    # One particle a call: a single term a pixel, bit for bit.
    one = tuple(a[7:8] for a in args[:2]) + (args[2][7:8], args[3][7:8],
                                             torch.tensor([True]))
    a, _ = tiled.rasterize_tiled_reference(cfg, *one)
    assert torch.equal(
        splat_kernel.splat_binned_reference(cfg, *one, chunk=chunk), a)


@pytest.mark.parametrize("kernel,apron,chunk", [
    ("gauss", 4, 256), ("quad", 4, 256), ("quad", 9, 128),
    ("gauss", 9, 64)])
def test_chunk_holds_at_most_two_batches(kernel, apron, chunk):
    """A chunk holds CHUNK particles, or two batches where a batch is
    smaller (the wide aprons' profiles fill a block's shared memory
    sooner), and the launch plan and the bins use that chunk."""
    cfg = tiled.TiledRasterConfig(height=1080, width=1920, apron=apron,
                                  kernel=kernel)
    assert splat_kernel.chunk_size(cfg) == chunk == min(
        splat_kernel.CHUNK, 2 * splat_kernel.batch_size(cfg))
    n = 1000
    x = torch.zeros(n)
    plan = splat_kernel.launch_plan(cfg, x, x, torch.zeros(n, 4), x,
                                    torch.ones(n, dtype=torch.bool))
    assert plan["chunk"] == plan["ints"][9] == chunk
    assert plan["blocks"] == -(-n // chunk) + 34 * 60
    bins = splat_kernel.bin_plan(cfg, x + 5.0, x + 5.0,
                                 torch.ones(n, dtype=torch.bool))
    assert int(bins["chunk_offsets"][-1]) == -(-n // chunk)


def test_launch_plan_sizes_scratch_from_n_and_the_grid(monkeypatch):
    """The scratch and the accumulation's grid come from n and the grid
    alone: bins tiles + 2 (tiles + 1) and the chunk table, slots 2n,
    records 8n,
    ceil(n / chunk) + tiles blocks; the batch from what a block's shared
    memory holds."""
    n = 1000
    x = torch.zeros(n)
    live = torch.zeros(n, dtype=torch.bool)
    cfg = tiled.TiledRasterConfig(height=1080, width=1920)
    plan = splat_kernel.launch_plan(cfg, x, x, torch.zeros(n, 4), x, live)
    assert plan["tiles"] == 34 * 60
    assert plan["scratch"] == dict(bins=2040 + 2 * (2040 + 1) + 4 + 2040,
                                   slots=2 * n, records=8 * n)
    assert plan["blocks"] == 4 + 2040
    # gauss at apron 4 reaches 2 x 4.5: profiles of 2 x 10 + 1 taps; the
    # window (40 rows of 40 x 4 + 4 floats) and 128 particles' headers and
    # profiles in a block's shared memory.
    assert (plan["batch"], plan["taps"]) == (128, 21)
    assert plan["smem_bytes"] == 4 * 40 * 164 + 128 * (40 + 8 * 21)
    assert plan["smem_bytes"] <= splat_kernel.BATCH_SMEM_BYTES
    # An apron of 9 (the sprite cells'): 41-tap profiles, batches of 32.
    wide = tiled.TiledRasterConfig(height=1080, width=1920, apron=9)
    assert (splat_kernel.batch_size(wide),
            splat_kernel.profile_taps(wide)) == (32, 41)
    monkeypatch.setattr(splat_kernel, "CHUNK", 0)
    with pytest.raises(ValueError, match="CHUNK"):
        splat_kernel.launch_plan(wide, x, x, torch.zeros(n, 4), x, live)


@pytest.mark.parametrize("kernel", KERNELS)
def test_profile_taps_bound_every_footprint(kernel):
    """The profile scratch a particle gets (`profile_taps`, computed on the
    host) holds the widest clipped footprint: 2 `support_taps` + 1 taps
    at the largest radius (apron + 0.5), at most the window's side."""
    for apron in (0, 1, 3, 4, 9):
        cfg = tiled.TiledRasterConfig(height=64, width=64, apron=apron,
                                      kernel=kernel)
        radius = torch.linspace(0.5, apron + 0.5, 50)
        k = int(splat_kernel.support_taps(kernel, radius).max())
        assert splat_kernel.profile_taps(cfg) == min(32 + 2 * apron,
                                                     2 * k + 1)


def test_launch_plan_reads_nothing_back():
    """The plan is sized on the host from the shapes and the config: no
    tensor is read back (an `item` on the card would drain the queue)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                Reads.n += 1
            return func(*args, **(kwargs or {}))

    n = 300
    pos = torch.rand(n, 4)
    cfg = tiled.TiledRasterConfig(height=50, width=70, kernel="gauss",
                                  channels=3)
    with Reads():
        plan = splat_kernel.launch_plan(cfg, pos[:, 0], pos[:, 1],
                                        torch.rand(n, 4), torch.rand(n),
                                        torch.rand(n) > 0.5)
    assert Reads.n == 0 and plan["n"] == n
