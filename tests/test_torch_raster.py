"""Particle raster, histogram and tonemap of the port against the JAX
package and the port's exact scatter oracle (itself held to the JAX
package's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.ops import tonemap as jtm
from illuminant_tpu.particles.state import ParticleState as JState
from illuminant_tpu.raster import tiled as jtiled
from illuminant_tpu.raster.particles import rasterize_additive
from illuminant_tpu.utils import histogram as jhist
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.ops import tonemap as tm
from illuminant_tpu_torch.particles.state import ParticleState
from illuminant_tpu_torch.raster import particles, tiled
from illuminant_tpu_torch.utils import histogram as hist

torch.set_num_threads(1)


def _particles(n, h, w, seed, hdr=2.0, sizes=(1.0, 7.0)):
    # tests/test_tiled_raster.py:_random_particles: positions on the JAX
    # payload's 1/16-px grid, some dead, some off screen by up to 2 px.
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-2, w + 2, n) * 16.0).astype(np.float32) / 16
    y = np.round(rng.uniform(-2, h + 2, n) * 16.0).astype(np.float32) / 16
    color = rng.uniform(0.0, hdr, (n, 4)).astype(np.float32)
    size = rng.uniform(*sizes, n).astype(np.float32)
    live = rng.uniform(size=n) > 0.1
    return x, y, color, size, live


def _both(cfg_kw, parts):
    x, y, color, size, live = parts
    ref, diag = jtiled.rasterize_tiled_jit(
        jtiled.TiledRasterConfig(**cfg_kw), *(jnp.asarray(a) for a in parts))
    # The port's config takes the fields its direct splat reads.
    port_kw = {k: v for k, v in cfg_kw.items()
               if k in ("height", "width", "tile", "apron", "kernel",
                        "channels")}
    out, tdiag = tiled.rasterize_tiled(
        tiled.TiledRasterConfig(**port_kw), *(torch.as_tensor(a)
                                              for a in parts))
    assert int(diag["dropped"]) == 0 and tdiag["dropped"] == 0
    return out.numpy().astype(np.float64), np.asarray(ref, np.float64)


def _rel(a, b, floor):
    return (np.abs(a - b) / np.maximum(np.abs(b), floor)).max()


def _numpy_oracle(kernel, h, w, tile, apron, channels, parts):
    """Separable-profile splat in float64 (test_tiled_raster.py's
    _oracle_additive), cut to each particle's tile window: the pixels
    [t * tile - apron, (t + 1) * tile + apron) of its tile t on each axis,
    the footprint the JAX tiled raster renders."""
    x, y, color, size, live = parts
    img = np.zeros((h, w, channels))
    ys, xs = np.arange(h), np.arange(w)
    prof = tiled._profile

    def axis(p, pix, extent):
        t = min(max(int(p / tile), 0), -(-extent // tile) - 1)
        wgt = prof(kernel, torch.as_tensor(pix + 0.5 - p), r).numpy()
        return np.where((pix >= t * tile - apron)
                        & (pix < (t + 1) * tile + apron), wgt, 0.0)

    for i in np.flatnonzero(live):
        r = torch.tensor(float(np.clip(size[i] * 0.5, 0.5, apron + 0.5)),
                         dtype=torch.float64)
        wy, wx = axis(float(y[i]), ys, h), axis(float(x[i]), xs, w)
        img += (wy[:, None] * wx[None, :])[..., None] * color[i, :channels]
    return img


@pytest.mark.parametrize("kernel", ["gauss", "round", "quad"])
def test_direct_splat_is_the_separable_profile(kernel):
    """The port's splat is exactly the sum of the separable profiles over
    the tile windows; float32 accumulation against a float64 sum."""
    h, w = 64, 96
    parts = _particles(600, h, w, seed=1)
    cfg = tiled.TiledRasterConfig(height=h, width=w, kernel=kernel,
                                  channels=4)
    out, _ = tiled.rasterize_tiled(cfg, *(torch.as_tensor(a)
                                          for a in parts))
    oracle = _numpy_oracle(kernel, h, w, cfg.tile, cfg.apron, 4, parts)
    assert _rel(out.numpy(), oracle, 0.25) < 1e-4


def test_quad_matches_exact_scatter_oracle():
    """The quad kernel against the port's raster/particles.py:
    rasterize_additive with rounding off (per-texel box coverage, a
    9-texel fan so no size clamps); that oracle against the JAX
    package's."""
    h, w, n = 64, 96, 400
    x, y, color, size, live = _particles(n, h, w, seed=2)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0], pos[:, 1] = x, y
    pos[:, 3] = np.where(live, 1.0, 0.0)
    rdata = np.zeros((n, 4), np.float32)
    rdata[:, 0] = size
    z = np.zeros((n, 4), np.float32)
    fields = dict(position=pos, velocity=z, color=z, render_color=color,
                  render_data=rdata, write_cursor=np.asarray(0, np.int32),
                  total_spawned=np.asarray(0, np.int32))
    oracle = particles.rasterize_additive(
        interop.to_torch(ParticleState, fields), h, w, footprint=9,
        rounded=False).numpy().astype(np.float64)
    reference = rasterize_additive(
        JState(**{k: jnp.asarray(v) for k, v in fields.items()}), h, w,
        footprint=9, rounded=False)
    # The same coverage scattered by index_add_ and by XLA: float32
    # summation order.
    np.testing.assert_allclose(oracle, np.asarray(reference), rtol=1e-5,
                               atol=1e-5)
    cfg = tiled.TiledRasterConfig(height=h, width=w, kernel="quad",
                                  channels=4)
    out, _ = tiled.rasterize_tiled(cfg, *(torch.as_tensor(a)
                                          for a in (x, y, color, size, live)))
    # Same box coverage; the oracle scatters in another order.
    np.testing.assert_allclose(out.numpy(), oracle, rtol=1e-5, atol=1e-4)


def test_gauss_matches_jax_rgba8():
    h, w = 96, 64
    kw = dict(height=h, width=w, tile=32, bin_capacity=1024, apron=4,
              kernel="gauss", rgba8_colors=True, color_scale=2.0)
    out, ref = _both(kw, _particles(1500, h, w, seed=3))
    # test_tiled_raster.py::test_additive_matches_oracle_gauss_rgba8's
    # bounds: the JAX side quantizes colours to rgba8 (2/255 a particle)
    # and the coverage to bf16; the port is float32 (measured 0.015 and
    # 0.12%).
    assert _rel(out, ref, 0.5) < 0.12
    assert abs(out.sum() - ref.sum()) / ref.sum() < 0.02


def test_gauss_matches_jax_flagship_preset():
    """The flagship's fast raster preset: compact payload (1/8-px
    positions, 8-bit log sizes, rgb888 colours) and the int8 splat."""
    h, w = 96, 160
    kw = dict(height=h, width=w, tile=32, bin_capacity=1016, apron=4,
              kernel="gauss", rgba8_colors=True, color_scale=4.0,
              channels=3, slots_per_row=16, compact_payload=True,
              int8_splat=True)
    x, y, color, size, live = _particles(2000, h, w, seed=4, hdr=0.9,
                                         sizes=(1.0, 3.0))
    out, ref = _both(kw, (x, y, color, size, live))
    assert out.shape == ref.shape == (h, w, 3)
    # test_tiled_raster.py::test_compact_payload_matches_full's bounds:
    # the compact payload moves positions by up to 1/16 px and sizes by
    # a log step, on top of the int8 coverage and colour steps (measured
    # 0.7% and 0.995).
    assert abs(out.sum() - ref.sum()) / ref.sum() < 0.08
    corr = np.corrcoef(out.reshape(-1), ref.reshape(-1))[0, 1]
    assert corr > 0.99, corr


def test_round_matches_jax_parity_preset():
    h, w = 64, 96
    kw = dict(height=h, width=w, tile=32, bin_capacity=256, apron=4,
              kernel="round", rgba8_colors=False, channels=3,
              slots_per_row=16)
    out, ref = _both(kw, _particles(400, h, w, seed=11))
    # test_tiled_raster.py::test_additive_matches_oracle_quad's bounds: bf16
    # payload and coverage on the JAX side (measured 0.039 and 0.015%).
    assert _rel(out, ref, 0.25) < 0.08
    assert abs(out.sum() - ref.sum()) / ref.sum() < 0.01


def test_histogram_percentile_tonemap_match_jax():
    rng = np.random.default_rng(5)
    img = np.exp(rng.normal(-1.0, 1.5, (48, 80, 3))).astype(np.float32)
    img[:3] = 0.0
    img[-2:] = 200.0  # past the last bucket
    # The frame feeds the histogram a bf16 image (scenes.py:847).
    img_b = torch.as_tensor(img).to(torch.bfloat16)
    img_j = jnp.asarray(img).astype(jnp.bfloat16)
    bounds = hist.bucket_boundaries(max_value=64.0)
    np.testing.assert_array_equal(bounds,
                                  jhist.bucket_boundaries(max_value=64.0))
    for ignore in (False, True):
        hr = hist.compute_histogram(img_b, bounds, ignore_zeroes=ignore)
        hj = jhist.compute_histogram(img_j, jnp.asarray(bounds),
                                     ignore_zeroes=ignore)
        # Integer counts: the JAX bf16 one-hot sums in float32, exact.
        # The luma of a pixel sitting on a bucket edge can round across it
        # (another summation order): at most a handful of moves.
        dc = np.abs(hr.counts.numpy() - np.asarray(hj.counts))
        assert dc.sum() <= 4, dc.sum()
        assert int(hr.sample_count) == int(hj.sample_count)
        for f in ("min", "max", "mean"):
            np.testing.assert_allclose(float(getattr(hr, f)),
                                       float(getattr(hj, f)), rtol=1e-5)
        for pct in (5.0, 50.0, 95.0, 99.9):
            np.testing.assert_allclose(float(hist.percentile(hr, pct)),
                                       float(jhist.percentile(hj, pct)),
                                       rtol=1e-3)
    # Non-log boundaries take the search path.
    odd = np.asarray([0.1, 0.5, 1.0, 4.0, 1e3], np.float32)
    np.testing.assert_array_equal(
        hist.compute_histogram(img_b, odd).counts.numpy(),
        np.asarray(jhist.compute_histogram(img_j, jnp.asarray(odd)).counts))
    v = np.linspace(0.0, 12.0, 997, dtype=np.float32)
    np.testing.assert_allclose(
        tm.uncharted2_tonemap(torch.as_tensor(v)).numpy(),
        np.asarray(jtm.uncharted2_tonemap(jnp.asarray(v))), rtol=1e-6,
        atol=1e-7)
