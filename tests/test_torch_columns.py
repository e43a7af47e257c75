"""Column-map sampler and ColumnField of the port against the JAX package.

The port's `columns_kernel.sample_maps` computes in float32. The JAX
package rounds the map operand to bf16 on both of its paths: the Pallas
kernel (columns_pallas.py:108, run here in TPU interpret mode) and the XLA
two-stage matmul it falls back to on the CPU (columns.py:329-334, 373).
`bf16_like_xla` reproduces the XLA path's rounding on the port's side, so
a test can separate that rounding from the rest of the arithmetic; other
port test files import it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.sdf import columns as jcols
from illuminant_tpu.sdf import columns_pallas
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.sdf import columns, columns_kernel
from illuminant_tpu_torch.sdf.volume import SdfVolume

torch.set_num_threads(1)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_like_xla(maps, ty, tx, want_grad=False):
    """`columns_kernel.sample_maps_reference` with the operand rounding of
    the JAX package's XLA map sampler (columns._map_core): bf16 maps and
    x-rows contracted into a bf16 x-lerp, then a float32 y-lerp."""
    n_maps, hc, wc = maps.shape
    y0, y1, wy = columns_kernel._taps(ty, hc)
    x0, x1, wx = columns_kernel._taps(tx, wc)
    m = _bf16(maps).reshape(n_maps, hc * wc)
    ax0, ax1 = _bf16(1.0 - wx), _bf16(wx)
    r0 = _bf16(ax0 * m[:, y0 * wc + x0] + ax1 * m[:, y0 * wc + x1])
    r1 = _bf16(ax0 * m[:, y1 * wc + x0] + ax1 * m[:, y1 * wc + x1])
    out = (1.0 - wy) * r0 + wy * r1
    if not want_grad:
        return out
    dx0 = _bf16(m[0, y0 * wc + x1] - m[0, y0 * wc + x0])
    dx1 = _bf16(m[0, y1 * wc + x1] - m[0, y1 * wc + x0])
    gx = (1.0 - wy) * dx0 + wy * dx1
    return torch.cat([out, gx[None], (r1[0] - r0[0])[None]], dim=0)


class sampler_rounding_like_jax:
    """Context manager: the port's plain sampler rounds as bf16_like_xla."""

    def __enter__(self):
        self.prev = columns_kernel.sample_maps_reference
        columns_kernel.sample_maps_reference = bf16_like_xla

    def __exit__(self, *exc):
        columns_kernel.sample_maps_reference = self.prev


def _maps_and_coords(seed, shape=(5, 16, 24), n=3000):
    rng = np.random.default_rng(seed)
    c, hc, wc = shape
    maps = rng.uniform(-3.5, 3.5, shape).astype(np.float32)
    ty = rng.uniform(-2.0, hc + 1.0, n).astype(np.float32)
    tx = rng.uniform(-2.0, wc + 1.0, n).astype(np.float32)
    # Exact edges: negative texel coords, the last texel, past the end.
    edges = np.asarray([-0.5, -3.25, 0.0, hc - 1.0, hc - 0.5, hc + 2.0],
                       np.float32)
    ty[:6] = edges
    tx[:6] = np.asarray([-0.5, wc - 1.0, wc + 3.0, -7.0, 0.25, wc - 1.5],
                        np.float32)
    return maps, ty, tx


@pytest.mark.parametrize("want_grad", [False, True])
def test_sample_maps_plain_matches_pallas_interpret(want_grad):
    from jax.experimental.pallas import tpu as pltpu

    maps, ty, tx = _maps_and_coords(0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(columns_pallas.sample_maps(
            jnp.asarray(maps), jnp.asarray(ty), jnp.asarray(tx),
            want_grad=want_grad))
    out = columns_kernel.sample_maps(torch.as_tensor(maps),
                                     torch.as_tensor(ty),
                                     torch.as_tensor(tx), want_grad)
    assert out.shape == ref.shape == (5 + 2 * want_grad, 3000)
    assert out.dtype == torch.float32
    # The Pallas kernel casts the maps and the y-rows to bf16
    # (columns_pallas.py:59, 108): each tap is off by at most 2^-8 of
    # max|maps|, a lerp or a difference of two taps by twice that.
    atol = 2.0 ** -7 * np.abs(maps).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)


def test_sample_maps_edge_taps():
    """The edge rule of columns_pallas._rows, not a texture clamp:
    t = -0.5 takes texels 0 and 1 at weights 0.5 each; t >= n-1 takes the
    last texel twice and its derivative row is zero."""
    maps = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    ty = torch.tensor([-0.5, 0.0, 2.0, 5.0])
    tx = torch.tensor([0.0, -0.5, 3.0, 9.0])
    out = columns_kernel.sample_maps(maps, ty, tx, want_grad=True)
    m0 = maps[0]
    expect0 = torch.stack([0.5 * m0[0, 0] + 0.5 * m0[1, 0],
                           0.5 * m0[0, 0] + 0.5 * m0[0, 1],
                           m0[2, 3], m0[2, 3]])
    torch.testing.assert_close(out[0], expect0)
    torch.testing.assert_close(out[1], expect0 + 12.0)
    # d/dtx: 1 per texel in x until the last column; d/dty: 4 per row
    # until the last row.
    torch.testing.assert_close(out[2], torch.tensor([1.0, 1.0, 0.0, 0.0]))
    torch.testing.assert_close(out[3], torch.tensor([4.0, 4.0, 0.0, 0.0]))


def test_sample_maps_checks_arguments():
    maps = torch.zeros((5, 4, 4))
    t = torch.zeros(8)
    with pytest.raises(TypeError):
        columns_kernel.sample_maps(maps.double(), t, t)
    with pytest.raises(ValueError):
        columns_kernel.sample_maps(maps, t, t[:4])
    with pytest.raises(ValueError):
        columns_kernel.sample_maps(maps[0], t, t)


def _jax_volume():
    env = jenv.LightingEnvironment()
    env.obstructions += [
        jenv.LightObstruction.box((60.0, 40.0, 24.0), (20.0, 12.0, 24.0)),
        jenv.LightObstruction.ellipsoid((30.0, 50.0, 20.0),
                                        (16.0, 10.0, 20.0)),
        jenv.LightObstruction.cylinder((100.0, 30.0, 26.0),
                                       (10.0, 10.0, 26.0)),
        jenv.LightObstruction.box((110.0, 70.0, 40.0), (12.0, 8.0, 10.0)),
    ]
    cfg = jvol.SdfVolumeConfig(virtual_width=128, virtual_height=96,
                               virtual_depth=64, slice_count=16,
                               resolution_scale=0.5)
    return jvol.generate_volume(cfg, env.pack_obstructions())


@pytest.fixture(scope="module")
def fields():
    vj = _jax_volume()
    cf_j = jax.jit(jcols.build_column_maps)(vj)
    vt = interop.to_torch(SdfVolume, interop.as_numpy_fields(vj))
    return cf_j, columns.build_column_maps(vt)


def test_build_column_maps_matches_jax(fields):
    cf_j, cf_t = fields
    for name in ("flat_d", "h_top", "h_bot", "d_top", "d_bot", "maps_c"):
        a = getattr(cf_t, name).numpy()
        b = np.asarray(getattr(cf_j, name))
        assert a.shape == b.shape, name
        # Same float32 elementwise inversion; the crossing lerps divide, so
        # 1e-4 absolute at heights up to 64.
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
    assert cf_t.maps_c.shape == (5, 24, 32)


def _points(seed, n=4000):
    rng = np.random.default_rng(seed)
    # Inside, around and outside the volume in x, y and z.
    return np.stack([rng.uniform(-10, 138, n), rng.uniform(-10, 106, n),
                     rng.uniform(-8, 72, n)], -1).astype(np.float32)


def test_sample_columns_matches_jax(fields):
    cf_j, cf_t = fields
    p = _points(1)
    ref = np.asarray(jax.jit(jcols.sample_columns)(cf_j, jnp.asarray(p)))
    out = columns.sample_columns(cf_t, torch.as_tensor(p)).numpy()
    # The JAX XLA path rounds the maps to bf16: 2^-7 of the largest map
    # value bounds the distance error (measured 0.25 at max|maps| 72).
    atol = 2.0 ** -7 * float(np.abs(np.asarray(cf_j.maps_c)).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    # With the JAX path's rounding reproduced, the reconstruction tail
    # agrees to float32 rounding.
    with sampler_rounding_like_jax():
        out_r = columns.sample_columns(cf_t, torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(out_r, ref, rtol=1e-5, atol=1e-4)


def test_sample_columns_grad_matches_jax(fields):
    cf_j, cf_t = fields
    p = _points(2)
    dj, gj = jax.jit(jcols.sample_columns_grad)(cf_j, jnp.asarray(p))
    dt, gt = columns.sample_columns_grad(cf_t, torch.as_tensor(p))
    assert gt.shape == (4000, 3)
    atol = 2.0 ** -7 * float(np.abs(np.asarray(cf_j.maps_c)).max())
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=atol)
    # The gradient switches branch (end clamp, cap vs side) on comparisons
    # of those distances, so bf16 rounding flips it on a share of points:
    # hold it to JAX with the JAX rounding reproduced.
    with sampler_rounding_like_jax():
        dr, gr = columns.sample_columns_grad(cf_t, torch.as_tensor(p))
    np.testing.assert_allclose(dr.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(gr.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4)


def test_scene_queries_dispatch_by_shape(fields, monkeypatch):
    """Separable grid queries (the occlusion image) read the exact volume
    through sampling.sample_grid and never the column kernel; scattered
    queries (particles) always go through the kernel's wrapper."""
    from illuminant_tpu.sdf import analytic as janalytic
    from illuminant_tpu_torch.sdf import analytic

    cf_j, cf_t = fields
    calls = []
    real = columns_kernel.sample_maps_reference

    def counting(*a, **k):
        calls.append(a[1].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(columns_kernel, "sample_maps_reference", counting)
    xs = np.linspace(0.5, 127.5, 64, dtype=np.float32)
    ys = np.linspace(0.5, 95.5, 48, dtype=np.float32)
    grid = analytic.scene_sample_p(cf_t, torch.as_tensor(xs)[None, :],
                                   torch.as_tensor(ys)[:, None],
                                   torch.tensor(12.0))
    assert calls == []
    ref = janalytic.scene_sample_p(cf_j, jnp.asarray(xs)[None, :],
                                   jnp.asarray(ys)[:, None],
                                   jnp.float32(12.0))
    # Both exact trilinear on the same float32 volume.
    np.testing.assert_allclose(grid.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)
    p = _points(3, 500)
    analytic.scene_sample_p(cf_t, *(torch.as_tensor(p[:, i])
                                     for i in range(3)))
    assert calls == [500]


def test_scene_normals_match_jax(fields):
    """scene_normal_p on a ColumnField: `fast` is the column
    reconstruction's own normalized gradient (the collision normal), the
    default is the tetrahedral normal of the exact volume."""
    from illuminant_tpu.sdf import analytic as janalytic
    from illuminant_tpu_torch.sdf import analytic

    cf_j, cf_t = fields
    p = _points(4, 2000)
    for fast in (False, True):
        ref = jax.jit(janalytic.scene_normal_p, static_argnames=("fast",))(
            cf_j, *(jnp.asarray(p[:, i]) for i in range(3)), fast=fast)
        with sampler_rounding_like_jax():
            out = analytic.scene_normal_p(
                cf_t, *(torch.as_tensor(p[:, i]) for i in range(3)),
                fast=fast)
        # The fast normal with the JAX sampler rounding reproduced, the
        # tetrahedral one on the same float32 volume: float32 rounding.
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("want_grad", [False, True])
def test_cuda_kernel_matches_plain(want_grad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    maps, ty, tx = _maps_and_coords(5, shape=(5, 135, 240), n=1 << 20)
    dev = torch.device("cuda")
    m, y, x = (torch.as_tensor(a, device=dev) for a in (maps, ty, tx))
    before = columns_kernel.LAUNCHES
    out = columns_kernel.sample_maps(m, y, x, want_grad)
    torch.cuda.synchronize()
    assert columns_kernel.LAUNCHES == before + 1
    ref = columns_kernel.sample_maps_reference(m, y, x, want_grad)
    # Both float32 with the same tap order and, with -fmad=false, the same
    # rounding of every product and sum.
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


# -- the quad pack and the fused query -----------------------------------


def _gather_from_pack(pack, n_maps, ty, tx, want_grad):
    """The kernel's device function (`sample` in csrc/column_maps.cu) in
    plain PyTorch: the four taps read from the record of the low corner
    (y0, x0) of the (Hc, Wc, R) pack, then the lerps of
    sample_maps_reference."""
    hc, wc, _ = pack.shape
    y0, _, wy = columns_kernel._taps(ty, hc)
    x0, _, wx = columns_kernel._taps(tx, wc)
    rec = pack[y0, x0]                           # (N, R): the cell's taps
    v00, v01, v10, v11 = (rec[:, k * n_maps:(k + 1) * n_maps].T
                          for k in range(4))
    col0 = (1.0 - wy) * v00 + wy * v10
    col1 = (1.0 - wy) * v01 + wy * v11
    out = (1.0 - wx) * col0 + wx * col1
    if not want_grad:
        return out
    row0 = (1.0 - wx) * v00[0] + wx * v01[0]
    row1 = (1.0 - wx) * v10[0] + wx * v11[0]
    return torch.cat([out, (col1[0] - col0[0])[None],
                      (row1 - row0)[None]], dim=0)


def _edge_tap_inputs():
    maps = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    return (maps, torch.tensor([-0.5, 0.0, 2.0, 5.0]),
            torch.tensor([0.0, -0.5, 3.0, 9.0]))


@pytest.mark.parametrize("inputs", ["random", "edge_taps"])
@pytest.mark.parametrize("want_grad", [False, True])
def test_gather_from_pack_equals_plain(want_grad, inputs):
    """The pack holds what the kernel reads: a gather from it equals
    sample_maps_reference exactly, at the edges too (the taps of
    test_sample_maps_edge_taps; coordinates before the first and past the
    last texel)."""
    if inputs == "random":
        m, ty, tx = (torch.as_tensor(a) for a in _maps_and_coords(6))
    else:
        m, ty, tx = _edge_tap_inputs()
    pack = columns_kernel.pack_maps(m)
    n_maps, hc, wc = m.shape
    # Four taps of n_maps floats, padded to whole 16-byte vectors.
    assert pack.shape == (hc, wc, -(-4 * n_maps // 4) * 4)
    torch.testing.assert_close(
        _gather_from_pack(pack, n_maps, ty, tx, want_grad),
        columns_kernel.sample_maps_reference(m, ty, tx, want_grad),
        rtol=0, atol=0)


def test_pack_records():
    """A texel's record holds its cell's four taps with the last row and
    column clamped."""
    m, _, _ = _edge_tap_inputs()             # (2, 3, 4)
    quad = columns_kernel.pack_maps(m)
    # Texel (1, 2): taps (1, 2), (1, 3), (2, 2), (2, 3), two maps each.
    assert quad[1, 2].tolist() == [6.0, 18.0, 7.0, 19.0, 10.0, 22.0, 11.0,
                                   23.0]
    # The corner texel (2, 3) repeats itself in every tap.
    assert quad[2, 3].tolist() == [11.0, 23.0] * 4
    # Three maps: 12 floats a record, no padding; five: 20.
    assert columns_kernel.pack_maps(torch.zeros((3, 2, 2))).shape[-1] == 12
    assert columns_kernel.pack_maps(torch.zeros((5, 2, 2))).shape[-1] == 20
    with pytest.raises(ValueError):
        columns_kernel.pack_maps(torch.zeros((9, 2, 2)))


def test_query_reads_strided_and_broadcast_inputs(fields):
    """`columns.query` takes planar x, y, z as the frame passes them (the
    columns of an (N, 4) state, a scalar, a 0-d tensor) and gives what the
    stacked (N, 3) query gives."""
    _, cf_t = fields
    p = torch.as_tensor(_points(7, 600))
    state = torch.cat([p, torch.ones(600, 1)], dim=1)
    d, g = columns.sample_columns_grad(cf_t, p)
    out = columns.query(cf_t, state[:, 0], state[:, 1], state[:, 2],
                        want_grad=True)
    torch.testing.assert_close(out[0], d, rtol=0, atol=0)
    torch.testing.assert_close(torch.stack(out[1:], -1), g, rtol=0, atol=0)
    flat = columns.query(cf_t, p[:, 0], 30.0, torch.tensor(12.0))
    ref = columns.sample_columns(cf_t, torch.stack(
        [p[:, 0], torch.full((600,), 30.0), torch.full((600,), 12.0)], -1))
    torch.testing.assert_close(flat, ref, rtol=0, atol=0)
    # A (rows, 1) x (1, cols) grid broadcasts to (rows, cols).
    grid = columns.query(cf_t, p[:8, 0][None, :], p[:5, 1][:, None],
                         torch.tensor(20.0))
    assert grid.shape == (5, 8)


def test_query_geometry_is_the_plain_constants(fields):
    """The twelve floats the kernel takes are the scalars of the plain
    version: the texel and derivative scales of `_map_coords`, the box of
    `_clamped_axes`, the end-slice heights of `_finish`."""
    _, cf_t = fields
    geom = dict(zip(columns_kernel.QUERY_GEOMETRY,
                    columns.query_geometry(cf_t)))
    c = cf_t.config
    p = torch.as_tensor(_points(8, 16))
    coords = columns._map_coords(cf_t, p[:, 0], p[:, 1], p[:, 2])
    assert (geom["sx_c"], geom["sy_c"]) == coords[5]
    assert (geom["ex"], geom["ey"], geom["ez"]) == (128.0, 96.0, 64.0)
    assert geom["rx"] * c.slice_width == cf_t.maps_c.shape[2]
    assert geom["ry"] * c.slice_height == cf_t.maps_c.shape[1]
    assert (geom["z_lo"], geom["z_hi"]) == (0.0, 60.0)
    tx = (torch.clamp(p[:, 0], 0.0, 128.0) * geom["scale_x"] - 0.5 + 0.5) \
        * geom["rx"] - 0.5
    torch.testing.assert_close(tx, coords[0], rtol=0, atol=0)


def test_query_columns_refuses_cpu_tensors(fields):
    """The fused kernel's launcher takes CUDA tensors only: no silent
    plain path behind it."""
    _, cf_t = fields
    pack = columns_kernel.pack_maps(cf_t.maps_c)
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="no kernel"):
        columns_kernel.query_columns(pack, columns.query_geometry(cf_t), x,
                                     x, x)
