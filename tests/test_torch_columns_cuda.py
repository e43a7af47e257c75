"""The column-map kernels on the card against their plain versions.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_columns_cuda.py

(`tests/conftest.py` configures jax; `--noconftest` leaves it out). Here,
without a card, the `cuda` cases skip and the CPU case checks that the
points reach every branch the kernel has.
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.lighting import environment as env_t
from illuminant_tpu_torch.sdf import columns, columns_kernel
from illuminant_tpu_torch.sdf import volume as vol

# The test volume of tests/test_torch_columns.py: 128 x 96 x 64 world
# units, 16 slices, fine maps (48, 64), coarse maps (5, 24, 32).
BOX = (128.0, 96.0, 64.0)
Z_HI = 60.0  # the last slice's z: (16 - 1) * 4


def _field(device, max_valid_z=None):
    """The port's ColumnField of the test volume on `device`, optionally
    with a lower max_valid_z, which the column query must ignore."""
    e = env_t.LightingEnvironment()
    L = env_t.LightObstruction
    e.obstructions += [
        L.box((60.0, 40.0, 24.0), (20.0, 12.0, 24.0)),
        L.ellipsoid((30.0, 50.0, 20.0), (16.0, 10.0, 20.0)),
        L.cylinder((100.0, 30.0, 26.0), (10.0, 10.0, 26.0)),
        L.box((110.0, 70.0, 40.0), (12.0, 8.0, 10.0)),
    ]
    cfg = vol.SdfVolumeConfig(virtual_width=128, virtual_height=96,
                              virtual_depth=64, slice_count=16,
                              resolution_scale=0.5)
    v = vol.generate_volume(cfg, e.pack_obstructions(device=device))
    if max_valid_z is not None:
        v = v.replace(max_valid_z=torch.tensor(max_valid_z, device=device))
    return columns.build_column_maps(v)


def _edge_points(field):
    """(N, 3) float32: points outside the volume on each side and on its
    faces, on every coarse texel edge, between max_valid_z and the box top
    and at the end slices, then a random cloud around the volume."""
    c = field.config
    _, hc, wc = field.maps_c.shape
    mid = np.asarray([64.0, 48.0, 20.0], np.float32)
    pts = []
    for axis, extent in enumerate(BOX):
        for v in (-6.0, extent + 6.0, 0.0, extent, extent / 2.0):
            p = mid.copy()
            p[axis] = v
            pts.append(p)
    # Coarse texel edges: t_c = x * scale_x * rx - 0.5 is an integer.
    sx = c.scale_x * wc / c.slice_width
    sy = c.scale_y * hc / c.slice_height
    pts += [[(k + 0.5) / sx, 40.0, 12.0] for k in range(-1, wc + 1)]
    pts += [[60.0, (k + 0.5) / sy, 30.0] for k in range(-1, hc + 1)]
    pts += [[x, y, z] for z in (45.0, 55.0, Z_HI, 62.0, 0.0)
            for x, y in ((64.0, 40.0), (30.0, 50.0))]
    rng = np.random.default_rng(9)
    cloud = np.stack([rng.uniform(-10, 138, 20000),
                      rng.uniform(-10, 106, 20000),
                      rng.uniform(-8, 72, 20000)], -1)
    return np.concatenate([np.asarray(pts), cloud]).astype(np.float32)


def test_edge_points_reach_every_branch():
    """On the CPU: the points hold each out-of-box side, points above
    max_valid_z inside the box, and end-slice clamp wins at both ends, so
    the card's comparison covers those branches."""
    field = _field("cpu", max_valid_z=40.0)
    p = torch.as_tensor(_edge_points(field))
    for axis, extent in enumerate(BOX):
        assert (p[:, axis] < 0).any() and (p[:, axis] > extent).any()
    assert ((p[:, 2] > 40.0) & (p[:, 2] < BOX[2])).any()
    coords = columns._map_coords(field, p[:, 0], p[:, 1], p[:, 2])
    m = columns_kernel.sample_maps_reference(field.maps_c, coords[1],
                                             coords[0])
    pzc = torch.clamp(p[:, 2] - coords[3][2], 0.0, Z_HI)
    d = columns._reconstruct(m[0], m[1], m[2], pzc, False)
    lip_top, lip_bot = m[3] + (Z_HI - pzc), m[4] + pzc
    clamped = torch.minimum(lip_top, lip_bot) < d
    assert (clamped & (lip_top <= lip_bot)).any()
    assert (clamped & (lip_top > lip_bot)).any()
    # The query's result does not read max_valid_z.
    torch.testing.assert_close(
        columns.query(field, p[:, 0], p[:, 1], p[:, 2]),
        columns.query(_field("cpu"), p[:, 0], p[:, 1], p[:, 2]),
        rtol=0, atol=0)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["distance", "gradient", "normal"])
def test_cuda_fused_query_matches_plain(mode):
    """The fused query kernel against its plain version on the card, at
    the edges of every branch. Tolerance: the source is compiled with
    -fmad=false, so every product and sum rounds as PyTorch rounds it,
    and sqrt and division are IEEE on both sides: 1e-5 of max(1,
    max|maps|) on the distance, 1e-5 on the gradient."""
    _needs_card()
    field = _field("cuda", max_valid_z=40.0)
    p = torch.as_tensor(_edge_points(field), device="cuda")
    want_grad = mode != "distance"
    normalize = mode == "normal"
    before = columns_kernel.QUERY_LAUNCHES
    out = columns.query(field, p[:, 0], p[:, 1], p[:, 2], want_grad,
                        normalize)
    torch.cuda.synchronize()
    assert columns_kernel.QUERY_LAUNCHES == before + 1
    ref = columns.query_reference(field, p[:, 0], p[:, 1], p[:, 2],
                                  want_grad, normalize)
    out, ref = (out, ref) if want_grad else ((out,), (ref,))
    tol_d = 1e-5 * max(1.0, float(field.maps_c.abs().max()))
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=tol_d)
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_pack_and_sample_match_plain():
    """The pack kernel equals its plain version exactly, and sample_maps
    matches sample_maps_reference at the flagship's map
    shape (same tap order and no contraction: 1e-5)."""
    _needs_card()
    rng = np.random.default_rng(10)
    hc, wc, n = 135, 240, 1 << 16
    maps = torch.as_tensor(rng.uniform(-3.5, 3.5, (5, hc, wc)),
                           dtype=torch.float32, device="cuda")
    ty, tx = (torch.as_tensor(rng.uniform(-2.0, m + 1.0, n),
                              dtype=torch.float32, device="cuda")
              for m in (hc, wc))
    torch.testing.assert_close(columns_kernel.pack_maps(maps),
                               columns_kernel.pack_maps_reference(maps),
                               rtol=0, atol=0)
    for want_grad in (False, True):
        before = columns_kernel.LAUNCHES
        out = columns_kernel.sample_maps(maps, ty, tx, want_grad)
        torch.cuda.synchronize()
        assert columns_kernel.LAUNCHES == before + 1
        ref = columns_kernel.sample_maps_reference(maps, ty, tx, want_grad)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
