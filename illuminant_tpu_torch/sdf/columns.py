"""Column-interval decomposition of a voxel SDF.

Counterpart of illuminant_tpu/sdf/columns.py, whose docstring derives the
model: for z-extruded or convex content every column (x, y) is occupied on
one z-interval [b, t], so the 3D SDF factors through 2D maps — footprint
f = min_z d, top t, bottom b — plus the end-slice profile values
(d_top, d_bot) that bound the single-interval model on two-band columns:

    d(x, y, z) = min(max(f, dz), 0) + hypot(max(f, 0), max(dz, 0)),
    dz = max(b - z, z - t).

Scattered queries (particle collision) go through `query`: on the card one
launch of the fused column-query kernel (`columns_kernel.query_columns`)
takes world positions to the distance and its gradient, doing in
registers what the JAX package does as the map sample between an
elementwise head and tail. Its plain version, `query_reference`, is that
two-stage composition: `_map_coords`, the map sample
(`columns_kernel.sample_maps_reference`), then `_finish`. Grid queries
stay exact on the volume (`analytic.scene_sample_p`). The TPU's chunked
one-hot matmul sampler (`_map_core`, `_packed_maps`) is not ported: on the
card the kernel is the path for every batch size.
"""

from __future__ import annotations

import torch

from ..core.pytree import tensor_dataclass
from . import columns_kernel
from .sampling import _clamped_axes, _interp_rows
from .volume import SdfVolume


@tensor_dataclass
class ColumnField:
    """A voxel field plus its column-interval maps: flat_d / h_top / h_bot
    / d_top / d_bot (H, W) float32 world units (heights include z_offset),
    and `maps_c`, the (5, Hc, Wc) stack of the five maps box-downsampled
    2x when the dims are even, for scattered queries."""

    volume: SdfVolume
    flat_d: torch.Tensor
    h_top: torch.Tensor
    h_bot: torch.Tensor
    d_top: torch.Tensor
    d_bot: torch.Tensor
    maps_c: torch.Tensor

    @property
    def config(self):
        return self.volume.config


def build_column_maps(volume: SdfVolume, coarse: int = 2) -> ColumnField:
    """Invert the column maps from the voxel stack (the derivation is in
    illuminant_tpu/sdf/columns.py:build_column_maps). Occupied columns
    (f < 0) take the interval ends from the profile's outermost zero
    crossings; empty columns invert the hypot arm at the first slice
    past the flat knee; an inverted interval collapses to its middle."""
    c = volume.config
    data = volume.data  # (S, H, W)
    f = torch.amin(data, dim=0)
    S = c.slice_count
    dz_slice = c.slice_z_size
    zs = (torch.arange(S, dtype=torch.float32, device=data.device)
          * dz_slice + c.z_offset)[:, None, None]
    big = 1e9

    d_lo, d_hi = data[:-1], data[1:]
    denom = d_lo - d_hi
    frac = d_lo / torch.where(torch.abs(denom) > 1e-9, denom,
                              torch.full_like(denom, 1e-9))
    cross_z = zs[:-1] + dz_slice * frac
    up = (d_lo < 0.0) & (d_hi >= 0.0)
    dn = (d_lo >= 0.0) & (d_hi < 0.0)
    t_occ = torch.amax(torch.where(up, cross_z, -big), dim=0)
    b_occ = torch.amin(torch.where(dn, cross_z, big), dim=0)
    z_first = zs[0, 0, 0]
    z_last = zs[-1, 0, 0]
    t_occ = torch.where(data[-1] < 0.0, z_last - data[-1], t_occ)
    b_occ = torch.where(data[0] < 0.0, z_first + data[0], b_occ)
    z_amin = zs[:, 0, 0][torch.argmin(data, dim=0)]
    t_occ = torch.where(t_occ <= -big, z_amin, t_occ)
    b_occ = torch.where(b_occ >= big, z_amin, b_occ)

    f_pos2 = torch.square(torch.clamp(f, min=0.0))[None]
    arm = torch.sqrt(torch.clamp(torch.square(data) - f_pos2, min=0.0))
    tol = 0.26 * dz_slice
    flat = data <= (f[None] + tol)
    rise = flat[:-1] & ~flat[1:]
    fall = ~flat[:-1] & flat[1:]
    t_emp = torch.amax(torch.where(rise, zs[1:] - arm[1:], -big), dim=0)
    b_emp = torch.amin(torch.where(fall, zs[:-1] + arm[:-1], big), dim=0)
    t_emp = torch.where(flat[-1], z_last, t_emp)
    b_emp = torch.where(flat[0], z_first, b_emp)
    t_emp = torch.where(t_emp <= -big, z_amin, t_emp)
    b_emp = torch.where(b_emp >= big, z_amin, b_emp)

    occ = f < 0.0
    t = torch.where(occ, t_occ, t_emp)
    b = torch.where(occ, b_occ, b_emp)
    mid = 0.5 * (t + b)
    t = torch.maximum(t, mid)
    b = torch.minimum(b, mid)
    stack = torch.stack([f, t, b, data[-1], data[0]], dim=0)  # (5, H, W)
    H, W = f.shape
    if coarse == 2 and H % 2 == 0 and W % 2 == 0:
        maps_c = stack.reshape(5, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    else:
        maps_c = stack
    return ColumnField(volume=volume, flat_d=f, h_top=t, h_bot=b,
                       d_top=data[-1], d_bot=data[0],
                       maps_c=maps_c.contiguous())


def _reconstruct(f, t, b, z, want_grad: bool, gfx=None, gfy=None):
    """Prism SDF from the maps at world z -> d, or (d, gx, gy, gz) with
    gfx/gfy the footprint map's world-space gradient."""
    below = b - z
    above = z - t
    dz = torch.maximum(below, above)
    f_pos = torch.clamp(f, min=0.0)
    dz_pos = torch.clamp(dz, min=0.0)
    outside = torch.sqrt(f_pos * f_pos + dz_pos * dz_pos)
    d = torch.clamp(torch.maximum(f, dz), max=0.0) + outside
    if not want_grad:
        return d
    one = torch.ones_like(d)
    zero = torch.zeros_like(d)
    zsign = torch.where(above > below, one, -one)
    inv = 1.0 / torch.clamp(outside, min=1e-9)
    out_mask = (f > 0.0) | (dz > 0.0)
    side_w = torch.where(out_mask, f_pos * inv,
                         torch.where(f >= dz, one, zero))
    cap_w = torch.where(out_mask, dz_pos * inv,
                        torch.where(f >= dz, zero, one))
    return d, side_w * gfx, side_w * gfy, cap_w * zsign


def reconstruct_profile(f, t, b, z):
    """Elementwise column-prism SDF from already-sampled map values (the
    carried scan refine's candidate distance)."""
    return _reconstruct(f, t, b, z, False)


def resample_map_to_grid(field: ColumnField, map2d, nh: int, nw: int,
                         nscale):
    """Bilinear-resample a column map onto an (nh, nw) pixel-center grid
    (centers at (i + 0.5) / nscale world units), with
    `sampling.grid_stack`'s texel conventions. The JAX package's
    `world_offset` is left out: a windowed scan keeps the exact refine and
    never resamples the maps (lighting/scan_shadows.py)."""
    c = field.config
    H, W = map2d.shape
    dev = map2d.device
    xs = (torch.arange(nw, dtype=torch.float32, device=dev) + 0.5) / nscale
    ys = (torch.arange(nh, dtype=torch.float32, device=dev) + 0.5) / nscale
    cx = torch.clamp(xs, 0.0, float(c.virtual_width))
    cy = torch.clamp(ys, 0.0, float(c.virtual_height))
    bx = _interp_rows(cx * c.scale_x - 0.5, W)   # (nw, W)
    by = _interp_rows(cy * c.scale_y - 0.5, H)   # (nh, H)
    return by @ map2d @ bx.T


def _map_coords(field: ColumnField, px, py, pz):
    """World x, y, z (N,) -> coarse-map texel coords plus the clamp/box
    terms. Coarse cell centers align with the 2x2 fine-box centers:
    t_c = (t_fine + 0.5) * ratio - 0.5."""
    c = field.config
    _, Hc, Wc = field.maps_c.shape
    rx = Wc / float(c.slice_width)
    ry = Hc / float(c.slice_height)
    tx, ty, _sp, (ux, uy, uz), (in_x, in_y, _) = _clamped_axes(
        field.volume, px, py, pz)
    tx = (tx + 0.5) * rx - 0.5
    ty = (ty + 0.5) * ry - 0.5
    return (tx, ty, pz, (ux, uy, uz), (in_x, in_y),
            (c.scale_x * rx, c.scale_y * ry))


def _finish(field: ColumnField, coords, f, t, b, d_top, d_bot,
            want_grad: bool, gfx=None, gfy=None):
    """Reconstruction at the z clamped to the end slices, the 1-Lipschitz
    end-slice clamps, then the out-of-volume distance
    (sampleDistanceFieldEx clamps, samples, then adds; fxh:320-321)."""
    c = field.config
    _tx, _ty, pz, (ux, uy, uz), (in_x, in_y), _scales = coords
    z_lo = c.z_offset
    z_hi = c.z_offset + min((c.slice_count - 1) * c.slice_z_size, 1e30)
    pzc = torch.clamp(pz - uz, z_lo, z_hi)
    dist = torch.sqrt(ux * ux + uy * uy + uz * uz)
    lip = torch.minimum(d_top + (z_hi - pzc), d_bot + (pzc - z_lo))
    if not want_grad:
        d = _reconstruct(f, t, b, pzc, False)
        return torch.minimum(d, lip) + dist

    zero = torch.zeros_like(gfx)
    gfx = torch.where(in_x, gfx, zero)
    gfy = torch.where(in_y, gfy, zero)
    d, gx, gy, gz = _reconstruct(f, t, b, pzc, True, gfx, gfy)
    # A winning end clamp puts the nearest feature toward that end:
    # d = d_top + (z_hi - z) has dd/dz = -1, the bottom clamp +1.
    top_wins = (d_top + (z_hi - pzc)) <= (d_bot + (pzc - z_lo))
    clamped = lip < d
    d = torch.minimum(d, lip)
    gx = torch.where(clamped, zero, gx)
    gy = torch.where(clamped, zero, gy)
    one = torch.ones_like(gz)
    gz = torch.where(clamped, torch.where(top_wins, -one, one), gz)
    safe = torch.clamp(dist, min=1e-9)
    outside = dist > 0.0
    gx = gx + torch.where(outside, ux / safe, zero)
    gy = gy + torch.where(outside, uy / safe, zero)
    gz = gz + torch.where(outside, uz / safe, zero)
    return d + dist, gx, gy, gz


def _normalized(gx, gy, gz):
    """Unit gradient, zero where it vanishes (|g| <= 1e-9)."""
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz)
    ok = norm > 1e-9
    safe = torch.clamp(norm, min=1e-9)
    zero = torch.zeros_like(gx)
    return (torch.where(ok, gx / safe, zero), torch.where(ok, gy / safe, zero),
            torch.where(ok, gz / safe, zero))


def query_reference(field: ColumnField, x, y, z, want_grad: bool = False,
                    normalize: bool = False, sampler=None):
    """Plain PyTorch version of the fused query kernel, composed as the
    JAX package's `_sample_pallas` composes the query: the coordinate
    head, `sampler(maps, ty, tx, want_grad)` over the five maps (default:
    `columns_kernel.sample_maps_reference`, looked up at the call;
    `columns_kernel.sample_maps` gives the two-stage query with the
    sampler kernel), then the reconstruction tail, on (N,) world x, y, z."""
    sampler = sampler or columns_kernel.sample_maps_reference
    coords = _map_coords(field, x, y, z)
    tx, ty = coords[0], coords[1]
    sx_c, sy_c = coords[5]
    out = sampler(field.maps_c, ty.contiguous(), tx.contiguous(), want_grad)
    f, t, b, d_top, d_bot = out[0], out[1], out[2], out[3], out[4]
    if not want_grad:
        return _finish(field, coords, f, t, b, d_top, d_bot, False)
    d, gx, gy, gz = _finish(field, coords, f, t, b, d_top, d_bot, True,
                            out[5] * sx_c, out[6] * sy_c)
    if normalize:
        gx, gy, gz = _normalized(gx, gy, gz)
    return d, gx, gy, gz


def query_geometry(field: ColumnField):
    """The fused kernel's ColumnField constants
    (`columns_kernel.QUERY_GEOMETRY`), the Python scalars that
    `_clamped_axes`, `_map_coords` and `_finish` use."""
    c = field.config
    _, Hc, Wc = field.maps_c.shape
    rx = Wc / float(c.slice_width)
    ry = Hc / float(c.slice_height)
    return (float(c.virtual_width), float(c.virtual_height),
            float(c.virtual_depth), c.z_offset, c.scale_x, c.scale_y, rx, ry,
            c.scale_x * rx, c.scale_y * ry, c.z_offset,
            c.z_offset + min((c.slice_count - 1) * c.slice_z_size, 1e30))


def _flat(v):
    """A 1-D view of v without a copy where its strides allow one."""
    try:
        return v.view(-1)
    except RuntimeError:
        return v.reshape(-1)


def query(field: ColumnField, x, y, z, want_grad: bool = False,
          normalize: bool = False):
    """The ColumnField query at world x, y, z (a tensor and tensors or
    scalars that broadcast with it) -> the distance of their broadcast
    shape, or (d, gx, gy, gz) with `want_grad`: the world-space gradient,
    of unit length (0 where it vanishes) with `normalize`.

    A CPU tensor runs `query_reference`; a CUDA tensor packs the maps and
    launches the fused kernel once, reading strided views (a column of an
    (N, 4) state, a broadcast scalar) in place, or raises."""
    dev = x.device
    x, y, z = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev)
          for v in (x, y, z)))
    shape = x.shape
    x, y, z = _flat(x), _flat(y), _flat(z)
    if dev.type == "cpu":
        out = query_reference(field, x, y, z, want_grad, normalize)
    else:
        out = columns_kernel.query_columns(
            columns_kernel.pack_maps(field.maps_c), query_geometry(field),
            x, y, z, want_grad, normalize)
    if not want_grad:
        return out.reshape(shape)
    return tuple(o.reshape(shape) for o in out)


def sample_columns(field: ColumnField, position):
    """Column-reconstruction distance at world positions (..., 3)."""
    p = position.reshape(-1, 3)
    d = query(field, p[:, 0], p[:, 1], p[:, 2])
    return d.reshape(position.shape[:-1])


def sample_columns_grad(field: ColumnField, position):
    """Distance and world-space gradient (the collision normal)."""
    shape = position.shape[:-1]
    p = position.reshape(-1, 3)
    d, gx, gy, gz = query(field, p[:, 0], p[:, 1], p[:, 2], want_grad=True)
    g = torch.stack([gx, gy, gz], dim=-1)
    return d.reshape(shape), g.reshape(tuple(shape) + (3,))
