"""Distance-field sampling.

Counterpart of illuminant_tpu/sdf/sampling.py:
  * `sample`: the exact trilinear gather of sampleDistanceFieldEx
    (DistanceFieldCommon.fxh:313-353) — clamp to the volume, bilinear xy,
    linear z, plus the distance from the query to the volume's box. The
    oracle every fast path is held to.
  * `estimate_normal`: the 4-tap tetrahedral normal (VisualizeCommon.fxh:
    44-63).
  * `grid_stack` / `sample_stack_z` / `sample_grid`: exact trilinear on a
    separable pixel grid (the occlusion image) via two small
    interpolation-matrix products per slice and a z-lerp over slices.
The MXU interpolation-matrix sampler for scattered points (`sample_interp`)
is TPU machinery and is not ported; on the card it becomes a gather kernel
(ROADMAP K8).
"""

from __future__ import annotations

import torch

from .volume import SdfVolume


def sample(volume: SdfVolume, position):
    """Trilinear distance at world positions (..., 3) -> (...,)."""
    c = volume.config
    data = volume.data
    px = position[..., 0]
    py = position[..., 1]
    pz = position[..., 2] - c.z_offset
    ex = float(c.virtual_width)
    ey = float(c.virtual_height)
    ez = float(c.virtual_depth)

    cx = torch.clamp(px, 0.0, ex)
    cy = torch.clamp(py, 0.0, ey)
    cz = torch.clamp(pz, 0.0, ez)

    dx = -torch.clamp(px, max=0.0) + torch.clamp(px - ex, min=0.0)
    dy = -torch.clamp(py, max=0.0) + torch.clamp(py - ey, min=0.0)
    dz = -torch.clamp(pz, max=0.0) + torch.clamp(pz - ez, min=0.0)
    distance_to_volume = torch.sqrt(dx * dx + dy * dy + dz * dz)

    z_to_slice = c.slice_count / ez
    slice_pos = torch.minimum(cz, volume.max_valid_z) * z_to_slice
    s0 = torch.floor(slice_pos)
    sw = slice_pos - s0
    s0i = torch.clamp(s0.long(), 0, c.slice_count - 1)
    s1i = torch.clamp(s0i + 1, 0, c.slice_count - 1)

    tx = cx * c.scale_x - 0.5
    ty = cy * c.scale_y - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    wx = tx - x0
    wy = ty - y0
    x0i = torch.clamp(x0.long(), 0, c.slice_width - 1)
    x1i = torch.clamp(x0i + 1, 0, c.slice_width - 1)
    y0i = torch.clamp(y0.long(), 0, c.slice_height - 1)
    y1i = torch.clamp(y0i + 1, 0, c.slice_height - 1)

    def bilinear(si):
        v00 = data[si, y0i, x0i]
        v01 = data[si, y0i, x1i]
        v10 = data[si, y1i, x0i]
        v11 = data[si, y1i, x1i]
        top = v00 + (v01 - v00) * wx
        bot = v10 + (v11 - v10) * wx
        return top + (bot - top) * wy

    a = bilinear(s0i)
    b = bilinear(s1i)
    return a + (b - a) * sw + distance_to_volume


_NORMAL_WEIGHTS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
                   (1.0, 1.0, 1.0))


def sample_or_max(volume, position, maximum_z: float = 128.0):
    """sampleDistanceField (DistanceFieldCommon.fxh:355-364): `sample`, or
    `maximum_z` everywhere when there is no field (`volume` None)."""
    if volume is None:
        return torch.full(position.shape[:-1], maximum_z,
                          dtype=torch.float32, device=position.device)
    return sample(volume, position)


def estimate_normal(volume: SdfVolume, position):
    """4-tap tetrahedral gradient with one-voxel world offsets
    (VisualizeCommon.fxh:47-63) -> unit normals (..., 3); a zero gradient
    gives 0."""
    c = volume.config
    texel = torch.tensor([1.0 / c.scale_x, 1.0 / c.scale_y, c.slice_z_size],
                         dtype=torch.float32, device=position.device)
    result = torch.zeros(position.shape, dtype=torch.float32,
                         device=position.device)
    for w in _NORMAL_WEIGHTS:
        wt = torch.tensor(w, dtype=torch.float32, device=position.device)
        d = sample(volume, position + wt * texel)
        result = result + wt * d[..., None]
    norm = torch.sqrt(torch.sum(result * result, dim=-1, keepdim=True))
    return torch.where(norm > 1e-9, result / torch.clamp(norm, min=1e-9),
                       torch.zeros_like(result))


def _clamped_axes(volume: SdfVolume, px, py, pz):
    """Clamp/convert exactly like `sample`. Returns texel coords (tx, ty),
    the slice coord sp clamped to [0, S-1], the signed out-of-box offsets
    (ux, uy, uz) and the per-axis inside masks."""
    c = volume.config
    ex = float(c.virtual_width)
    ey = float(c.virtual_height)
    ez = float(c.virtual_depth)
    pz = pz - c.z_offset

    cx = torch.clamp(px, 0.0, ex)
    cy = torch.clamp(py, 0.0, ey)
    cz = torch.clamp(pz, 0.0, ez)

    ux = torch.clamp(px, max=0.0) + torch.clamp(px - ex, min=0.0)
    uy = torch.clamp(py, max=0.0) + torch.clamp(py - ey, min=0.0)
    uz = torch.clamp(pz, max=0.0) + torch.clamp(pz - ez, min=0.0)

    zc = torch.minimum(cz, volume.max_valid_z)
    sp = torch.clamp(zc * (c.slice_count / ez), max=float(c.slice_count - 1))

    tx = cx * c.scale_x - 0.5
    ty = cy * c.scale_y - 0.5

    in_x = (px > 0.0) & (px < ex)
    in_y = (py > 0.0) & (py < ey)
    in_z = (pz > 0.0) & (pz < ez) & (cz < volume.max_valid_z)
    return tx, ty, sp, (ux, uy, uz), (in_x, in_y, in_z)


def _interp_rows(t, n: int):
    """Interpolation-row matrix (..., n): (1 - w) at i0, w at
    i1 = min(i0 + 1, n - 1), with i0 = clip(floor(t), 0, n - 1) taken
    first and w = t - floor(t) from the unclipped floor."""
    i0 = torch.floor(t)
    w = (t - i0)[..., None]
    i0 = torch.clamp(i0.long(), 0, n - 1)[..., None]
    i1 = torch.clamp(i0 + 1, max=n - 1)
    iota = torch.arange(n, device=t.device)
    return (iota == i0) * (1.0 - w) + (iota == i1) * w


def grid_stack(volume: SdfVolume, xs, ys):
    """Every slice resampled onto the separable world grid (ys, xs):
    (S, len(ys), len(xs)) float32, exact bilinear per slice."""
    c = volume.config
    cx = torch.clamp(xs, 0.0, float(c.virtual_width))
    cy = torch.clamp(ys, 0.0, float(c.virtual_height))
    bx = _interp_rows(cx * c.scale_x - 0.5, c.slice_width)   # (W', W)
    by = _interp_rows(cy * c.scale_y - 0.5, c.slice_height)  # (H', H)
    t = torch.matmul(volume.data, bx.T)                      # (S, H, W')
    return torch.matmul(by, t)                               # (S, H', W')


def sample_stack_z(volume: SdfVolume, stack, xs, ys, z):
    """Trilinear with xy on a `grid_stack` grid and z free; z broadcasts
    against (len(ys), len(xs)). Adds the out-of-box distance."""
    c = volume.config
    S = c.slice_count
    ez = float(c.virtual_depth)
    z = torch.as_tensor(z, dtype=torch.float32, device=stack.device)
    z = z - c.z_offset
    cz = torch.clamp(z, 0.0, ez)
    zc = torch.minimum(cz, volume.max_valid_z)
    sp = torch.clamp(zc * (S / ez), max=float(S - 1))

    shape = torch.broadcast_shapes(sp.shape, (len(ys), len(xs)))
    d = torch.zeros(shape, dtype=torch.float32, device=stack.device)
    for s in range(S):
        w = torch.clamp(1.0 - torch.abs(sp - float(s)), 0.0, 1.0)
        d = d + w * stack[s]

    ux = torch.clamp(xs, max=0.0) + torch.clamp(xs - float(c.virtual_width),
                                                min=0.0)
    uy = torch.clamp(ys, max=0.0) + torch.clamp(ys - float(c.virtual_height),
                                                min=0.0)
    uz = torch.clamp(z, max=0.0) + torch.clamp(z - ez, min=0.0)
    dist = torch.sqrt(ux[None, :] ** 2 + uy[:, None] ** 2 + uz * uz)
    return d + dist


def sample_grid(volume: SdfVolume, xs, ys, z):
    """Exact trilinear on the separable world grid (ys, xs) at height z:
    the occlusion-image shape -> (..., len(ys), len(xs))."""
    stack = grid_stack(volume, xs, ys)
    return sample_stack_z(volume, stack, xs, ys, z)
