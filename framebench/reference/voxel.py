"""A voxel SDF of boxes and its column-interval maps, in plain PyTorch.

The volume: slice-major (S, H, W) raw distances, slice s at world z =
s * depth / S, texel (y, x) at world ((x + 0.5) / scale_x, (y + 0.5) /
scale_y), each the minimum over the boxes clamped to the band the
reference engine's encoded texture holds, [-(63/255) m, (192/255) m]
(DistanceFieldCommon.fxh:264-270). The column maps factor the field
through its footprint f = min_z d, top t and bottom b of each column's
occupied interval and the end slices' distances, box-downsampled 2x; a
scattered query samples them bilinearly and reconstructs
    d = min(max(f, dz), 0) + hypot(max(f, 0), max(dz, 0)),
    dz = max(b - z, z - t),
clamped by the end slices and plus the distance to the volume's box.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Geometry:
    width: int  # world extents
    height: int
    depth: float
    slices: int
    scale: float  # texels a world unit
    max_encoded: float = 128.0

    @property
    def shape(self):
        return (self.slices, max(1, int(round(self.height * self.scale))),
                max(1, int(round(self.width * self.scale))))

    @property
    def scale_x(self):
        return self.shape[2] / self.width

    @property
    def scale_y(self):
        return self.shape[1] / self.height

    @property
    def dz(self):
        return self.depth / self.slices


def box_volume(g: Geometry, centers, sizes):
    """The (S, H, W) field of unrotated boxes: centers, sizes (N, 3)
    half-extents, every voxel evaluating every box at once."""
    f32 = torch.float32
    dev = centers.device
    s, h, w = g.shape
    xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / g.scale_x
    ys = (torch.arange(h, dtype=f32, device=dev) + 0.5) / g.scale_y
    zs = torch.arange(s, dtype=f32, device=dev) * g.dz
    z, y, x = torch.meshgrid(zs, ys, xs, indexing="ij")
    p = torch.stack([x, y, z], dim=-1)[..., None, :] - centers
    d = torch.abs(p) - sizes
    c = torch.clamp(d, min=0.0)
    outside = torch.sqrt(torch.sum(c * c, dim=-1) + 1e-12)
    inside = torch.clamp(torch.amax(d, dim=-1), max=0.0)
    dist = torch.amin(inside + outside, dim=-1)
    m = g.max_encoded
    return torch.clamp(dist, -(63.0 / 255.0) * m, (192.0 / 255.0) * m)


def column_maps(g: Geometry, data):
    """The (5, H/2, W/2) maps (f, t, b, d_top, d_bot) of a volume: occupied
    columns take the interval ends from the profile's outermost zero
    crossings, empty columns invert the hypot arm at the first slice past
    the flat knee, an inverted interval collapses to its middle."""
    f = torch.amin(data, dim=0)
    n = g.slices
    dz = g.dz
    zs = (torch.arange(n, dtype=torch.float32, device=data.device)
          * dz)[:, None, None]
    big = 1e9
    d_lo, d_hi = data[:-1], data[1:]
    denom = d_lo - d_hi
    frac = d_lo / torch.where(torch.abs(denom) > 1e-9, denom,
                              torch.full_like(denom, 1e-9))
    cross_z = zs[:-1] + dz * frac
    up = (d_lo < 0.0) & (d_hi >= 0.0)
    dn = (d_lo >= 0.0) & (d_hi < 0.0)
    t_occ = torch.amax(torch.where(up, cross_z, -big), dim=0)
    b_occ = torch.amin(torch.where(dn, cross_z, big), dim=0)
    z_first, z_last = zs[0, 0, 0], zs[-1, 0, 0]
    t_occ = torch.where(data[-1] < 0.0, z_last - data[-1], t_occ)
    b_occ = torch.where(data[0] < 0.0, z_first + data[0], b_occ)
    z_amin = zs[:, 0, 0][torch.argmin(data, dim=0)]
    t_occ = torch.where(t_occ <= -big, z_amin, t_occ)
    b_occ = torch.where(b_occ >= big, z_amin, b_occ)
    f_pos2 = torch.square(torch.clamp(f, min=0.0))[None]
    arm = torch.sqrt(torch.clamp(torch.square(data) - f_pos2, min=0.0))
    flat = data <= (f[None] + 0.26 * dz)
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
    stack = torch.stack([f, t, b, data[-1], data[0]], dim=0)
    _, h, w = data.shape
    return stack.reshape(5, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


class ColumnQuery:
    """distance(x, y, z) and the unit gradient as normal(x, y, z) of the
    column reconstruction, on (N,) world coordinates."""

    def __init__(self, g: Geometry, maps):
        self.g, self.maps = g, maps

    def _coords(self, px, py, pz):
        g = self.g
        _, hc, wc = self.maps.shape
        _, h, w = g.shape
        ex, ey, ez = float(g.width), float(g.height), float(g.depth)
        cx = torch.clamp(px, 0.0, ex)
        cy = torch.clamp(py, 0.0, ey)
        # The signed distances past the volume's box, per axis.
        ux = torch.clamp(px, max=0.0) + torch.clamp(px - ex, min=0.0)
        uy = torch.clamp(py, max=0.0) + torch.clamp(py - ey, min=0.0)
        uz = torch.clamp(pz, max=0.0) + torch.clamp(pz - ez, min=0.0)
        tx = cx * g.scale_x - 0.5
        ty = cy * g.scale_y - 0.5
        in_x = (px > 0.0) & (px < ex)
        in_y = (py > 0.0) & (py < ey)
        rx, ry = wc / float(w), hc / float(h)
        return ((tx + 0.5) * rx - 0.5, (ty + 0.5) * ry - 0.5, pz,
                (ux, uy, uz), (in_x, in_y), (g.scale_x * rx, g.scale_y * ry))

    def _sample(self, ty, tx, want_grad):
        maps = self.maps
        n, hc, wc = maps.shape

        def taps(t, m):
            fl = torch.floor(t)
            i0 = torch.clamp(fl, 0, m - 1).long()
            return i0, torch.clamp(i0 + 1, max=m - 1), t - fl

        y0, y1, wy = taps(ty, hc)
        x0, x1, wx = taps(tx, wc)
        flat = maps.reshape(n, hc * wc)
        v00 = flat[:, y0 * wc + x0]
        v01 = flat[:, y0 * wc + x1]
        v10 = flat[:, y1 * wc + x0]
        v11 = flat[:, y1 * wc + x1]
        col0 = (1.0 - wy) * v00 + wy * v10
        col1 = (1.0 - wy) * v01 + wy * v11
        out = (1.0 - wx) * col0 + wx * col1
        if not want_grad:
            return out
        row0 = (1.0 - wx) * v00[0] + wx * v01[0]
        row1 = (1.0 - wx) * v10[0] + wx * v11[0]
        return torch.cat([out, (col1[0] - col0[0])[None],
                          (row1 - row0)[None]], dim=0)

    @staticmethod
    def _profile(f, t, b, z, want_grad, gfx=None, gfy=None):
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

    def _query(self, x, y, z, want_grad):
        g = self.g
        c = self._coords(x, y, z)
        tx, ty, pz, (ux, uy, uz), (in_x, in_y), (sx, sy) = c
        out = self._sample(ty.contiguous(), tx.contiguous(), want_grad)
        f, t, b, d_top, d_bot = out[0], out[1], out[2], out[3], out[4]
        z_lo = 0.0
        z_hi = min((g.slices - 1) * g.dz, 1e30)
        pzc = torch.clamp(pz - uz, z_lo, z_hi)
        dist = torch.sqrt(ux * ux + uy * uy + uz * uz)
        lip = torch.minimum(d_top + (z_hi - pzc), d_bot + (pzc - z_lo))
        if not want_grad:
            return torch.minimum(self._profile(f, t, b, pzc, False), lip) \
                + dist
        zero = torch.zeros_like(out[5])
        gfx = torch.where(in_x, out[5] * sx, zero)
        gfy = torch.where(in_y, out[6] * sy, zero)
        d, gx, gy, gz = self._profile(f, t, b, pzc, True, gfx, gfy)
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
        norm = torch.sqrt(gx * gx + gy * gy + gz * gz)
        ok = norm > 1e-9
        safe = torch.clamp(norm, min=1e-9)
        return (d + dist, torch.where(ok, gx / safe, zero),
                torch.where(ok, gy / safe, zero),
                torch.where(ok, gz / safe, zero))

    def distance(self, x, y, z):
        return self._query(x, y, z, False)

    def normal(self, x, y, z):
        return self._query(x, y, z, True)[1:]
