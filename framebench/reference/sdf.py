"""Signed distances of the analytic obstruction scene, in plain PyTorch.

A frozen copy of the arithmetic the measured frame evaluates (iq's
distance formulas of the reference engine's DistanceFunctionCommon.fxh:
box, improved-V2 ellipsoid, capped cylinder; each primitive's closed-form
normal), kept apart from the program so that the benchmark's comparison
does not judge the program by its own code. Primitives are unrotated and
evaluated one at a time, in the order the scene lists them after grouping
by type id, which fixes the order of the running minimum.
"""

from __future__ import annotations

import dataclasses

import torch

TYPE_ELLIPSOID = 1
TYPE_BOX = 2
TYPE_CYLINDER = 3


def _len3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z + 1e-12)


def _len2(x, y):
    return torch.sqrt(x * x + y * y + 1e-12)


def sd_box(px, py, pz, sx, sy, sz):
    dx = torch.abs(px) - sx
    dy = torch.abs(py) - sy
    dz = torch.abs(pz) - sz
    inside = torch.clamp(torch.maximum(dx, torch.maximum(dy, dz)), max=0.0)
    outside = _len3(torch.clamp(dx, min=0.0), torch.clamp(dy, min=0.0),
                    torch.clamp(dz, min=0.0))
    return inside + outside


def sd_ellipsoid(px, py, pz, sx, sy, sz):
    sx = torch.clamp(sx, min=1e-6)
    sy = torch.clamp(sy, min=1e-6)
    sz = torch.clamp(sz, min=1e-6)
    k0 = _len3(px / sx, py / sy, pz / sz)
    k1 = _len3(px / (sx * sx), py / (sy * sy), pz / (sz * sz))
    rmin = torch.minimum(sx, torch.minimum(sy, sz))
    near = (k0 - 1.0) * rmin
    far = k0 * (k0 - 1.0) / torch.clamp(k1, min=1e-12)
    return torch.where(k0 < 1.0, near, far)


def sd_cylinder(px, py, pz, sx, sy, sz):
    r = _len2(sx, sy)
    d_xy = _len2(px, py) - r
    d_z = torch.abs(pz) - sz
    inside = torch.clamp(torch.maximum(d_xy, d_z), max=0.0)
    outside = _len2(torch.clamp(d_xy, min=0.0), torch.clamp(d_z, min=0.0))
    return inside + outside


def _unit(px, py, pz):
    l = torch.sqrt(px * px + py * py + pz * pz)
    ok = l > 1e-9
    inv = 1.0 / torch.where(ok, l, 1.0)
    return (torch.where(ok, px * inv, 0.0), torch.where(ok, py * inv, 0.0),
            torch.where(ok, pz * inv, 1.0))


def n_box(px, py, pz, bx, by, bz):
    qx = torch.abs(px) - bx
    qy = torch.abs(py) - by
    qz = torch.abs(pz) - bz
    outside = (qx > 0.0) | (qy > 0.0) | (qz > 0.0)
    ox = torch.sign(px) * torch.clamp(qx, min=0.0)
    oy = torch.sign(py) * torch.clamp(qy, min=0.0)
    oz = torch.sign(pz) * torch.clamp(qz, min=0.0)
    mx = (qx >= qy) & (qx >= qz)
    my = (~mx) & (qy >= qz)
    ix = torch.where(mx, torch.sign(px), 0.0)
    iy = torch.where(my, torch.sign(py), 0.0)
    iz = torch.where(~(mx | my), torch.sign(pz), 0.0)
    return _unit(torch.where(outside, ox, ix), torch.where(outside, oy, iy),
                 torch.where(outside, oz, iz))


def n_ellipsoid(px, py, pz, rx, ry, rz):
    rx = torch.clamp(rx, min=1e-6)
    ry = torch.clamp(ry, min=1e-6)
    rz = torch.clamp(rz, min=1e-6)
    return _unit(px / (rx * rx), py / (ry * ry), pz / (rz * rz))


def n_cylinder(px, py, pz, sx, sy, sz):
    r = torch.sqrt(sx * sx + sy * sy)
    lxy = torch.sqrt(px * px + py * py + 1e-12)
    d_xy = lxy - r
    d_z = torch.abs(pz) - sz
    both_out = (d_xy > 0.0) & (d_z > 0.0)
    radial = d_xy >= d_z
    ox = px / lxy * torch.clamp(d_xy, min=0.0)
    oy = py / lxy * torch.clamp(d_xy, min=0.0)
    oz = torch.sign(pz) * torch.clamp(d_z, min=0.0)
    nx = torch.where(both_out, ox, torch.where(radial, px / lxy, 0.0))
    ny = torch.where(both_out, oy, torch.where(radial, py / lxy, 0.0))
    nz = torch.where(both_out, oz, torch.where(radial, 0.0, torch.sign(pz)))
    return _unit(nx, ny, nz)


DISTANCE = {TYPE_ELLIPSOID: sd_ellipsoid, TYPE_BOX: sd_box,
            TYPE_CYLINDER: sd_cylinder}
NORMAL = {TYPE_ELLIPSOID: n_ellipsoid, TYPE_BOX: n_box,
          TYPE_CYLINDER: n_cylinder}


@dataclasses.dataclass
class Primitive:
    type: int
    center: torch.Tensor  # (3,)
    size: torch.Tensor  # (3,)


@dataclasses.dataclass
class Scene:
    """Unrotated primitives in evaluation order; beyond `far` nothing."""

    primitives: list
    far: float = 128.0

    def distance(self, x, y, z):
        shape = torch.broadcast_shapes(x.shape, torch.as_tensor(y).shape,
                                       torch.as_tensor(z).shape)
        d = torch.full(shape, self.far, dtype=torch.float32,
                       device=x.device)
        for p in self.primitives:
            c, s = p.center, p.size
            d = torch.minimum(d, DISTANCE[p.type](
                x - c[0], y - c[1], z - c[2], s[0], s[1], s[2]))
        return d

    def normal(self, x, y, z):
        """The closed-form normal of the nearest primitive (strictly
        nearer than `far` and every earlier one), else (0, 0, 0)."""
        shape = torch.broadcast_shapes(x.shape, y.shape, z.shape)
        best = torch.full(shape, self.far, dtype=torch.float32,
                          device=x.device)
        nx = torch.zeros(shape, dtype=torch.float32, device=x.device)
        ny = torch.zeros_like(nx)
        nz = torch.zeros_like(nx)
        for p in self.primitives:
            c, s = p.center, p.size
            px, py, pz = x - c[0], y - c[1], z - c[2]
            d = DISTANCE[p.type](px, py, pz, s[0], s[1], s[2])
            ix, iy, iz = NORMAL[p.type](px, py, pz, s[0], s[1], s[2])
            closer = d < best
            nx = torch.where(closer, ix, nx)
            ny = torch.where(closer, iy, ny)
            nz = torch.where(closer, iz, nz)
            best = torch.minimum(best, d)
        return nx, ny, nz
