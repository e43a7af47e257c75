"""Signed distances of a 2.5D scene, in plain PyTorch: the analytic
primitives of `sdf.py`, each turned by its quaternion where it has one,
and the height volumes' polygons extruded into prisms over their z range.

Written from the reference engine's definitions:
  * rotateLocalPosition (DistanceFunctionCommon.fxh:23-26): the query
    point taken into the primitive's frame as p + w t + q.xyz x t with
    t = 2 q.xyz x p;
  * iq's signed polygon distance (Fracture SDF2D.fxh, sdPolygon): the
    nearest edge's distance, negative where the crossings' parity says
    inside;
  * the extrusion (DistanceField.fx:46-72, finalEval): the polygon's
    distance biased out by PolygonXyBias = 1.5 (DistanceField.fx:13) and
    the distance past the z range, summed outside, the larger inside.

A scene's distance is the minimum over its primitives and prisms and 128,
the farthest the engine's encoded field holds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from framebench.reference import sdf

POLYGON_XY_BIAS = 1.5
FAR = 128.0


def rotate(px, py, pz, q):
    """The point (px, py, pz) turned by the quaternion q = (x, y, z, w)
    (0-d tensors): rotateLocalPosition."""
    qx, qy, qz, qw = q
    tx = 2.0 * (qy * pz - qz * py)
    ty = 2.0 * (qz * px - qx * pz)
    tz = 2.0 * (qx * py - qy * px)
    return (px + qw * tx + (qy * tz - qz * ty),
            py + qw * ty + (qz * tx - qx * tz),
            pz + qw * tz + (qx * ty - qy * tx))


def polygon_sd(px, py, vertices):
    """Signed distance from (px, py) to the closed polygon `vertices`
    ((M, 2) float32), negative inside: the nearest of its M edges; a
    point is inside where the edges for which all three or none of
    (py >= ay, py < by, e x w > 0) hold are odd in number."""
    m = vertices.shape[0]
    d2 = odd = None
    for j in range(m):
        ax, ay = vertices[j, 0], vertices[j, 1]
        bx, by = vertices[(j + 1) % m, 0], vertices[(j + 1) % m, 1]
        ex, ey = bx - ax, by - ay
        wx, wy = px - ax, py - ay
        t = torch.clamp((wx * ex + wy * ey)
                        / torch.clamp(ex * ex + ey * ey, min=1e-12), 0.0, 1.0)
        qx = wx - ex * t
        qy = wy - ey * t
        e2 = qx * qx + qy * qy
        d2 = e2 if d2 is None else torch.minimum(d2, e2)
        c1 = py >= ay
        c2 = py < by
        c3 = ex * wy > ey * wx
        flip = (c1 & c2 & c3) | (~c1 & ~c2 & ~c3)
        odd = flip if odd is None else odd ^ flip
    root = torch.sqrt(torch.clamp(d2, min=0.0))
    return torch.where(odd, -root, root)


@dataclasses.dataclass
class Prism:
    """A height volume as an obstruction: its polygon ((M, 2) float32) and
    its z range (0-d float32 tensors)."""

    vertices: torch.Tensor
    z0: torch.Tensor
    z1: torch.Tensor

    def distance(self, x, y, z):
        dxy = polygon_sd(x, y, self.vertices) + POLYGON_XY_BIAS
        z0, z1 = self.z0, self.z1
        inside_z = (z >= z0) & (z <= z1)
        dz = torch.where(inside_z, torch.maximum(z - z1, z0 - z),
                         torch.where(z > z1, z - z1, z0 - z))
        return torch.where(
            dxy <= 0.0, torch.where(dz <= 0.0, dxy + dz, dz),
            torch.clamp(dxy, min=0.0) + torch.clamp(dz, min=0.0))


@dataclasses.dataclass
class Turned:
    """A primitive of `sdf.py` with its quaternion ((4,) float32), or None
    for one in the world's axes."""

    primitive: sdf.Primitive
    rotation: Optional[torch.Tensor] = None

    def distance(self, x, y, z):
        p = self.primitive
        c, s = p.center, p.size
        px, py, pz = x - c[0], y - c[1], z - c[2]
        if self.rotation is not None:
            px, py, pz = rotate(px, py, pz, tuple(self.rotation))
        return sdf.DISTANCE[p.type](px, py, pz, s[0], s[1], s[2])


@dataclasses.dataclass
class Scene:
    """Primitives (`Turned`) and prisms (`Prism`); `distance(x, y, z)`,
    their minimum and FAR, at the broadcast shape of x, y and z."""

    primitives: list
    prisms: list

    def distance(self, x, y, z):
        shape = torch.broadcast_shapes(x.shape, torch.as_tensor(y).shape,
                                       torch.as_tensor(z).shape)
        d = torch.full(shape, FAR, dtype=torch.float32, device=x.device)
        for part in self.primitives + self.prisms:
            d = torch.minimum(d, part.distance(x, y, z))
        return d
