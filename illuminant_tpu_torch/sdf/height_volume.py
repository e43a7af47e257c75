"""Height volumes: polygonal 2.5D geometry.

Counterpart of illuminant_tpu/sdf/height_volume.py (HeightVolume.cs:
polygon + ZBase + Height). Its two consumers are the G-buffer
rasterization (lighting/height_volume.py) and the obstruction field: the
signed 2D polygon distance (iq's formulation, Fracture SDF2D.fxh) extruded
over the z range with the reference's finalEval composition and
PolygonXyBias = 1.5 (DistanceField.fx:13, 46-72).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.pytree import tensor_dataclass

POLYGON_XY_BIAS = 1.5  # DistanceField.fx:13


@dataclasses.dataclass
class HeightVolume:
    """Host volume (HeightVolume.cs:15-23)."""

    polygon: Sequence[Tuple[float, float]]
    z_base: float = 0.0
    height: float = 32.0
    is_obstruction: bool = True
    top_face_enable_shadows: bool = True
    front_face_enable_shadows: bool = True
    is_dynamic: bool = False


@tensor_dataclass
class HeightVolumes:
    """SoA: polygons padded to E edges by repeating the last vertex (a
    degenerate edge is a no-op in the distance and in the coverage tests).
    vertices / next_vertices (P, E, 2) edge start and end points of the
    closed loop; z_range (P, 2) base and top; top_shadows, front_shadows,
    active (P,)."""

    vertices: torch.Tensor
    next_vertices: torch.Tensor
    z_range: torch.Tensor
    top_shadows: torch.Tensor
    front_shadows: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self):
        return self.vertices.shape[0]


def pack_height_volumes(volumes: List[HeightVolume],
                        max_edges: Optional[int] = None,
                        device="cuda") -> HeightVolumes:
    n = len(volumes)
    cap = max(n, 1)
    e = max_edges or max((len(v.polygon) for v in volumes), default=3)
    verts = np.zeros((cap, e, 2), np.float32)
    nxt = np.zeros((cap, e, 2), np.float32)
    zr = np.zeros((cap, 2), np.float32)
    ts = np.ones((cap,), np.float32)
    fs = np.ones((cap,), np.float32)
    act = np.zeros((cap,), np.float32)
    for i, v in enumerate(volumes):
        poly = np.asarray(v.polygon, np.float32)
        m = len(poly)
        if m > e:
            raise ValueError(f"polygon has {m} > {e} edges")
        for j in range(e):
            a = poly[min(j, m - 1)]
            verts[i, j] = a
            nxt[i, j] = poly[(j + 1) % m] if j < m else a
        zr[i] = [v.z_base, v.z_base + v.height]
        ts[i] = 1.0 if v.top_face_enable_shadows else 0.0
        fs[i] = 1.0 if v.front_face_enable_shadows else 0.0
        act[i] = 1.0

    def t(a):
        return torch.as_tensor(a, device=device)

    return HeightVolumes(vertices=t(verts), next_vertices=t(nxt),
                         z_range=t(zr), top_shadows=t(ts),
                         front_shadows=t(fs), active=t(act))


def polygon_sdf_2d_p(px, py, vertices, next_vertices):
    """Planar form of `polygon_sdf_2d`: px, py (...,) broadcast against the
    leading axes of vertices / next_vertices (..., E, 2) -> (...,). The
    edge axis is the only extra one: no (..., E, 2) temporaries."""
    px = px[..., None]
    py = py[..., None]
    ax, ay = vertices[..., 0], vertices[..., 1]
    bx, by = next_vertices[..., 0], next_vertices[..., 1]
    ex, ey = bx - ax, by - ay
    wx, wy = px - ax, py - ay
    ee = torch.clamp(ex * ex + ey * ey, min=1e-12)
    t = torch.clamp((wx * ex + wy * ey) / ee, 0.0, 1.0)
    qx = wx - ex * t
    qy = wy - ey * t
    dist2 = torch.amin(qx * qx + qy * qy, dim=-1)

    # Winding: the sign flips where all three or none of the crossing
    # conditions hold (iq sdPolygon).
    c1 = py >= ay
    c2 = py < by
    c3 = ex * wy > ey * wx
    flip = (c1 & c2 & c3) | (~c1 & ~c2 & ~c3)
    odd = torch.remainder(torch.sum(flip, dim=-1), 2).to(torch.float32)
    return (1.0 - 2.0 * odd) * torch.sqrt(torch.clamp(dist2, min=0.0))


def polygon_sdf_2d(point_xy, vertices, next_vertices):
    """iq's signed polygon distance, negative inside. point_xy (..., 2);
    vertices / next_vertices (..., E, 2). A degenerate (zero-length) pad
    edge contributes its point's distance and no winding flip."""
    return polygon_sdf_2d_p(point_xy[..., 0], point_xy[..., 1], vertices,
                            next_vertices)


def extruded_polygon_distance_p(x, y, z, volumes: HeightVolumes):
    """Planar form of `extruded_polygon_distance`: x, y, z broadcastable
    tensors -> the distance of their broadcast shape. The (few) volumes
    are walked one at a time, and the 2D polygon distance is taken at the
    broadcast shape of x and y alone (one plane for a pixel grid sampled
    at a height per light): the largest temporary is that shape x E."""
    x, y = torch.broadcast_tensors(x, y)
    best = None
    for p in range(volumes.capacity):
        sd2 = polygon_sdf_2d_p(x, y, volumes.vertices[p],
                               volumes.next_vertices[p])
        distance_xy = sd2 + POLYGON_XY_BIAS
        z0 = volumes.z_range[p, 0]
        z1 = volumes.z_range[p, 1]
        inside_z = (z >= z0) & (z <= z1)
        distance_z = torch.where(inside_z, torch.maximum(z - z1, z0 - z),
                                 torch.where(z > z1, z - z1, z0 - z))
        d = torch.where(
            distance_xy <= 0.0,
            torch.where(distance_z <= 0.0, distance_xy + distance_z,
                        distance_z),
            torch.clamp(distance_xy, min=0.0)
            + torch.clamp(distance_z, min=0.0))
        d = torch.where(volumes.active[p] > 0.5, d, 1e9)
        best = d if best is None else torch.minimum(best, d)
    return best


def extruded_polygon_distance(position, volumes: HeightVolumes):
    """3D distance at (..., 3) positions to the nearest volume, finalEval
    semantics (DistanceField.fx:46-72) with the xy bias."""
    return extruded_polygon_distance_p(position[..., 0], position[..., 1],
                                       position[..., 2], volumes)
