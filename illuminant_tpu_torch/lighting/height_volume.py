"""Height-volume G-buffer rasterization.

Counterpart of illuminant_tpu/lighting/height_volume.py (GBuffer.fx
HeightVolume / HeightVolumeFace, LightingRenderer.GBuffer.cs:221-265);
sdf/height_volume.py holds the geometry. Top and front faces are analytic
per-pixel coverage tests over (P, H, W) and (P, H, W, E) planes, not a mesh
rasterization: volumes are few and the pixel grid is the big axis.
"""

from __future__ import annotations

import torch

from ..sdf.height_volume import (  # noqa: F401 -- re-exported
    HeightVolume, HeightVolumes, POLYGON_XY_BIAS, extruded_polygon_distance,
    pack_height_volumes, polygon_sdf_2d, polygon_sdf_2d_p)
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer

_NONE = -1e9  # the z of "no face here"; a hit is anything above -1e8


def rasterize_height_volumes(gbuffer: GBuffer, volumes: HeightVolumes,
                             env: EnvironmentUniforms,
                             self_occlusion_z: float = 0.5) -> GBuffer:
    """Write top and front faces into the G-buffer (GBuffer.fx:75-105).

    Screen-space shear: geometry at height z appears at screen
    y = world_y - zToY * z. Depth resolve: the highest z wins (the
    reference's GreaterEqual depth test over z / extent); of two volumes
    at one height, the first. With zToY <= 1e-6 no front face exists."""
    f32 = torch.float32
    h, w = gbuffer.shape
    dev = gbuffer.z.device
    scale = gbuffer.render_scale
    z_to_y = env.z_to_y_multiplier
    sy = (torch.arange(h, dtype=f32, device=dev) + 0.5) / scale
    sx = (torch.arange(w, dtype=f32, device=dev) + 0.5) / scale
    gx = sx[None, None, :]  # (1, 1, W)
    gy = sy[None, :, None]  # (1, H, 1)

    z_top = volumes.z_range[:, 1][:, None, None]  # (P, 1, 1)
    z_base = volumes.z_range[:, 0][:, None, None]
    active = volumes.active[:, None, None] > 0.5

    # Top faces: world xy = (sx, sy + zToY * z_top) inside the polygon.
    top_x, top_y = torch.broadcast_tensors(gx + torch.zeros_like(z_top),
                                           gy + z_to_y * z_top)
    sd_top = polygon_sdf_2d_p(top_x, top_y, volumes.vertices[:, None, None],
                              volumes.next_vertices[:, None, None])
    top_hit = (sd_top <= 0.0) & active  # (P, H, W)

    # Front faces: a pixel shows the face of a south-facing edge at height
    # z when the world point (sx, sy + zToY * z) lies on that edge; solved
    # per edge for z in [z_base, z_top].
    a = volumes.vertices  # (P, E, 2)
    b = volumes.next_vertices
    ex = (b[..., 0] - a[..., 0])[:, None, None]  # (P, 1, 1, E)
    ey = (b[..., 1] - a[..., 1])[:, None, None]
    ax = a[:, None, None, :, 0]
    ay = a[:, None, None, :, 1]
    # The outward normal of a counter-clockwise edge is (ey, -ex); it faces
    # south (+y on screen) when -ex > 0.
    south = (-ex) > 1e-6
    t_edge = (gx[..., None] - ax) / torch.where(torch.abs(ex) > 1e-6, ex,
                                                1e9)  # (P, 1, W, E)
    in_span = (t_edge >= 0.0) & (t_edge <= 1.0)
    y_edge = ay + t_edge * ey
    z_hit = (y_edge - gy[..., None]) / torch.clamp(z_to_y, min=1e-6)
    valid = (in_span & south
             & (z_hit >= z_base[..., None]) & (z_hit <= z_top[..., None])
             & active[..., None] & (z_to_y > 1e-6))  # (P, H, W, E)
    # Per volume: the highest valid front-face z and its edge's normal.
    z_valid = torch.where(valid, z_hit, _NONE)
    z_front = torch.amax(z_valid, dim=-1)  # (P, H, W)
    edge_idx = torch.argmax(z_valid, dim=-1)  # the first maximum
    front_hit = z_front > -1e8
    elen = torch.sqrt(torch.clamp(ex * ex + ey * ey, min=1e-12))
    shape = z_hit.shape

    def of_edge(per_edge):
        return torch.gather(per_edge.expand(shape), -1,
                            edge_idx[..., None])[..., 0]

    nx = of_edge(ey / elen)
    ny = of_edge(-ex / elen)

    # Depth resolve over the candidates: the top z where top_hit, the
    # front z where front_hit and no higher top covers it.
    z_top_cand = torch.where(top_hit, z_top.expand(top_hit.shape), _NONE)
    z_front_cand = torch.where(front_hit, z_front, _NONE)
    use_front = z_front_cand > z_top_cand
    z_cand = torch.maximum(z_top_cand, z_front_cand)  # (P, H, W)
    best_p = torch.argmax(z_cand, dim=0)  # (H, W), the first maximum
    best_z = torch.amax(z_cand, dim=0)
    hit = best_z > -1e8

    def pick(per_volume):
        return torch.gather(per_volume.expand(z_cand.shape), 0,
                            best_p[None])[0]

    front_sel = pick(use_front)
    pnx = pick(nx)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev)
    normal = torch.where(
        front_sel[..., None],
        torch.stack([pnx, pick(ny), torch.zeros_like(pnx)], dim=-1), up)
    shadows = torch.where(front_sel,
                          pick(volumes.front_shadows[:, None, None]),
                          pick(volumes.top_shadows[:, None, None]))
    z_out = best_z + self_occlusion_z
    relative_y = z_out * z_to_y  # GBuffer.fx:85

    return gbuffer.replace(
        normal=torch.where(hit[..., None], normal, gbuffer.normal),
        relative_y=torch.where(hit, relative_y, gbuffer.relative_y),
        z=torch.where(hit, z_out, gbuffer.z),
        enable_shadows=torch.where(hit, shadows, gbuffer.enable_shadows))
