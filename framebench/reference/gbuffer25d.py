"""The 2.5D G-buffer, in plain PyTorch: the ground plane, the height
volumes' top and front faces, and mask billboards.

Written from the reference engine's definitions:
  * the ground plane (RenderGroundPlane, LightingRenderer.GBuffer.cs:
    271-329): normal +z at ground_z, no y offset, shadows enabled;
  * height volumes (GBuffer.fx HeightVolume / HeightVolumeFace :75-105,
    LightingRenderer.GBuffer.cs:221-265): geometry at height z appears at
    screen y = world y - zToY z. A pixel shows a volume's top face where
    the world point (x, y + zToY z_top) lies inside its polygon (the
    signed distance of `sdf25d.polygon_sd` at most 0), and the face of a
    south-facing edge (one whose outward normal, (ey, -ex) for a
    counter-clockwise polygon, has -ex > 1e-6) at the height z in
    [z_base, z_top] at which (x, y + zToY z) lies on that edge; the
    highest such z over the edges, the first edge of it. The depth test
    keeps the highest z over the volumes, the first volume of it (the
    GreaterEqual test over z / extent, drawn in order). The pixel's z is
    that z plus 0.5 (the faces' self-occlusion offset), its relativeY
    z zToY (GBuffer.fx:85), its normal +z on a top face, the edge's
    outward unit normal on a front face;
  * mask billboards (Billboard.cs:9-87, GBufferBitmap.fx) at the
    defaults (elevation 0, DataScale 1, normal (0, 1, 0), shadows on,
    not fullbright): a screen rectangle whose texels of alpha above 0.5
    (the nearest texel) stand up from the bottom edge: z = (1 - v)
    height zToY, relativeY = bottom - y, and the normal bent like a
    cylinder's across the rectangle (Billboard.cs:44-47): side = (2u - 1)
    CylinderFactor, n = unit(side, sqrt(1 - side^2), 0).

The G-buffer is a dict of planes: normal (H, W, 3), relative_y, z,
enable_shadows and fullbright (H, W), at render scale 1.
"""

from __future__ import annotations

import torch

from framebench.reference.sdf25d import polygon_sd

NONE = -1e9  # the z of "no face here"; a face is anything above -1e8
SELF_OCCLUSION_Z = 0.5


def ground(height: int, width: int, ground_z: float, device) -> dict:
    f32 = torch.float32
    normal = torch.zeros((height, width, 3), dtype=f32, device=device)
    normal[..., 2] = 1.0
    return dict(
        normal=normal,
        relative_y=torch.zeros((height, width), dtype=f32, device=device),
        z=torch.full((height, width), ground_z, dtype=f32, device=device),
        enable_shadows=torch.ones((height, width), dtype=f32, device=device),
        fullbright=torch.zeros((height, width), dtype=f32, device=device))


def pixel_centres(height: int, width: int, device):
    """World x (1, W) and y (H, 1) of the pixel centres."""
    f32 = torch.float32
    xs = torch.arange(width, dtype=f32, device=device) + 0.5
    ys = torch.arange(height, dtype=f32, device=device) + 0.5
    return xs[None, :], ys[:, None]


def _front_face(gx, gy, vertices, z0, z1, z_to_y):
    """The highest front-face z of one volume at each pixel (NONE where
    none) and that face's outward unit normal (x, y)."""
    m = vertices.shape[0]
    best = torch.full(torch.broadcast_shapes(gx.shape, gy.shape), NONE,
                      dtype=torch.float32, device=gx.device)
    nx = torch.zeros_like(best)
    ny = torch.zeros_like(best)
    for j in range(m):
        ax, ay = vertices[j, 0], vertices[j, 1]
        ex = vertices[(j + 1) % m, 0] - ax
        ey = vertices[(j + 1) % m, 1] - ay
        if not bool(-ex > 1e-6):
            continue  # not south-facing
        t = (gx - ax) / ex
        y_edge = ay + t * ey
        z_hit = (y_edge - gy) / torch.clamp(z_to_y, min=1e-6)
        valid = ((t >= 0.0) & (t <= 1.0) & (z_hit >= z0) & (z_hit <= z1)
                 & (z_to_y > 1e-6))
        z_edge = torch.where(valid, z_hit, NONE)
        higher = z_edge > best
        length = torch.sqrt(torch.clamp(ex * ex + ey * ey, min=1e-12))
        nx = torch.where(higher, ey / length, nx)
        ny = torch.where(higher, -ex / length, ny)
        best = torch.maximum(best, z_edge)
    return best, nx, ny


def height_volumes(gbuf: dict, volumes, z_to_y) -> dict:
    """Write the volumes' faces into the G-buffer, every face casting
    shadows (HeightVolume's defaults). volumes: a list of (vertices
    (M, 2) float32, z_base, z_top (0-d float32)); z_to_y a 0-d float32
    tensor."""
    h, w = gbuf["z"].shape
    gx, gy = pixel_centres(h, w, gbuf["z"].device)
    best = torch.full((h, w), NONE, dtype=torch.float32, device=gx.device)
    front = torch.zeros((h, w), dtype=torch.bool, device=gx.device)
    nx = torch.zeros_like(best)
    ny = torch.zeros_like(best)
    for vertices, z0, z1 in volumes:
        top = polygon_sd(gx, gy + z_to_y * z1, vertices) <= 0.0
        z_top = torch.where(top, z1, NONE)
        z_front, fx, fy = _front_face(gx, gy, vertices, z0, z1, z_to_y)
        z_front = torch.where(z_front > -1e8, z_front, NONE)
        use_front = z_front > z_top
        z = torch.maximum(z_top, z_front)
        nearer = z > best
        front = torch.where(nearer, use_front, front)
        nx = torch.where(nearer, fx, nx)
        ny = torch.where(nearer, fy, ny)
        best = torch.maximum(best, z)
    hit = best > -1e8
    up = torch.tensor([0.0, 0.0, 1.0], device=gx.device)
    normal = torch.where(front[..., None],
                         torch.stack([nx, ny, torch.zeros_like(nx)], dim=-1),
                         up)
    z_out = best + SELF_OCCLUSION_Z
    return dict(
        gbuf,
        normal=torch.where(hit[..., None], normal, gbuf["normal"]),
        relative_y=torch.where(hit, z_out * z_to_y, gbuf["relative_y"]),
        z=torch.where(hit, z_out, gbuf["z"]),
        enable_shadows=torch.where(hit, 1.0, gbuf["enable_shadows"]))


def _unit(n):
    return n / torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                      min=1e-12))


def mask_billboard(gbuf: dict, bounds, texture, z_to_y,
                   cylinder_factor: float) -> dict:
    """Write one mask billboard into the G-buffer: bounds (x0, y0, x1, y1)
    on the screen; texture (TH, TW, 4) float32 (its alpha the mask)."""
    h, w = gbuf["z"].shape
    dev = gbuf["z"].device
    xs, ys = pixel_centres(h, w, dev)
    gy, gx = torch.broadcast_tensors(ys, xs)
    x0, y0, x1, y1 = bounds
    inside = (gx >= x0) & (gx < x1) & (gy >= y0) & (gy < y1)
    u = torch.clamp((gx - x0) / max(x1 - x0, 1e-6), 0.0, 1.0)
    v = torch.clamp((gy - y0) / max(y1 - y0, 1e-6), 0.0, 1.0)
    th, tw = texture.shape[0], texture.shape[1]
    ti = torch.clamp((v * th).to(torch.int64), 0, th - 1)
    tj = torch.clamp((u * tw).to(torch.int64), 0, tw - 1)
    hit = inside & (texture[ti, tj][..., 3] > 0.5)
    z = (1.0 - v) * (y1 - y0) * torch.clamp(z_to_y, min=0.0)
    side = (u * 2.0 - 1.0) * cylinder_factor
    bend = torch.sqrt(torch.clamp(1.0 - side * side, min=0.0))
    n = _unit(torch.stack([side, bend, torch.zeros_like(side)], dim=-1))
    return dict(
        normal=torch.where(hit[..., None], n, gbuf["normal"]),
        relative_y=torch.where(hit, y1 - gy, gbuf["relative_y"]),
        z=torch.where(hit, z, gbuf["z"]),
        enable_shadows=torch.where(hit, 1.0, gbuf["enable_shadows"]),
        fullbright=torch.where(hit, 0.0, gbuf["fullbright"]))
