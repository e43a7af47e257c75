"""G-buffer billboards: sprites that stand up in the 2.5D scene.

Counterpart of illuminant_tpu/lighting/billboard.py (Billboard.cs,
LightingRenderer.GBuffer.cs RenderGBufferBillboards :331-506,
GBufferBitmap.fx, AutoGBufferBitmap.fx): a screen rectangle whose covered
pixels write normal / z / relativeY into the G-buffer. Billboards are few;
each one rasterizes over the whole pixel grid in a host loop in sort
order, its texture uploaded and read by a nearest-texel gather.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.coords import decode_normal_spherical
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer

TYPE_MASK = 0
TYPE_GBUFFER_DATA = 1
# AutoGBufferBitmap.fx variants: g-data inferred from an ordinary sprite.
TYPE_AUTO = 2              # AutoGBufferBitmapPixelShader (:12-57)
TYPE_NORMAL_BILLBOARD = 3  # NormalBillboardPixelShader (:59-101)


@dataclasses.dataclass
class Billboard:
    """Host billboard (Billboard.cs:9-87)."""

    screen_bounds: Tuple[float, float, float, float] = (0, 0, 32, 32)
    texture: Optional[np.ndarray] = None  # (TH, TW, 4); None: the full rect
    type: int = TYPE_MASK
    normal: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    world_elevation: float = 0.0  # z of the billboard's bottom edge
    cylinder_factor: float = 0.0
    data_scale: float = 1.0
    static_lighting_only: bool = False
    enable_shadows: bool = True
    sort_key: float = 0.0
    # AutoGBufferBitmap parameters (userData / ZFromDistance): a normal_z
    # below -900 disables directional occlusion.
    normal_z: float = 0.0
    z_to_y_ratio: float = 0.0
    base_z: float = 0.0
    fullbright: bool = False
    normals_are_signed: bool = False
    distance_texture: Optional[np.ndarray] = None  # (TH, TW) float32
    # (min z offset, max z offset, distance scale)
    z_from_distance: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _texel(tex, u, v):
    """Nearest texel of `tex` (TH, TW, ...) at u, v in [0, 1]."""
    th, tw = tex.shape[0], tex.shape[1]
    ti = torch.clamp((v * th).to(torch.int64), 0, th - 1)
    tj = torch.clamp((u * tw).to(torch.int64), 0, tw - 1)
    return tex[ti, tj]


def _unit(n):
    return n / torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                      min=1e-12))


def rasterize_billboards(gbuffer: GBuffer, billboards: List[Billboard],
                         env: EnvironmentUniforms) -> GBuffer:
    """Write billboards into the G-buffer in `sort_key` order (the
    reference sorts by SortKey / type / texture, GBuffer.cs:353-367)."""
    f32 = torch.float32
    h, w = gbuffer.shape
    dev = gbuffer.z.device
    scale = gbuffer.render_scale
    ys = (torch.arange(h, dtype=f32, device=dev) + 0.5) / scale
    xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / scale
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")

    def upload(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    normal = gbuffer.normal
    rel_y = gbuffer.relative_y
    z = gbuffer.z
    shadows = gbuffer.enable_shadows
    fullbright = gbuffer.fullbright

    for b in sorted(billboards, key=lambda b: b.sort_key):
        x0, y0, x1, y1 = b.screen_bounds
        inside = (gx >= x0) & (gx < x1) & (gy >= y0) & (gy < y1)
        u = torch.clamp((gx - x0) / max(x1 - x0, 1e-6), 0.0, 1.0)
        v = torch.clamp((gy - y0) / max(y1 - y0, 1e-6), 0.0, 1.0)

        texel = None
        hit = inside
        if b.texture is not None:
            texel = _texel(upload(b.texture), u, v)
            hit = inside & (texel[..., 3] > 0.5)

        if b.type == TYPE_MASK:
            # The silhouette stands up: world z rises from the bottom edge
            # by screen height * DataScale (Billboard.cs:49-52), and screen
            # y folds into relativeY so the lit world y is the billboard's
            # ground line.
            bz = (b.world_elevation
                  + (1.0 - v) * (y1 - y0) * b.data_scale
                  * torch.clamp(env.z_to_y_multiplier, min=0.0))
            b_rel = (y1 - gy) * b.data_scale  # anchored at the bottom edge
            # Cylinder normal bend (Billboard.cs:44-47).
            n0 = _unit(torch.tensor(b.normal, dtype=f32, device=dev))
            side = (u * 2.0 - 1.0) * b.cylinder_factor
            bend = torch.sqrt(torch.clamp(1.0 - side * side, min=0.0))
            n = _unit(torch.stack([n0[0] * bend + side, n0[1] * bend,
                                   n0[2].expand(side.shape)], dim=-1))
        elif b.type == TYPE_GBUFFER_DATA:
            # The texture's channels carry (encoded normal.xy, relativeY,
            # z) scaled by DataScale (Billboard.cs:88-117).
            n = decode_normal_spherical(texel[..., :2])
            b_rel = texel[..., 2] * b.data_scale
            bz = texel[..., 3] * b.data_scale
        elif b.type == TYPE_AUTO:
            # AutoGBufferBitmap (:32-56): the normal from the scalar
            # normal_z, relativeY measured up from the sprite's bottom
            # edge, z = base + zToYRatio * relativeY (+ the clamped
            # distance-texture offset).
            nz = b.normal_z
            if nz < -900.0:
                n = torch.zeros(gy.shape + (3,), dtype=f32, device=dev)
            else:
                n0 = np.asarray([0.0, 1.0 - abs(nz), nz], np.float32)
                n0 = n0 / max(np.linalg.norm(n0), 1e-9)
                n = upload(n0).expand(gy.shape + (3,))
            b_rel = (y1 - gy) * b.data_scale
            bz = b.base_z + b.z_to_y_ratio * b_rel
            if b.distance_texture is not None and \
                    abs(b.z_from_distance[2]) > 0.001:
                dist = _texel(upload(b.distance_texture), u, v)
                bz = bz + torch.clamp(b.z_from_distance[2] * dist,
                                      b.z_from_distance[0],
                                      b.z_from_distance[1])
        elif b.type == TYPE_NORMAL_BILLBOARD:
            # NormalBillboard (:59-101): the normal straight from the
            # sprite's rgb (signed or 0.5-biased); dead where the alpha is
            # low or the vector is about zero.
            rgb = texel[..., :3]
            n = rgb if b.normals_are_signed else (rgb - 0.5) * 2.0
            nl = torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1,
                                                  keepdim=True), min=1e-12))
            hit = hit & (nl[..., 0] > 0.01)
            n = n / nl
            b_rel = (y1 - gy) * b.data_scale
            bz = b.base_z + b.z_to_y_ratio * b_rel
        else:
            raise ValueError(f"unknown billboard type {b.type!r}")

        normal = torch.where(hit[..., None], n, normal)
        rel_y = torch.where(hit, b_rel, rel_y)
        z = torch.where(hit, bz, z)
        shadows = torch.where(hit, 1.0 if b.enable_shadows else 0.0, shadows)
        fullbright = torch.where(hit, 1.0 if b.fullbright else 0.0,
                                 fullbright)

    return gbuffer.replace(normal=normal, relative_y=rel_y, z=z,
                           enable_shadows=shadows, fullbright=fullbright)
