"""Projector lights: project a texture onto the scene.

Counterpart of illuminant_tpu/lighting/projector.py
(ProjectorLightCore.fxh; ProjectorLightSource,
Lighting/LightSource.cs:507-600): the shaded world position maps through
the projector's inverse transform into texture space (fxh:43-52), samples
the projection texture within a region with optional wrap or clamp falloff
(fxh:55-67, 290-301), and an optional origin point adds a normal factor
and cone-traced shadows (fxh:76-77, 134-137). The texture fetch is a
gather by advanced indexing; tex2Dbias is emulated over a 2x2-box mip
pyramid built at pack time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import QualitySettings
from ..core.pytree import tensor_dataclass
from .cone_trace import cone_trace
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from .sphere import compute_ao, compute_normal_factor


@tensor_dataclass
class ProjectorLights:
    """SoA: inverse_matrix (L, 4, 4) world -> projector space; texture
    (L, TH, TW, 4) padded to one size; properties = (radius, ramp_length,
    ramp_mode, cast_shadows); more = (ao_radius, opacity, wrap (0) or
    clamp-falloff (1), ao_opacity); texture_region (L, 4) x1 y1 x2 y2 in
    uv; origin (L, 4) xyz + has_origin; color (L, 4); active (L,);
    mip_bias (L,); `mips`, the pyramid of `texture` above level 0, a tuple
    of (L, TH/2^k, TW/2^k, 4); tex_size (L, 2), each light's (actual /
    padded) texture extent fractions (h, w)."""

    inverse_matrix: torch.Tensor
    texture: torch.Tensor
    properties: torch.Tensor
    more: torch.Tensor
    texture_region: torch.Tensor
    origin: torch.Tensor
    color: torch.Tensor
    active: torch.Tensor
    mip_bias: torch.Tensor
    mips: tuple = ()
    tex_size: Optional[torch.Tensor] = None

    @property
    def capacity(self):
        return self.inverse_matrix.shape[0]


@dataclasses.dataclass
class ProjectorLightSource:
    """Host (LightSource.cs:507-600). `transform` maps projector / texture
    space ([0, 1]^2 at z = 0) into the world; the pack inverts it."""

    texture: np.ndarray = None  # (TH, TW, 4) float
    transform: np.ndarray = None  # (4, 4) row-vector world transform
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: Tuple[float, float] = (128.0, 128.0)
    opacity: float = 1.0
    wrap: bool = False
    origin: Optional[Tuple[float, float, float]] = None
    cast_shadows: bool = False
    radius: float = 4.0
    ramp_length: float = 128.0
    # tex2Dbias LOD offset (the projector's MipBias).
    mip_bias: float = 0.0
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    ambient_occlusion_radius: float = 0.0
    ambient_occlusion_opacity: float = 1.0
    texture_region: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    # LightSource.BlendMode (LightSource.cs:65).
    blend_mode: str = "additive"

    def world_matrix(self) -> np.ndarray:
        if self.transform is not None:
            return np.asarray(self.transform, np.float32)
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = self.scale[0]
        m[1, 1] = self.scale[1]
        m[3, :3] = self.position
        return m


def pack_projector_lights(lights: List[ProjectorLightSource],
                          device="cuda") -> ProjectorLights:
    n = max(len(lights), 1)
    th = max((l.texture.shape[0] for l in lights if l.texture is not None),
             default=1)
    tw = max((l.texture.shape[1] for l in lights if l.texture is not None),
             default=1)
    inv = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    tex = np.zeros((n, th, tw, 4), np.float32)
    props = np.zeros((n, 4), np.float32)
    more = np.zeros((n, 4), np.float32)
    region = np.tile(np.asarray([0, 0, 1, 1], np.float32), (n, 1))
    origin = np.zeros((n, 4), np.float32)
    color = np.zeros((n, 4), np.float32)
    active = np.zeros((n,), np.float32)
    tex_size = np.ones((n, 2), np.float32)
    for i, l in enumerate(lights):
        try:
            inv[i] = np.linalg.inv(l.world_matrix())
        except np.linalg.LinAlgError:
            # A degenerate transform (zero scale) leaves an inactive
            # light instead of aborting the pack.
            continue
        if l.texture is not None:
            t = np.asarray(l.texture, np.float32)
            tex[i, : t.shape[0], : t.shape[1]] = t
            # Mixed-size textures pad to the largest; sampling rescales uv
            # by actual / padded so each image spans its full projection.
            tex_size[i] = [t.shape[0] / th, t.shape[1] / tw]
        else:
            tex_size[i] = [1.0, 1.0]
        props[i] = [l.radius, l.ramp_length, 0.0,
                    1.0 if l.cast_shadows else 0.0]
        more[i] = [l.ambient_occlusion_radius, l.opacity,
                   0.0 if l.wrap else 1.0, l.ambient_occlusion_opacity]
        region[i] = l.texture_region
        if l.origin is not None:
            origin[i] = [*l.origin, 1.0]
        color[i] = l.color
        active[i] = 1.0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    # The mip pyramid (2x2 box) for the tex2Dbias emulation. Odd
    # dimensions are edge-replicated before the pool: cropping would shift
    # the mip's content in uv space, compounding per level.
    mips = []
    level = tex
    while min(level.shape[1], level.shape[2]) >= 2:
        if level.shape[1] % 2:
            level = np.concatenate([level, level[:, -1:]], axis=1)
        if level.shape[2] % 2:
            level = np.concatenate([level, level[:, :, -1:]], axis=2)
        level = 0.25 * (level[:, 0::2, 0::2] + level[:, 1::2, 0::2]
                        + level[:, 0::2, 1::2] + level[:, 1::2, 1::2])
        mips.append(t(level))
        if len(mips) >= 5:
            break
    mip_bias = np.asarray(
        ([getattr(l, "mip_bias", 0.0) for l in lights] + [0.0] * n)[:n],
        np.float32)
    return ProjectorLights(
        inverse_matrix=t(inv), texture=t(tex), properties=t(props),
        more=t(more), texture_region=t(region), origin=t(origin),
        color=t(color), active=t(active), mip_bias=t(mip_bias),
        mips=tuple(mips), tex_size=t(tex_size))


def support_radius_px(lights: List[ProjectorLightSource],
                      render_scale: float = 1.0):
    """Conservative per-light support radius in pixels around each
    projected quad's center (position + scale / 2): the scaled quad's
    half-diagonal plus the ramp's reach; sizes the bounded evaluation
    window. Host-side, from the light sources."""
    out = []
    for l in lights:
        half_diag = 0.5 * math.hypot(l.scale[0], l.scale[1])
        out.append((half_diag + max(getattr(l, "ramp_length", 0.0), 0.0))
                   * render_scale)
    return np.asarray(out, np.float32)


def _transform_point(p, m):
    """Row-vector homogeneous transform with the perspective divide
    (fxh:43-44), as explicit multiply-adds."""
    out = (p[..., 0:1] * m[..., 0, :] + p[..., 1:2] * m[..., 1, :]
           + p[..., 2:3] * m[..., 2, :] + m[..., 3, :])
    w = torch.where(torch.abs(out[..., 3:4]) > 1e-9, out[..., 3:4], 1.0)
    return out / w


def _sample_texture_bilinear(tex, u, v, wrap):
    """tex (TH, TW, 4); u, v in [0, 1]; `wrap` (a float or 0-d tensor)
    above 0.5 wraps the texel indices, else they clamp."""
    th, tw = tex.shape[0], tex.shape[1]
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    wrap = torch.as_tensor(wrap, dtype=torch.float32, device=tex.device)

    def idx(a, n):
        ai = a.to(torch.int64)
        return torch.where(wrap > 0.5, torch.remainder(ai, n),
                           torch.clamp(ai, 0, n - 1))

    x0i = idx(x0, tw)
    x1i = idx(x0 + 1, tw)
    y0i = idx(y0, th)
    y1i = idx(y0 + 1, th)
    v00 = tex[y0i, x0i]
    v01 = tex[y0i, x1i]
    v10 = tex[y1i, x0i]
    v11 = tex[y1i, x1i]
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def _ediff(a, axis: int):
    """Forward difference along `axis` whose last element repeats its
    neighbour's: differencing the last row against the first (a wrapped
    roll) would force the coarsest mip on a 1-px border of every
    window."""
    n = a.shape[axis]
    d = a.narrow(axis, 1, n - 1) - a.narrow(axis, 0, n - 1)
    return torch.cat([d, d.narrow(axis, n - 2, 1)], dim=axis)


def _sample_texture_mipped(lights, i, uv, wrap):
    """tex2Dbias emulation: the per-pixel LOD from the projected uv's
    screen derivative (a finite difference along the pixel grid) plus the
    light's MipBias, trilinear across the pyramid. Plain bilinear when
    there is no pyramid or the uv field has no screen extent."""
    base = lights.texture[i]
    u = uv[..., 0]
    v = uv[..., 1]
    if lights.tex_size is not None:
        # Content uv -> padded-atlas uv: wrap over the actual texture
        # extent, then rescale both axes by actual / padded.
        frac_h = lights.tex_size[i, 0]
        frac_w = lights.tex_size[i, 1]
        u = torch.where(wrap > 0.5, torch.remainder(u, 1.0), u) * frac_w
        v = torch.where(wrap > 0.5, torch.remainder(v, 1.0), v) * frac_h
        wrap = 0.0  # already wrapped in content space
    if not lights.mips or u.dim() < 2 or u.shape[-1] < 2 or u.shape[-2] < 2:
        return _sample_texture_bilinear(base, u, v, wrap)
    th, tw = base.shape[0], base.shape[1]
    dudx = _ediff(u, u.dim() - 1) * tw
    dvdx = _ediff(v, v.dim() - 1) * th
    dudy = _ediff(u, u.dim() - 2) * tw
    dvdy = _ediff(v, v.dim() - 2) * th
    foot = torch.sqrt(torch.clamp(
        torch.maximum(dudx * dudx + dvdx * dvdx, dudy * dudy + dvdy * dvdy),
        min=1e-12))
    n_levels = len(lights.mips)
    lod = torch.clamp(
        0.5 * torch.log2(torch.clamp(foot * foot, min=1e-12))
        + lights.mip_bias[i], 0.0, float(n_levels))
    out = _sample_texture_bilinear(base, u, v, wrap) * torch.clamp(
        1.0 - lod, 0.0, 1.0)[..., None]
    for lvl in range(n_levels):
        wgt = torch.clamp(1.0 - torch.abs(lod - (lvl + 1)), 0.0, 1.0)
        out = out + _sample_texture_bilinear(
            lights.mips[lvl][i], u, v, wrap) * wgt[..., None]
    return out


def accumulate_projector_lights(volume, gbuffer: GBuffer,
                                lights: ProjectorLights,
                                env: EnvironmentUniforms,
                                quality: QualitySettings):
    """All projector lights -> (H, W, 4) additive HDR contribution, one
    light at a time (each has its own texture). The AO sample and the
    cone march toward the origin run for every light, as in the JAX
    package; the march ends at once where no ray is enabled (no origin,
    or shadows off)."""
    world_pos = gbuffer.world_position()
    normal = gbuffer.normal
    h, w = gbuffer.shape

    out = torch.zeros((h, w, 4), dtype=torch.float32, device=world_pos.device)
    for i in range(lights.capacity):
        psp = _transform_point(world_pos, lights.inverse_matrix[i])
        region = lights.texture_region[i]
        uv = psp[..., :2] + region[:2]

        clamped = torch.minimum(torch.maximum(uv, region[:2]), region[2:])
        clamp_mode = lights.more[i, 2]
        # The clamp-mode falloff includes the projector-space z overshoot,
        # like the reference's clamp3 (fxh:57-67).
        zr = psp[..., 2]
        dz = zr - torch.clamp(zr, 0.0, 1.0)
        dist_out = torch.sqrt(torch.sum((clamped - uv) ** 2, dim=-1)
                              + dz * dz)
        distance_opacity = torch.where(
            clamp_mode > 0.5,
            torch.clamp(1.0 - torch.clamp(dist_out, max=0.001) * 1000.0,
                        min=0.0), 1.0)
        uv_final = uv + (clamped - uv) * clamp_mode  # fxh:74

        origin = lights.origin[i]
        light_normal = world_pos - origin[:3]
        ln = light_normal / torch.sqrt(torch.clamp(
            torch.sum(light_normal ** 2, dim=-1, keepdim=True), min=1e-12))
        nf = compute_normal_factor(ln, normal)
        normal_opacity = 1.0 + (nf - 1.0) * origin[3]

        visible = ((distance_opacity > 0.0) & (world_pos[..., 0] > -9999.0)
                   & (gbuffer.fullbright < 0.5))

        ao_radius = lights.more[i, 0] * torch.clamp(normal[..., 2], min=0.0)
        ao = compute_ao(volume, world_pos, normal, ao_radius,
                        lights.more[i, 3], visible)

        trace_enable = (
            visible
            & (lights.properties[i, 3] * gbuffer.enable_shadows > 0.0)
            & (origin[3] > 0.5) & (lights.active[i] > 0.0))
        cone = cone_trace(volume, origin[:3], lights.properties[i, 0],
                          lights.properties[i, 1], world_pos + 1.5 * normal,
                          trace_enable, quality)

        tex_color = _sample_texture_mipped(lights, i, uv_final,
                                           1.0 - clamp_mode)
        opacity = (distance_opacity * normal_opacity * lights.more[i, 1] * ao
                   * cone)
        opacity = torch.where(visible, opacity, 0.0) * lights.active[i]
        color = tex_color * lights.color[i]
        rgb = color[..., :3] * color[..., 3:4] * opacity[..., None]
        out = out + torch.cat([rgb, opacity[..., None]], dim=-1)
    return out
