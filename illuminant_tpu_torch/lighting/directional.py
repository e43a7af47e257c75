"""Directional lights.

Counterpart of illuminant_tpu/lighting/directional.py (DirectionalLight.fx
and DirectionalLightSource, Lighting/LightSource.cs:105-212): a light
direction (or none: a pure ambient term), normal-factor opacity with the
directional dot constants (LightCommon.fxh:7-8, 224-231), AO, and shadows
traced toward a fake light center `pixel - direction * shadowTraceLength`
(DirectionalLight.fx:76-83) with (softness, rampRate) shaping the cone.
On the scan path the parallel rays are the limit of the radial scan with
its center pushed far along -direction (`_scan_pseudo_centers`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import QualitySettings
from ..core.pytree import tensor_dataclass
from .cone_trace import cone_trace
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from .sphere import compute_ao, compute_normal_factor

# LightCommon.fxh:7-8.
DIRECTIONAL_DOT_OFFSET = 0.35
DIRECTIONAL_DOT_RAMP_RANGE = 0.35
# DirectionalLight.fx:13.
SELF_OCCLUSION_HACK = 1.5


@tensor_dataclass
class DirectionalLights:
    """SoA: direction (L, 4) normalized xyz with .w the has-direction flag
    (0: ambient); color (L, 4), opacity folded into alpha; properties =
    (cast_shadows, trace_length, softness, ramp_rate) (fx:57); more =
    (ao_radius, distance_falloff, _, ao_opacity); active (L,)."""

    direction: torch.Tensor
    color: torch.Tensor
    properties: torch.Tensor
    more: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.direction.shape[0]


@dataclasses.dataclass
class DirectionalLightSource:
    """Host-side (LightSource.cs:105-212)."""

    direction: Optional[Tuple[float, float, float]] = (0.0, 0.0, -1.0)
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    opacity: float = 1.0
    cast_shadows: bool = True
    shadow_trace_length: float = 256.0
    shadow_softness: float = 12.0
    shadow_ramp_rate: float = 0.5
    shadow_distance_falloff: Optional[float] = None
    ambient_occlusion_radius: float = 0.0
    ambient_occlusion_opacity: float = 1.0
    # LightSource.BlendMode (LightSource.cs:65).
    blend_mode: str = "additive"


def pack_directional_lights(lights: List[DirectionalLightSource],
                            capacity: Optional[int] = None,
                            device="cuda") -> DirectionalLights:
    n = len(lights)
    cap = capacity or max(n, 1)
    direction = np.zeros((cap, 4), np.float32)
    color = np.zeros((cap, 4), np.float32)
    props = np.zeros((cap, 4), np.float32)
    more = np.zeros((cap, 4), np.float32)
    more[:, 3] = 1.0
    active = np.zeros((cap,), np.float32)
    for i, l in enumerate(lights):
        if l.direction is not None:
            d = np.asarray(l.direction, np.float32)
            norm = np.linalg.norm(d)
            if norm > 0:
                d = d / norm
            direction[i] = [*d, 1.0]
        col = np.asarray(l.color, np.float32).copy()
        col[3] *= l.opacity
        color[i] = col
        props[i] = [1.0 if l.cast_shadows else 0.0, l.shadow_trace_length,
                    l.shadow_softness, l.shadow_ramp_rate]
        more[i] = [l.ambient_occlusion_radius,
                   l.shadow_distance_falloff or 0.0, 0.0,
                   l.ambient_occlusion_opacity]
        active[i] = 1.0

    def t(a):
        return torch.as_tensor(a, device=device)

    return DirectionalLights(direction=t(direction), color=t(color),
                             properties=t(props), more=t(more),
                             active=t(active))


def compute_directional_opacity(light_direction, shaded_normal):
    """computeDirectionalLightOpacity (LightCommon.fxh:224-231)."""
    factor = compute_normal_factor(
        light_direction[..., :3], shaded_normal, DIRECTIONAL_DOT_OFFSET,
        DIRECTIONAL_DOT_RAMP_RANGE)
    return torch.where(light_direction[..., 3] < 0.1, 1.0, factor)


def _scan_pseudo_centers(gbuffer: GBuffer, lights: DirectionalLights,
                         env: EnvironmentUniforms):
    """Far pseudo light centers for the scan path: a center at in-plane
    distance D = 4 screen diagonals from the screen center bounds the
    ray-direction error across the screen by atan(1/8). Its z sits at
    slope -dz/|d_xy|, so the scan readout's 3D secant (the trace-length
    cap, the refine samples' ray heights) follows the true directional
    ray.

    Returns (centers (L, 3), the trace plane's z, D)."""
    h, w = gbuffer.shape
    rs = gbuffer.render_scale
    d = lights.direction
    n_xy = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    # Near-vertical lights have no in-plane shadow travel; the clamp
    # keeps the geometry finite.
    safe = torch.clamp(n_xy, min=0.05)
    u_xy = d[:, :2] / safe[:, None]
    dist = 4.0 * float(np.hypot(h, w)) / rs
    z0 = torch.mean(gbuffer.z)
    cx = 0.5 * w / rs
    cy = 0.5 * h / rs + torch.mean(gbuffer.relative_y)
    centers = torch.stack([cx - u_xy[:, 0] * dist, cy - u_xy[:, 1] * dist,
                           z0 - d[:, 2] / safe * dist], dim=-1)
    # The occlusion image's height: blockers matter only where the ray is
    # low, and over-nomination is safe (the 3D refine rejects blockers the
    # true ray clears), so the plane stays inside the environment's height
    # band, biased low.
    rise = torch.clamp(-d[:, 2], min=0.0) * lights.properties[:, 1]
    wsum = torch.clamp(torch.sum(lights.active), min=1.0)
    rise_mean = torch.sum(rise * lights.active) / wsum
    band = torch.clamp(env.maximum_z - env.ground_z, min=1.0)
    trace_plane = z0 + torch.minimum(0.4 * rise_mean, 0.25 * band)
    return centers, trace_plane, dist


def directional_scan_args(gbuffer: GBuffer, lights: DirectionalLights,
                          env: EnvironmentUniforms):
    """The radial scan's arguments for directional lights: (centers
    (L, 3), radius (L,), ramp (L,), max_trace_distance (L,), trace plane
    ()). Shared by the in-family scan branch and the fused multi-family
    scan (scenes.py)."""
    centers, trace_plane, _ = _scan_pseudo_centers(gbuffer, lights, env)
    ramp = torch.clamp(lights.more[:, 1], min=16.0) / torch.clamp(
        lights.properties[:, 3], min=1e-3)
    return (centers, lights.properties[:, 2], ramp, lights.properties[:, 1],
            trace_plane)


def accumulate_directional_lights(volume, gbuffer: GBuffer,
                                  lights: DirectionalLights,
                                  env: EnvironmentUniforms,
                                  quality: QualitySettings,
                                  shadow_mode: str = "march",
                                  scan_visibility_precomputed=None,
                                  with_ao: bool = True):
    """All directional lights -> (H, W, 4) additive HDR contribution.
    `scan_visibility_precomputed` ((L, H, W)): visibility from a fused
    radial scan over `_scan_pseudo_centers`; it implies the scan path.
    `shadow_mode`: "scan" (the column scan with far pseudo centers and
    the ShadowTraceLength cap), "none", or the per-pixel cone march
    (fx:76-83)."""
    world_pos = gbuffer.world_position()
    normal = gbuffer.normal

    direction = lights.direction[:, None, None, :]
    props = lights.properties[:, None, None, :]
    more = lights.more[:, None, None, :]
    active = lights.active[:, None, None]

    opacity = compute_directional_opacity(direction, normal[None])
    visible = (world_pos[None, ..., 0] > -9999.0) & (
        gbuffer.fullbright[None] < 0.5)

    if with_ao:
        # Hosts skip this statically when no light has an AO radius: it
        # costs a full-resolution field evaluation per light.
        ao_radius = more[..., 0] * torch.clamp(normal[None, ..., 2], min=0.0)
        opacity = opacity * compute_ao(volume, world_pos[None], normal[None],
                                       ao_radius, more[..., 3], visible)

    cast = props[..., 0] * gbuffer.enable_shadows[None]
    trace_enable = (visible & (cast > 0.0) & (opacity >= 1.0 / 256.0)
                    & (direction[..., 3] >= 0.1) & (active > 0.0))
    if scan_visibility_precomputed is not None:
        cone = torch.where(trace_enable,
                           scan_visibility_precomputed.to(torch.float32),
                           1.0)
    elif shadow_mode == "none":
        cone = 1.0
    elif shadow_mode == "scan":
        from .scan_shadows import scan_cone_visibility

        centers, radius, scan_ramp, mtd, trace_plane = \
            directional_scan_args(gbuffer, lights, env)
        vis = scan_cone_visibility(
            volume, gbuffer, centers, radius, scan_ramp, quality,
            max_trace_distance=mtd, trace_z=trace_plane,
            self_occlusion_lift=SELF_OCCLUSION_HACK)
        cone = torch.where(trace_enable, vis, 1.0)
    else:
        # Cone config (fx:78-83): radius = softness, ramp = distance
        # falloff, the per-light growth factor rampRate folded into the
        # ramp length. The fake light center sits behind the pixel along
        # the direction (fx:76-77).
        ramp = torch.clamp(more[..., 1], min=16.0) / torch.clamp(
            props[..., 3], min=1e-3)
        fake_center = world_pos[None] - direction[..., :3] * props[..., 1:2]
        cone = cone_trace(
            volume, fake_center, props[..., 2], ramp,
            world_pos[None] + SELF_OCCLUSION_HACK * normal[None],
            trace_enable, quality)
    opacity = opacity * cone

    opacity = torch.where(visible, opacity, 0.0) * active
    rgb = (lights.color[:, None, None, :3] * lights.color[:, None, None, 3:4]
           * opacity[..., None])
    return torch.cat([rgb.sum(dim=0), opacity.sum(dim=0)[..., None]], dim=-1)
