"""Line lights.

Counterpart of illuminant_tpu/lighting/line.py (LineLight.fx,
LineLightCore.fxh, FBPBR.fxh:53-101; LineLightSource,
Lighting/LightSource.cs:313-371): a segment light with Frostbite-style
area-light illuminance (rectangle solid angle plus a sphere term at the
closest point), colors lerped start -> end by the closest-point parameter
u (LineLight.fx:40), and shadows from three radial scans anchored at the
segment's start, midpoint and end, or from the 3-ray cone march at
u - offset / u / u + offset whose raw visibilities average before the
threshold (LineLightCore.fxh:17-68).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import QualitySettings
from ..core.pytree import tensor_dataclass
from .cone_trace import (FULLY_SHADOWED_THRESHOLD, UNSHADOWED_THRESHOLD,
                         cone_trace)
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from .sphere import compute_ao

SELF_OCCLUSION_HACK = 1.5  # LineLightCore.fxh:10
SHADOW_OPACITY_THRESHOLD = 0.75 / 255.0


@tensor_dataclass
class LineLights:
    """SoA: start / end (L, 3); color_start / color_end (L, 4); properties
    = (radius, ramp_length, mode, shadows); more = (ao_radius, falloff,
    y_factor, ao_opacity); active (L,)."""

    start: torch.Tensor
    end: torch.Tensor
    color_start: torch.Tensor
    color_end: torch.Tensor
    properties: torch.Tensor
    more: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self):
        return self.start.shape[0]


@dataclasses.dataclass
class LineLightSource:
    """Host (LightSource.cs:313-371)."""

    start: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    end: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    radius: float = 1.0
    color_start: tuple = (1.0, 1.0, 1.0, 1.0)
    color_end: Optional[tuple] = None
    opacity: float = 1.0
    cast_shadows: bool = True
    ambient_occlusion_radius: float = 0.0
    ambient_occlusion_opacity: float = 1.0
    # LightSource.BlendMode (LightSource.cs:65).
    blend_mode: str = "additive"


def pack_line_lights(lights: List[LineLightSource],
                     capacity: Optional[int] = None,
                     device="cuda") -> LineLights:
    n = len(lights)
    cap = capacity or max(n, 1)
    start = np.zeros((cap, 3), np.float32)
    end = np.ones((cap, 3), np.float32)
    cs = np.zeros((cap, 4), np.float32)
    ce = np.zeros((cap, 4), np.float32)
    props = np.zeros((cap, 4), np.float32)
    more = np.zeros((cap, 4), np.float32)
    more[:, 2] = 1.0
    more[:, 3] = 1.0
    active = np.zeros((cap,), np.float32)
    for i, l in enumerate(lights):
        start[i] = l.start
        end[i] = l.end
        a = np.asarray(l.color_start, np.float32).copy()
        a[3] *= l.opacity
        b = np.asarray(l.color_end if l.color_end is not None
                       else l.color_start, np.float32).copy()
        b[3] *= l.opacity
        cs[i] = a
        ce[i] = b
        props[i] = [l.radius, 1.0, 0.0, 1.0 if l.cast_shadows else 0.0]
        more[i] = [l.ambient_occlusion_radius, 0.0, 1.0,
                   l.ambient_occlusion_opacity]
        active[i] = 1.0

    def t(a):
        return torch.as_tensor(a, device=device)

    return LineLights(start=t(start), end=t(end), color_start=t(cs),
                      color_end=t(ce), properties=t(props), more=t(more),
                      active=t(active))


def _saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def _norm(v, eps=1e-12):
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=eps))


def _unit(v):
    return v / _norm(v)[..., None]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def closest_point_on_segment(p0, p1, point):
    """-> (closest (..., 3), u (...,)) with u clamped to [0, 1]."""
    d = p1 - p0
    len_sq = torch.clamp(torch.sum(d * d, dim=-1), min=1e-12)
    u = _saturate(torch.sum((point - p0) * d, dim=-1) / len_sq)
    return p0 + u[..., None] * d, u


def rectangle_solid_angle(world, p0, p1, p2, p3):
    """FBPBR.fxh:33-51."""
    v0 = p0 - world
    v1 = p1 - world
    v2 = p2 - world
    v3 = p3 - world
    n0 = _unit(_cross(v0, v1))
    n1 = _unit(_cross(v1, v2))
    n2 = _unit(_cross(v2, v3))
    n3 = _unit(_cross(v3, v0))

    def g(a, b):
        return torch.acos(torch.clamp(torch.sum(-a * b, dim=-1), -1.0, 1.0))

    return g(n0, n1) + g(n1, n2) + g(n2, n3) + g(n3, n0) - 2.0 * math.pi


def compute_line_light_opacity(world, normal, p0, p1, radius):
    """computeLineLightOpacity (FBPBR.fxh:53-101) -> (opacity, the
    closest point on the segment, u)."""
    light_left = _unit(p1 - p0)
    light_center = (p0 + p1) * 0.5

    sphere_pos, u = closest_point_on_segment(p0, p1, world)
    forward = _unit(sphere_pos - world)
    up = _cross(light_left, forward)
    r = radius[..., None]
    q0 = p0 + r * up
    q1 = p0 - r * up
    q2 = p1 - r * up
    q3 = p1 + r * up
    solid_angle = rectangle_solid_angle(world, q0, q1, q2, q3)

    def sdot(p):
        return _saturate(torch.sum(_unit(p - world) * normal, dim=-1))

    illuminance = solid_angle * 0.2 * (
        sdot(q0) + sdot(q1) + sdot(q2) + sdot(q3) + sdot(light_center))
    sphere_un = sphere_pos - world
    sq_dist = torch.clamp(torch.sum(sphere_un * sphere_un, dim=-1), min=1e-9)
    ill_sphere = (math.pi
                  * _saturate(torch.sum(_unit(sphere_un) * normal, dim=-1))
                  * (radius * radius / sq_dist))
    return _saturate(illuminance + ill_sphere), sphere_pos, u


def line_scan_anchors(lights: LineLights):
    """The segment anchors as radial-scan centers: (3L, 3) positions
    (start, midpoint, end; anchor-major) with tiled radii and ramps.
    Shared by the in-family scan branch and the fused multi-family scan
    (scenes.py)."""
    anchors = torch.cat(
        [lights.start, (lights.start + lights.end) * 0.5, lights.end], dim=0)
    return (anchors, lights.properties[:, 0].repeat(3),
            lights.properties[:, 1].repeat(3))


def accumulate_line_lights(volume, gbuffer: GBuffer, lights: LineLights,
                           env: EnvironmentUniforms,
                           quality: QualitySettings,
                           shadow_mode: str = "march",
                           scan_visibility_precomputed=None,
                           with_ao: bool = True):
    """All line lights -> (H, W, 4) additive HDR contribution.

    `scan_visibility_precomputed` ((3L, H, W), anchor-major like
    `line_scan_anchors`): per-anchor visibilities from a caller's fused
    radial scan; it implies the scan path and takes precedence over
    `shadow_mode`. `shadow_mode="scan"` blends the thresholded
    visibilities of the three fixed anchors by hat weights over u;
    "none" skips the shadows; any other value runs the 3-ray march."""
    world_pos = gbuffer.world_position()
    normal = gbuffer.normal

    p0 = lights.start[:, None, None, :]
    p1 = lights.end[:, None, None, :]
    props = lights.properties[:, None, None, :]
    more = lights.more[:, None, None, :]
    active = lights.active[:, None, None]
    radius = props[..., 0]

    opacity, _, u = compute_line_light_opacity(
        world_pos[None], normal[None], p0, p1, radius)
    visible = ((opacity > 0.0) & (world_pos[None, ..., 0] > -9999.0)
               & (gbuffer.fullbright[None] < 0.5))

    if with_ao:
        ao_radius = more[..., 0] * torch.clamp(normal[None, ..., 2], min=0.0)
        pre_trace = opacity * compute_ao(volume, world_pos[None],
                                         normal[None], ao_radius,
                                         more[..., 3], visible)
    else:
        pre_trace = opacity

    cast = props[..., 3] * gbuffer.enable_shadows[None]
    trace_enable = (visible & (cast > 0.0)
                    & (pre_trace >= SHADOW_OPACITY_THRESHOLD)
                    & (active > 0.0))

    if shadow_mode == "none" and scan_visibility_precomputed is None:
        cone = 1.0
    elif shadow_mode == "scan" or scan_visibility_precomputed is not None:
        if scan_visibility_precomputed is not None:
            vis3 = scan_visibility_precomputed.to(torch.float32)
        else:
            from .scan_shadows import scan_cone_visibility

            anchors, rad3, ramp3 = line_scan_anchors(lights)
            vis3 = scan_cone_visibility(
                volume, gbuffer, anchors, rad3, ramp3, quality,
                self_occlusion_lift=SELF_OCCLUSION_HACK,
                light_active=lights.active.repeat(3))
        vis3 = vis3.reshape(3, lights.capacity, *vis3.shape[1:])
        # Hat weights over u: anchor 0 at u = 0, 1 at 0.5, 2 at 1.
        w0 = _saturate(1.0 - 2.0 * u)
        w2 = _saturate(2.0 * u - 1.0)
        w1 = 1.0 - w0 - w2
        vis = w0 * vis3[0] + w1 * vis3[1] + w2 * vis3[2]
        cone = torch.where(trace_enable, vis, 1.0)
    else:
        shaded = world_pos[None] + SELF_OCCLUSION_HACK * normal[None]
        delta = p1 - p0
        offset = torch.clamp(
            _saturate((radius + 1.0) / torch.clamp(_norm(delta), min=1e-6)),
            min=0.03)
        raws = []
        for du in (-1.0, 0.0, 1.0):
            uu = _saturate(u + du * offset)
            raws.append(cone_trace(volume, p0 + uu[..., None] * delta,
                                   radius, props[..., 1], shaded,
                                   trace_enable, quality, raw=True))
        visibility = (raws[0] + raws[1] + raws[2]) / 3.0
        cone = _saturate(
            _saturate(visibility - FULLY_SHADOWED_THRESHOLD)
            / (UNSHADOWED_THRESHOLD - FULLY_SHADOWED_THRESHOLD)) \
            ** quality.occlusion_to_opacity_power
        cone = torch.where(trace_enable, cone, 1.0)

    light_opacity = torch.where(visible, pre_trace * cone, 0.0) * active
    color = (lights.color_start[:, None, None, :]
             + (lights.color_end - lights.color_start)[:, None, None, :]
             * u[..., None])
    rgb = color[..., :3] * color[..., 3:4] * light_opacity[..., None]
    return torch.cat([rgb.sum(dim=0), light_opacity.sum(dim=0)[..., None]],
                     dim=-1)
