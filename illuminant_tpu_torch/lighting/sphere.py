"""Sphere-light per-pixel shading.

Counterpart of illuminant_tpu/lighting/sphere.py:accumulate_sphere_lights
with scan shadows and without specular or ambient occlusion, the flagship
frame's flags (scenes.py:681-685), against any field the scan takes (an
AnalyticScene, a ColumnField, an SdfVolume). All lights evaluate as
one batched (L, H, W) computation (LightCommon.fxh:154-210 falloff and
normal ramp, SphereLightCore.fxh:58-158 sequencing) and sum into the
lightmap as sum_l color_l.rgb * color_l.a * opacity_l (SphereLight.fx:
42-45). The JAX package sums that contraction from bfloat16 operands
(sphere.py:367-368); the port sums in float32. Specular, AO, the march
shadow mode, precomputed visibility and ramp textures are ROADMAP M4.
"""

from __future__ import annotations

import torch

from ..core.config import QualitySettings
from ..core.pytree import named_scope
from .environment import EnvironmentUniforms, SphereLights
from .gbuffer import GBuffer

SHADOW_OPACITY_THRESHOLD = 0.75 / 255.0  # SphereLightCore.fxh:10-11

DOT_OFFSET = 0.15  # LightCommon.fxh:1-10
DOT_RAMP_RANGE = 0.15
DOT_EXPONENT = 0.85


def _saturate(x):
    return torch.clamp(x, 0.0, 1.0)


@named_scope("illuminant/sphere_lights")
def accumulate_sphere_lights(volume, gbuffer: GBuffer, lights: SphereLights,
                             env: EnvironmentUniforms,
                             quality: QualitySettings,
                             with_specular: bool = True,
                             shadow_mode: str = "march",
                             with_ao: bool = True, with_alpha: bool = True):
    """Shade all sphere lights against the G-buffer with scan shadows ->
    (H, W, 3) HDR add, or (H, W, 4) with the accumulated opacity when
    `with_alpha`. The arguments and their defaults are the JAX package's;
    the values outside the flagship's raise NotImplementedError."""
    if with_specular or with_ao:
        raise NotImplementedError(
            "sphere-light specular and AO are not ported yet (ROADMAP M4)")
    if shadow_mode != "scan":
        raise NotImplementedError(
            f"shadow_mode={shadow_mode!r} (ROADMAP M4/K12: the port has "
            "the scan path)")
    f32 = torch.float32
    h, w = gbuffer.shape
    rs = gbuffer.render_scale
    dev = gbuffer.z.device
    ys = (torch.arange(h, dtype=f32, device=dev) + 0.5) / rs
    xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / rs
    wx = xs[None, None, :]
    wy = ys[None, :, None] + gbuffer.relative_y[None]
    wz = gbuffer.z[None]
    nx = gbuffer.normal[None, ..., 0]
    ny = gbuffer.normal[None, ..., 1]
    nz = gbuffer.normal[None, ..., 2]

    def lplane(v):  # (L,) -> (L, 1, 1)
        return v[:, None, None]

    active = lplane(lights.active)
    radius = lplane(lights.properties[:, 0])
    ramp_length = torch.clamp(lplane(lights.properties[:, 1]), min=1e-6)
    falloff_mode = lplane(lights.properties[:, 2])
    y_factor = lplane(lights.more[:, 2])

    # computeSphereLightOpacity (LightCommon.fxh:173-210), planar.
    d3x = wx - lplane(lights.position[:, 0])
    d3y = (wy - lplane(lights.position[:, 1])) * y_factor
    d3z = wz - lplane(lights.position[:, 2])
    distance = torch.sqrt(d3x * d3x + d3y * d3y + d3z * d3z + 1e-12)
    distance_factor = 1.0 - _saturate((distance - radius) / ramp_length)

    # Far-behind-the-pixel occlusion (fxh:187-192).
    lo = torch.clamp(env.light_occlusion, min=1e-6)
    occl = 1.0 - _saturate(d3z / lo)
    distance_factor = distance_factor * torch.where(
        env.light_occlusion > 0.0, occl, torch.ones_like(occl))

    # Normal ramp (fxh:154-171).
    dot = -(d3x * nx + d3y * ny + d3z * nz) / distance
    normal_factor = _saturate((dot + DOT_OFFSET) / DOT_RAMP_RANGE) \
        ** DOT_EXPONENT
    no_normal = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
    normal_factor = torch.where(no_normal, 1.0, normal_factor)

    # Falloff modes (fxh:197-203): 2 = none, 1 = exponential, 0 = linear.
    df_none = 1.0 - _saturate(distance - radius)
    df_exp = distance_factor * distance_factor
    distance_factor = torch.where(
        falloff_mode >= 2.0, df_none,
        torch.where(falloff_mode >= 1.0, df_exp, distance_factor))
    normal_factor = torch.where(falloff_mode >= 2.0, 1.0, normal_factor)

    # Inside the radius -> fully lit (fxh:208-209).
    pre_trace = _saturate(normal_factor * distance_factor
                          + _saturate(radius - distance))  # (L, H, W)

    visible = (pre_trace > 0.0) & (wx > -9999.0)
    visible = visible & (gbuffer.fullbright[None] < 0.5)

    cast_shadows = lplane(lights.properties[:, 3]) \
        * gbuffer.enable_shadows[None]
    trace_enable = (visible & (cast_shadows > 0.0)
                    & (pre_trace >= SHADOW_OPACITY_THRESHOLD)
                    & (active > 0.0))
    from .scan_shadows import scan_cone_visibility

    vis = scan_cone_visibility(
        volume, gbuffer, lights.position, lights.properties[:, 0],
        lights.properties[:, 1], quality, light_active=lights.active)
    cone = torch.where(trace_enable, vis, 1.0)

    opacity = pre_trace * cone
    opacity = torch.where(visible, opacity, 0.0) * active
    color = lights.color[:, :3] * lights.color[:, 3:4]  # (L, 3)
    out_rgb = torch.einsum("lhw,lc->hwc", opacity, color)
    if not with_alpha:
        return out_rgb
    return torch.cat([out_rgb, opacity.sum(dim=0)[..., None]], dim=-1)
