"""Sphere-light per-pixel shading.

Counterpart of illuminant_tpu/lighting/sphere.py: `accumulate_sphere_lights`
with scan shadows, the exact cone march, a caller's precomputed visibility
or no shadows, with or without ambient occlusion, specular and ramp
textures, against any field the scan takes (an AnalyticScene, a
ColumnField, an SdfVolume); and the falloff, normal-factor, specular and
AO helpers the other light families share. All lights evaluate as one
batched (L, H, W) computation (LightCommon.fxh:154-210 falloff and normal
ramp, AOCommon.fxh:1-20, SphereLightCore.fxh:58-158 sequencing,
LightCommon.fxh:212-222 specular) and sum into the lightmap as
sum_l color_l.rgb * color_l.a * opacity_l (SphereLight.fx:42-45). The JAX
package sums that contraction and the opacity from bfloat16 operands
(sphere.py:366-370, :395); the port sums in float32. On the card the march
is one launch of K12 for every (light, pixel) ray; on the CPU its plain
loop walks a few lights at a time so that its (lights, H, W, 3) ray
tensors stay bounded.
"""

from __future__ import annotations

import torch

from ..core.config import QualitySettings
from ..core.trace import span
from ..sdf.analytic import scene_sample, scene_sample_p
from ..sdf.columns import ColumnField
from ..sdf.volume import SdfVolume
from .cone_trace import cone_trace
from .environment import EnvironmentUniforms, SphereLights
from .gbuffer import GBuffer

SELF_OCCLUSION_HACK = 1.6  # SphereLightCore.fxh:10-11
SHADOW_OPACITY_THRESHOLD = 0.75 / 255.0

DOT_OFFSET = 0.15  # LightCommon.fxh:1-10
DOT_RAMP_RANGE = 0.15
DOT_EXPONENT = 0.85

# Rays (lights x pixels) one call of the plain march walks: it holds some
# forty float32 temporaries of that size and five of three times it, about
# 220 bytes a ray. 2 lights of a 1080 x 1920 frame. K12 holds none.
MARCH_CHUNK_RAYS = 1 << 22


def _saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def compute_normal_factor(light_normal, shaded_normal, offset=DOT_OFFSET,
                          range_=DOT_RAMP_RANGE):
    """LightCommon.fxh:154-171; a zero shaded normal gives 1 (no
    occlusion). `offset` / `range_`: floats or tensors of the result's
    shape."""
    d = torch.sum(-light_normal * shaded_normal, dim=-1)
    factor = _saturate((d + offset) / range_) ** DOT_EXPONENT
    no_normal = torch.all(shaded_normal == 0.0, dim=-1)
    return torch.where(no_normal, 1.0, factor)


def compute_sphere_light_opacity(shaded_position, shaded_normal,
                                 light_center, light_properties,
                                 y_distance_factor, light_occlusion):
    """computeSphereLightOpacity (LightCommon.fxh:173-210) on (..., 3)
    positions. light_properties (..., 4) = radius, ramp_length,
    falloff_mode, _; y_distance_factor and light_occlusion: floats or
    tensors that broadcast with the leading shape."""
    radius = light_properties[..., 0]
    ramp_length = torch.clamp(light_properties[..., 1], min=1e-6)
    falloff_mode = light_properties[..., 2]
    light_occlusion = torch.as_tensor(light_occlusion, dtype=torch.float32,
                                      device=shaded_position.device)

    d3 = shaded_position - light_center
    d3 = torch.stack([d3[..., 0], d3[..., 1] * y_distance_factor,
                      d3[..., 2]], dim=-1)
    distance = torch.sqrt(torch.clamp(torch.sum(d3 * d3, dim=-1),
                                      min=1e-12))
    distance_factor = 1.0 - _saturate((distance - radius) / ramp_length)

    # Far-behind-the-pixel occlusion (fxh:187-192).
    occl = 1.0 - _saturate(d3[..., 2] / torch.clamp(light_occlusion,
                                                    min=1e-6))
    distance_factor = distance_factor * torch.where(
        light_occlusion > 0.0, occl, 1.0)

    normal_factor = compute_normal_factor(d3 / distance[..., None],
                                          shaded_normal)

    # Falloff modes (fxh:197-203): 2 = none, 1 = exponential, 0 = linear.
    df_none = 1.0 - _saturate(distance - radius)
    df_exp = distance_factor * distance_factor
    distance_factor = torch.where(
        falloff_mode >= 2.0, df_none,
        torch.where(falloff_mode >= 1.0, df_exp, distance_factor))
    normal_factor = torch.where(falloff_mode >= 2.0, 1.0, normal_factor)

    # Inside the radius -> fully lit (fxh:208-209).
    return _saturate(normal_factor * distance_factor
                     + _saturate(radius - distance))


def compute_specularity(camera_position, shaded_position, shaded_normal,
                        light_center, power):
    """CalcSphereLightSpecularity (LightCommon.fxh:212-222) on (..., 3)
    vectors; `power` a float or a tensor of the leading shape."""
    def norm(v):
        return v / torch.sqrt(torch.clamp(
            torch.sum(v * v, dim=-1, keepdim=True), min=1e-12))

    light_direction = shaded_position - light_center
    h = norm(norm(camera_position - shaded_position) - light_direction)
    power = torch.as_tensor(power, dtype=torch.float32,
                            device=shaded_position.device)
    return _saturate(torch.sum(h * shaded_normal, dim=-1)) \
        ** torch.clamp(power, min=1e-6)


def _ao_ramp(d, ao_radius, ao_opacity, visible):
    """The squared AO ramp of a field sample `d` taken `ao_radius` above
    the surface (AOCommon.fxh:1-20)."""
    clamped = torch.minimum(torch.clamp(d, min=0.0), ao_radius)
    r = 1.0 - _saturate(clamped / torch.clamp(ao_radius, min=1e-6))
    r = 1.0 - r * r
    result = (1.0 - ao_opacity) + r * ao_opacity
    return torch.where((ao_radius >= 0.5) & visible, result, 1.0)


def compute_ao(volume, shaded_position, shaded_normal, ao_radius,
               ao_opacity, visible):
    """AOCommon.fxh:1-20 on (..., 3) positions: one field sample above
    the surface, squared ramp. ao_radius / ao_opacity / visible: tensors
    that broadcast with the positions' leading shape."""
    if volume is None:
        return torch.ones(ao_radius.shape, dtype=torch.float32,
                          device=ao_radius.device)
    offset = torch.stack([torch.zeros_like(ao_radius),
                          torch.zeros_like(ao_radius),
                          shaded_normal[..., 2] * ao_radius], dim=-1)
    d = scene_sample(volume, shaded_position + offset)
    return _ao_ramp(d, ao_radius, ao_opacity, visible)


def compute_ao_p(volume, px, py, pz, nz, ao_radius, ao_opacity, visible,
                 pixel_grid=None):
    """Planar compute_ao. `pixel_grid` ((xs, ys) world vectors): on a
    voxel field the probe's xy anchors to the frame's pixel grid, so the
    lookup is the resampled-stack z-lerp (sampling.grid_stack); exact
    where relative_y is 0."""
    if volume is None:
        return torch.ones(torch.broadcast_shapes(px.shape, ao_radius.shape),
                          dtype=torch.float32, device=ao_radius.device)
    vol_field = volume.volume if isinstance(volume, ColumnField) else volume
    if pixel_grid is not None and isinstance(vol_field, SdfVolume):
        from ..sdf.sampling import grid_stack, sample_stack_z

        xs, ys = pixel_grid
        d = sample_stack_z(vol_field, grid_stack(vol_field, xs, ys), xs, ys,
                           pz + nz * ao_radius)
    else:
        d = scene_sample_p(volume, px, py, pz + nz * ao_radius)
    return _ao_ramp(d, ao_radius, ao_opacity, visible)


@span("illuminant/sphere_lights")
def accumulate_sphere_lights(volume, gbuffer: GBuffer, lights: SphereLights,
                             env: EnvironmentUniforms,
                             quality: QualitySettings,
                             with_specular: bool = True,
                             shadow_mode: str = "march",
                             with_ao: bool = True, with_alpha: bool = True,
                             scan_visibility_precomputed=None):
    """Shade all sphere lights against the G-buffer -> (H, W, 3) HDR add,
    or (H, W, 4) with the accumulated opacity when `with_alpha`.

    `scan_visibility_precomputed` ((L, H, W)): a caller's cone visibility,
    usually a slice of one fused radial scan shared by several light
    families; it implies the scan path. `shadow_mode`: "scan", "march"
    (the exact cone trace: on the card one K12 launch for every ray, no
    host read; on the CPU the plain loop, one host read a step and chunk
    of lights) or "none", the host's static skip for a set in which no
    light casts shadows. `with_specular` adds specularity * opacity * specular
    colour (LightCommon.fxh:212-222), the camera straight above each pixel
    at maximum_z + 0.01. Lights packed with a ramp texture take their rgb
    from it (the WithRamp epilogue). The arguments and their defaults are
    the JAX package's."""
    if scan_visibility_precomputed is None and \
            shadow_mode not in ("scan", "march", "none"):
        raise ValueError(f"unknown shadow_mode {shadow_mode!r} (expected "
                         "'scan', 'march' or 'none')")
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

    if with_ao:
        # AO only on upward-facing surfaces (SphereLightCore.fxh:77).
        with span("illuminant/sphere_lights/ao"):
            ao_radius = lplane(lights.more[:, 0]) * torch.clamp(nz, min=0.0)
            pre_trace = pre_trace * compute_ao_p(
                volume, wx, wy, wz, nz, ao_radius, lplane(lights.more[:, 3]),
                visible, pixel_grid=(xs, ys))

    cast_shadows = lplane(lights.properties[:, 3]) \
        * gbuffer.enable_shadows[None]
    trace_enable = (visible & (cast_shadows > 0.0)
                    & (pre_trace >= SHADOW_OPACITY_THRESHOLD)
                    & (active > 0.0))
    if scan_visibility_precomputed is not None:
        cone = torch.where(trace_enable,
                           scan_visibility_precomputed.to(f32), 1.0)
    elif shadow_mode == "none":
        cone = 1.0
    elif shadow_mode == "scan":
        from .scan_shadows import scan_cone_visibility

        vis = scan_cone_visibility(
            volume, gbuffer, lights.position, lights.properties[:, 0],
            lights.properties[:, 1], quality, light_active=lights.active)
        cone = torch.where(trace_enable, vis, 1.0)
    else:
        cone = _march_visibility(volume, gbuffer, lights, trace_enable,
                                 quality)

    opacity = pre_trace * cone
    opacity = torch.where(visible, opacity, 0.0) * active
    color = lights.color[:, :3] * lights.color[:, 3:4]  # (L, 3)

    if lights.ramp_texture is not None:
        # WithRamp epilogue (SphereLightCore.fxh:99-119): rgb from a ramp
        # texture sampled at (pre-trace opacity, angle-derived v), times
        # the cone term; the per-light flag mixes ramped and plain lights.
        from .projector import _sample_texture_bilinear

        orate = lights.ramp_offset_rate
        angle = torch.atan2(wy - lplane(lights.position[:, 1]), d3x)
        v = (angle + lplane(orate[:, 0])) * lplane(orate[:, 1])
        pre = torch.clamp(pre_trace, 0.0, 1.0).expand(angle.shape)
        lit = torch.stack([
            _sample_texture_bilinear(lights.ramp_texture[li], pre[li],
                                     torch.remainder(v[li], 1.0), 1.0)
            for li in range(lights.capacity)], dim=0)  # (L, H, W, 3)
        lit = lit * (cone * active)[..., None]
        lit = torch.where(visible[..., None], lit, 0.0)
        has = orate[:, None, None, 2:3] > 0.5
        per_light_rgb = torch.where(has, lit, opacity[..., None])
        out_rgb = torch.sum(color[:, None, None, :] * per_light_rgb, dim=0)
    else:
        out_rgb = torch.einsum("lhw,lc->hwc", opacity, color)

    if with_specular:
        # CalcSphereLightSpecularity (LightCommon.fxh:212-222), planar:
        # camera - shaded = (0, -relativeY, maximum_z + 0.01 - z).
        spec = lights.specular_color_power
        cy = -gbuffer.relative_y[None]
        cz = env.maximum_z + 0.01 - wz
        c_len = torch.sqrt(cy * cy + cz * cz + 1e-12)
        hx = -d3x
        hy = cy / c_len - (wy - lplane(lights.position[:, 1]))
        hz = cz / c_len - d3z
        h_len = torch.sqrt(hx * hx + hy * hy + hz * hz + 1e-12)
        sdot = _saturate((hx * nx + hy * ny + hz * nz) / h_len)
        specularity = sdot ** torch.clamp(lplane(spec[:, 3]), min=1e-6)
        out_rgb = out_rgb + torch.einsum("lhw,lc->hwc", specularity * opacity,
                                         spec[:, :3])

    if not with_alpha:
        return out_rgb
    return torch.cat([out_rgb, opacity.sum(dim=0)[..., None]], dim=-1)


def _march_visibility(volume, gbuffer: GBuffer, lights: SphereLights,
                      trace_enable, quality: QualitySettings):
    """The exact cone march of every (light, pixel) ray -> (L, H, W), from
    the shaded point lifted 1.6 along its normal (SphereLightCore.fxh:151).
    On the card one K12 launch marches every ray; on the CPU the plain
    loop walks MARCH_CHUNK_RAYS rays at a time, in light order, each
    chunk's loop ending when its own last ray does."""
    h, w = gbuffer.shape
    origin = (gbuffer.world_position()
              + SELF_OCCLUSION_HACK * gbuffer.normal)[None]
    per_chunk = (max(1, lights.capacity) if origin.device.type == "cuda"
                 else max(1, MARCH_CHUNK_RAYS // max(h * w, 1)))
    enable = trace_enable.expand(lights.capacity, h, w)
    parts = []
    for l0 in range(0, lights.capacity, per_chunk):
        sl = slice(l0, l0 + per_chunk)
        props = lights.properties[sl, None, None, :]
        parts.append(cone_trace(
            volume, lights.position[sl, None, None, :], props[..., 0],
            props[..., 1], origin, enable[sl], quality))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
