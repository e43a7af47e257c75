"""Volumetric lights (light shafts, glowing volumes).

Counterpart of illuminant_tpu/lighting/volumetric.py
(VolumetricLightCore.fxh; VolumetricLightSource,
Lighting/LightSource.cs:372-466): an ellipsoid, round-cone or box volume
whose density a vertical per-pixel column march accumulates
(volumetricTrace :316-409: each screen pixel integrates the shape's
interior ramp down its z column), plus a surface "diffuse" term from the
shape SDF at the shaded point (:462-505), blowout, and distance
attenuation. The shadowed variant occludes the column by one radial scan
from the light's origin, or each column sample by a march toward it
(:358-392).

Packing (fxh:417-422): properties = (volumetricity, ramp_length,
ramp_mode, cast_shadows); even_more = (blowout, ramp_power,
distance_attenuation, shape).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import QualitySettings
from ..core.pytree import tensor_dataclass
from ..sdf.analytic import scene_sample
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from .sphere import (DOT_OFFSET, DOT_RAMP_RANGE, SELF_OCCLUSION_HACK,
                     compute_normal_factor)

SHAPE_ELLIPSOID = 0
SHAPE_CONE = 1
SHAPE_BOX = 2


def _saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def _norm(v, eps=1e-12):
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=eps))


def sd_ellipsoid_simple(p, r):
    """fxh:25-29 (no near-field branch, unlike the obstruction's)."""
    k0 = _norm(p / r)
    k1 = _norm(p / (r * r))
    return k0 * (k0 - 1.0) / torch.clamp(k1, min=1e-9)


def sd_round_cone(p, a, b, r1, r2):
    """iq's round cone between a (radius r1) and b (radius r2)
    (fxh:31-54)."""
    ba = b - a
    l2 = torch.clamp(torch.sum(ba * ba, dim=-1), min=1e-9)
    rr = r1 - r2
    a2 = l2 - rr * rr
    il2 = 1.0 / l2

    pa = p - a
    y = torch.sum(pa * ba, dim=-1)
    z = y - l2
    d = pa * l2[..., None] - ba * y[..., None]
    x2 = torch.sum(d * d, dim=-1)
    y2 = y * y * l2
    z2 = z * z * l2

    k = torch.sign(rr) * rr * rr * x2
    below = torch.sign(z) * a2 * z2 > k
    above = torch.sign(y) * a2 * y2 < k
    d_below = torch.sqrt(torch.clamp(x2 + z2, min=0.0)) * il2 - r2
    d_above = torch.sqrt(torch.clamp(x2 + y2, min=0.0)) * il2 - r1
    d_side = (torch.sqrt(torch.clamp(x2 * a2 * il2, min=0.0))
              + y * rr) * il2 - r1
    return torch.where(below, d_below, torch.where(above, d_above, d_side))


def sd_box_centered(p, half):
    d = torch.abs(p) - half
    return torch.clamp(torch.amax(d, dim=-1), max=0.0) + _norm(
        torch.clamp(d, min=0.0))


def shape_distance(position, start4, end4, shape):
    """eval (fxh:281-299): the shape picked by id; start / end are
    (..., 4) with .w the radii (cone) or unused."""
    d_ell = sd_ellipsoid_simple(position - start4[..., :3],
                                torch.clamp(end4[..., :3], min=1e-4))
    d_cone = sd_round_cone(position, start4[..., :3], end4[..., :3],
                           start4[..., 3], end4[..., 3])
    d_box = sd_box_centered(position - start4[..., :3], end4[..., :3])
    return torch.where(shape <= SHAPE_ELLIPSOID, d_ell,
                       torch.where(shape <= SHAPE_CONE, d_cone, d_box))


@tensor_dataclass
class VolumetricLights:
    """SoA: start (L, 4) position + start radius; end (L, 4) position or
    size + end radius; color (L, 4); properties = (volumetricity,
    ramp_length, mode, shadows); more = (ao_radius, falloff, y,
    ao_opacity); even_more = (blowout, ramp_power, distance_attenuation,
    shape); active (L,)."""

    start: torch.Tensor
    end: torch.Tensor
    color: torch.Tensor
    properties: torch.Tensor
    more: torch.Tensor
    even_more: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self):
        return self.start.shape[0]


@dataclasses.dataclass
class VolumetricLightSource:
    """Host (LightSource.cs:372-466)."""

    shape: int = SHAPE_CONE
    start_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    end_position: Tuple[float, float, float] = (64.0, 0.0, 0.0)
    start_radius: float = 8.0
    end_radius: float = 0.0
    volumetricity: float = 1.0
    distance_attenuation: float = 1.0
    ramp_length: float = 1.0
    ramp_power: float = 1.0
    blowout_factor: float = 0.0
    ramp_mode: int = 0
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    opacity: float = 1.0
    cast_shadows: bool = False
    # LightSource.BlendMode (LightSource.cs:65).
    blend_mode: str = "additive"


def pack_volumetric_lights(lights: List[VolumetricLightSource],
                           capacity: Optional[int] = None,
                           device="cuda") -> VolumetricLights:
    n = len(lights)
    cap = capacity or max(n, 1)
    start = np.zeros((cap, 4), np.float32)
    end = np.ones((cap, 4), np.float32)
    color = np.zeros((cap, 4), np.float32)
    props = np.ones((cap, 4), np.float32)
    more = np.zeros((cap, 4), np.float32)
    more[:, 2] = 1.0
    more[:, 3] = 1.0
    even = np.zeros((cap, 4), np.float32)
    active = np.zeros((cap,), np.float32)
    for i, l in enumerate(lights):
        start[i] = [*l.start_position, l.start_radius]
        end[i] = [*l.end_position, l.end_radius]
        c = np.asarray(l.color, np.float32).copy()
        c[3] *= l.opacity
        color[i] = c
        props[i] = [max(l.volumetricity, 1e-3), max(l.ramp_length, 1e-3),
                    float(l.ramp_mode), 1.0 if l.cast_shadows else 0.0]
        even[i] = [l.blowout_factor, max(l.ramp_power, 1e-3),
                   max(l.distance_attenuation, 1e-3), float(l.shape)]
        active[i] = 1.0

    def t(a):
        return torch.as_tensor(a, device=device)

    return VolumetricLights(start=t(start), end=t(end), color=t(color),
                            properties=t(props), more=t(more),
                            even_more=t(even), active=t(active))


def support_radius_px(lights: VolumetricLights, render_scale: float = 1.0):
    """Conservative per-light xy support radius (pixels at render_scale)
    around start.xy, to size the bounded evaluation window. For cones
    start / end are endpoints with .w radii; for ellipsoids and boxes
    end.xyz is the radius or half-size vector (LightSource.cs:372-394).
    The lit region extends ramp_length beyond the shape's surface."""
    shape = lights.even_more[:, 3]
    cone_reach = (
        torch.linalg.norm(lights.end[:, :2] - lights.start[:, :2], dim=-1)
        + torch.maximum(lights.start[:, 3], lights.end[:, 3]))
    radial_reach = torch.linalg.norm(lights.end[:, :2], dim=-1)
    reach = torch.where(shape == SHAPE_CONE, cone_reach, radial_reach)
    return (reach + lights.properties[:, 1]) * lights.active * render_scale


def _inner_occlusion(volume, origin, pos, quality: QualitySettings):
    """The inner occlusion march of the column samples `pos` (fxh:358-392,
    projectFromOrigin): sphere-step from the shape's origin toward each;
    occlusion = saturate(last sample * 0.5), zero on penetration (sample
    <= -0.1), step = max(|sample| * 0.99, minStepSize), with the full step
    budget of getStepLimit (fxh:362)."""
    toward = pos - origin
    md = _norm(toward)
    along = toward / md[..., None]
    d = torch.full_like(md, 0.33)  # the mean of the dither * 0.66 start
    occ = torch.ones_like(md)
    done = torch.zeros_like(md, dtype=torch.bool)
    for _ in range(max(quality.max_step_count, 8)):
        s = scene_sample(volume, origin + along * d[..., None])
        occ_new = torch.where(done, occ, _saturate(s * 0.5))
        blocked = (s <= -0.1) & ~done
        occ = torch.where(blocked, 0.0, occ_new)
        d_new = d + torch.clamp(torch.abs(s) * 0.99,
                                min=quality.min_step_size)
        d = torch.where(done, d, d_new)
        done = done | blocked | (d_new >= md)
    return occ


# Column samples evaluated at once by `volumetric_trace`: steps x pixels.
_TRACE_CHUNK_ELEMENTS = 1 << 22


def volumetric_trace(volume, start4, end4, world_xy, world_z, env, props,
                     even_more, quality: QualitySettings, shadowed: bool):
    """volumetricTrace (fxh:316-409): the per-pixel vertical column
    integral over `quality.max_step_count` column samples.

    world_xy (..., 2) -> (...,) opacity. The column start's dithering is
    replaced by a half-step offset. The JAX package loops over the
    samples; here a leading step axis carries as many samples at once as
    fit `_TRACE_CHUNK_ELEMENTS` (all 64 on a light's window, a few on a
    full frame), and the chunks' sums add up in step order."""
    shape = even_more[..., 3]
    steps = quality.max_step_count

    z2 = torch.maximum(world_z, env.ground_z)
    z1 = torch.maximum(env.maximum_z, z2)
    r = torch.maximum(start4[..., 3], end4[..., 3])
    z_hi_cone = torch.maximum(start4[..., 2], end4[..., 2]) + r
    z_lo_cone = torch.minimum(start4[..., 2], end4[..., 2]) - r
    z_hi_other = start4[..., 2] + end4[..., 2]
    z_lo_other = start4[..., 2] - end4[..., 2]
    is_cone = shape == SHAPE_CONE
    z1 = torch.minimum(z1, torch.where(is_cone, z_hi_cone, z_hi_other))
    z2 = torch.maximum(z2, torch.where(is_cone, z_lo_cone, z_lo_other))

    step = torch.clamp(torch.abs(z2 - z1), min=1.0) / steps
    ramp_length = props[..., 1]
    ramp_power = even_more[..., 1]

    # The broadcast shape of lights x pixels: with L > 1 the per-light z
    # bounds are (L, 1, 1) while world_xy alone is (1, H, W, 2).
    out_shape = torch.broadcast_shapes(
        world_xy.shape[:-1], start4.shape[:-1], props.shape[:-1])
    dev = world_xy.device
    hits = torch.zeros(out_shape, dtype=torch.float32, device=dev)
    chunk = max(1, min(steps, _TRACE_CHUNK_ELEMENTS
                       // max(hits.numel(), 1)))
    lead = (slice(None),) + (None,) * len(out_shape)
    for i0 in range(0, steps, chunk):
        i = torch.arange(i0, min(i0 + chunk, steps), dtype=torch.float32,
                         device=dev)[lead]              # (S, 1, ..., 1)
        z = (z1 - (i + 0.5) * step).expand((i.shape[0],) + out_shape)
        pos = torch.cat([world_xy.expand(z.shape + (2,)), z[..., None]],
                        dim=-1)
        sd = shape_distance(pos, start4, end4, shape)
        ramp = _saturate(-sd / ramp_length) ** ramp_power
        if shadowed and volume is not None:
            ramp = ramp * _inner_occlusion(volume, start4[..., :3], pos,
                                           quality)
        hits = hits + (ramp * (z >= z2).to(torch.float32)).sum(dim=0)
    return _saturate(hits / steps / props[..., 0])


def accumulate_volumetric_lights(volume, gbuffer: GBuffer,
                                 lights: VolumetricLights,
                                 env: EnvironmentUniforms,
                                 quality: QualitySettings,
                                 shadowed: bool = False,
                                 shadow_detail: str = "march"):
    """All volumetric lights -> (H, W, 4) additive HDR contribution
    (VolumetricLightPixelCore, fxh:411-516).

    `shadow_detail` selects the shadowed path's occlusion source:
      * "march": the per-column-sample inner sphere march (fxh:358-392),
        max_step_count x inner steps field samples per pixel per light;
      * "scan": one radial scan from each light's origin modulates the
        whole column integral by the pixel's 2D visibility. Shadow
        footprints on surfaces match; shadows inside the volume's body
        lose their vertical gradient.
    """
    world_pos = gbuffer.world_position()
    normal = gbuffer.normal

    start4 = lights.start[:, None, None, :]
    end4 = lights.end[:, None, None, :]
    props = lights.properties[:, None, None, :]
    even = lights.even_more[:, None, None, :]
    active = lights.active[:, None, None]
    shape = even[..., 3]

    visible = (world_pos[None, ..., 0] > -9999.0) & (
        gbuffer.fullbright[None] < 0.5)
    # AO is skipped: VolumetricLightSource has no AO fields (the pack
    # leaves more[:, 0] at 0).

    if shadow_detail not in ("scan", "march"):
        raise ValueError(f"unknown shadow_detail {shadow_detail!r} "
                         "(expected 'scan' or 'march')")
    scan_occ = None
    if shadowed and shadow_detail == "scan":
        from .scan_shadows import scan_cone_visibility

        scan_occ = scan_cone_visibility(
            volume, gbuffer, lights.start[:, :3],
            torch.clamp(lights.start[:, 3], min=1.0),
            lights.properties[:, 1], quality, light_active=lights.active,
            self_occlusion_lift=SELF_OCCLUSION_HACK)

    def trace(march: bool):
        return volumetric_trace(volume, start4, end4,
                                world_pos[None, ..., :2],
                                world_pos[None, ..., 2], env, props, even,
                                quality, march)

    vol_opacity = trace(shadowed and shadow_detail == "march")
    # The per-light CastsShadows gate (lightProperties.w, fxh:451): lights
    # with the flag off keep full visibility in a shadowed pass.
    occ_gate = props[..., 3] > 0.0
    if scan_occ is not None:
        vol_opacity = vol_opacity * torch.where(occ_gate, scan_occ, 1.0)
    elif shadowed:
        # The march folded occlusion into vol_opacity; gated-off lights
        # take the unshadowed trace.
        vol_opacity = torch.where(occ_gate, vol_opacity, trace(False))
    pre_trace = vol_opacity

    # The diffuse surface term (fxh:462-494).
    cone_sharp = torch.where(
        shape == SHAPE_CONE,
        torch.maximum(start4[..., 3], end4[..., 3]) / 64.0, 0.0)
    dot_range = DOT_RAMP_RANGE + (0.33 - DOT_RAMP_RANGE) * cone_sharp
    dot_offset = DOT_OFFSET + (0.33 - DOT_OFFSET) * cone_sharp
    to_pixel = world_pos[None] - start4[..., :3]
    ln = to_pixel / _norm(to_pixel)[..., None]
    normal_opacity = compute_normal_factor(ln, normal[None],
                                           offset=dot_offset,
                                           range_=dot_range)
    # Blowout (fxh:485): lerp toward 2x - 1 (can go negative).
    normal_opacity = normal_opacity + (
        (normal_opacity * 2.0 - 1.0) - normal_opacity) * even[..., 0]

    contact = shape_distance(world_pos[None], start4, end4, shape)
    shape_opacity = torch.where(
        contact < 0.0, _saturate(-contact / props[..., 1]) ** even[..., 1],
        0.0)
    trajectory_len = torch.where(
        shape == SHAPE_CONE, _norm(end4[..., :3] - start4[..., :3]),
        _norm(end4[..., :3]))
    distance_opacity = 1.0 - _saturate(
        _norm(to_pixel) / torch.clamp(trajectory_len * even[..., 2],
                                      min=1e-6))
    # No ramp-mode squaring: the reference squares (fxh:495-498) after
    # the diffuse term is computed (fxh:492) and never reads it again.
    diffuse = normal_opacity * shape_opacity * distance_opacity

    opacity = torch.where(diffuse < 0.0, pre_trace + diffuse,
                          torch.maximum(pre_trace, diffuse))
    opacity = torch.where(visible, opacity, 0.0) * active

    rgb = (lights.color[:, None, None, :3] * lights.color[:, None, None, 3:4]
           * opacity[..., None])
    out_a = torch.clamp(opacity, min=0.0).sum(dim=0)
    return torch.cat([rgb.sum(dim=0), out_a[..., None]], dim=-1)
