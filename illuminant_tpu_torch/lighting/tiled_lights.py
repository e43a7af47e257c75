"""Tiled light culling: exact evaluation of many small lights.

Counterpart of illuminant_tpu/lighting/tiled_lights.py. The reference draws
one instanced quad per particle light (ParticleLight.fx; the rasteriser
culls each quad to the light's screen bounds); here the screen is cut
into square tiles, each light is binned into every tile its influence
region overlaps (the ramps reach exactly zero at radius + ramp_length),
and each tile is shaded against its binned lights only. Every live light
contributes up to the per-tile capacity; `dropped` counts the overflow.

The whole route is K10 (`tiled_lights_kernel.tiled_lights_fused`): one
launch a frame in which each block bins the lights for its tile, samples
the AO (on a ColumnField through the column query's device function) and
shades its pixels, float32, slots in order, straight into the (H, W, 4)
image, where the JAX package contracts (T, 8, tile, tile) opacity chunks
with the colours in bfloat16 over a padded frame. This module turns the
template into the kernel's scalars (`shading_for`) and picks its factor
mode; the kernel module holds the plain version (on the CPU the wrapper
runs it) and its pieces, among them `bin_lights_to_tiles`, which this
module names too, as the JAX module does.
"""

from __future__ import annotations

import torch

from ..core.trace import span
from ..sdf.columns import ColumnField
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from . import tiled_lights_kernel
from .tiled_lights_kernel import bin_lights_to_tiles  # noqa: F401


def shading_for(template, tile: int, capacity: int, render_scale: float,
                max_relative_y: float = 0.0, brightness_scale: float = 1.0,
                with_alpha: bool = True) -> tiled_lights_kernel.Shading:
    """The call's scalars from the shared template (radius, ramp,
    falloff, colour, AO)."""
    rs = render_scale
    # Support radius in px (LightCommon.fxh:197-203) + a pixel-centre
    # guard; the y reach is longer by 1 / falloff_y_factor.
    r_world = template.radius + (
        template.ramp_length if template.ramp_mode < 2 else 1.0)
    return tiled_lights_kernel.Shading(
        tile=tile, capacity=capacity, render_scale=rs,
        influence=float(r_world) * rs + 0.5,
        influence_y=float(r_world) / max(template.falloff_y_factor, 1e-3)
        * rs + 0.5,
        extra_y=float(max_relative_y) * rs, radius=float(template.radius),
        ramp_length=max(template.ramp_length, 1e-6),
        y_factor=max(template.falloff_y_factor, 1e-3),
        ramp_mode=int(template.ramp_mode),
        color=tuple(float(c) for c in template.color),
        weight=template.opacity * brightness_scale,
        ao_radius=float(template.ambient_occlusion_radius),
        ao_opacity=float(template.ambient_occlusion_opacity),
        with_alpha=with_alpha)


@span("illuminant/tiled_particle_lights")
def accumulate_sphere_lights_tiled(volume, gbuffer: GBuffer, position,
                                   color, active, template,
                                   env: EnvironmentUniforms, tile: int = 64,
                                   capacity: int = 32,
                                   with_alpha: bool = True,
                                   max_relative_y: float = 0.0,
                                   brightness_scale: float = 1.0):
    """Shade N template-uniform shadowless lights -> ((H, W, 4) HDR add,
    {"dropped": capacity overflow, "window_deficit_px": relief beyond the
    candidate window}), both device scalars.

    position (N, >=3) world; color (N, 4) un-premultiplied rgba a light;
    active (N,) bool; template the shared SphereLightSource (radius, ramp,
    falloff, AO). The shading is accumulate_sphere_lights' per light
    (computeSphereLightOpacity) restricted to each light's support tiles;
    no specular, ramp texture or shadows (LightSource.cs:466-505). On the
    card: K10 once, after the ColumnField's map pack when the AO samples
    one; an AO on another volume is computed in PyTorch first
    (`tiled_lights_kernel.pixel_factor`) and passed in."""
    sh = shading_for(template, tile, capacity, gbuffer.render_scale,
                     max_relative_y, brightness_scale, with_alpha)
    f32 = torch.float32
    with_ao = template.ambient_occlusion_radius > 0.0 and volume is not None
    column = None
    if with_ao and isinstance(volume, ColumnField):
        mode, factor, column = "column_ao", gbuffer.fullbright, volume
    elif with_ao:
        mode = "pix_f"
        factor = tiled_lights_kernel.pixel_factor(
            volume, gbuffer.z, gbuffer.relative_y, gbuffer.normal,
            gbuffer.fullbright, gbuffer.render_scale, sh.ao_radius,
            sh.ao_opacity)
    else:
        mode, factor = "fullbright", gbuffer.fullbright
    out, dropped, deficit = tiled_lights_kernel.tiled_lights_fused(
        gbuffer.z.contiguous(), gbuffer.relative_y.contiguous(),
        gbuffer.normal.contiguous(), factor.to(f32).contiguous(), position,
        color.contiguous(), active.contiguous(),
        env.light_occlusion.to(f32).reshape(()), sh, mode, column)
    return out, dict(dropped=dropped, window_deficit_px=deficit)
