"""Cone-traced soft shadows: the exact march (ConeTrace.fxh).

Counterpart of illuminant_tpu/lighting/cone_trace.py: sphere-trace from the
shaded point toward the light, shrinking visibility by the ratio of the
scene distance to the local cone radius, with a step budget and early-out
thresholds (fxh:141-191). It is the oracle the scan shadows are held to,
and the `shadow_mode="march"` of the light accumulators and of
`LightingRenderer.render_lighting` (its default). The JAX `while_loop`
over the whole ray tensor becomes a Python loop of at most
`max_step_count` steps that stops once no ray is live: one device-to-host
read per step (its Hopper kernel is ROADMAP K12).

Constants (ConeTrace.fxh:1-29):
"""

from __future__ import annotations

import torch

from ..core.config import QualitySettings
from ..sdf.analytic import scene_sample

MIN_CONE_RADIUS = 0.33
MAX_STEP_RAMP_WINDOW = 2.0
TRACE_INITIAL_OFFSET_PX = 0.5
FULLY_SHADOWED_THRESHOLD = 0.075
UNSHADOWED_THRESHOLD = 0.95
HACK_DISTANCE_OFFSET = 1.5


def _saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def cone_trace(volume, light_center, light_radius, light_ramp_length,
               shaded_position, enable, quality: QualitySettings,
               raw: bool = False):
    """Visibility in [0, 1] of `light_center` from `shaded_position`
    through the field `volume` (None: no field, every ray is clear).

    light_center / shaded_position (..., 3); light_radius /
    light_ramp_length broadcastable tensors (...); enable (...) bool —
    disabled rays return 1.0 (fxh:190). `raw` returns the pre-threshold
    visibility min(vis, step window) (fxh:175-180), which the line
    light's 3-ray average thresholds once (LineLightCore.fxh:52-65)."""
    dev = shaded_position.device
    f32 = torch.float32
    light_radius = torch.as_tensor(light_radius, dtype=f32, device=dev)
    light_ramp_length = torch.as_tensor(light_ramp_length, dtype=f32,
                                        device=dev)
    enable = torch.as_tensor(enable, device=dev)
    shape = torch.broadcast_shapes(shaded_position.shape[:-1],
                                   light_center.shape[:-1], enable.shape,
                                   light_radius.shape)
    if volume is None:
        return torch.ones(shape, dtype=f32, device=dev)

    trace_vector = light_center - shaded_position
    trace_length = torch.sqrt(torch.clamp(
        torch.sum(trace_vector * trace_vector, dim=-1), min=1e-12))
    direction = trace_vector / trace_length[..., None]
    # data.y: stop distance (fxh:46); data.x: start offset (fxh:47).
    end_offset = torch.clamp(trace_length - light_radius, min=1.0)

    # createTraceConfig (fxh:122-139).
    max_radius = torch.clamp(light_radius, MIN_CONE_RADIUS,
                             quality.max_cone_radius)
    growth_per_px = max_radius / torch.clamp(light_ramp_length, min=16.0) \
        * quality.cone_growth_factor
    min_step = max(1.0, quality.min_step_size)

    offset = torch.full(shape, TRACE_INITIAL_OFFSET_PX, dtype=f32,
                        device=dev)
    vis = torch.ones(shape, dtype=f32, device=dev)
    steps = torch.full(shape, float(quality.max_step_count), dtype=f32,
                       device=dev)
    live = enable.expand(shape)
    origin = shaded_position.expand(shape + (3,))
    direction = direction.expand(shape + (3,))
    end_offset = end_offset.expand(shape)
    max_radius = max_radius.expand(shape)
    growth_per_px = growth_per_px.expand(shape)

    for _ in range(quality.max_step_count):
        if not bool(live.any()):
            break
        steps = torch.where(live, steps - 1.0, steps)
        # coneTraceAdvance (fxh:73-82): sample, shrink visibility, step.
        d = scene_sample(volume, origin + direction * offset[..., None])
        local_radius = torch.minimum(growth_per_px * offset + MIN_CONE_RADIUS,
                                     max_radius)
        new_vis = torch.minimum(vis, (d + HACK_DISTANCE_OFFSET)
                                / local_radius)
        new_offset = offset + torch.clamp(
            torch.abs(d) * quality.long_step_factor, min=min_step)
        vis = torch.where(live, new_vis, vis)
        offset = torch.where(live, new_offset, offset)
        # liveness = stepsRemaining * saturate(vis - threshold)
        #            * saturate(end - offset)   (fxh:81, 163-170)
        step_live = (_saturate(vis - FULLY_SHADOWED_THRESHOLD)
                     * _saturate(end_offset - offset)) > 0.0
        live = live & step_live & (steps > 0.0)

    # Ramp visibility to 0 when the step budget ran out (fxh:175-180).
    visibility = torch.minimum(vis, steps / MAX_STEP_RAMP_WINDOW)
    if raw:
        return torch.where(enable, visibility, 1.0)
    final = _saturate(_saturate(visibility - FULLY_SHADOWED_THRESHOLD)
                      / (UNSHADOWED_THRESHOLD - FULLY_SHADOWED_THRESHOLD)) \
        ** quality.occlusion_to_opacity_power
    return torch.where(enable, final, 1.0)
