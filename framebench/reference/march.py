"""The sphere lights' exact cone march over a flat ground G-buffer, in
plain PyTorch.

A frozen copy of the computation the measured frame makes under
`shadow_mode="march"`, written from the reference engine's shaders: the
ray from the shaded point lifted 1.6 along its normal toward the light's
centre (SphereLightCore.fxh:151), the trace config from the light's
radius and ramp (ConeTrace.fxh:37-47, 122-139), then per step the scene's
distance d at the ray's offset t, `visibility = min(visibility, (d + 1.5)
/ coneRadius(t))` and a step of `max(|d| * longStepFactor, minStepSize)`
(fxh:51-82), until the step budget runs out, the visibility falls to the
fully-shadowed 0.075 or the ray reaches the light's surface (fxh:141-170);
then the visibility ramped by the steps left and mapped from [0.075,
0.95] to [0, 1] (fxh:175-191). The sphere lights' falloff and normal ramp
around it (LightCommon.fxh:154-210) are the scan reference's
(`lighting.sphere_lights`).

Where it departs from the .fxh, it departs as the measured frame does:
  * the distance is the analytic scene's closed form (`sdf.Scene`), where
    the shader samples the distance-field atlas;
  * the minimum step is at least 1 (max(1, minStepSize));
  * 0.95 is only the top of the final ramp: a ray stays live above it
    (the shader's unshadowed early-out changes no result, since the
    visibility only falls);
  * lengths carry the frame's 1e-12 floor under the root, and the
    light's distance is the root of ((x * x + y * y) + z * z), summed in
    that order;
  * rays march a block of lights at a time (RAYS_PER_BLOCK rays), so that
    16,588,800 rays a frame fit on the card; every ray's loop is its own.

A ray of `enable` False is not marched and reads 1.
"""

from __future__ import annotations

import torch

# ConeTrace.fxh:1-29 and SphereLightCore.fxh:10-11.
MIN_CONE_RADIUS = 0.33
MAX_STEP_RAMP_WINDOW = 2.0
TRACE_INITIAL_OFFSET = 0.5
FULLY_SHADOWED_THRESHOLD = 0.075
UNSHADOWED_THRESHOLD = 0.95
HACK_DISTANCE_OFFSET = 1.5
SELF_OCCLUSION_LIFT = 1.6
SHADOW_OPACITY_THRESHOLD = 0.75 / 255.0
DOT_OFFSET = 0.15
DOT_RAMP_RANGE = 0.15
DOT_EXPONENT = 0.85
# The march's defaults (LightingRenderer.Configuration.cs:262-291).
STEPS = dict(min_step_size=3.0, long_step_factor=1.0, max_step_count=64)
# Rays one block marches: about 200 bytes of temporaries a ray, 4 lights
# of a 1080 x 1920 frame.
RAYS_PER_BLOCK = 1 << 23


def _sat(x):
    return torch.clamp(x, 0.0, 1.0)


def march(scene, center, radius, ramp, origin, enable, quality):
    """The march of the rays (light l, point p): center (L, 3), radius and
    ramp (L,), origin (P..., 3), enable (L, P...) bool; `quality` holds
    max_cone_radius, cone_growth_factor, occlusion_to_opacity_power and
    STEPS' keys. -> (visibility, steps left), each (L, P...) float32."""
    lights = center.shape[0]
    points = enable[0].numel()
    per = max(1, RAYS_PER_BLOCK // max(points, 1))
    parts = [_march_block(scene, center[l0:l0 + per],
                          radius[l0:l0 + per], ramp[l0:l0 + per], origin,
                          enable[l0:l0 + per], quality)
             for l0 in range(0, lights, per)]
    return tuple(torch.cat(p, dim=0) if len(p) > 1 else p[0]
                 for p in zip(*parts))


def _march_block(scene, center, radius, ramp, origin, enable, quality):
    f32 = torch.float32
    lead = (slice(None),) + (None,) * (enable.dim() - 1)
    cx, cy, cz = (center[:, k][lead] for k in range(3))
    ox, oy, oz = (origin[None, ..., k] for k in range(3))
    light_radius = radius[lead]
    shape = enable.shape
    # The trace (fxh:37-47): toward the light's centre, ending at its
    # surface but at least 1 out.
    tx, ty, tz = cx - ox, cy - oy, cz - oz
    length = torch.sqrt(torch.clamp(tx * tx + ty * ty + tz * tz,
                                    min=1e-12))
    dx, dy, dz = tx / length, ty / length, tz / length
    end = torch.clamp(length - light_radius, min=1.0)
    # The cone (fxh:122-139).
    max_radius = torch.clamp(light_radius, MIN_CONE_RADIUS,
                             quality["max_cone_radius"])
    growth = max_radius / torch.clamp(ramp[lead], min=16.0) \
        * quality["cone_growth_factor"]
    min_step = max(1.0, quality["min_step_size"])

    t = torch.full(shape, TRACE_INITIAL_OFFSET, dtype=f32,
                   device=enable.device)
    vis = torch.ones(shape, dtype=f32, device=enable.device)
    steps = torch.full(shape, float(quality["max_step_count"]), dtype=f32,
                       device=enable.device)
    live = enable
    for _ in range(quality["max_step_count"]):
        if not bool(live.any()):
            break
        steps = torch.where(live, steps - 1.0, steps)
        d = scene.distance(ox + dx * t, oy + dy * t, oz + dz * t)
        cone = torch.minimum(growth * t + MIN_CONE_RADIUS, max_radius)
        new_vis = torch.minimum(vis, (d + HACK_DISTANCE_OFFSET) / cone)
        new_t = t + torch.clamp(torch.abs(d) * quality["long_step_factor"],
                                min=min_step)
        vis = torch.where(live, new_vis, vis)
        t = torch.where(live, new_t, t)
        # Live while steps remain, the visibility is above the fully
        # shadowed threshold and the ray short of its end (fxh:81,
        # 163-170).
        going = (_sat(vis - FULLY_SHADOWED_THRESHOLD) * _sat(end - t)) > 0.0
        live = live & going & (steps > 0.0)
    # The step budget's ramp, the threshold and the power (fxh:175-191).
    visibility = torch.minimum(vis, steps / MAX_STEP_RAMP_WINDOW)
    final = _sat(_sat(visibility - FULLY_SHADOWED_THRESHOLD)
                 / (UNSHADOWED_THRESHOLD - FULLY_SHADOWED_THRESHOLD)) \
        ** quality["occlusion_to_opacity_power"]
    return torch.where(enable, final, 1.0), steps


def terms(gbuf, lights, light_occlusion):
    """The sphere lights' unshadowed terms over the G-buffer, (L, H, W)
    each: `pre_trace` (falloff and normal ramp), `visible` and
    `trace_enable` (the rays the march traces), as `lighting.
    sphere_lights` computes them."""
    f32 = torch.float32
    h, w = gbuf["z"].shape
    dev = gbuf["z"].device
    ys = torch.arange(h, dtype=f32, device=dev) + 0.5
    xs = torch.arange(w, dtype=f32, device=dev) + 0.5
    wx = xs[None, None, :]
    wy = ys[None, :, None] + gbuf["relative_y"][None]
    wz = gbuf["z"][None]
    nx, ny, nz = (gbuf["normal"][None, ..., i] for i in range(3))

    def lp(v):
        return v[:, None, None]

    pos, props = lights["position"], lights["properties"]
    active = lp(lights["active"])
    radius = lp(props[:, 0])
    ramp_length = torch.clamp(lp(props[:, 1]), min=1e-6)
    falloff_mode = lp(props[:, 2])
    y_factor = lp(lights["more"][:, 2])
    d3x = wx - lp(pos[:, 0])
    d3y = (wy - lp(pos[:, 1])) * y_factor
    d3z = wz - lp(pos[:, 2])
    distance = torch.sqrt(d3x * d3x + d3y * d3y + d3z * d3z + 1e-12)
    distance_factor = 1.0 - _sat((distance - radius) / ramp_length)
    lo = torch.clamp(light_occlusion, min=1e-6)
    occl = 1.0 - _sat(d3z / lo)
    distance_factor = distance_factor * torch.where(
        light_occlusion > 0.0, occl, torch.ones_like(occl))
    dot = -(d3x * nx + d3y * ny + d3z * nz) / distance
    normal_factor = _sat((dot + DOT_OFFSET) / DOT_RAMP_RANGE) ** DOT_EXPONENT
    no_normal = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
    normal_factor = torch.where(no_normal, 1.0, normal_factor)
    df_none = 1.0 - _sat(distance - radius)
    df_exp = distance_factor * distance_factor
    distance_factor = torch.where(
        falloff_mode >= 2.0, df_none,
        torch.where(falloff_mode >= 1.0, df_exp, distance_factor))
    normal_factor = torch.where(falloff_mode >= 2.0, 1.0, normal_factor)
    pre_trace = _sat(normal_factor * distance_factor + _sat(radius - distance))
    visible = (pre_trace > 0.0) & (wx > -9999.0)
    cast = lp(props[:, 3])
    trace_enable = (visible & (cast > 0.0)
                    & (pre_trace >= SHADOW_OPACITY_THRESHOLD) & (active > 0.0))
    return dict(pre_trace=pre_trace, visible=visible,
                trace_enable=trace_enable)


def rays(gbuf, lights, trace_enable):
    """The march's rays: every light's centre, radius and ramp, and from
    every pixel the shaded point lifted SELF_OCCLUSION_LIFT along its
    normal (SphereLightCore.fxh:151) -> the keyword arguments of `march`
    but the scene and the quality."""
    f32 = torch.float32
    h, w = gbuf["z"].shape
    dev = gbuf["z"].device
    ys = torch.arange(h, dtype=f32, device=dev) + 0.5
    xs = torch.arange(w, dtype=f32, device=dev) + 0.5
    shaded = torch.stack([xs[None, :].expand(h, w),
                          ys[:, None] + gbuf["relative_y"], gbuf["z"]],
                         dim=-1)
    props = lights["properties"]
    return dict(center=lights["position"], radius=props[:, 0],
                ramp=props[:, 1],
                origin=shaded + SELF_OCCLUSION_LIFT * gbuf["normal"],
                enable=trace_enable)


def sphere_lights(scene, gbuf, lights, light_occlusion, quality):
    """The sphere lights' sum (H, W, 3) under the march: falloff, normal
    ramp and the march's visibility, no specular, no AO (the flagship's
    settings)."""
    t = terms(gbuf, lights, light_occlusion)
    vis, _ = march(scene, quality=quality,
                   **rays(gbuf, lights, t["trace_enable"]))
    cone = torch.where(t["trace_enable"], vis, 1.0)
    opacity = torch.where(t["visible"], t["pre_trace"] * cone, 0.0) \
        * lights["active"][:, None, None]
    color = lights["color"][:, :3] * lights["color"][:, 3:4]
    return torch.einsum("lhw,lc->hwc", opacity, color)
