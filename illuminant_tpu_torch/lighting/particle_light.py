"""Particle lights: a sphere-light template applied per live particle.

Counterpart of illuminant_tpu/lighting/particle_light.py (ParticleLight.fx;
ParticleLightSource, Lighting/LightSource.cs:466-505): each live particle
becomes an instance of the template sphere light, its color the
particle's attribute color (un-premultiplied) times the template's
(fx:40-71), with StippleFactor thinning the set (fx:27).

Two evaluations, as in the JAX package. The exact tiled culling
(lighting/tiled_lights.py, its shading the CUDA kernel K10) takes small
shadowless sets: every live particle is a light, binned to the screen
tiles its influence reaches. The strided subset takes the rest: at most
`max_lights` slots at a fixed stride, evaluated as one batched
SphereLights set, brightness compensated by the sampling ratio so that
the total emitted energy is preserved.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import QualitySettings
from ..ops.coords import stipple_keep
from ..particles.state import ParticleState
from .environment import EnvironmentUniforms, SphereLights, SphereLightSource
from .gbuffer import GBuffer
from .sphere import accumulate_sphere_lights
from . import tiled_lights


@dataclasses.dataclass
class ParticleLightSource:
    """Host (LightSource.cs:466-505). `method`: "auto" (the tiled culling
    for small shadowless sets, the strided subset otherwise), "subset" or
    "tiled"; `max_lights` is the subset path's evaluation budget, `tile` /
    `tile_capacity` / `max_relative_y` the tiled path's."""

    template: SphereLightSource = dataclasses.field(
        default_factory=SphereLightSource)
    stipple_factor: float = 1.0
    max_lights: int = 64
    method: str = "auto"
    tile: int = 64
    tile_capacity: int = 32
    max_relative_y: float | None = None


def subset_lights_from_particles(state: ParticleState,
                                 template: SphereLightSource,
                                 max_lights: int,
                                 energy_compensate: bool = True,
                                 stipple_factor: float = 1.0
                                 ) -> SphereLights:
    """A strided subset of the particle slots as a SphereLights SoA.
    `stipple_factor` thins the subset further, with brightness
    compensation preserving the total emitted energy."""
    n = state.capacity
    stride = max(n // max_lights, 1)
    pos = state.position[::stride][:max_lights]
    col = state.color[::stride][:max_lights]
    count = pos.shape[0]
    dev = pos.device
    f32 = torch.float32

    live = pos[:, 3] > 0.0
    alpha_ok = col[:, 3] > 0.0
    if stipple_factor < 1.0:
        live = live & stipple_keep(count, stipple_factor, device=dev)
    active = (live & alpha_ok).to(f32)

    # Un-premultiplied attribute color x template (ParticleLight.fx:40-71).
    color = col * torch.tensor(template.color, dtype=f32, device=dev)
    scale = float(stride) if energy_compensate else 1.0
    if energy_compensate and stipple_factor < 1.0:
        scale /= max(stipple_factor, 1e-3)
    color = torch.cat(
        [color[:, :3], color[:, 3:4] * (template.opacity * scale)], dim=-1)

    props = torch.tensor(
        [template.radius, template.ramp_length, float(template.ramp_mode),
         1.0 if template.cast_shadows else 0.0], dtype=f32,
        device=dev).expand(count, 4)
    more = torch.tensor(
        [template.ambient_occlusion_radius, 0.0,
         max(template.falloff_y_factor, 1e-3),
         template.ambient_occlusion_opacity], dtype=f32,
        device=dev).expand(count, 4)
    return SphereLights(
        position=pos[:, :3], color=color, properties=props, more=more,
        specular_color_power=torch.zeros((count, 4), dtype=f32, device=dev),
        active=active)


def accumulate_particle_lights(volume, gbuffer: GBuffer,
                               state: ParticleState,
                               source: ParticleLightSource,
                               env: EnvironmentUniforms,
                               quality: QualitySettings,
                               shadow_mode: str = "scan",
                               return_diagnostics: bool = False):
    """-> (H, W, 4) additive HDR contribution; with `return_diagnostics`
    -> ((H, W, 4), dropped), the count of tile-capacity overflow drops,
    always 0 on the subset path (whose error is the strided sampling
    itself).

    Uses the previous frame's particle state by convention (the reference
    reads usePreviousData, LightingRenderer.cs:1138-43); pass whichever
    state you have. `method="auto"` takes the exact tiled culling for a
    shadowless template without a ramp texture on a full-frame G-buffer
    whose expected binned lights a tile fit the capacity, and the subset
    otherwise."""
    tpl = source.template
    tpl_support = tpl.radius + (tpl.ramp_length if tpl.ramp_mode < 2
                                else 1.0)
    h, w = gbuffer.shape
    # The JAX package's static density estimate: the lights binned per
    # tile if the set spread uniformly over the frame.
    rs = max(gbuffer.render_scale, 1e-6)
    inf_x = tpl_support * rs
    inf_y = tpl_support / max(tpl.falloff_y_factor, 1e-3) * rs
    exp_binned = (state.capacity * (2.0 * inf_x + source.tile)
                  * (2.0 * inf_y + source.tile) / max(w * h, 1))
    use_tiled = source.method == "tiled" or (
        source.method == "auto" and not tpl.cast_shadows
        and tpl.ramp_texture is None
        and gbuffer.pixel_origin is None and state.capacity <= 2048
        and exp_binned * 1.5 <= source.tile_capacity)
    if use_tiled:
        active = (state.position[:, 3] > 0.0) & (state.color[:, 3] > 0.0)
        brightness = 1.0
        if source.stipple_factor < 1.0:
            active = active & stipple_keep(state.capacity,
                                           source.stipple_factor,
                                           device=active.device)
            # The subset path's energy-preserving convention, so that the
            # auto route never changes the scene's brightness.
            brightness = 1.0 / max(source.stipple_factor, 1e-3)
        mry = (source.max_relative_y if source.max_relative_y is not None
               else source.tile / max(gbuffer.render_scale, 1e-6))
        img, diag = tiled_lights.accumulate_sphere_lights_tiled(
            volume, gbuffer, state.position, state.color, active, tpl, env,
            tile=source.tile, capacity=source.tile_capacity,
            brightness_scale=brightness, max_relative_y=mry)
        if return_diagnostics:
            return img, diag["dropped"]
        return img
    lights = subset_lights_from_particles(
        state, tpl, source.max_lights, stipple_factor=source.stipple_factor)
    if not tpl.cast_shadows:
        # The host's static skip: the scan runs its full fixed-shape work
        # even when every per-light cast flag is off.
        shadow_mode = "none"
    img = accumulate_sphere_lights(
        volume, gbuffer, lights, env, quality, with_specular=False,
        shadow_mode=shadow_mode,
        with_ao=tpl.ambient_occlusion_radius > 0.0)
    if return_diagnostics:
        return img, torch.zeros((), dtype=torch.int32, device=img.device)
    return img
