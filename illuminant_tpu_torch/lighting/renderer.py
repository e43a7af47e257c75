"""LightingRenderer: the host-side frame orchestrator.

Counterpart of illuminant_tpu/lighting/renderer.py, the public surface of
the reference renderer (LightingRenderer.cs:434 — UpdateFields :1949,
RenderLighting :917, RenderedLighting.Resolve HDR.cs:99/128):

    renderer = LightingRenderer(config, environment, sdf_config)
    renderer.update_fields()              # G-buffer, budgeted voxel field
    lightmap = renderer.render_lighting() # (H, W, 4) HDR
    image = renderer.resolve(lightmap, hdr)

Everything the renderer builds lives on its `device` (default "cuda").
Incremental field updates keep the reference's budget semantics
(MaximumFieldUpdatesPerFrame, Configuration.cs:87-91): slice validity is
tracked on the host, slabs are generated and written on the device. Field
updates are functional: `update_fields` replaces `renderer.volume` with a
new volume and never writes into one it handed out, so a caller's handle
to last frame's field keeps last frame's distances. With no dynamic
obstruction `renderer.volume` is the static partition itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import HDRConfig, RendererConfig
from ..core.trace import span
from ..raster.resolve import resolve as resolve_lightmap
from ..sdf import volume as vol
from ..sdf.analytic import pack_scene
from ..sdf.height_volume import pack_height_volumes
from ..sdf.volume import SdfVolume, SdfVolumeConfig
from . import gbuffer as gbuf
from .billboard import rasterize_billboards
from .directional import (DirectionalLightSource,
                          accumulate_directional_lights,
                          pack_directional_lights)
from .environment import (EnvironmentUniforms, LightingEnvironment,
                          LightSourceReplicator, SphereLights,
                          SphereLightSource, pack_sphere_lights)
from .height_volume import rasterize_height_volumes
from .line import LineLightSource, accumulate_line_lights, pack_line_lights
from .projector import (ProjectorLightSource, accumulate_projector_lights,
                        pack_projector_lights)
from .sphere import accumulate_sphere_lights
from .volumetric import (VolumetricLightSource, accumulate_volumetric_lights,
                         pack_volumetric_lights)

BLEND_MODES = ("additive", "subtractive", "max")
# The reference regenerates 3 virtual slices per physical update
# (PackedSliceCount, LightingRenderer.cs:313): the same granularity, so a
# budget means the same thing.
SLICES_PER_UPDATE = 3
_OTHER_SOURCES = (DirectionalLightSource, LineLightSource,
                  VolumetricLightSource, ProjectorLightSource)


def render_lightmap(volume, gbuffer: gbuf.GBuffer,
                    sphere_lights: SphereLights, env: EnvironmentUniforms,
                    config: RendererConfig, directional_lights=None,
                    line_lights=None, volumetric_lights=None,
                    projector_lights=None, with_specular: bool = False,
                    shadow_mode: str = "march", with_ao: bool = True):
    """The light pass (LightingRenderer.cs:1004-1168): clear to ambient,
    add every light family -> (H, W, 4) HDR lightmap."""
    h, w = gbuffer.shape
    quality = config.quality
    lightmap = env.ambient.to(torch.float32).expand(h, w, 4) \
        + accumulate_sphere_lights(
            volume, gbuffer, sphere_lights, env, quality,
            with_specular=with_specular, shadow_mode=shadow_mode,
            with_ao=with_ao)
    if directional_lights is not None:
        lightmap = lightmap + accumulate_directional_lights(
            volume, gbuffer, directional_lights, env, quality,
            shadow_mode=shadow_mode, with_ao=with_ao)
    if line_lights is not None:
        lightmap = lightmap + accumulate_line_lights(
            volume, gbuffer, line_lights, env, quality,
            shadow_mode=shadow_mode, with_ao=with_ao)
    if volumetric_lights is not None:
        # The pass's shadow setting; a light's own CastsShadows flag gates
        # inside.
        lightmap = lightmap + accumulate_volumetric_lights(
            volume, gbuffer, volumetric_lights, env, quality,
            shadowed=(shadow_mode != "none"),
            shadow_detail="scan" if shadow_mode == "scan" else "march")
    if projector_lights is not None:
        lightmap = lightmap + accumulate_projector_lights(
            volume, gbuffer, projector_lights, env, quality)
    return lightmap


def _mode_of(light) -> str:
    mode = getattr(light, "blend_mode", "additive")
    if mode not in BLEND_MODES:
        raise ValueError(
            f"unknown blend_mode {mode!r} on {type(light).__name__} "
            "(expected 'additive', 'subtractive' or 'max')")
    return mode


class LightingRenderer:
    """Host wrapper that owns the field, the G-buffer and the packed
    scene tensors, all on `device`.

    `light_capacity` and `obstruction_capacity` are kept for the JAX
    package's signature, where they pad every blend group to that many
    sphere lanes and every field partition to that many obstruction lanes
    so that a jit cache stays warm. Eager PyTorch has no such cache: the
    port packs each group and each partition to its live count (at least
    one lane). Inactive lanes add nothing and never win the field's min,
    so image and field are the padded pack's. Sphere lights never raise,
    however many there are (the JAX package grows the pad to fit them):
    `light_capacity` is accepted for the signature only and never read.
    A field partition of more than `obstruction_capacity` obstructions
    raises ValueError, as the JAX package's pack does."""

    def __init__(self, config: RendererConfig,
                 environment: LightingEnvironment,
                 sdf_config: Optional[SdfVolumeConfig] = None,
                 light_capacity: int = 64, obstruction_capacity: int = 64,
                 device="cuda"):
        self.config = config
        self.environment = environment
        self.light_capacity = light_capacity
        self.obstruction_capacity = obstruction_capacity
        self.sdf_config = sdf_config
        self.device = torch.device(device)

        def empty():
            return (SdfVolume.empty(sdf_config, device=self.device)
                    if sdf_config else None)

        # The static / dynamic field partition (DynamicDistanceField,
        # SDF/DistanceField.cs:248-321): the static partition holds the
        # non-dynamic obstructions and is not regenerated when dynamic
        # ones move. `volume` is the combined (minimum) field.
        self.volume: Optional[SdfVolume] = empty()
        self._volume_static: Optional[SdfVolume] = empty()
        self._volume_dynamic: Optional[SdfVolume] = empty()
        # All slices start invalid (DistanceField.cs:13-16).
        all_slices = list(range(sdf_config.slice_count)) if sdf_config else []
        self._invalid_static = list(all_slices)
        self._invalid_dynamic = list(all_slices)
        self._obstruction_snapshot = ()
        self.gbuffer: Optional[gbuf.GBuffer] = None
        # OnRenderGBuffer (LightingRenderer.GBuffer.cs:173-198): callbacks
        # run after the built-in G-buffer passes, each taking the GBuffer
        # and the uniforms and returning a GBuffer.
        self.on_render_gbuffer = []

    # -- field generation (UpdateFields, LightingRenderer.cs:1949) --------

    @property
    def _invalid_slices(self):
        """The union of both partitions' invalid slices."""
        return sorted(set(self._invalid_static) | set(self._invalid_dynamic))

    def invalidate(self, static: bool = True):
        """Full invalidation (DistanceField.Invalidate); `static=False` is
        DynamicDistanceField.Invalidate(false), the dynamic partition
        only."""
        if self.sdf_config:
            all_slices = list(range(self.sdf_config.slice_count))
            self._invalid_dynamic = list(all_slices)
            if static:
                self._invalid_static = list(all_slices)

    def auto_invalidate(self):
        """AutoInvalidateDistanceField (LightingRenderer.cs:1977-2015):
        consume the obstructions' dirty flags. A mutated dynamic
        obstruction invalidates the dynamic partition only; a mutated
        static one, a dynamicity flip or a static add / remove invalidates
        both."""
        if self.sdf_config is None:
            return
        obstructions = self.environment.obstructions
        snapshot = (
            tuple(o.serial for o in obstructions if not o.is_dynamic),
            tuple(o.serial for o in obstructions if o.is_dynamic))
        invalidated_static = invalidated_dynamic = False
        if snapshot != self._obstruction_snapshot:
            # Added or removed obstructions: the IsInvalid(Dynamic)
            # collection flags (LightingEnvironment.cs:51-133).
            static_changed = (snapshot[0] != self._obstruction_snapshot[0]
                              if self._obstruction_snapshot else True)
            self._obstruction_snapshot = snapshot
            self.invalidate(static=static_changed)
            invalidated_dynamic = True
            invalidated_static = static_changed
        for o in obstructions:
            if getattr(o, "has_dynamicity_changed", False):
                object.__setattr__(o, "has_dynamicity_changed", False)
                if not invalidated_static:
                    self.invalidate(static=True)
                    invalidated_static = invalidated_dynamic = True
            if not getattr(o, "is_valid", True):
                object.__setattr__(o, "is_valid", True)
                if o.is_dynamic:
                    if not invalidated_dynamic:
                        self.invalidate(static=False)
                        invalidated_dynamic = True
                elif not invalidated_static:
                    self.invalidate(static=True)
                    invalidated_static = invalidated_dynamic = True

    @span("illuminant/renderer/update_fields")
    def update_fields(self, budget: Optional[int] = None):
        """Rebuild the G-buffer, then regenerate up to `budget` slabs of
        each invalid field partition (default: the configuration's
        maximum_field_updates_per_frame)."""
        env_u = self.environment.uniforms(device=self.device)
        self.gbuffer = self._render_gbuffer(env_u)
        if self.sdf_config is None:
            return
        self.auto_invalidate()
        budget = budget or self.config.maximum_field_updates_per_frame
        with span("illuminant/renderer/field_regen"):
            self._regenerate(budget)

    @span("illuminant/renderer/gbuffer")
    def _render_gbuffer(self, env_u) -> gbuf.GBuffer:
        env = self.environment
        h, w = self.config.lightmap_shape
        if not self.config.enable_gbuffer:
            return gbuf.no_gbuffer(h, w, env_u, self.config.render_scale)
        gbuffer = gbuf.flat_ground(h, w, env_u, self.config.render_scale)
        if env.height_volumes and self.config.two_point_five_d:
            with span("illuminant/renderer/gbuffer/height_volumes"):
                gbuffer = rasterize_height_volumes(
                    gbuffer, pack_height_volumes(env.height_volumes,
                                                 device=self.device), env_u)
        if env.billboards:
            with span("illuminant/renderer/gbuffer/billboards"):
                gbuffer = rasterize_billboards(gbuffer, env.billboards,
                                               env_u)
        for hook in self.on_render_gbuffer:
            gbuffer = hook(gbuffer, env_u)
        return gbuffer

    def _regenerate(self, budget: int):
        if any(o.is_dynamic for o in self.environment.obstructions):
            self._volume_static, self._invalid_static = \
                self._regenerate_partition(
                    self._volume_static, self._invalid_static, budget,
                    dynamic=False)
            self._volume_dynamic, self._invalid_dynamic = \
                self._regenerate_partition(
                    self._volume_dynamic, self._invalid_dynamic, budget,
                    dynamic=True)
            self.volume = vol.combine_static_dynamic(
                self._volume_static, self._volume_dynamic)
        else:
            self._volume_static, self._invalid_static = \
                self._regenerate_partition(
                    self._volume_static, self._invalid_static, budget,
                    dynamic=None)
            self._invalid_dynamic = []
            self.volume = self._volume_static

    def _regenerate_partition(self, volume, invalid, budget, dynamic):
        """Budgeted slab regeneration of one partition
        (RenderDistanceFieldPartition, LightingRenderer.DistanceField.cs:
        415-462). `dynamic=None`: the single-field mode, every
        obstruction."""
        if not invalid:
            return volume, invalid
        slice_count = self.sdf_config.slice_count
        live = sum(dynamic is None or o.is_dynamic == dynamic
                   for o in self.environment.obstructions)
        if live > self.obstruction_capacity:
            raise ValueError(f"capacity {self.obstruction_capacity} < "
                             f"{live} obstructions")
        obstructions = self.environment.pack_obstructions(
            dynamic=dynamic, device=self.device)
        for _ in range(budget):
            if not invalid:
                break
            start = invalid[0]
            count = min(SLICES_PER_UPDATE, slice_count - start)
            # One span a slab written: their count is the slabs a frame.
            with span("illuminant/renderer/field_slab"):
                volume = vol.update_slices(volume, start, vol.generate_slab(
                    self.sdf_config, obstructions, start, count))
            done = set(range(start, start + count))
            invalid = [s for s in invalid if s not in done]
        # The world z up to which every slice is valid.
        first_invalid = min(invalid, default=slice_count)
        valid_z = first_invalid * self.sdf_config.slice_z_size
        return volume.replace(max_valid_z=torch.tensor(
            valid_z, dtype=torch.float32, device=self.device)), invalid

    # -- lighting ---------------------------------------------------------

    @span("illuminant/renderer/render_lighting")
    def render_lighting(self, intensity_scale: float = 1.0,
                        shadow_mode: str = "march"):
        """-> (H, W, 4) HDR lightmap: one pass for the additive lights
        over the ambient, one for the subtractive group, one for each max
        light. `shadow_mode="scan"` (or a renderer without a voxel field)
        lights against the analytic scene of the obstructions and the
        obstruction-flagged height volumes, packed here every call."""
        if self.gbuffer is None:
            self.update_fields(budget=10**6)
        env = self.environment
        dev = self.device
        sphere_sources = [l for l in env.lights
                          if isinstance(l, SphereLightSource)]
        for rep in env.lights:
            if isinstance(rep, LightSourceReplicator):
                sphere_sources += rep.expand()

        field = self.volume
        if shadow_mode == "scan" or field is None:
            field = pack_scene(env.obstructions,
                               height_volumes=env.height_volumes, device=dev)

        def group_of(mode):
            """All lights of `mode`, the spheres (replicator expansions
            included) first."""
            return ([s for s in sphere_sources if _mode_of(s) == mode]
                    + [l for l in env.lights
                       if isinstance(l, _OTHER_SOURCES)
                       and _mode_of(l) == mode])

        def light_pass(lights, env_u, mode):
            """One blend group's whole light pass (the reference batches
            lights into render states keyed by BlendState and draws a
            group together, LightingRenderer.cs:48-96, 206)."""
            def of(cls):
                return [l for l in lights if isinstance(l, cls)]

            def packed(cls, pack):
                group = of(cls)
                return pack(group, device=dev) if group else None

            # A group in which no light casts shadows skips the scan or
            # the march, and one without an AO radius the AO sample: the
            # accumulators run them whatever the per-light flags say.
            group_mode = shadow_mode if any(
                getattr(l, "cast_shadows", False) for l in lights) else "none"
            with span(f"illuminant/renderer/light_pass/{mode}"):
                return render_lightmap(
                    field, self.gbuffer,
                    pack_sphere_lights(of(SphereLightSource), device=dev),
                    env_u, self.config,
                    directional_lights=packed(DirectionalLightSource,
                                              pack_directional_lights),
                    line_lights=packed(LineLightSource, pack_line_lights),
                    volumetric_lights=packed(VolumetricLightSource,
                                             pack_volumetric_lights),
                    projector_lights=packed(ProjectorLightSource,
                                            pack_projector_lights),
                    shadow_mode=group_mode,
                    with_ao=any(
                        getattr(l, "ambient_occlusion_radius", 0) > 0
                        for l in lights))

        env_u = env.uniforms(device=dev)
        # The ambient clears the base (additive) pass only; the
        # subtractive and max groups composite pure light.
        env_zero = env_u.replace(ambient=torch.zeros_like(env_u.ambient))
        lightmap = light_pass(group_of("additive"), env_u, "additive")
        sub_group = group_of("subtractive")
        if sub_group:
            # Subtraction is linear, so the group is one pass. A float
            # lightmap does not clamp a subtractive blend (HalfVector4 in
            # the reference); the resolve clamps.
            lightmap = lightmap - light_pass(sub_group, env_zero,
                                             "subtractive")
        # MaxBlendValue applies per draw: max lights compose as the max of
        # each, never of a group's sum.
        for mx_light in group_of("max"):
            lightmap = torch.maximum(
                lightmap, light_pass([mx_light], env_zero, "max"))
        if intensity_scale != 1.0:
            lightmap = lightmap * intensity_scale
        return lightmap

    @span("illuminant/renderer/resolve")
    def resolve(self, lightmap, hdr: HDRConfig = HDRConfig(), albedo=None,
                inverse_scale: float = 1.0, average_luminance: float = 0.5,
                albedo_is_srgb: bool = False):
        return resolve_lightmap(
            lightmap, hdr, albedo=albedo, inverse_scale=inverse_scale,
            average_luminance=average_luminance,
            albedo_is_srgb=albedo_is_srgb)
