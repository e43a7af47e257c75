"""The flagship scene on PyTorch.

Counterpart of illuminant_tpu/scenes.py:build_flagship, its two fields and
two presets:
  * field="analytic" (the headline frame): the type-grouped analytic scene
    whose two dynamic occluders orbit every frame, evaluated in closed form
    wherever the frame queries it;
  * field="voxel": a baked static voxel field saved and loaded
    (DistanceField.cs Save/Load :178-213), a dynamic partition regenerated
    every frame and min-combined with it (DynamicDistanceField :248-321),
    and column maps built from the result;
  * preset="fast": library-default quality, one collision substep, the
    Gaussian glow; preset="parity": full-resolution shadows with quarter-
    resolution nomination, three collision substeps, the round kernel.
On that field the frame runs
  * 8 sphere lights with scan shadows (or, `shadow_mode="march"`, the
    exact cone march: K12 on the card) over a flat G-buffer, radius pulse
    and orbit animated by beziers;
  * a 1M-particle system: bezier-path spawner, gravity attractors, SDF
    collision against the moving occluders;
  * the additive particle splat, an HDR luminance histogram driving the
    next frame's exposure, and the Uncharted2 tonemap to uint8.
With `mesh` each rank of a multi-device run builds its part of the frame
(see build_flagship). With `full_family` (True, or a set of family names)
the frame also shades
the full "Lumined scene" light set (scenes.py:259-372, 593-799): a
directional sun and a line light whose shadows ride the sphere lights'
scan as extra lanes (under the march, the sun marches and the line light
takes its own scan, as in the JAX frame), a shadowed volumetric light
and a projector evaluated on windows, and particle lights from the
incoming particle state.

JAX's jit, buffer donation and fori_loop have no counterpart here: `frame`
runs the stages eagerly, and `frame_loop` is a Python loop over `frame`.
The spawn writes into the incoming state's tensors in place (see
particles/spawner.py:spawn). The scene's HDR composite is cast to
bfloat16 exactly as in the JAX frame (scenes.py:847): the histogram
buckets and the uint8 frame are defined on that value.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .core.config import QualitySettings, RendererConfig
from .core.trace import span
from .lighting import gbuffer as gbuf
from .lighting.directional import (DirectionalLightSource,
                                   accumulate_directional_lights,
                                   directional_scan_args,
                                   pack_directional_lights)
from .lighting.environment import (LightObstruction, LightingEnvironment,
                                   SphereLightSource, pack_sphere_lights)
from .lighting.line import (LineLightSource, accumulate_line_lights,
                            line_scan_anchors, pack_line_lights)
from .lighting.particle_light import (ParticleLightSource,
                                      accumulate_particle_lights)
from .lighting.projector import (ProjectorLightSource,
                                 accumulate_projector_lights,
                                 pack_projector_lights)
from .lighting.projector import support_radius_px as projector_support_px
from .lighting.scan_shadows import (resize_visibility, scan_cone_visibility,
                                    upsample2x_bilinear)
from .lighting.sphere import accumulate_sphere_lights
from .lighting.volumetric import (SHAPE_ELLIPSOID, VolumetricLightSource,
                                  accumulate_volumetric_lights,
                                  pack_volumetric_lights)
from .lighting.volumetric import support_radius_px as volumetric_support_px
from .lighting.windowed import accumulate_windowed, window_for_support
from .ops import tonemap as tm
from .ops.bezier import (DynamicMatrix, constant_bezier, evaluate_bezier,
                         pack_bezier, pack_bezier_matrix)
from .parallel.mesh import (check_mesh, gather_slots, mesh_device,
                            reduce_histogram, row_band)
from .parallel.raster import rasterize_tiled_sharded
from .particles import transforms as tx
from .particles.formula import FORMULA_SPHERICAL, Formula1, Formula3, Formula4
from .particles.integrate import integrate_with_distance_field
from .particles.render_data import RenderDataUniforms
from .particles.spawner import Spawner, spawn
from .particles.state import ParticleState
from .particles.system import ParticleSystem, ParticleSystemConfig
from .raster.tiled import TiledRasterConfig, rasterize_tiled
from .sdf import analytic, volume as vol
from .sdf.columns import build_column_maps
from .utils.histogram import bucket_boundaries, compute_histogram, percentile

DT = 1.0 / 60.0  # one timestep for physics and animation
FAMILIES = ("directional", "line", "volumetric", "projector", "particle")


@dataclasses.dataclass
class FlagshipScene:
    config: RendererConfig
    environment: LightingEnvironment
    sdf_config: vol.SdfVolumeConfig
    # The frame's field argument: the analytic pack, or the loaded static
    # voxel partition.
    volume: object
    gbuffer: gbuf.GBuffer
    sphere_lights: object
    system: ParticleSystem
    raster_config: TiledRasterConfig
    # frame(state, avg_lum, generator, volume, gbuffer, lights, env_u,
    #       spawn_count, frame_index=0, spawn_uniforms=None)
    #   -> (img, state, avg_lum, dropped)
    frame: object
    # frame_loop(state, avg_lum, generator, volume, gbuffer, lights, env_u,
    #            spawn_count, i0, n_frames) -> (img, state, avg_lum, drops)
    frame_loop: object
    spawner: Spawner
    device: torch.device
    # The extra families' packed lights and host-side constants, by name
    # (None without `full_family`): "directional", "line", "volumetric",
    # "projector" hold the SoAs, "particle_light" the source.
    extra_lights: Optional[dict] = None


def build_flagship(height: int = 1080, width: int = 1920, n_lights: int = 8,
                   capacity: int = 1 << 20, spawn_max: int = 4096,
                   sdf_resolution_scale: float = 0.25,
                   quality: Optional[QualitySettings] = None,
                   bin_capacity: int = 1016,
                   preset: str = "fast",
                   shadow_mode: str = "scan", full_family=False,
                   spawn_sub_rings: int = 1,
                   collision_substeps: Optional[int] = None,
                   raster_preset: Optional[str] = None, mesh=None,
                   field: str = "analytic",
                   device="cuda") -> FlagshipScene:
    """The flagship frame on `device` (the card unless the caller asks for
    another); the arguments mean what they mean in the JAX package:
    `full_family` is False, True (every extra light family) or an iterable
    of names from FAMILIES; `raster_preset` picks the splat's kernel (the
    parity round disc or the fast Gaussian) apart from `preset`;
    `collision_substeps` overrides the preset's count (3 parity, 1 fast);
    `spawn_sub_rings` partitions the spawn ring (particles/spawner.py:
    spawn) and must divide `spawn_max` and `capacity`. `bin_capacity` is
    the raster config's bin size: the port's splat has no bins of fixed
    size and never drops a particle, so the frame's `dropped` counts only
    the mesh's send drops.

    `mesh` (parallel.mesh.make_mesh) builds the calling rank's frame of a
    multi-device run: its device is the rank's, and `frame` takes the
    rank's capacity shard of the state (parallel.mesh.shard_particles),
    spawns into it (the global ring's rows that land in its slots, or its
    own sub-ring segments; every rank draws the same global uniforms),
    rasterizes through parallel.raster.rasterize_tiled_sharded and
    returns its row band of the image (parallel.mesh.row_band) with the
    exposure of the whole frame (the band's histogram summed over the
    mesh). The other inputs are whole on every rank
    (parallel.mesh.replicate); each rank computes the whole lightmap and
    keeps its band. With `spawn_sub_rings` > 1 the count is a multiple of
    the mesh size."""
    if preset not in ("fast", "parity"):
        raise ValueError(f"unknown preset {preset!r}")
    if field not in ("analytic", "voxel"):
        raise ValueError(f"unknown field {field!r}")
    if raster_preset not in (None, "fast", "parity"):
        raise ValueError(f"unknown raster_preset {raster_preset!r}")
    if not isinstance(full_family, bool):
        bad = set(full_family) - set(FAMILIES)
        if bad:
            raise ValueError(f"unknown light families {sorted(bad)}; "
                             f"valid: {sorted(FAMILIES)}")
    if shadow_mode not in ("scan", "march", "none"):
        raise ValueError(f"unknown shadow_mode {shadow_mode!r} (expected "
                         "'scan', 'march' or 'none')")
    if spawn_sub_rings < 1 or spawn_max % spawn_sub_rings \
            or capacity % spawn_sub_rings:
        raise ValueError(f"spawn_sub_rings={spawn_sub_rings} must divide "
                         f"spawn_max {spawn_max} and capacity {capacity}")
    if mesh is not None:
        check_mesh(mesh)
        if torch.device(device).type != mesh.device_type:
            raise ValueError(f"a {mesh.device_type} mesh builds no frame on "
                             f"{device!r}")
        device = mesh_device(mesh)
        if capacity % mesh.size() or (spawn_sub_rings > 1
                                      and spawn_sub_rings % mesh.size()):
            raise ValueError(
                f"the capacity {capacity} and spawn_sub_rings "
                f"{spawn_sub_rings} (when > 1) must be multiples of the "
                f"mesh size {mesh.size()}")
    device = torch.device(device)
    parity = preset == "parity"
    substeps = (collision_substeps if collision_substeps is not None
                else (3 if parity else 1))
    if quality is None and parity:
        # Full-resolution readout and refine under a quarter-resolution
        # nomination walk, one refine sample (scenes.py:152-177).
        quality = QualitySettings(shadow_scale=1.0, scan_refine_samples=1,
                                  scan_nomination_scale=0.25,
                                  extra_family_scale=1.0)

    env = LightingEnvironment(ground_z=0.0, maximum_z=128.0,
                              ambient=(0.03, 0.03, 0.04, 1.0))
    cx, cy = width * 0.5, height * 0.5
    ring = min(width, height) * 0.38
    colors = [
        (1.0, 0.5, 0.3, 1.0), (0.3, 1.0, 0.5, 1.0), (0.4, 0.5, 1.0, 1.0),
        (1.0, 0.9, 0.4, 1.0), (0.9, 0.3, 0.9, 1.0), (0.3, 0.9, 0.9, 1.0),
        (1.0, 0.7, 0.7, 1.0), (0.7, 1.0, 0.7, 1.0),
    ]
    for i in range(n_lights):
        a = 2 * math.pi * i / n_lights
        env.lights.append(SphereLightSource(
            position=(cx + ring * math.cos(a), cy + ring * math.sin(a),
                      40.0),
            radius=12.0, ramp_length=max(width, height) * 0.45,
            color=colors[i % len(colors)]))
    # Occluders; the ellipsoid and the cylinder move every frame.
    env.obstructions += [
        LightObstruction.box((cx, cy, 24.0), (22.0, 22.0, 24.0)),
        LightObstruction.ellipsoid((cx - ring * 0.5, cy, 20.0),
                                   (28.0, 16.0, 20.0), is_dynamic=True),
        LightObstruction.cylinder((cx, cy - ring * 0.5, 26.0),
                                  (12.0, 12.0, 26.0), is_dynamic=True),
        LightObstruction.box((cx + ring * 0.45, cy + ring * 0.3, 16.0),
                             (30.0, 10.0, 16.0)),
    ]
    config = RendererConfig(width=width, height=height,
                            quality=quality or QualitySettings())
    sdf_config = vol.SdfVolumeConfig(
        virtual_width=width, virtual_height=height, virtual_depth=64,
        slice_count=16, resolution_scale=sdf_resolution_scale)
    # Tight group packing: the scene is fixed. Both fields key each dynamic
    # occluder's orbit frequency by its type group here.
    packed = analytic.pack_scene(env.obstructions, group_capacity_round=1,
                                 device=device)
    if field == "voxel":
        volume = _load_static_voxels(env, sdf_config, width, height,
                                     sdf_resolution_scale, device)
        animate_field = _voxel_animation(
            sdf_config, env.pack_obstructions(dynamic=True, device=device),
            [0.9 + 0.3 * packed.group_types.index(o.type)
             for o in env.obstructions if o.is_dynamic], device)
    else:
        volume = packed
        animate_field = _analytic_animation(packed, env.obstructions, device)

    env_u = env.uniforms(device=device)
    gbuffer = gbuf.flat_ground(height, width, env_u)
    sphere_lights = pack_sphere_lights(
        [l for l in env.lights if isinstance(l, SphereLightSource)],
        capacity=max(n_lights, 1), device=device)
    fam_set = (set(FAMILIES) if full_family is True
               else set(full_family) if full_family else set())
    extra = (_author_extra_lights(fam_set, cx, cy, ring, device)
             if fam_set else None)

    p_config = ParticleSystemConfig(
        capacity=capacity, updates_per_second=0.0,
        life_decay_per_second=0.2, friction=0.05, maximum_velocity=600.0,
        collision_distance=1.0, bounce_velocity_multiplier=0.7)
    # Tangential orbit spawn with an animated 84..96 degree velocity
    # post-matrix (scenes.py:455-474).
    rot90 = pack_bezier_matrix(
        [DynamicMatrix.from_components(angle=84.0, device=device),
         DynamicMatrix.from_components(angle=96.0, device=device),
         DynamicMatrix.from_components(angle=84.0, device=device)],
        min_value=0.0, max_value=4.0, device=device)
    spawner = Spawner(
        min_rate=float(capacity) * 0.2, max_rate=float(capacity) * 0.2,
        life=Formula1(constant=2.5, random_scale=1.0, offset=-0.5),
        position=Formula3(constant=(cx, cy, 30.0),
                          offset=(width * 0.36, height * 0.37, 8.0),
                          random_scale=(width * 0.14, height * 0.13, 4.0),
                          type=FORMULA_SPHERICAL),
        velocity=Formula3(offset=(150.0, 150.0, 0.0),
                          random_scale=(40.0, 40.0, 10.0),
                          type=FORMULA_SPHERICAL),
        align_velocity_and_position=True, velocity_post_matrix=rot90,
        color=Formula4(constant=(0.4, 0.5, 0.9, 0.5),
                       random_scale=(0.4, 0.3, 0.1, 0.3)),
        spawn_max=spawn_max)
    # Attractor plus central repulsor: a stable annulus.
    grav = tx.Gravity(attractors=[
        tx.Attractor(position=(cx, cy, 20.0),
                     radius=float(max(width, height)), strength=32.0,
                     falloff_type=tx.FALLOFF_LINEAR),
        tx.Attractor(position=(cx, cy, 20.0), radius=float(height) * 0.38,
                     strength=-110.0, falloff_type=tx.FALLOFF_LINEAR),
    ], maximum_acceleration=3000.0)
    render_data = RenderDataUniforms(
        color_from_life=pack_bezier(
            [(0.3, 0.3, 0.6, 0.0), (1.0, 1.0, 1.0, 1.0),
             (1.0, 1.0, 1.0, 1.0)], min_value=0.0, max_value=4.0,
            device=device),
        color_from_velocity=constant_bezier([1.0, 1.0, 1.0, 1.0],
                                            device=device),
        size_from_life=pack_bezier([[1.0], [2.5], [3.0]], min_value=0.0,
                                   max_value=4.0, device=device),
        size_from_velocity=constant_bezier([1.0], device=device),
        rotation_from_life_and_index=torch.zeros(
            (2,), dtype=torch.float32, device=device),
    )
    system = ParticleSystem(p_config, [spawner, grav], volume=volume,
                            render_data=render_data, device=device)

    # The raster preset's splat kernel: the parity round disc or the fast
    # Gaussian glow. The JAX presets' payload quantization has no
    # counterpart in the direct splat.
    raster_config = TiledRasterConfig(
        height=height, width=width, tile=32, apron=4, channels=3,
        kernel="round" if (raster_preset or preset) == "parity" else "gauss",
        bin_capacity=bin_capacity)

    frame = _FlagshipFrame(
        device=device, cx=cx, cy=cy, ring=ring, config=config,
        animate_field=animate_field, substeps=substeps,
        su=system.system_uniforms(DT), rd=system.render_data,
        grav_u=grav.uniforms(0.0, device=device),
        spawn_u=spawner.uniforms(0.0, device=device), spawner=spawner,
        raster_config=raster_config, extra=extra, shadow_mode=shadow_mode,
        sub_rings=spawn_sub_rings, mesh=mesh)
    return FlagshipScene(
        config=config, environment=env, sdf_config=sdf_config,
        volume=volume, gbuffer=gbuffer, sphere_lights=sphere_lights,
        system=system, raster_config=raster_config, frame=frame.frame,
        frame_loop=frame.frame_loop, spawner=spawner, device=device,
        extra_lights=extra)


def _author_extra_lights(fam_set, cx, cy, ring, device):
    """The full "Lumined scene" light set (scenes.py:282-372), packed: a
    directional sun, a line light, a shadowed volumetric ellipsoid, a
    projector with a procedural window-pane texture, and particle lights.
    Beside each SoA sit the host-side constants the frame reads: the AO
    gates (AO costs a field evaluation per light unless skipped
    statically), and the windowed lights' centers (world xy, numpy) and
    support radii (world units)."""
    extra = {}
    if "directional" in fam_set:
        sun = DirectionalLightSource(
            direction=(0.35, 0.55, -0.76), color=(0.35, 0.33, 0.28, 1.0),
            shadow_trace_length=256.0, shadow_softness=12.0,
            shadow_ramp_rate=0.5)
        extra["directional"] = pack_directional_lights([sun], device=device)
        extra["directional_ao"] = sun.ambient_occlusion_radius > 0.0
    if "line" in fam_set:
        line = LineLightSource(
            start=(cx - ring * 0.9, cy - ring * 0.75, 44.0),
            end=(cx + ring * 0.9, cy - ring * 0.75, 44.0), radius=6.0,
            color_start=(0.9, 0.2, 0.2, 0.9), color_end=(0.2, 0.3, 0.9, 0.9))
        extra["line"] = pack_line_lights([line], device=device)
        extra["line_ao"] = line.ambient_occlusion_radius > 0.0
    if "volumetric" in fam_set:
        # For an ellipsoid end_position is the radius vector
        # (LightSource.cs:381-383). The 24-unit ramp keeps the silhouette
        # soft enough for the half-resolution evaluation.
        volum = VolumetricLightSource(
            shape=SHAPE_ELLIPSOID,
            start_position=(cx - ring * 0.6, cy + ring * 0.55, 30.0),
            end_position=(110.0, 80.0, 26.0), volumetricity=0.75,
            distance_attenuation=0.8, ramp_length=24.0,
            color=(0.5, 0.8, 0.6, 0.8), cast_shadows=True)
        packed = pack_volumetric_lights([volum], device=device)
        extra["volumetric"] = packed
        extra["volumetric_centers"] = packed.start[:, :2].cpu().numpy()
        extra["volumetric_support"] = float(
            volumetric_support_px(packed).max())
    if "projector" in fam_set:
        ty, txx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64),
                              indexing="ij")
        pane = (np.sin(txx * np.pi * 4) * np.sin(ty * np.pi * 4)) ** 2
        ptex = np.stack([pane * 0.9, pane * 0.8, pane * 0.5,
                         np.ones_like(pane)], axis=-1).astype(np.float32)
        proj = ProjectorLightSource(
            texture=ptex, position=(cx + ring * 0.35, cy + ring * 0.4, 0.0),
            scale=(260.0, 200.0), opacity=0.8)
        extra["projector"] = pack_projector_lights([proj], device=device)
        # The projected quad's center, for the windowed evaluation.
        extra["projector_centers"] = np.asarray(
            [[proj.position[0] + proj.scale[0] * 0.5,
              proj.position[1] + proj.scale[1] * 0.5]], np.float32)
        extra["projector_support"] = float(np.max(
            projector_support_px([proj])))
    if "particle" in fam_set:
        # A shadowless template, the common reference usage: 32 extra
        # shadow traces would dominate the frame.
        extra["particle_light"] = ParticleLightSource(
            template=SphereLightSource(
                position=(0.0, 0.0, 0.0), radius=3.0, ramp_length=90.0,
                color=(1.0, 1.0, 1.0, 0.035), cast_shadows=False),
            max_lights=32)
    return extra


def _take_light(lights, i: int):
    """Light i of a packed SoA as a one-light SoA (tuples of per-level
    tensors, the projector's mips, are sliced level by level)."""
    def cut(v):
        if torch.is_tensor(v):
            return v[i:i + 1]
        if isinstance(v, tuple):
            return tuple(cut(e) for e in v)
        return v

    return lights.replace(**{f.name: cut(getattr(lights, f.name))
                             for f in dataclasses.fields(lights)})


def _load_static_voxels(env, sdf_config, width, height,
                        sdf_resolution_scale, device):
    """Bake the static partition, save it and load it back (the shipped-
    scene path). The file name is the port's own, written by rename."""
    static_vox = vol.generate_volume(
        sdf_config, env.pack_obstructions(dynamic=False, device=device))
    path = os.path.join(
        tempfile.gettempdir(),
        f"illum_torch_flagship_field_{width}x{height}_"
        f"{sdf_resolution_scale}.npz")
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(path))
    os.close(fd)
    try:
        vol.save(static_vox, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return vol.load(path, device=device)


def _orbit(freq, t):
    """(n, 3) offsets of a unit orbit at time t, one frequency per row."""
    return torch.stack([torch.sin(freq * t), torch.cos(freq * t),
                        torch.zeros_like(freq)], dim=-1)


def _analytic_animation(scene, obstructions, device):
    """animate(scene, t): each dynamic occluder of the analytic pack orbits
    a (60, 40) ellipse at 0.9 + 0.3 * its group index per second
    (scenes.py:374-404)."""
    amps, freqs = [], []
    for gi, type_id in enumerate(scene.group_types):
        n = scene.centers[gi].shape[0]
        amp = np.zeros((n, 3), np.float32)
        freq = np.zeros((n,), np.float32)
        group = [o for o in obstructions if o.type == type_id][:n]
        for j, o in enumerate(group):
            if o.is_dynamic:
                amp[j] = (60.0, 40.0, 0.0)
                freq[j] = 0.9 + 0.3 * gi
        amps.append(torch.as_tensor(amp, device=device))
        freqs.append(torch.as_tensor(freq, device=device))

    def animate(scene_, t):
        return scene_.replace(centers=tuple(
            c + a * _orbit(f, t)
            for c, a, f in zip(scene_.centers, amps, freqs)))

    return animate


def _voxel_animation(sdf_config, dyn_obs, dyn_freqs, device):
    """animate(static volume, t): the same orbits applied to the packed
    dynamic partition, which is regenerated, min-combined with the static
    field and turned into column maps (scenes.py:406-443)."""
    n_dyn = dyn_obs.centers.shape[0]
    damp = np.zeros((n_dyn, 3), np.float32)
    dfreq = np.zeros((n_dyn,), np.float32)
    for j, fq in enumerate(dyn_freqs):
        damp[j] = (60.0, 40.0, 0.0)
        dfreq[j] = fq
    damp = torch.as_tensor(damp, device=device)
    dfreq = torch.as_tensor(dfreq, device=device)

    def animate(static_volume, t):
        centers = dyn_obs.centers + damp * _orbit(dfreq, t)
        dyn_vol = vol.generate_volume(sdf_config,
                                      dyn_obs.replace(centers=centers))
        return build_column_maps(
            vol.combine_static_dynamic(static_volume, dyn_vol))

    return animate


class _FlagshipFrame:
    """The frame's constants and its stages, one method each."""

    def __init__(self, *, device, cx, cy, ring, config, animate_field,
                 substeps, su, rd, grav_u, spawn_u, spawner, raster_config,
                 extra=None, shadow_mode="scan", sub_rings=1, mesh=None):
        f32 = torch.float32
        self.device = device
        self.quality = config.quality
        self.center = torch.tensor([cx, cy, 0.0], dtype=f32, device=device)
        # animate_field(volume, t) -> the field the frame queries at t.
        self.animate_field = animate_field
        self.substeps = substeps
        self.su, self.rd, self.grav_u = su, rd, grav_u
        self.spawner = spawner
        self.raster_config = raster_config
        self.extra = extra
        # "scan": the sphere lights' radial scan, fused with the sun's and
        # the line light's lanes; "march": the exact cone march (K12 on
        # the card) for the sphere lights and the sun.
        self.shadow_mode = shadow_mode
        self.sub_rings = sub_rings
        # A mesh rank's part: its row band and, on a mesh of several
        # ranks, its capacity shard of the spawn ring.
        self.mesh = mesh
        self.rows = (row_band(mesh, raster_config) if mesh is not None
                     else (0, raster_config.height))
        self.shard = ((mesh.get_local_rank(), mesh.size())
                      if mesh is not None and mesh.size() > 1 else None)
        self.light_radius_bezier = pack_bezier(
            [[10.0], [16.0], [11.0], [10.0]], min_value=0.0, max_value=2.0,
            device=device)
        # An open cubic under the mod-6 time wrap: the emission point jumps
        # from P3 back to P0 every 6 s, as in the JAX frame.
        self.spawn_path_bezier = pack_bezier(
            [(cx - ring * 0.5, cy, 30.0), (cx, cy - ring * 0.4, 34.0),
             (cx + ring * 0.5, cy, 30.0), (cx, cy + ring * 0.4, 26.0)],
            min_value=0.0, max_value=6.0, device=device)
        # The spawn's uniforms with the emission path; it and the animated
        # velocity post-matrix are evaluated by the spawn at the frame's
        # time wrapped at 6 s and 4 s (on the card inside K4b's launch).
        self.spawn_u = spawn_u.replace(
            position_path=self.spawn_path_bezier,
            animation_periods=(6.0, 0.0, 4.0))
        self.hist_bounds = bucket_boundaries(max_value=64.0)
        self.white = tm.uncharted2_tonemap(
            torch.tensor(4.0, dtype=f32, device=device))

    # -- stages -----------------------------------------------------------

    def animate_lights(self, lights, i, t):
        """Orbit the lights about the screen center and pulse their
        radius."""
        ang = i * 0.01
        ca, sa = torch.cos(ang), torch.sin(ang)
        rel = lights.position - self.center
        rot = torch.stack([rel[:, 0] * ca - rel[:, 1] * sa,
                           rel[:, 0] * sa + rel[:, 1] * ca, rel[:, 2]],
                          dim=-1)
        radius_t = evaluate_bezier(self.light_radius_bezier,
                                   torch.remainder(t, 2.0))[0]
        props = lights.properties.clone()
        props[:, 0] = radius_t
        return lights.replace(position=self.center + rot, properties=props)

    def fused_scan(self, field, gbuffer, lights, env_u):
        """One radial scan for every family that casts scan shadows: the
        directional sun's far pseudo-center and the line light's three
        anchors ride the sphere lights' walk as extra lanes of the L axis
        (the sequential column walk costs per pass, not per light). Lifts
        per family: 1.6 for spheres (SphereLightCore.fxh:151), 1.5 for
        directional and line lights (DirectionalLight.fx:13,
        LineLightCore.fxh:10). The trace plane is pinned to the radial
        lights' height: the sun's pseudo-center sits thousands of units
        out, and over-nomination is safe for it (its 3D refine rejects
        blockers the climbing ray clears).

        Returns (sphere, directional, line) visibilities, the first at the
        G-buffer's resolution, the others at the scan's; None for a
        family that is absent, all None when neither extra family
        scans or the frame does not run the scan (scenes.py:604)."""
        extra = self.extra or {}
        fuse_dir, fuse_line = "directional" in extra, "line" in extra
        if not (fuse_dir or fuse_line) or self.shadow_mode != "scan":
            return None, None, None
        f32 = torch.float32
        dev = self.device

        def full(n, v):
            return torch.full((n,), v, dtype=f32, device=dev)

        # Lanes: (centers, radii, ramps, lifts, trace budgets). Spheres
        # trace to the light: a cap beyond any screen diagonal is a no-op
        # in the readout.
        ns = lights.position.shape[0]
        lanes = [(lights.position, lights.properties[:, 0],
                  lights.properties[:, 1], full(ns, 1.6), full(ns, 1e8))]
        nd = 0
        if fuse_dir:
            dcen, drad, dramp, dtrace, _ = directional_scan_args(
                gbuffer, extra["directional"], env_u)
            nd = dcen.shape[0]
            lanes.append((dcen, drad, dramp, full(nd, 1.5), dtrace))
        if fuse_line:
            anchors, rad3, ramp3 = line_scan_anchors(extra["line"])
            n3 = rad3.shape[0]
            lanes.append((anchors, rad3, ramp3, full(n3, 1.5),
                          full(n3, 1e8)))
        pos, rad, ramp, lift, mtd = (torch.cat(c, 0) for c in zip(*lanes))
        vis_all = scan_cone_visibility(
            field, gbuffer, pos, rad, ramp, self.quality,
            self_occlusion_lift=lift, max_trace_distance=mtd,
            # The active-masked trace plane (pad slots sit at z = 0).
            trace_z=torch.sum(lights.position[:, 2] * lights.active)
            / torch.clamp(torch.sum(lights.active), min=1.0) * 0.4,
            upsample=False)
        return (resize_visibility(vis_all[:ns], gbuffer.shape),
                vis_all[ns:ns + nd] if fuse_dir else None,
                vis_all[ns + nd:] if fuse_line else None)

    def extra_families(self, field, gbuffer, env_u, state, dir_vis,
                       line_vis):
        """The directional, line, volumetric and particle lights' sum
        (H, W, 3) at the G-buffer's resolution. They evaluate at
        `quality.extra_family_scale` (0.5: a half-resolution flat-ground
        buffer, their sum upsampled 2x bilinear, in float32 where the JAX
        frame rounds to bfloat16; otherwise on the G-buffer itself). The
        volumetric light runs on a window derived from its support
        radius, with its own windowed scan."""
        extra, quality = self.extra, self.quality
        h, w = gbuffer.shape
        half = quality.extra_family_scale == 0.5 and h % 2 == 0 \
            and w % 2 == 0
        gb_ex = gbuf.flat_ground(
            h // 2, w // 2, env_u, render_scale=0.5 * gbuffer.render_scale) \
            if half else gbuffer
        ex = torch.zeros(gb_ex.shape + (3,), dtype=torch.float32,
                         device=self.device)
        if "directional" in extra:
            # The fused scan's visibility, or without it the standalone
            # march (scenes.py:731-734).
            with span("illuminant/lighting/directional"):
                ex = ex + accumulate_directional_lights(
                    field, gb_ex, extra["directional"], env_u, quality,
                    shadow_mode="march" if dir_vis is None else "scan",
                    scan_visibility_precomputed=None if dir_vis is None
                    else resize_visibility(dir_vis, gb_ex.shape),
                    with_ao=extra["directional_ao"])[..., :3]
        if "line" in extra:
            # The fused scan's visibility, or without it the line light's
            # own scan, as in the JAX frame.
            with span("illuminant/lighting/line"):
                ex = ex + accumulate_line_lights(
                    field, gb_ex, extra["line"], env_u, quality,
                    shadow_mode="scan",
                    scan_visibility_precomputed=None if line_vis is None
                    else resize_visibility(line_vis, gb_ex.shape),
                    with_ao=extra["line_ao"])[..., :3]
        if "volumetric" in extra:
            vl = extra["volumetric"]
            rs = np.float32(gb_ex.render_scale)
            with span("illuminant/lighting/volumetric"):
                ex = accumulate_windowed(
                    ex, gb_ex, extra["volumetric_centers"] * rs,
                    window_for_support(extra["volumetric_support"]
                                       * gb_ex.render_scale, *gb_ex.shape),
                    lambda i, gbw: accumulate_volumetric_lights(
                        field, gbw, _take_light(vl, i), env_u, quality,
                        shadowed=True, shadow_detail="scan"))
        if "particle_light" in extra:
            with span("illuminant/lighting/particle_lights"):
                ex = ex + accumulate_particle_lights(
                    field, gb_ex, state, extra["particle_light"], env_u,
                    quality, shadow_mode="scan")[..., :3]
        if half:
            ex = upsample2x_bilinear(ex.movedim(-1, 0)).movedim(0, -1)
        return ex

    def lighting(self, field, gbuffer, lights, env_u, state):
        """The lightmap (H, W, 3): ambient, the sphere lights, and with
        `full_family` the extra families. `state` is the incoming particle
        state, before this frame's spawn: the particle lights read the
        previous frame's particles (the reference's usePreviousData,
        LightingRenderer.cs:1138-43)."""
        h, w = gbuffer.shape
        ambient = env_u.ambient[:3].expand(h, w, 3)
        with span("illuminant/lighting/fused_scan"):
            sphere_vis, dir_vis, line_vis = self.fused_scan(
                field, gbuffer, lights, env_u)
        lightmap = ambient + accumulate_sphere_lights(
            field, gbuffer, lights, env_u, self.quality,
            with_specular=False, shadow_mode=self.shadow_mode, with_ao=False,
            with_alpha=False, scan_visibility_precomputed=sphere_vis)
        if not self.extra:
            return lightmap
        if "particle_light" in self.extra:
            state = self.whole_state(state)
        lightmap = lightmap + self.extra_families(
            field, gbuffer, env_u, state, dir_vis, line_vis)
        if "projector" in self.extra:
            # At full resolution on the lightmap (projected texture
            # detail), on a window around the projected quad.
            pj = self.extra["projector"]
            rs = np.float32(gbuffer.render_scale)
            with span("illuminant/lighting/projector"):
                lightmap = accumulate_windowed(
                    lightmap, gbuffer, self.extra["projector_centers"] * rs,
                    window_for_support(self.extra["projector_support"]
                                       * gbuffer.render_scale, h, w),
                    lambda i, gbw: accumulate_projector_lights(
                        field, gbw, _take_light(pj, i), env_u,
                        self.quality))
        return lightmap

    def particles(self, state, field, t, spawn_count, generator,
                  spawn_uniforms):
        """Bezier-path spawn at time `t`, gravity, then SDF collision."""
        state = spawn(state, self.spawn_u, spawn_count,
                      self.spawner.spawn_max,
                      generator=None if spawn_uniforms is not None
                      else generator, uniforms=spawn_uniforms,
                      sub_rings=self.sub_rings, shard=self.shard, time=t)
        with span("illuminant/particles/transforms"):
            pos, vel = tx.apply_modifiers(
                state.position, state.velocity,
                [(tx.apply_gravity, self.grav_u)], self.su)
        state = state.replace(position=pos, velocity=vel)
        return integrate_with_distance_field(
            state, self.su, self.rd, field, substeps=self.substeps,
            first_slot=0 if self.shard is None
            else self.shard[0] * state.capacity)

    def raster(self, state):
        """The particle image of the frame's rows (a mesh rank's band)."""
        args = (self.raster_config, state.position[:, 0],
                state.position[:, 1], state.render_color,
                state.render_data[:, 0], state.live_mask())
        if self.mesh is not None:
            return rasterize_tiled_sharded(self.mesh, *args)
        return rasterize_tiled(*args)

    def exposure(self, scene_hdr, avg_lum):
        """The HDR histogram's 95th percentile, smoothed into the next
        frame's average luminance; on a mesh the histogram of every
        rank's band."""
        hist = compute_histogram(scene_hdr, self.hist_bounds)
        if self.mesh is not None:
            hist = reduce_histogram(hist, self.mesh)
        return avg_lum * 0.95 + percentile(hist, 95.0) * 0.05

    def whole_state(self, state):
        """The whole particle set on a mesh of several ranks (every rank's
        shard gathered in slot order, one all_gather), else `state`."""
        if self.shard is None:
            return state
        planes = ("position", "velocity", "color", "render_color",
                  "render_data")
        cat = gather_slots(self.mesh, torch.cat(
            [getattr(state, p) for p in planes], dim=1))
        return ParticleState(
            **dict(zip(planes, cat.split(4, dim=1))),
            write_cursor=state.write_cursor,
            total_spawned=state.total_spawned)

    def tonemap(self, scene_hdr, avg_lum):
        """Uncharted2 + gamma to uint8 at this frame's exposure."""
        exposure = 1.1 / torch.clamp(avg_lum, min=0.05)
        mapped = tm.uncharted2_tonemap(scene_hdr.to(torch.float32)
                                       * exposure)
        rgb = torch.clamp(mapped / self.white, 0.0, 1.0) ** (1.0 / 2.2)
        return (rgb * 255.0 + 0.5).to(torch.uint8)

    # -- entry points -----------------------------------------------------

    def frame(self, state, avg_lum, generator, volume, gbuffer, lights,
              env_u, spawn_count, frame_index=0, spawn_uniforms=None):
        """One frame at time frame_index / 60 s. `spawn_uniforms` (three
        (spawn_max, 4) arrays) replaces the generator's draws.
        Returns (uint8 image (H, W, 3), state, next avg_lum, dropped); a
        mesh rank's image is its row band (row1 - row0, W, 3)."""
        f32 = torch.float32
        i = torch.tensor(float(frame_index), dtype=f32, device=self.device)
        t = i * DT
        avg_lum = torch.as_tensor(avg_lum, dtype=f32, device=self.device)
        with span("illuminant/frame/animate_field"):
            field = self.animate_field(volume, t)
        with span("illuminant/frame/animate_lights"):
            lights_t = self.animate_lights(lights, i, t)
        with span("illuminant/frame/lighting"):
            lightmap = self.lighting(field, gbuffer, lights_t, env_u, state)
        with span("illuminant/frame/particles"):
            state = self.particles(state, field, t, spawn_count, generator,
                                   spawn_uniforms)
        with span("illuminant/frame/raster"):
            particle_img, diag = self.raster(state)
        row0, row1 = self.rows
        scene_hdr = (lightmap[row0:row1] + particle_img[..., :3]).to(
            torch.bfloat16)
        with span("illuminant/frame/exposure"):
            new_avg = self.exposure(scene_hdr, avg_lum)
        with span("illuminant/frame/tonemap"):
            img = self.tonemap(scene_hdr, avg_lum)
        return img, state, new_avg, diag["dropped"]

    def frame_loop(self, state, avg_lum, generator, volume, gbuffer, lights,
                   env_u, spawn_count, i0, n_frames: int):
        """n_frames frames from frame index i0; returns the last image,
        the state, avg_lum and the largest drop count."""
        img, drops = None, 0
        for j in range(n_frames):
            img, state, avg_lum, dropped = self.frame(
                state, avg_lum, generator, volume, gbuffer, lights, env_u,
                spawn_count, frame_index=i0 + j)
            drops = max(drops, dropped)
        return img, state, avg_lum, drops
