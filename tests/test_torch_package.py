"""The port's package boundary: it never imports jax, and arguments
outside the ported slice fail loudly."""

import os
import subprocess
import sys

import pytest

from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.scenes import build_flagship

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Modules the particle engine's API added; the walk below must reach them.
NEW_MODULES = [f"illuminant_tpu_torch.{m}" for m in (
    "core.upload", "ops.noise", "particles.system", "particles.spawner",
    "particles.transforms", "particles.integrate", "particles.render_data",
    "raster.particles", "raster.render", "utils.perf", "raster.sprites",
    "raster.tile_kernel", "raster.warp", "lighting.tiled_lights",
    "lighting.tiled_lights_kernel", "lighting.probes",
    "lighting.spherical_harmonics", "utils.jumpflood", "utils.mapgen",
    "utils.visualize")]


def test_import_leaves_jax_out():
    """Every module of the port imported in a fresh interpreter: jax is
    not in sys.modules afterwards."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import illuminant_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [m for m in {NEW_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'jaxlib',\n"
        "                                            'illuminant_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_modules_load_nothing_at_import():
    """Importing the kernel wrappers builds and loads no library: the
    CUDA sources compile at the first launch, on the card."""
    code = (
        "import illuminant_tpu_torch.raster.tile_kernel as t\n"
        "import illuminant_tpu_torch.sdf.columns_kernel as c\n"
        "import illuminant_tpu_torch.lighting.tiled_lights_kernel as k\n"
        "import illuminant_tpu_torch.raster.render\n"
        "import illuminant_tpu_torch.lighting.particle_light\n"
        "from illuminant_tpu_torch.core.cuda_build import BUILD_LOGS\n"
        "assert t._lib is None, 'tile_raster'\n"
        "assert k._lib is None and k.LAUNCHES == 0, 'tiled_lights'\n"
        "assert c._lib is None, 'column_maps'\n"
        "assert not BUILD_LOGS\n"
        "assert t.COMPOSITE_LAUNCHES == t.ACCUMULATE_LAUNCHES == 0\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_quality_rejects_unknown_refine_mode():
    assert QualitySettings().scan_refine_mode == "carried"
    with pytest.raises(ValueError):
        QualitySettings(scan_refine_mode="carry")


# Both fields, both presets and the extra light families are ported. A
# raster preset other than the frame's own, a collision substep count
# outside 1-3 and the march are not, also with the families on.
@pytest.mark.parametrize("kwargs", [
    dict(raster_preset="parity"),
    dict(preset="parity", raster_preset="fast"),
    dict(full_family=True, shadow_mode="march"),
    dict(mesh=object()), dict(shadow_mode="march"),
    dict(collision_substeps=0), dict(spawn_sub_rings=2),
    dict(collision_substeps=4),
])
def test_unported_arguments_raise(kwargs):
    kw = dict(height=32, width=48, capacity=64, spawn_max=16, n_lights=2,
              field="voxel")
    kw.update(kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_flagship(**kw)


@pytest.mark.parametrize("families", [{"nope"}, ("line", "sun"), "line"])
def test_unknown_light_family_raises(families):
    """Family names outside FAMILIES raise ValueError before anything is
    built, as in the JAX package (a bare string is a set of letters)."""
    with pytest.raises(ValueError, match="unknown light families"):
        build_flagship(height=32, width=48, capacity=64, spawn_max=16,
                       n_lights=2, full_family=families)


def test_tiled_particle_lights_run_on_the_cpu():
    """`ParticleLightSource(method="tiled")` on CPU tensors runs K10's
    plain version, gives the (H, W, 4) image and, with
    `return_diagnostics`, the tiled overflow count as an int32 device
    scalar."""
    import torch

    from illuminant_tpu_torch.lighting import environment as env
    from illuminant_tpu_torch.lighting.gbuffer import flat_ground
    from illuminant_tpu_torch.lighting.particle_light import (
        ParticleLightSource, accumulate_particle_lights)
    from illuminant_tpu_torch.particles.state import ParticleState

    env_u = env.EnvironmentUniforms.make(device="cpu")
    state = ParticleState.empty(16, device=torch.device("cpu"))
    state.position[:4] = torch.tensor([4.0, 4.0, 3.0, 1.0])
    img, dropped = accumulate_particle_lights(
        None, flat_ground(8, 8, env_u), state,
        ParticleLightSource(method="tiled", tile=4, tile_capacity=2,
                            template=env.SphereLightSource(
                                radius=1.0, ramp_length=4.0,
                                cast_shadows=False)),
        env_u, QualitySettings(), return_diagnostics=True)
    assert img.shape == (8, 8, 4) and float(img[..., 3].max()) > 0.0
    assert dropped.dtype == torch.int32 and int(dropped) > 0


def test_flagship_holds_the_packed_extra_lights():
    """`FlagshipScene.extra_lights`: None without the families, else the
    packed SoAs by name, only those asked for."""
    kw = dict(height=32, width=48, capacity=64, spawn_max=16, n_lights=2,
              device="cpu")
    assert build_flagship(**kw).extra_lights is None
    extra = build_flagship(full_family=True, **kw).extra_lights
    assert {"directional", "line", "volumetric", "projector",
            "particle_light"} <= set(extra)
    assert extra["projector"].texture.shape == (1, 64, 64, 4)
    assert len(extra["projector"].mips) == 5
    assert extra["directional_ao"] is False and extra["line_ao"] is False
    only = build_flagship(full_family=("line",), **kw).extra_lights
    assert set(only) == {"line", "line_ao"}


def _entry_points():
    from illuminant_tpu_torch.lighting import directional, line
    from illuminant_tpu_torch.lighting import environment as env
    from illuminant_tpu_torch.lighting import projector, volumetric
    from illuminant_tpu_torch.lighting.probes import pack_probes
    from illuminant_tpu_torch.lighting.renderer import LightingRenderer
    from illuminant_tpu_torch.lighting.spherical_harmonics import (
        bake_probe_from_lights)
    from illuminant_tpu_torch.ops.noise import RandomField
    from illuminant_tpu_torch.particles.system import ParticleSystem
    from illuminant_tpu_torch.raster import sprites
    from illuminant_tpu_torch.raster.render import ParticleAppearance
    from illuminant_tpu_torch.sdf.analytic import pack_scene
    from illuminant_tpu_torch.sdf.height_volume import pack_height_volumes
    from illuminant_tpu_torch.sdf.volume import SdfObstructions, SdfVolume
    from illuminant_tpu_torch.utils.jumpflood import jump_flood_sdf
    from illuminant_tpu_torch.utils.visualize import visualize_distance_field

    return {
        "pack_probes": pack_probes,
        "bake_probe_from_lights": bake_probe_from_lights,
        "jump_flood_sdf": jump_flood_sdf,
        "visualize_distance_field": visualize_distance_field,
        "LightingRenderer": LightingRenderer.__init__,
        "pack_height_volumes": pack_height_volumes,
        "SdfVolume.empty": SdfVolume.empty,
        "SdfObstructions.empty": SdfObstructions.empty,
        "SphereLights.empty": env.SphereLights.empty,
        "pack_directional_lights": directional.pack_directional_lights,
        "pack_line_lights": line.pack_line_lights,
        "pack_volumetric_lights": volumetric.pack_volumetric_lights,
        "pack_projector_lights": projector.pack_projector_lights,
        "build_flagship": build_flagship,
        "ParticleSystem": ParticleSystem.__init__,
        "RandomField.create": RandomField.create,
        "build_sprite_table": sprites.build_sprite_table,
        "build_power_disc_table": sprites.build_power_disc_table,
        "ParticleAppearance.sprite_table": ParticleAppearance.sprite_table,
        "ParticleAppearance.power_disc_table":
            ParticleAppearance.power_disc_table,
        "pack_scene": pack_scene,
        "EnvironmentUniforms.make": env.EnvironmentUniforms.make,
        "pack_sphere_lights": env.pack_sphere_lights,
        "LightingEnvironment.uniforms": env.LightingEnvironment.uniforms,
        "LightingEnvironment.pack_obstructions":
            env.LightingEnvironment.pack_obstructions,
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """What a user builds lands on the card unless the caller asks for
    another device (the CPU tests pass device="cpu")."""
    import inspect

    default = inspect.signature(_entry_points()[name]).parameters[
        "device"].default
    assert default == "cuda", (name, default)


def test_renderer_builds_on_its_device():
    """Everything a LightingRenderer builds lies on the device it was
    given: the field partitions, the G-buffer, the lightmap, the image
    (the new `pack_*` arguments `height_volumes=` and ramp textures too)."""
    import numpy as np
    import torch

    from illuminant_tpu_torch.core.config import HDRConfig, RendererConfig
    from illuminant_tpu_torch.lighting import environment as env
    from illuminant_tpu_torch.lighting.renderer import LightingRenderer
    from illuminant_tpu_torch.sdf.analytic import pack_scene
    from illuminant_tpu_torch.sdf.height_volume import HeightVolume
    from illuminant_tpu_torch.sdf.volume import SdfVolumeConfig

    scene = env.LightingEnvironment(z_to_y_multiplier=1.0)
    scene.lights.append(env.SphereLightSource(
        position=(10.0, 10.0, 8.0), radius=2.0, ramp_length=20.0,
        ramp_texture=np.ones((1, 4, 3), np.float32)))
    scene.height_volumes.append(HeightVolume(
        polygon=[(4.0, 4.0), (12.0, 4.0), (12.0, 12.0)], height=4.0))
    scene.obstructions.append(env.LightObstruction.box((20.0, 8.0, 4.0),
                                                       (2.0, 2.0, 4.0)))
    r = LightingRenderer(
        RendererConfig(width=32, height=16, two_point_five_d=True), scene,
        SdfVolumeConfig(virtual_width=32, virtual_height=16,
                        virtual_depth=16, slice_count=4,
                        resolution_scale=0.5), device="cpu")
    cpu = torch.device("cpu")
    assert r.device == cpu and r.volume.data.device == cpu
    r.update_fields(budget=4)
    assert r.gbuffer.z.device == cpu and r.volume.max_valid_z.device == cpu
    image = r.resolve(r.render_lighting(), HDRConfig(mode=2))
    assert image.device == cpu and image.shape == (16, 32, 4)
    field = pack_scene(scene.obstructions,
                       height_volumes=scene.height_volumes, device="cpu")
    assert field.polygons.vertices.device == cpu
    assert env.pack_sphere_lights(scene.lights, device="cpu"
                                  ).ramp_texture.device == cpu
