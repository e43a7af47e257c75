"""The config-4 particle system at 1080p (BASELINE config 4, demo.py:
344-410 scaled by 1080 / 512) on the ColumnField of the flagship's static
voxel field, driven a frame at a time as a game draws it:
`ParticleSystem.update` (one tick at 60 ticks a second), `render` (the
additive quad splat, K5), `raster.resolve.resolve` and `to_uint8`.

Traffic (the workload file's parameters): the ring's every slot filled
from the seed with the spawner's formulas (`Reference.population`),
`spawn_max` spawns a tick whose draws cycle through a pool of `draw_pool`
ticks' draws made from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from framebench.lib.capture import Recorder
from framebench.lib.loader import module

NAME = "particles-config4-1080p"
DT = 1.0 / 60.0
STATE_IN = ("position", "velocity", "color", "write_cursor", "total_spawned")
STATE_OUT = STATE_IN + ("render_color", "render_data")
UPDATE_RANGE = "framebench/particles/update"


def swirl_field(n=64):
    """Config 4's procedural swirl (demo.py:364-371): unit tangents about
    the field's centre in channels x, y."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    c = n * 0.5
    fx, fy = -(yy - c), xx - c
    norm = np.sqrt(fx * fx + fy * fy) + 1e-3
    field = np.zeros((n, n, 4), np.float32)
    field[..., 0], field[..., 1] = fx / norm, fy / norm
    return field


def static_field(height, width, scale, device):
    """The ColumnField of the flagship's static voxel partition: its two
    boxes at `scale` texels a unit, 16 slices over 64 units."""
    from illuminant_tpu_torch.lighting.environment import (
        LightingEnvironment, LightObstruction)
    from illuminant_tpu_torch.sdf import volume as vol
    from illuminant_tpu_torch.sdf.columns import build_column_maps

    cx, cy = width * 0.5, height * 0.5
    ring = min(width, height) * 0.38
    env = LightingEnvironment(obstructions=[
        LightObstruction.box((cx, cy, 24.0), (22.0, 22.0, 24.0)),
        LightObstruction.box((cx + ring * 0.45, cy + ring * 0.3, 16.0),
                             (30.0, 10.0, 16.0))])
    config = vol.SdfVolumeConfig(
        virtual_width=width, virtual_height=height, virtual_depth=64,
        slice_count=16, resolution_scale=scale)
    return build_column_maps(vol.generate_volume(
        config, env.pack_obstructions(dynamic=False, device=device)))


def config4_system(field, height, width, capacity, spawn_max, device):
    """BASELINE config 4 (demo.py:344-410) on `field`: a ring spawner
    filling the ring in capacity / spawn_max ticks, the swirl VectorField,
    a central attractor, Noise, a Sensor over the centre quarter of the
    frame; SDF collision at 3 substeps."""
    from illuminant_tpu_torch.ops.sdf_primitives import TYPE_BOX
    from illuminant_tpu_torch.particles import formula as f
    from illuminant_tpu_torch.particles import transforms as tx
    from illuminant_tpu_torch.particles.spawner import Spawner
    from illuminant_tpu_torch.particles.system import (ParticleSystem,
                                                       ParticleSystemConfig)

    s, cx, cy = height / 512.0, width * 0.5, height * 0.5
    cfg = ParticleSystemConfig(
        capacity=capacity, updates_per_second=60.0,
        life_decay_per_second=0.4, friction=0.1,
        maximum_velocity=220.0 * s, collision_distance=1.0,
        bounce_velocity_multiplier=0.65, collision_substeps=3)
    spawner = Spawner(
        min_rate=spawn_max / DT, max_rate=spawn_max / DT,
        life=f.Formula1(constant=2.5, random_scale=1.0, offset=-0.5),
        position=f.Formula3(constant=(cx, cy, 10.0),
                            offset=(170.0 * s, 170.0 * s, 4.0),
                            random_scale=(30.0 * s, 30.0 * s, 2.0),
                            type=f.FORMULA_SPHERICAL),
        velocity=f.Formula3(random_scale=(30.0 * s, 30.0 * s, 0.0),
                            type=f.FORMULA_SPHERICAL),
        color=f.Formula4(constant=(0.3, 0.8, 1.0, 0.5),
                         random_scale=(0.4, 0.2, 0.0, 0.3)),
        spawn_max=spawn_max)
    vf = tx.VectorField(
        field=swirl_field(), field_scale=(64.0 / height,) * 2,
        velocity_scale=(160.0 * s, 160.0 * s, 0.0, 0.0),
        cycles_per_second=3.0)
    grav = tx.Gravity(attractors=[tx.Attractor(
        position=(cx, cy, 10.0), radius=600.0 * s, strength=60.0 * s,
        falloff_type=tx.FALLOFF_LINEAR)])
    noise = tx.Noise(velocity_scale=(18.0 * s, 18.0 * s, 3.0, 0.0),
                     cycles_per_second=4.0, _rng=np.random.default_rng(1))
    sensor = tx.Sensor(area=tx.TransformArea(
        type=TYPE_BOX, center=(cx, cy, 0.0),
        size=(width * 0.25, height * 0.25, 1e4)))
    return ParticleSystem(cfg, [spawner, vf, grav, noise, sensor],
                          volume=field, device=device)


class Cell:
    # Host ranges and device kernels the per-layer metrics read: the tick
    # has no range inside the program, so the benchmark opens one around
    # `update`; its column queries and map packs launch through ctypes.
    ranges = dict(particles=UPDATE_RANGE)
    kernels = dict(particles=r"\b(column_query|pack_quad)_kernel")

    def __init__(self, config, params, seed, device):
        from illuminant_tpu_torch.core.config import HDRConfig
        from illuminant_tpu_torch.particles.state import ParticleState
        from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

        self.device = device
        self.pin = device.type == "cuda"
        h, w = config["height"], config["width"]
        field = static_field(h, w, config["sdf_resolution_scale"], device)
        self.system = config4_system(field, h, w, config["capacity"],
                                     config["spawn_max"], device)
        self.raster = TiledRasterConfig(height=h, width=w)
        self.hdr = HDRConfig(mode=2, exposure=2.2, white_point=3.0,
                             srgb_output=True)
        inputs = module("reference", NAME).Reference(config, device)
        gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
        pop = inputs.population(gen)
        self.pool = inputs.draws(gen, params["draw_pool"])
        zeros = torch.zeros_like(pop["position"])
        self.system.state = ParticleState(
            position=pop["position"], velocity=pop["velocity"],
            color=pop["color"], render_color=zeros,
            render_data=zeros.clone(), write_cursor=pop["write_cursor"],
            total_spawned=pop["total_spawned"])
        self.k = 0

    def _frame(self, outs=None):
        from illuminant_tpu_torch.raster.resolve import resolve, to_uint8

        with torch.profiler.record_function(UPDATE_RANGE):
            self.system.update(DT, spawn_uniforms=[
                [self.pool[self.k % len(self.pool)]]])
        self.k += 1
        img, _ = self.system.render(self.raster)
        if outs is not None:
            for n in STATE_OUT:
                outs.keep(n, getattr(self.system.state, n))
            outs.keep("particle_image", img)
        return to_uint8(resolve(img, self.hdr))

    def step(self):
        """One frame: a tick, the render, the resolve; -> its uint8
        image."""
        return self._frame()

    def captured_step(self, buffers=None):
        """step() with the frame's inputs and results copied as the frame
        makes them: the particle state after the tick, the particle image
        and the image. -> (inputs, results), host copies."""
        ins = Recorder(buffers and buffers[0], self.pin)
        outs = Recorder(buffers and buffers[1], self.pin)
        for n in STATE_IN:
            ins.keep(n, getattr(self.system.state, n))
        ins.keep("frame_index", self.k)
        ins.keep("draws", self.pool[self.k % len(self.pool)])
        outs.keep("image", self._frame(outs))
        return ins.out, outs.out

    def splat_inputs(self):
        c = self.raster
        st = self.system.state
        cfg = dict(height=c.height, width=c.width, tile=c.tile,
                   apron=c.apron, channels=c.channels, kernel="quad")
        return (cfg, st.position[:, 0], st.position[:, 1], st.render_color,
                st.render_data[:, 0], st.live_mask())

    def release(self):
        self.system = self.pool = None


def build(config, params, seed, device):
    return Cell(config, params, seed, device)
