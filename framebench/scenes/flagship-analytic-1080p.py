"""The flagship frame on the analytic field (`build_flagship(field=
"analytic", preset="fast", shadow_mode="scan")`), driven frame by frame
through the scene's own `frame` entry.

Traffic (the workload file's parameters): the ring's every slot filled
from the seed with the spawner's formulas (the steady population,
`Reference.population`), `spawn_max` spawns a frame whose draws cycle
through a pool of `draw_pool` frames' draws made from the seed, and the
frame index advancing one a frame from 0.
"""

from __future__ import annotations

import torch

from framebench.lib.capture import Recorder
from framebench.lib.loader import module

NAME = "flagship-analytic-1080p"
STATE_IN = ("position", "velocity", "color", "write_cursor", "total_spawned")
STATE_OUT = STATE_IN + ("render_color", "render_data")


class Cell:
    # Host ranges and device kernels the per-layer metrics read.
    ranges = dict(lighting="illuminant/frame/lighting",
                  particles="illuminant/frame/particles")
    kernels = dict(particles=None)

    def __init__(self, config, params, seed, device):
        from illuminant_tpu_torch.particles.state import ParticleState
        from illuminant_tpu_torch.scenes import build_flagship

        self.device = device
        self.pin = device.type == "cuda"
        self.scene = build_flagship(
            height=config["height"], width=config["width"],
            n_lights=config["n_lights"], capacity=config["capacity"],
            spawn_max=config["spawn_max"],
            sdf_resolution_scale=config["sdf_resolution_scale"],
            field=config["field"], preset=config["preset"],
            shadow_mode=config["shadow_mode"], device=device)
        self.frame_obj = self.scene.frame.__self__
        self.env_u = self.scene.environment.uniforms(device=device)
        self.spawn_max = config["spawn_max"]
        inputs = module("reference", NAME).Reference(config, device)
        gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
        pop = inputs.population(gen)
        self.pool = inputs.draws(gen, params["draw_pool"])
        zeros = torch.zeros_like(pop["position"])
        self.state = ParticleState(
            position=pop["position"], velocity=pop["velocity"],
            color=pop["color"], render_color=zeros,
            render_data=zeros.clone(), write_cursor=pop["write_cursor"],
            total_spawned=pop["total_spawned"])
        self.avg = torch.tensor(params["avg_lum"], dtype=torch.float32,
                                device=device)
        self.k = 0

    def step(self):
        """One frame through the scene's entry; -> its uint8 image."""
        s = self.scene
        img, self.state, self.avg, _ = s.frame(
            self.state, self.avg, None, s.volume, s.gbuffer, s.sphere_lights,
            self.env_u, self.spawn_max, frame_index=self.k,
            spawn_uniforms=self.pool[self.k % len(self.pool)])
        self.k += 1
        return img

    def captured_step(self, buffers=None):
        """step() with the frame's inputs and its stages' results copied
        as the frame makes them: the lightmap, the particle state after
        the tick, the particle image, the next exposure and the image.
        -> (inputs, results), host copies."""
        ins = Recorder(buffers and buffers[0], self.pin)
        outs = Recorder(buffers and buffers[1], self.pin)
        for n in STATE_IN:
            ins.keep(n, getattr(self.state, n))
        ins.keep("avg_lum", self.avg)
        ins.keep("frame_index", self.k)
        ins.keep("draws", self.pool[self.k % len(self.pool)])
        f = self.frame_obj
        orig = {n: getattr(f, n)
                for n in ("lighting", "particles", "raster", "exposure")}

        def lighting(*a, **kw):
            out = orig["lighting"](*a, **kw)
            outs.keep("lightmap", out)
            return out

        def particles(*a, **kw):
            st = orig["particles"](*a, **kw)
            for n in STATE_OUT:
                outs.keep(n, getattr(st, n))
            return st

        def raster(*a, **kw):
            img, diag = orig["raster"](*a, **kw)
            outs.keep("particle_image", img[..., :3])
            return img, diag

        def exposure(*a, **kw):
            out = orig["exposure"](*a, **kw)
            outs.keep("avg_lum", out)
            return out

        f.lighting, f.particles, f.raster, f.exposure = (
            lighting, particles, raster, exposure)
        try:
            outs.keep("image", self.step())
        finally:
            for n in orig:
                delattr(f, n)
        return ins.out, outs.out

    def splat_inputs(self):
        """The last frame's splat inputs: (raster config, x, y, colour,
        size, live) of the state after its tick."""
        c = self.scene.raster_config
        st = self.state
        cfg = dict(height=c.height, width=c.width, tile=c.tile,
                   apron=c.apron, channels=c.channels, kernel=c.kernel)
        return (cfg, st.position[:, 0], st.position[:, 1], st.render_color,
                st.render_data[:, 0], st.live_mask())

    def release(self):
        self.scene = self.frame_obj = self.state = self.pool = None


def build(config, params, seed, device):
    return Cell(config, params, seed, device)
