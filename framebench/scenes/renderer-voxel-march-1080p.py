"""`LightingRenderer`'s voxel march frame, driven through the renderer's
public calls as a game drives them: the configuration's ring of sphere
lights, static obstructions and two dynamic boxes (the reference's
`layout`), a budgeted static / dynamic voxel field, the exact cone march,
the Uncharted2 resolve and `to_uint8`.

Set-up builds the renderer and writes every slice of both field
partitions (`update_fields(budget=10 ** 6)`). Frame k then moves the two
boxes to where phase k0 + k puts them (`dynamic_centers`; assigning a
centre marks the box dirty), calls `update_fields(budget)`,
`render_lighting(shadow_mode="march")`, `resolve` and `to_uint8`. The
start phase k0 is drawn from the seed in [0, `phases`).

Besides, the cell remembers the inputs of the last frame run while a
profiler recorded, so that a reader can count the work of the march that
frame made (`traced_march`).
"""

from __future__ import annotations

import random

from torch.autograd import _profiler_enabled

from framebench.lib.capture import Recorder
from framebench.lib.loader import module

NAME = "renderer-voxel-march-1080p"
# Set-up: every slice of both partitions written.
SETUP_BUDGET = 10 ** 6


class Cell:
    def __init__(self, config, params, seed, device):
        from illuminant_tpu_torch.core.config import HDRConfig, RendererConfig
        from illuminant_tpu_torch.lighting import environment as env_mod
        from illuminant_tpu_torch.lighting.renderer import LightingRenderer
        from illuminant_tpu_torch.raster.resolve import to_uint8
        from illuminant_tpu_torch.sdf.volume import SdfVolumeConfig

        self.ref = module("reference", NAME)
        self.config, self.device = config, device
        lay = self.ref.layout(config)
        env = env_mod.LightingEnvironment(
            ground_z=config["ground_z"], maximum_z=config["maximum_z"],
            ambient=tuple(config["ambient"]))
        env.lights += [env_mod.SphereLightSource(
            position=p, radius=r, ramp_length=ramp, color=c)
            for p, r, ramp, c in lay["lights"]]

        def obstruction(o, dynamic):
            type_id, center, size = o
            return env_mod.LightObstruction(type=type_id, center=center,
                                            size=size, is_dynamic=dynamic)

        env.obstructions += [obstruction(o, False) for o in lay["static"]]
        self.dynamic = [obstruction(o, True) for o in lay["dynamic"]]
        env.obstructions += self.dynamic
        w, h = config["width"], config["height"]
        self.renderer = LightingRenderer(
            RendererConfig(width=w, height=h), env,
            SdfVolumeConfig(virtual_width=w, virtual_height=h,
                            virtual_depth=config["virtual_depth"],
                            slice_count=config["slice_count"],
                            resolution_scale=config["resolution_scale"],
                            max_encoded_distance=config[
                                "max_encoded_distance"]),
            device=device)
        self.hdr = HDRConfig(mode=config["hdr_mode"],
                             exposure=config["exposure"],
                             white_point=config["white_point"])
        self.to_uint8 = to_uint8
        self.renderer.update_fields(budget=SETUP_BUDGET)
        self.budget = params["budget"]
        self.k0 = random.Random(seed).randrange(params["phases"])
        self.k = 0
        self.traced = None

    def inputs(self) -> dict:
        """The next frame's inputs: its phase, the frames run since the
        set-up with it, the budget."""
        return dict(frame=self.k0 + self.k, frames_run=self.k + 1,
                    budget=self.budget)

    def _frame(self, keep):
        inp = self.inputs()
        if _profiler_enabled():
            self.traced = inp
        for box, center in zip(self.dynamic, self.ref.dynamic_centers(
                self.config, inp["frame"])):
            box.center = center
        r = self.renderer
        r.update_fields(budget=self.budget)
        keep("field", r.volume.data)
        keep("max_valid_z", r.volume.max_valid_z)
        lightmap = r.render_lighting(shadow_mode=self.config["shadow_mode"])
        keep("lightmap", lightmap)
        img = self.to_uint8(r.resolve(lightmap, self.hdr))
        self.k += 1
        return img

    def step(self):
        """One frame; -> its uint8 image."""
        return self._frame(lambda name, value: None)

    def captured_step(self, buffers=None):
        """step() with the frame's inputs and its results copied as the
        frame makes them: the combined field after `update_fields` (a new
        volume a frame, never written again), the lightmap and the image.
        -> (inputs, results), host copies."""
        ins = Recorder(buffers and buffers[0], self.device.type == "cuda")
        outs = Recorder(buffers and buffers[1], self.device.type == "cuda")
        for name, value in self.inputs().items():
            ins.keep(name, value)
        outs.keep("image", self._frame(outs.keep))
        return ins.out, outs.out

    def traced_march(self):
        """The march of the last frame run under a profiler, as the plain
        reference makes it from the frame's inputs: (the field, the
        keyword arguments of `march.march` but the field), or None where
        no frame was traced."""
        if self.traced is None:
            return None
        return self.ref.Reference(self.config, self.device).march_rays(
            self.traced)

    def release(self):
        self.renderer = self.dynamic = None


def build(config, params, seed, device):
    return Cell(config, params, seed, device)
