"""`LightingRenderer`'s 2.5D scan frame, driven through the renderer's
public calls as a game drives them: the configuration's height volumes,
billboard, ring lights (specular, AO and ramp settings included), light
replicator, subtractive sphere light, max directional light and
obstructions (the reference's `layout`), `two_point_five_d=True`, scan
shadows, the Uncharted2 resolve with sRGB output and dithering, and
`to_uint8`.

Frame k moves the moving ring light and the moving box to where phase
k0 + k puts them (`moving_light`, `moving_box`; assigning an obstruction's
centre marks it dirty, a light's position is read at its next pack), calls
`update_fields()` (the G-buffer re-rasterized), `render_lighting(
shadow_mode="scan")`, `resolve` and `to_uint8`. The start phase k0 is
drawn from the seed in [0, `phases`).
"""

from __future__ import annotations

import random

from framebench.lib.capture import Recorder
from framebench.lib.loader import module

NAME = "renderer-25d-scan-1080p"


class Cell:
    def __init__(self, config, params, seed, device):
        from illuminant_tpu_torch.core.config import HDRConfig, RendererConfig
        from illuminant_tpu_torch.lighting import environment as env_mod
        from illuminant_tpu_torch.lighting.billboard import Billboard
        from illuminant_tpu_torch.lighting.directional import (
            DirectionalLightSource)
        from illuminant_tpu_torch.lighting.renderer import LightingRenderer
        from illuminant_tpu_torch.raster.resolve import to_uint8
        from illuminant_tpu_torch.sdf.height_volume import HeightVolume

        self.ref = module("reference", NAME)
        self.config, self.device = config, device
        lay = self.ref.layout(config)
        env = env_mod.LightingEnvironment(
            ground_z=config["ground_z"], maximum_z=config["maximum_z"],
            z_to_y_multiplier=config["z_to_y_multiplier"],
            ambient=tuple(config["ambient"]))

        def sphere(l):
            (spec_colour, spec_power) = l["specular"]
            s = env_mod.SphereLightSource(
                position=l["position"], radius=l["radius"],
                ramp_length=l["ramp_length"], color=l["colour"],
                cast_shadows=l["cast_shadows"],
                ambient_occlusion_radius=l["ao_radius"],
                ambient_occlusion_opacity=l["ao_opacity"],
                specular_color=spec_colour, specular_power=spec_power,
                blend_mode=l["blend"])
            if l["ramp"] is not None:
                s.ramp_texture, s.ramp_offset, s.ramp_rate = l["ramp"]
            return s

        ring = [sphere(l) for l in lay["lights"]]
        env.lights += ring
        rep = env_mod.LightSourceReplicator(
            template=sphere(self.ref.replica_template(config)))
        for r in self.ref.replica_instances(config):
            rep.add(env_mod.ReplicatedLight(
                position=r["position"], radius=r["radius"],
                color=r["colour"], opacity=r["opacity"]))
        env.lights.append(rep)
        env.lights.append(sphere(lay["subtractive"]))
        direction, colour = lay["directional"]
        env.lights.append(DirectionalLightSource(
            direction=direction, color=colour, cast_shadows=False,
            blend_mode="max"))
        env.height_volumes += [
            HeightVolume(polygon=poly, z_base=z0, height=height)
            for poly, z0, height in lay["volumes"]]
        self.obstructions = [env_mod.LightObstruction(
            type_id, centre, size,
            rotation=(0.0, 0.0, 0.0, 1.0) if q is None else q)
            for type_id, centre, size, q in lay["obstructions"]]
        env.obstructions += self.obstructions
        bounds, texture, cylinder = lay["billboard"]
        env.billboards.append(Billboard(screen_bounds=bounds,
                                        texture=texture,
                                        cylinder_factor=cylinder))
        self.renderer = LightingRenderer(
            RendererConfig(width=config["width"], height=config["height"],
                           two_point_five_d=config["two_point_five_d"]),
            env, None, device=device)
        self.hdr = HDRConfig(mode=config["hdr_mode"],
                             exposure=config["exposure"],
                             white_point=config["white_point"],
                             srgb_output=config["srgb_output"],
                             dithering=config["dithering"])
        self.to_uint8 = to_uint8
        self.moving_light = ring[config["moving_light"] % len(ring)]
        self.ring_base = self.moving_light.position
        self.moving_box = self.obstructions[config["moving_box"]]
        self.k0 = random.Random(seed).randrange(params["phases"])
        self.k = 0

    def inputs(self) -> dict:
        """The next frame's inputs: its phase."""
        return dict(frame=self.k0 + self.k)

    def _frame(self, keep):
        i = self.inputs()["frame"]
        self.moving_light.position = self.ref.moving_light(
            self.config, self.ring_base, i)
        self.moving_box.center = self.ref.moving_box(self.config, i)
        r = self.renderer
        r.update_fields()
        keep("z", r.gbuffer.z)
        keep("normal", r.gbuffer.normal)
        keep("relative_y", r.gbuffer.relative_y)
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
        frame makes them: the G-buffer's z, normal and relative_y after
        `update_fields` (new planes a frame), the lightmap and the image.
        -> (inputs, results), host copies."""
        ins = Recorder(buffers and buffers[0], self.device.type == "cuda")
        outs = Recorder(buffers and buffers[1], self.device.type == "cuda")
        for name, value in self.inputs().items():
            ins.keep(name, value)
        outs.keep("image", self._frame(outs.keep))
        return ins.out, outs.out

    def release(self):
        self.renderer = self.obstructions = self.moving_box = None
        self.moving_light = None


def build(config, params, seed, device):
    return Cell(config, params, seed, device)
