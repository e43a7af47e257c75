"""Plain reference of the flagship frame on the analytic field under scan
shadows (the "fast" preset): the Lumined scene's eight orbiting sphere
lights over a flat ground with four SDF occluders, two of them orbiting,
a ring of particles spawned along a bezier path under two attractors and
collided against the field, the additive Gaussian splat, the HDR composite
cast to bfloat16, the 95th-percentile exposure and the Uncharted2 tonemap
to uint8.

It rebuilds the scene from the configuration's sizes and the frame's
constants, and computes a frame from a particle state, the exposure and
three spawn draws. With `lowp` it stands for the control: every stage's
float result (the lightmap, the particle state after the tick, the
particle image, the next exposure) is rounded to bfloat16, the precision
next below the float32 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from framebench.reference import image, lighting, particles, sdf

DT = 1.0 / 60.0
COLORS = [(1.0, 0.5, 0.3, 1.0), (0.3, 1.0, 0.5, 1.0), (0.4, 0.5, 1.0, 1.0),
          (1.0, 0.9, 0.4, 1.0), (0.9, 0.3, 0.9, 1.0), (0.3, 0.9, 0.9, 1.0),
          (1.0, 0.7, 0.7, 1.0), (0.7, 1.0, 0.7, 1.0)]
QUALITY = dict(max_cone_radius=24.0, cone_growth_factor=1.0,
               occlusion_to_opacity_power=1.0)
STATE = ("position", "velocity", "color")


def _f32(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _round(x, lowp):
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


class Reference:
    def __init__(self, config: dict, device):
        if (config["field"], config["preset"], config["shadow_mode"]) != (
                "analytic", "fast", "scan"):
            raise ValueError("this reference computes the analytic field's "
                             "fast frame under scan shadows only")
        dev = self.device = torch.device(device)
        h, w = self.h, self.w = config["height"], config["width"]
        n_lights = config["n_lights"]
        self.capacity, self.spawn_max = config["capacity"], config["spawn_max"]
        cx, cy = w * 0.5, h * 0.5
        ring = min(w, h) * 0.38
        self.center = torch.tensor([cx, cy, 0.0], dtype=torch.float32,
                                   device=dev)
        pos = []
        for i in range(n_lights):
            a = 2 * math.pi * i / n_lights
            pos.append((cx + ring * math.cos(a), cy + ring * math.sin(a),
                        40.0))
        props = [(12.0, max(w, h) * 0.45, 0.0, 1.0)] * n_lights
        self.lights = dict(
            position=_f32(pos, dev),
            color=_f32([COLORS[i % len(COLORS)] for i in range(n_lights)],
                       dev),
            properties=_f32(props, dev),
            more=_f32([(0.0, 0.0, 1.0, 1.0)] * n_lights, dev),
            active=_f32([1.0] * n_lights, dev))
        self.radius_bezier = particles.bezier([[10.0], [16.0], [11.0],
                                               [10.0]], 0.0, 2.0, dev)
        # The occluders in the order the field evaluates them (by type id:
        # the ellipsoid, the two boxes, the cylinder), with each one's
        # orbit: amplitude (60, 40) at 0.9 + 0.3 x its type group's index
        # per second for the moving two.
        self.occluders = [
            (sdf.TYPE_ELLIPSOID, (cx - ring * 0.5, cy, 20.0),
             (28.0, 16.0, 20.0), 0.9),
            (sdf.TYPE_BOX, (cx, cy, 24.0), (22.0, 22.0, 24.0), 0.0),
            (sdf.TYPE_BOX, (cx + ring * 0.45, cy + ring * 0.3, 16.0),
             (30.0, 10.0, 16.0), 0.0),
            (sdf.TYPE_CYLINDER, (cx, cy - ring * 0.5, 26.0),
             (12.0, 12.0, 26.0), 1.5),
        ]
        self.gbuf = lighting.flat_ground(h, w, 0.0, dev)
        self.ambient = _f32([0.03, 0.03, 0.04], dev)
        self.light_occlusion = torch.tensor(0.0, device=dev)
        self.path = particles.bezier(
            [(cx - ring * 0.5, cy, 30.0), (cx, cy - ring * 0.4, 34.0),
             (cx + ring * 0.5, cy, 30.0), (cx, cy + ring * 0.4, 26.0)],
            0.0, 6.0, dev)
        self.spawner = dict(
            position=(None, _f32((w * 0.14, h * 0.13, 4.0, 1.0), dev),
                      _f32((w * 0.36, h * 0.37, 8.0, -0.5), dev)),
            velocity=(_f32((0.0, 0.0, 0.0, 0.0), dev),
                      _f32((40.0, 40.0, 10.0, 0.0), dev),
                      _f32((150.0, 150.0, 0.0, 0.0), dev)),
            color=(_f32((0.4, 0.5, 0.9, 0.5), dev),
                   _f32((0.4, 0.3, 0.1, 0.3), dev),
                   _f32((0.0, 0.0, 0.0, 0.0), dev)),
            axis_mask=_f32((1.0, 1.0, 1.0), dev), discard=0.0, align=True)
        self.life_constant = 2.5
        self.su = dict(dt=torch.tensor(DT, dtype=torch.float32, device=dev),
                       friction=torch.tensor(0.05, device=dev),
                       maximum_velocity=torch.tensor(600.0, device=dev),
                       life_decay=torch.tensor(0.2, device=dev),
                       collision=_f32((128.0, 0.7, 1.0, 0.0), dev))
        big = float(max(w, h))
        self.gravity = dict(
            positions=_f32([(cx, cy, 20.0), (cx, cy, 20.0)], dev),
            radiuses=_f32([big, h * 0.38], dev),
            strengths=_f32([32.0, -110.0], dev),
            falloff_types=_f32([1.0, 1.0], dev),
            active=_f32([1.0, 1.0], dev),
            maximum_acceleration=torch.tensor(3000.0, device=dev))
        self.render = dict(
            color_from_life=particles.bezier(
                [(0.3, 0.3, 0.6, 0.0), (1.0, 1.0, 1.0, 1.0),
                 (1.0, 1.0, 1.0, 1.0)], 0.0, 4.0, dev),
            color_from_velocity=_f32((1.0, 1.0, 1.0, 1.0), dev),
            size_from_life=particles.bezier([[1.0], [2.5], [3.0]], 0.0,
                                            4.0, dev),
            size_from_velocity=_f32((1.0,), dev))
        self.raster = dict(height=h, width=w, tile=32, apron=4, channels=3,
                           kernel="gauss")

    # -- the scene at time t ------------------------------------------------

    def field(self, t):
        prims = []
        for type_id, c, s, freq in self.occluders:
            f = _f32([freq], self.device)
            amp = _f32([(60.0, 40.0, 0.0) if freq else (0.0, 0.0, 0.0)],
                       self.device)
            orbit = torch.stack([torch.sin(f * t), torch.cos(f * t),
                                 torch.zeros_like(f)], dim=-1)
            center = (_f32([c], self.device) + amp * orbit)[0]
            prims.append(sdf.Primitive(type_id, center, _f32(s, self.device)))
        return sdf.Scene(prims)

    def lights_at(self, i, t):
        ang = i * 0.01
        ca, sa = torch.cos(ang), torch.sin(ang)
        rel = self.lights["position"] - self.center
        rot = torch.stack([rel[:, 0] * ca - rel[:, 1] * sa,
                           rel[:, 0] * sa + rel[:, 1] * ca, rel[:, 2]],
                          dim=-1)
        radius = particles.evaluate(self.radius_bezier,
                                    torch.remainder(t, 2.0))[0]
        props = self.lights["properties"].clone()
        props[:, 0] = radius
        return dict(self.lights, position=self.center + rot,
                    properties=props)

    def spawn_point(self, t):
        """The emission point (the bezier path, 6 s a lap) with the
        spawned life's constant in w, and the tangential velocity's
        post-matrix (84 -> 96 -> 84 degrees over 4 s)."""
        p = particles.evaluate(self.path, torch.remainder(t, 6.0))
        pc = torch.cat([p, torch.full_like(p[:1], self.life_constant)])
        vm = particles.rotation_matrix_bezier(
            [84.0, 96.0, 84.0], 1.0, 0.0, 4.0, torch.remainder(t, 4.0))
        return pc, vm

    # -- the benchmark's inputs --------------------------------------------

    def population(self, generator):
        """Every slot of the ring filled as the spawner would have filled
        it over the last capacity / spawn_max frames: slot group g
        (spawn_max slots) spawned g - groups frames before frame 0 at that
        frame's emission point, its life decayed since; the cursor at slot
        0 (the oldest group), in a few large calls on the device."""
        n, per = self.capacity, self.spawn_max
        groups = n // per
        dev = self.device
        frames = torch.arange(groups, dtype=torch.float32,
                              device=dev) - groups
        t = frames * DT
        p = particles.evaluate(self.path, torch.remainder(t, 6.0))
        pc = torch.cat([p, torch.full_like(p[:, :1], self.life_constant)],
                       dim=1)
        vm = particles.rotation_matrix_bezier(
            [84.0, 96.0, 84.0], 1.0, 0.0, 4.0, torch.remainder(t, 4.0))
        draws = [torch.rand((n, 4), generator=generator, device=dev)
                 for _ in range(3)]
        rows = particles.spawn_rows(
            self.spawner, pc.repeat_interleave(per, dim=0),
            torch.eye(4, device=dev), draws)
        velocity = rows[1]
        m = vm.repeat_interleave(per, dim=0)
        v3 = (velocity[:, 0:1] * m[:, 0, :3] + velocity[:, 1:2] * m[:, 1, :3]
              + velocity[:, 2:3] * m[:, 2, :3] + m[:, 3, :3])
        age = (-frames).repeat_interleave(per) * DT
        position = rows[0].clone()
        position[:, 3] = position[:, 3] - 0.2 * age
        return dict(position=position,
                    velocity=torch.cat([v3, velocity[:, 3:4]], dim=1),
                    color=rows[2],
                    write_cursor=torch.zeros((), dtype=torch.int32,
                                             device=dev),
                    total_spawned=torch.tensor(n, dtype=torch.int32,
                                               device=dev))

    def draws(self, generator, count):
        """`count` frames' spawn draws: three (spawn_max, 4) uniform
        arrays each, made in one call."""
        u = torch.rand((count, 3, self.spawn_max, 4), generator=generator,
                       device=self.device)
        return [tuple(u[k]) for k in range(count)]

    # -- one frame ---------------------------------------------------------

    def frame(self, inp: dict, lowp: bool = False) -> dict:
        """inp: position, velocity, color (N, 4), write_cursor,
        total_spawned, avg_lum (0-d), frame_index (int), draws (three
        (spawn_max, 4)). -> the frame's intermediate results and image."""
        f32 = torch.float32
        dev = self.device
        i = torch.tensor(float(inp["frame_index"]), dtype=f32, device=dev)
        t = i * DT
        avg_lum = inp["avg_lum"].to(device=dev, dtype=f32)
        scene = self.field(t)
        lights = self.lights_at(i, t)
        lightmap = self.ambient.expand(self.h, self.w, 3) + \
            lighting.sphere_lights(scene, self.gbuf, lights,
                                   self.light_occlusion, QUALITY)
        lightmap = _round(lightmap, lowp)

        state = {k: inp[k].to(dev).clone() for k in STATE}
        state["write_cursor"] = inp["write_cursor"].to(dev)
        state["total_spawned"] = inp["total_spawned"].to(dev)
        pc, vm = self.spawn_point(t)
        state = particles.spawn(state, self.spawner, pc, vm,
                                [d.to(dev) for d in inp["draws"]],
                                self.spawn_max)
        state["velocity"] = particles.gravity(state["position"],
                                              state["velocity"],
                                              self.gravity, self.su)
        pos, vel = particles.integrate(state, self.su, scene, substeps=1)
        rc, rd = particles.render_data(pos, vel, state["color"], self.render)
        out = dict(position=pos, velocity=vel, color=state["color"],
                   render_color=rc, render_data=rd)
        out = {k: _round(v, lowp) for k, v in out.items()}
        out["write_cursor"] = state["write_cursor"]
        out["total_spawned"] = state["total_spawned"]

        pimg = _round(image.splat(
            self.raster, out["position"][:, 0], out["position"][:, 1],
            out["render_color"], out["render_data"][:, 0],
            out["position"][:, 3] > 0.0), lowp)
        hdr = (lightmap + pimg[..., :3]).to(torch.bfloat16)
        new_avg = avg_lum * 0.95 + image.percentile_of_luma(hdr, 95.0) * 0.05
        out.update(lightmap=lightmap, particle_image=pimg,
                   avg_lum=_round(new_avg, lowp),
                   image=image.tonemap_u8(hdr, avg_lum))
        return out
