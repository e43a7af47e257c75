"""Plain reference of the config-4 particle frame at 1080p: a ring spawner
around the frame's centre, the swirl VectorField, a central attractor and
temporal Noise, collision at three sphere-trace substeps against the
column maps of the flagship's static voxel field (its two boxes), the
additive quad splat, the Uncharted2 resolve with sRGB output and the
uint8 quantisation.

It rebuilds the field from the boxes and the system's constants from the
configuration's sizes, and computes a frame from a particle state, the
frame index and three spawn draws. With `lowp` it stands for the
control: the particle state after the tick and the particle image are
rounded to bfloat16, the precision next below the float32 the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from framebench.reference import image, particles, voxel

DT = 1.0 / 60.0
STATE = ("position", "velocity", "color")


def _f32(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _round(x, lowp):
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


def swirl(n=64):
    """Unit tangents about the field's centre in channels x, y."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    c = n * 0.5
    fx, fy = -(yy - c), xx - c
    norm = np.sqrt(fx * fx + fy * fy) + 1e-3
    field = np.zeros((n, n, 4), np.float32)
    field[..., 0], field[..., 1] = fx / norm, fy / norm
    return field


def uncharted2(v):
    ka, kb, kc, kd, ke, kf = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((v * (ka * v + kc * kb) + kd * ke)
            / (v * (ka * v + kb) + kd * kf)) - ke / kf


class Reference:
    def __init__(self, config: dict, device):
        dev = self.device = torch.device(device)
        h, w = self.h, self.w = config["height"], config["width"]
        self.capacity, self.spawn_max = config["capacity"], config["spawn_max"]
        s = h / 512.0
        cx, cy = w * 0.5, h * 0.5
        ring = min(w, h) * 0.38
        # The flagship scene's static boxes, voxelised at a quarter of the
        # frame's resolution in 16 slices 4 units apart.
        g = voxel.Geometry(width=w, height=h, depth=64, slices=16,
                           scale=config["sdf_resolution_scale"])
        data = voxel.box_volume(
            g, _f32([(cx, cy, 24.0), (cx + ring * 0.45, cy + ring * 0.3,
                                     16.0)], dev),
            _f32([(22.0, 22.0, 24.0), (30.0, 10.0, 16.0)], dev))
        self.field = voxel.ColumnQuery(g, voxel.column_maps(g, data))
        self.position_constant = _f32((cx, cy, 10.0, 2.5), dev)
        self.spawner = dict(
            position=(None, _f32((30.0 * s, 30.0 * s, 2.0, 1.0), dev),
                      _f32((170.0 * s, 170.0 * s, 4.0, -0.5), dev)),
            velocity=(_f32((0.0, 0.0, 0.0, 0.0), dev),
                      _f32((30.0 * s, 30.0 * s, 0.0, 0.0), dev),
                      _f32((0.0, 0.0, 0.0, 0.0), dev)),
            color=(_f32((0.3, 0.8, 1.0, 0.5), dev),
                   _f32((0.4, 0.2, 0.0, 0.3), dev),
                   _f32((0.0, 0.0, 0.0, 0.0), dev)),
            axis_mask=_f32((1.0, 1.0, 1.0), dev), discard=0.0, align=False)
        self.su = dict(dt=torch.tensor(DT, dtype=torch.float32, device=dev),
                       friction=torch.tensor(0.1, device=dev),
                       maximum_velocity=torch.tensor(220.0 * s, device=dev),
                       life_decay=torch.tensor(0.4, device=dev),
                       collision=_f32((128.0, 0.65, 1.0, 0.0), dev))
        self.vector_field = dict(
            field=_f32(swirl(), dev), scale=_f32((64.0 / h, 64.0 / h), dev),
            offset=_f32((0.0, 0.0), dev),
            velocity_scale=_f32((160.0 * s, 160.0 * s, 0.0, 0.0), dev),
            cycles_per_second=torch.tensor(3.0, device=dev))
        self.gravity = dict(
            positions=_f32([(cx, cy, 10.0), (0.0, 0.0, 0.0)], dev),
            radiuses=_f32([600.0 * s, 1.0], dev),
            strengths=_f32([60.0 * s, 0.0], dev),
            falloff_types=_f32([1.0, 0.0], dev),
            active=_f32([1.0, 0.0], dev),
            maximum_acceleration=torch.tensor(1e6, device=dev))
        self.noise = dict(
            velocity_offset=_f32((-0.5,) * 4, dev),
            velocity_minimum=_f32((0.0,) * 4, dev),
            velocity_scale=_f32((18.0 * s, 18.0 * s, 3.0, 0.0), dev),
            cycles_per_second=torch.tensor(4.0, device=dev))
        # The noise's random table: 653 x 807 uniform draws from the
        # system's seed (0) xor 0x5EED on the device.
        self.random_field = torch.rand(
            (653, 807, 4), generator=torch.Generator(dev).manual_seed(
                0 ^ 0x5EED), dtype=torch.float32, device=dev)
        i = torch.arange(self.capacity, dtype=torch.float32, device=dev)
        self.slot_xy = torch.stack([i % 256.0, torch.floor(i / 256.0)],
                                   dim=-1)
        one = _f32((1.0, 1.0, 1.0, 1.0), dev)
        self.render = dict(color_from_life=one, color_from_velocity=one,
                           size_from_life=_f32((1.0,), dev),
                           size_from_velocity=_f32((1.0,), dev))
        self.raster = dict(height=h, width=w, tile=32, apron=4, channels=4,
                           kernel="quad")

    @staticmethod
    def noise_offsets(now: float):
        """The noise's two randomness offsets and its lerp at time `now`:
        a new pair of draws every second from the seed-1 stream,
        ((37, 59) before the first)."""
        draws = np.random.default_rng(1)
        a, b = (0.0, 0.0), (37.0, 59.0)
        for _ in range(int(now) + 1):
            a, b = b, (float(draws.uniform(0, 253)),
                       float(draws.uniform(0, 127)))
        return a, b, now % 1.0

    # -- the benchmark's inputs --------------------------------------------

    def population(self, generator):
        """Every slot of the ring filled as the spawner would have filled
        it over the last capacity / spawn_max ticks: slot group g
        (spawn_max slots) spawned g - groups ticks before tick 0, its life
        decayed since; the cursor at slot 0 (the oldest group), in a few
        large calls on the device."""
        n, per = self.capacity, self.spawn_max
        dev = self.device
        draws = [torch.rand((n, 4), generator=generator, device=dev)
                 for _ in range(3)]
        rows = particles.spawn_rows(
            self.spawner, self.position_constant.expand(n, 4),
            torch.eye(4, device=dev), draws)
        age = (n // per - torch.arange(n, device=dev) // per).to(
            torch.float32) * DT
        position = rows[0].clone()
        position[:, 3] = position[:, 3] - 0.4 * age
        return dict(position=position, velocity=rows[1], color=rows[2],
                    write_cursor=torch.zeros((), dtype=torch.int32,
                                             device=dev),
                    total_spawned=torch.tensor(n, dtype=torch.int32,
                                               device=dev))

    def draws(self, generator, count):
        u = torch.rand((count, 3, self.spawn_max, 4), generator=generator,
                       device=self.device)
        return [tuple(u[k]) for k in range(count)]

    # -- one frame ---------------------------------------------------------

    def frame(self, inp: dict, lowp: bool = False) -> dict:
        """inp: position, velocity, color (N, 4), write_cursor,
        total_spawned, frame_index (int: the tick), draws (three
        (spawn_max, 4)). -> the state after the tick, the particle image
        and the uint8 frame."""
        dev = self.device
        now = 0.0
        for _ in range(inp["frame_index"]):
            now += DT
        state = {k: inp[k].to(dev).clone() for k in STATE}
        state["write_cursor"] = inp["write_cursor"].to(dev)
        state["total_spawned"] = inp["total_spawned"].to(dev)
        state = particles.spawn(state, self.spawner, self.position_constant,
                                torch.eye(4, device=dev),
                                [d.to(dev) for d in inp["draws"]],
                                self.spawn_max)
        pos, vel = state["position"], state["velocity"]
        vel = particles.vector_field(pos, vel, self.vector_field, self.su)
        vel = particles.gravity(pos, vel, self.gravity, self.su)
        a, b, lerp = self.noise_offsets(now)
        vel = particles.noise(pos, vel, dict(
            self.noise, offset_a=_f32(a, dev), offset_b=_f32(b, dev),
            lerp=torch.tensor(lerp, dtype=torch.float32, device=dev)),
            self.su, self.random_field, self.slot_xy)
        state["velocity"] = vel
        pos, vel = particles.integrate(state, self.su, self.field,
                                       substeps=3)
        rc, rd = particles.render_data(pos, vel, state["color"], self.render)
        out = dict(position=pos, velocity=vel, color=state["color"],
                   render_color=rc, render_data=rd)
        out = {k: _round(v, lowp) for k, v in out.items()}
        out["write_cursor"] = state["write_cursor"]
        out["total_spawned"] = state["total_spawned"]
        img = _round(particles_image(self.raster, out), lowp)
        out.update(particle_image=img, image=self.resolve_u8(img))
        return out

    @staticmethod
    def resolve_u8(img):
        """Exposure 2.2, Uncharted2 with white point 3, sRGB, alpha 1, to
        uint8 rounding half to even."""
        pre = torch.clamp(img[..., :3] + 0.0, min=0.0) * 2.2
        white = max(uncharted2(3.0), 1e-6)
        rgb = torch.clamp(uncharted2(pre) / white, min=0.0) ** 1.0
        alpha = torch.ones_like(img[..., 3:4])
        straight = torch.clamp(torch.clamp(rgb, 0.0, 1.0)
                               / torch.clamp(alpha, min=1e-6), 0.0, 1.0)
        low = straight * 12.92
        high = 1.055 * torch.clamp(straight, min=1e-8) ** (1.0 / 2.4) - 0.055
        rgb = torch.where(straight <= 0.0031308, low, high) \
            * torch.clamp(alpha, 0.0, 1.0)
        out = torch.cat([rgb, alpha], dim=-1)
        return torch.clamp(torch.round(out * 255.0), 0.0,
                           255.0).to(torch.uint8)


def particles_image(raster, st):
    return image.splat(raster, st["position"][:, 0], st["position"][:, 1],
                       st["render_color"], st["render_data"][:, 0],
                       st["position"][:, 3] > 0.0)
