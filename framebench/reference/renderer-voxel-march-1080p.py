"""Plain reference of `LightingRenderer`'s voxel march frame: 8 sphere
lights on a ring over a flat ground, 6 static and 2 moving obstructions
in a budgeted static / dynamic voxel field, the lights' exact cone march
through that field, the ambient, the Uncharted2 resolve and the uint8
quantization.

Written from the reference engine's definitions:
  * the field (DynamicDistanceField, DistanceField.cs:248-321): two
    partitions, the static obstructions' and the dynamic ones', each an
    (S, H, W) volume whose voxel (s, y, x) holds the minimum of its
    obstructions' distances (DistanceFunctionCommon.fxh's box, ellipsoid
    and capped cylinder, `sdf.py`) at world ((x + 0.5) / scale_x,
    (y + 0.5) / scale_y, s * depth / S), clamped to the band the encoded
    texture holds, [-(63/255) m, (192/255) m] (DistanceFieldCommon.fxh:
    264-270); the combined field is their minimum, valid up to the lower
    of their `max_valid_z`;
  * the budgeted slice queue (RenderDistanceFieldPartition, Lighting
    Renderer.DistanceField.cs:415-462; MaximumFieldUpdatesPerFrame,
    Configuration.cs:87-91), replayed on the host from the set-up
    (`Queue`): a moved dynamic obstruction invalidates every slice of the
    dynamic partition (AutoInvalidateDistanceField, LightingRenderer.cs:
    1977-2015); each frame a partition writes up to `budget` slabs of 3
    slices, lowest invalid slice first, from that frame's obstructions, and
    is valid up to the first slice still invalid. A slice keeps the
    obstruction set that last wrote it, so the frame's field is computed
    from each slice's own set;
  * the trilinear sample (sampleDistanceFieldEx, DistanceFieldCommon.fxh:
    313-353): the point clamped into the volume's box and its z to
    `max_valid_z`, bilinear in xy on two slices, linear in z, plus the
    distance from the point to the box;
  * the march and the sphere lights' shading around it (`march.py`, whose
    docstring lists its departures from the shaders), the ambient clear
    of the additive pass (LightingRenderer.cs:1004-1168), the lightmap's
    alpha the ambient's plus the lights' summed opacity;
  * the resolve in HDR mode 2 (Resolve.fx's tonemapped variant,
    LightingRenderer.HDR.cs:198-258) at the configuration's offset 0 and
    gamma 1: exposure, Uncharted2 over Uncharted2(white point), alpha 1,
    then round half to even to uint8.

Where it departs from the .fxh and .cs sources, it departs as the measured
frame does:
  * distances are float32 values, not the 16-bit encoded texture: only its
    band's clamp is kept;
  * the slab of 3 slices is PackedSliceCount (LightingRenderer.cs:313)
    regenerated in one pass; `max_valid_z` is the z of the partition's
    first invalid slice (the sample there reads that slice's older
    distances), not a per-slice mask;
  * Uncharted2(white point) is taken in double precision, once.

`frame(inputs)` takes the frame's index and how many frames the renderer
has run since its set-up, and replays the queue over them. With `lowp` it
stands for the control: every stage's float result (the combined field,
then the lightmap the march makes on it) is rounded to bfloat16, the
precision next below the float32 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from framebench.reference import image, lighting, march, sdf
from framebench.reference.voxel import Geometry

# PackedSliceCount (LightingRenderer.cs:313): slices a slab.
SLICES_PER_UPDATE = 3
# The slice queue's tag of the set-up's obstruction positions.
SETUP = "setup"
COLOURS = [(1.0, 0.5, 0.3, 1.0), (0.3, 1.0, 0.5, 1.0), (0.4, 0.5, 1.0, 1.0),
           (1.0, 0.9, 0.4, 1.0), (0.9, 0.3, 0.9, 1.0), (0.3, 0.9, 0.9, 1.0),
           (1.0, 0.7, 0.7, 1.0), (0.7, 1.0, 0.7, 1.0)]
QUALITY = dict(max_cone_radius=24.0, cone_growth_factor=1.0,
               occlusion_to_opacity_power=1.0, **march.STEPS)
# Set-up: every slice of both partitions written (the renderer's
# `update_fields(budget=10 ** 6)`).
SETUP_BUDGET = 10 ** 6


def _round(x, lowp):
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


def layout(config: dict) -> dict:
    """The frame's scene on the host, in world units (the configuration's
    frame, obstruction footprints in units of height / 270):
    lights [(position, radius, ramp, colour)], static and dynamic
    obstructions [(type, centre, half size)], the dynamic ones at their
    set-up centres."""
    w, h = float(config["width"]), float(config["height"])
    n = config["n_lights"]
    cx, cy, ring = w * 0.5, h * 0.5, h * 0.37
    lights = [((cx + ring * math.cos(2 * math.pi * i / n),
                cy + ring * math.sin(2 * math.pi * i / n),
                config["light_z"]), config["light_radius"], 0.5 * h,
               COLOURS[i % len(COLOURS)]) for i in range(n)]
    u = h / 270.0
    box, ell, cyl = sdf.TYPE_BOX, sdf.TYPE_ELLIPSOID, sdf.TYPE_CYLINDER
    static = [
        (box, (0.5 * w, 0.5 * h, 20.0), (14.0 * u, 14.0 * u, 20.0)),
        (box, (0.18 * w, 0.25 * h, 12.0), (20.0 * u, 8.0 * u, 12.0)),
        (cyl, (0.8 * w, 0.7 * h, 24.0), (10.0 * u, 10.0 * u, 24.0)),
        (cyl, (0.3 * w, 0.8 * h, 10.0), (7.0 * u, 7.0 * u, 10.0)),
        (ell, (0.7 * w, 0.2 * h, 16.0), (18.0 * u, 10.0 * u, 16.0)),
        (ell, (0.1 * w, 0.6 * h, 14.0), (8.0 * u, 12.0 * u, 14.0))]
    dynamic = [
        (box, (0.4 * w, 0.3 * h, 16.0), (12.0 * u, 12.0 * u, 16.0)),
        (box, (0.62 * w, 0.75 * h, 8.0), (9.0 * u, 16.0 * u, 8.0))]
    return dict(lights=lights, static=static, dynamic=dynamic)


def dynamic_centers(config: dict, i: int):
    """Where frame i puts the two dynamic boxes (a sin / cos sway)."""
    w, h = float(config["width"]), float(config["height"])
    return [((0.4 + 0.04 * math.sin(0.6 * i)) * w,
             (0.3 + 0.05 * math.cos(0.6 * i)) * h, 16.0),
            ((0.62 + 0.05 * math.cos(0.4 * i)) * w, 0.75 * h, 8.0)]


class Queue:
    """One partition's slice queue, replayed on the host: `source[s]`, the
    frame whose obstruction set last wrote slice s (None: never written,
    where the volume holds `max_encoded`); `invalid`, the slices waiting,
    lowest first."""

    def __init__(self, slices: int):
        self.slices = slices
        self.source = [None] * slices
        self.invalid = list(range(slices))

    def invalidate(self):
        self.invalid = list(range(self.slices))

    def update(self, budget: int, frame):
        """Up to `budget` slabs of SLICES_PER_UPDATE slices from `frame`'s
        obstructions, each starting at the lowest invalid slice."""
        for _ in range(budget):
            if not self.invalid:
                return
            start = self.invalid[0]
            done = range(start, min(start + SLICES_PER_UPDATE, self.slices))
            for s in done:
                self.source[s] = frame
            self.invalid = [s for s in self.invalid if s not in done]

    @property
    def valid_slices(self) -> int:
        """The slices below the first invalid one."""
        return min(self.invalid, default=self.slices)


def replay(slices: int, first: int, frames: int, budget: int):
    """The two partitions' queues after the set-up and `frames` frames
    from index `first`: each frame moves both dynamic boxes, which
    invalidates the dynamic partition, then updates the static partition
    and the dynamic one under `budget`. -> (static, dynamic)."""
    static, dynamic = Queue(slices), Queue(slices)
    static.update(SETUP_BUDGET, SETUP)
    dynamic.update(SETUP_BUDGET, SETUP)
    for i in range(first, first + frames):
        dynamic.invalidate()
        static.update(budget, i)
        dynamic.update(budget, i)
    return static, dynamic


def slices(g: Geometry, primitives, index) -> torch.Tensor:
    """The slices `index` (a list of slice numbers) of the field of
    `primitives` (`sdf.Primitive`s) -> (len(index), H, W), clamped to
    the encoded band."""
    f32 = torch.float32
    dev = primitives[0].center.device
    _, h, w = g.shape
    xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / g.scale_x
    ys = (torch.arange(h, dtype=f32, device=dev) + 0.5) / g.scale_y
    zs = torch.tensor(index, dtype=f32, device=dev) * g.dz
    z, y, x = torch.meshgrid(zs, ys, xs, indexing="ij")
    d = sdf.Scene(primitives).distance(x, y, z)
    m = g.max_encoded
    return torch.clamp(d, -(63.0 / 255.0) * m, (192.0 / 255.0) * m)


class VolumeField:
    """A volume as the march samples it: `data` (S, H, W) float32,
    `max_valid_z` a 0-d float32 tensor; `distance(x, y, z)` the
    trilinear sample at world points."""

    def __init__(self, g: Geometry, data, max_valid_z):
        self.g, self.data, self.max_valid_z = g, data, max_valid_z

    def distance(self, px, py, pz):
        g, data = self.g, self.data
        s, h, w = data.shape
        ex, ey, ez = float(g.width), float(g.height), float(g.depth)
        cx = torch.clamp(px, 0.0, ex)
        cy = torch.clamp(py, 0.0, ey)
        cz = torch.clamp(pz, 0.0, ez)
        dx = -torch.clamp(px, max=0.0) + torch.clamp(px - ex, min=0.0)
        dy = -torch.clamp(py, max=0.0) + torch.clamp(py - ey, min=0.0)
        dz = -torch.clamp(pz, max=0.0) + torch.clamp(pz - ez, min=0.0)
        to_volume = torch.sqrt(dx * dx + dy * dy + dz * dz)

        slice_pos = torch.minimum(cz, self.max_valid_z) * (s / ez)
        s0 = torch.floor(slice_pos)
        sw = slice_pos - s0
        s0i = torch.clamp(s0.long(), 0, s - 1)
        s1i = torch.clamp(s0i + 1, 0, s - 1)
        tx = cx * g.scale_x - 0.5
        ty = cy * g.scale_y - 0.5
        x0 = torch.floor(tx)
        y0 = torch.floor(ty)
        wx = tx - x0
        wy = ty - y0
        x0i = torch.clamp(x0.long(), 0, w - 1)
        x1i = torch.clamp(x0i + 1, 0, w - 1)
        y0i = torch.clamp(y0.long(), 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)

        def bilinear(si):
            v00 = data[si, y0i, x0i]
            v01 = data[si, y0i, x1i]
            v10 = data[si, y1i, x0i]
            v11 = data[si, y1i, x1i]
            top = v00 + (v01 - v00) * wx
            bot = v10 + (v11 - v10) * wx
            return top + (bot - top) * wy

        a = bilinear(s0i)
        b = bilinear(s1i)
        return a + (b - a) * sw + to_volume


class Reference:
    def __init__(self, config: dict, device):
        if config["shadow_mode"] != "march" or config["hdr_mode"] != 2:
            raise ValueError("this reference computes the renderer's frame "
                             "under the cone march and the Uncharted2 "
                             "resolve only")
        dev = self.device = torch.device(device)
        self.config = config
        h, w = config["height"], config["width"]
        self.g = Geometry(width=w, height=h, depth=config["virtual_depth"],
                          slices=config["slice_count"],
                          scale=config["resolution_scale"],
                          max_encoded=config["max_encoded_distance"])
        lay = layout(config)
        f32 = np.float32

        def t(v):
            return torch.as_tensor(np.asarray(v, f32), device=dev)

        n = len(lay["lights"])
        self.lights = dict(
            position=t([p for p, _, _, _ in lay["lights"]]),
            color=t([c for _, _, _, c in lay["lights"]]),
            properties=t([(r, ramp, 0.0, 1.0)
                          for _, r, ramp, _ in lay["lights"]]),
            more=t([(0.0, 0.0, 1.0, 1.0)] * n), active=t([1.0] * n))
        self.static = [self._primitive(o) for o in lay["static"]]
        self.dynamic_setup = lay["dynamic"]
        self.gbuf = lighting.flat_ground(h, w, config["ground_z"], dev)
        self.ambient = t(config["ambient"])
        self.light_occlusion = torch.tensor(0.0, device=dev)

    def _primitive(self, obstruction, center=None):
        type_id, c, size = obstruction
        return sdf.Primitive(
            type_id, torch.tensor(c if center is None else center,
                                  dtype=torch.float32, device=self.device),
            torch.tensor(size, dtype=torch.float32, device=self.device))

    def _dynamic(self, frame):
        """The dynamic boxes as `frame` (an index, or SETUP) put them."""
        if frame == SETUP:
            return [self._primitive(o) for o in self.dynamic_setup]
        return [self._primitive(o, c) for o, c in zip(
            self.dynamic_setup, dynamic_centers(self.config, frame))]

    def _partition(self, queue: Queue, primitives_of):
        """A partition's volume from its queue: each slice computed from
        the obstruction set of the frame that last wrote it."""
        g = self.g
        data = torch.full(g.shape, g.max_encoded, dtype=torch.float32,
                          device=self.device)
        for frame in dict.fromkeys(queue.source):
            if frame is None:
                continue
            index = [s for s, f in enumerate(queue.source) if f == frame]
            data[index] = slices(g, primitives_of(frame), index)
        valid_z = torch.tensor(queue.valid_slices * g.dz,
                               dtype=torch.float32, device=self.device)
        return data, valid_z

    def field(self, inputs: dict) -> VolumeField:
        """The combined field the renderer holds after the frame of
        `inputs` (the frame's index, the frames run since the set-up,
        the budget)."""
        frames = inputs["frames_run"]
        static, dynamic = replay(self.g.slices,
                                 inputs["frame"] - frames + 1, frames,
                                 inputs["budget"])
        s_data, s_z = self._partition(static, lambda _: self.static)
        d_data, d_z = self._partition(dynamic, self._dynamic)
        return VolumeField(self.g, torch.minimum(s_data, d_data),
                           torch.minimum(s_z, d_z))

    def march_rays(self, inputs: dict):
        """What the march traces in the frame of `inputs`: (the field,
        the keyword arguments of `march.march` but the field)."""
        enable = march.terms(self.gbuf, self.lights,
                             self.light_occlusion)["trace_enable"]
        return self.field(inputs), dict(
            march.rays(self.gbuf, self.lights, enable), quality=QUALITY)

    def lightmap(self, field: VolumeField):
        """The additive pass: the ambient plus the sphere lights' sum,
        their summed opacity in alpha -> (H, W, 4)."""
        terms = march.terms(self.gbuf, self.lights, self.light_occlusion)
        enable = terms["trace_enable"]
        vis, _ = march.march(field, quality=QUALITY,
                             **march.rays(self.gbuf, self.lights, enable))
        cone = torch.where(enable, vis, 1.0)
        opacity = torch.where(terms["visible"], terms["pre_trace"] * cone,
                              0.0) * self.lights["active"][:, None, None]
        color = self.lights["color"][:, :3] * self.lights["color"][:, 3:4]
        rgb = torch.einsum("lhw,lc->hwc", opacity, color)
        return self.ambient + torch.cat(
            [rgb, opacity.sum(dim=0)[..., None]], dim=-1)

    def resolve_u8(self, lightmap):
        """HDR mode 2 without an albedo (offset 0, gamma 1), then uint8
        (H, W, 4)."""
        c = self.config
        pre = torch.clamp(lightmap[..., :3], min=0.0) * c["exposure"]
        white = max(image.uncharted2(float(c["white_point"])), 1e-6)
        rgb = torch.clamp(image.uncharted2(pre) / white, min=0.0)
        out = torch.cat([rgb, torch.ones_like(lightmap[..., 3:4])], dim=-1)
        return torch.clamp(torch.round(out * 255.0), 0.0,
                           255.0).to(torch.uint8)

    def frame(self, inputs: dict, lowp: bool = False) -> dict:
        """inputs: frame (the index the boxes' motion takes), frames_run
        (the frames since the set-up, this one included), budget. -> the
        combined field (`field`, `max_valid_z`), the lightmap and the
        image."""
        field = self.field(inputs)
        field.data = _round(field.data, lowp)
        lightmap = _round(self.lightmap(field), lowp)
        return dict(field=field.data, max_valid_z=field.max_valid_z,
                    lightmap=lightmap, image=self.resolve_u8(lightmap))
