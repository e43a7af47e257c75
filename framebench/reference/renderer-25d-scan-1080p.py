"""Plain reference of `LightingRenderer`'s 2.5D scan frame: the G-buffer of
3 height volumes and a cylinder-bent billboard, 8 shadow-casting ring
lights (one with an AO radius, one with a ramp texture) and 8 replicated
shadowless lights in one additive pass under scan shadows, a subtractive
sphere light, a `max` directional light, the Uncharted2 resolve with sRGB
output and ordered dither, and the uint8 quantization.

Written from the reference engine's definitions:
  * the G-buffer (`gbuffer25d.py`: the ground plane, GBuffer.fx:75-105's
    height-volume faces, Billboard.cs's mask billboards);
  * the obstructions (`sdf25d.py`): DistanceFunctionCommon.fxh's box,
    ellipsoid and capped cylinder, rotateLocalPosition, and the height
    volumes extruded into prisms (DistanceField.fx:46-72);
  * the replicator (LightSource.cs:601-620): each replica is the template
    with the replica's position and whichever of radius, ramp length,
    opacity, colour and specular it sets;
  * the blend groups (LightingRenderer.cs:48-96, 1004-1168): the additive
    lights drawn together over the ambient, the subtractive group's sum
    taken away, each max light's pass composed by the per-channel
    maximum (MaxBlendValue per draw); the subtractive and max passes
    clear to no ambient;
  * the sphere lights (LightCommon.fxh:154-210 falloff and normal ramp at
    the G-buffer's world position (x, y + relativeY, z); AOCommon.fxh:1-20,
    one field sample ao_radius max(n.z, 0) above the surface and a
    squared ramp; SphereLightCore.fxh:58-158, the shadow gated by the
    light's CastsShadows, the pixel's enable_shadows and an opacity of
    0.75 / 255; the WithRamp epilogue :99-119, the rgb of a light with a
    ramp texture sampled bilinearly, wrapped, at (its pre-shadow
    opacity, (atan2(y - ly, x - lx) + offset) rate) times the shadow);
    the shadows by the scan of `lighting.scan_visibility`, unchanged,
    from endpoints lifted 1.6 along the normal and offset by relativeY,
    over this scene's distances, at the default quality (shadow scale
    0.5, nomination on a grid halved once, one exact refine sample);
  * the directional light (LightCommon.fxh:224-231, DirectionalLight.fx):
    the normal ramp with offset and range 0.35, no shadow;
  * the resolve in HDR mode 2 (Resolve.fx's tonemapped variant,
    LightingRenderer.HDR.cs:198-258) at offset 0 and gamma 1, the sRGB
    output of premultiplied values (pLinearToPSRGB), the 4 x 4 ordered
    dither of 1 / 255, then round half to even to uint8.

Where it departs from the .fxh and .cs sources, it departs as the measured
frame does:
  * every light of a blend group is one batched evaluation, not one draw a
    light; float32 throughout, so the lightmap's sums and the subtraction
    are not clamped as a HalfVector4 target would not clamp them either;
  * the scan is the library's cone-trace equivalent (`lighting.py`'s
    docstring), not the per-pixel cone march; the replicas, which cast no
    shadow, are scanned with the ring lights and their visibility
    discarded, as the measured frame does;
  * no specularity: `render_lighting` passes none (ring lights 0 and 3
    carry specular colours that add nothing);
  * the AO sample is taken for every light of the additive pass and is 1
    wherever a light's AO radius there is below 0.5; Uncharted2(white
    point) is taken in double precision, once.

`frame(inputs)` takes the frame's phase. With `lowp` it stands for the
control: every stage's float result (the G-buffer's planes, then the
lightmap lit from them) is rounded to bfloat16, the precision next below
the float32 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from framebench.reference import gbuffer25d, image, lighting, sdf, sdf25d

QUALITY = dict(max_cone_radius=24.0, cone_growth_factor=1.0,
               occlusion_to_opacity_power=1.0)
TYPES = dict(ellipsoid=sdf.TYPE_ELLIPSOID, box=sdf.TYPE_BOX,
             cylinder=sdf.TYPE_CYLINDER)
SHADOW_OPACITY_THRESHOLD = 0.75 / 255.0
DIRECTIONAL_DOT = 0.35  # offset and range (LightCommon.fxh:7-8)
BAYER_4X4 = ((0, 8, 2, 10), (12, 4, 14, 6), (3, 11, 1, 9), (15, 7, 13, 5))


def _round(x, lowp):
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


def _sat(x):
    return torch.clamp(x, 0.0, 1.0)


def ramp_texture(rows: int, cols: int):
    """(rows, cols, 3) float32: brighter along u (u^1.5), the hue turning
    from (1, 0.6, 0.3) to (0.4, 0.7, 1) along v."""
    u = np.linspace(0.0, 1.0, cols, dtype=np.float32)[None, :, None]
    v = np.linspace(0.0, 1.0, rows, dtype=np.float32)[:, None, None]
    hue = np.asarray([1.0, 0.6, 0.3], np.float32) * (1.0 - v) \
        + np.asarray([0.4, 0.7, 1.0], np.float32) * v
    return (u ** 1.5 * hue).astype(np.float32)


def disc_texture(size: int, radius_sq: float):
    """(size, size, 4) float32: alpha 1 on the texels within
    sqrt(radius_sq) of the centre, else 0."""
    yy, xx = np.mgrid[0:size, 0:size]
    c = 0.5 * (size - 1)
    tex = np.zeros((size, size, 4), np.float32)
    tex[..., 3] = ((xx - c) ** 2 + (yy - c) ** 2 <= radius_sq)
    return tex


def _sphere(position, radius, ramp_length, colour, cast_shadows=True,
            opacity=1.0, ao_radius=0.0, ao_opacity=1.0,
            specular=((0.0, 0.0, 0.0), 2.0), ramp=None, blend="additive"):
    return dict(position=tuple(position), radius=radius,
                ramp_length=ramp_length, colour=tuple(colour),
                opacity=opacity, cast_shadows=cast_shadows,
                ao_radius=ao_radius, ao_opacity=ao_opacity,
                specular=specular, ramp=ramp, blend=blend)


def replica_template(config: dict) -> dict:
    """The replicator's template light (its position unused)."""
    t = config["replica_template"]
    return _sphere((0.0, 0.0, 0.0), t["radius"] * config["z_unit"],
                   t["ramp_length"] * float(config["height"]), t["colour"],
                   cast_shadows=t["cast_shadows"])


def replica_instances(config: dict) -> list:
    """Each replica's position (a row along the bottom of the frame) and
    the overrides the configuration gives replica i (where i % every ==
    at): {position, radius, colour, opacity}, None where not set."""
    w, h = float(config["width"]), float(config["height"])
    zu = config["z_unit"]
    row, n = config["replica_row"], config["replicas"]
    out = []
    for i in range(n):
        r = dict(position=(w * (row["x0"] + row["x_span"] * (i + 0.5) / n),
                           row["y"] * h, row["z"] * zu),
                 radius=None, colour=None, opacity=None)
        for o in config["replica_overrides"]:
            if i % o["every"] == o["at"]:
                if "radius" in o:
                    r["radius"] = o["radius"] * zu
                if "colour" in o:
                    r["colour"] = tuple(o["colour"])
                if "opacity" in o:
                    r["opacity"] = o["opacity"]
        out.append(r)
    return out


def expand_replicas(config: dict) -> list:
    """The replicator's lights, in order: the template with each replica's
    position and whichever overrides it sets."""
    out = []
    for r in replica_instances(config):
        light = dict(replica_template(config), position=r["position"])
        for key in ("radius", "colour", "opacity"):
            if r[key] is not None:
                light[key] = r[key]
        out.append(light)
    return out


def layout(config: dict) -> dict:
    """The scene on the host, in world units (doubles): ring lights (with
    their specular, AO and ramp settings), replicas, the subtractive
    sphere light, the max directional light (direction, colour), height
    volumes [(polygon, z_base, height)], obstructions [(type id, centre,
    half size, quaternion or None)], the billboard (bounds, texture,
    cylinder factor)."""
    w, h = float(config["width"]), float(config["height"])
    zu = config["z_unit"]
    n = config["ring_lights"]
    cx, cy, ring = w * 0.5, h * 0.5, h * config["ring_radius"]
    lights = [_sphere(
        (cx + ring * math.cos(2 * math.pi * i / n),
         cy + ring * math.sin(2 * math.pi * i / n), config["ring_z"] * zu),
        config["ring_light_radius"] * zu, config["ring_ramp_length"] * h,
        config["ring_colours"][i % len(config["ring_colours"])])
        for i in range(n)]
    for s in config["specular_lights"]:
        lights[s["light"] % n]["specular"] = (tuple(s["colour"]), s["power"])
    lights[config["ao_light"] % n]["ao_radius"] = config["ao_radius"] * zu
    lights[config["ramp_light"] % n]["ramp"] = (
        ramp_texture(*config["ramp_texture"]), config["ramp_offset"],
        config["ramp_rate"])
    sub = config["subtractive_light"]
    subtractive = _sphere(
        (sub["position"][0] * w, sub["position"][1] * h,
         sub["position"][2] * zu), sub["radius"] * zu,
        sub["ramp_length"] * h, sub["colour"], cast_shadows=False,
        blend="subtractive")
    volumes = [([(v["centre"][0] * w + dx * h, v["centre"][1] * h + dy * h)
                 for dx, dy in v["polygon"]], v["z_base"] * zu,
                v["height"] * zu) for v in config["height_volumes"]]
    obstructions = []
    for o in config["obstructions"]:
        q = None
        if "rotation_half_angle_deg" in o:
            a = math.radians(o["rotation_half_angle_deg"])
            q = (0.0, 0.0, math.sin(a), math.cos(a))
        obstructions.append((
            TYPES[o["type"]],
            (o["centre"][0] * w, o["centre"][1] * h, o["centre"][2] * zu),
            (o["size"][0] * h, o["size"][1] * h, o["size"][2] * zu), q))
    b = config["billboard"]
    bx = b["centre_x"] * w
    billboard = ((bx - b["half_width"] * h, b["top"] * h,
                  bx + b["half_width"] * h, b["bottom"] * h),
                 disc_texture(b["texture"], b["disc_radius_sq"]),
                 b["cylinder_factor"])
    return dict(lights=lights, replicas=expand_replicas(config),
                subtractive=subtractive,
                directional=(tuple(config["max_light"]["direction"]),
                             tuple(config["max_light"]["colour"])),
                volumes=volumes, obstructions=obstructions,
                billboard=billboard)


def moving_light(config: dict, base, i: int):
    """Where frame i puts the moving ring light: on a circle about its
    ring position `base`."""
    h = float(config["height"])
    r, ph = config["moving_light_circle"], config["moving_light_rate"] * i
    return (base[0] + r * h * math.sin(ph), base[1] + r * h * math.cos(ph),
            base[2])


def moving_box(config: dict, i: int):
    """Where frame i puts the moving box's centre: swaying along x."""
    w, h = float(config["width"]), float(config["height"])
    o = config["obstructions"][config["moving_box"]]
    x = o["centre"][0] + config["moving_box_amplitude"] * math.sin(
        config["moving_box_rate"] * i)
    return (x * w, o["centre"][1] * h, o["centre"][2] * config["z_unit"])


def pack(lights: list, device) -> dict:
    """Sphere lights as float32 tensors, the opacity folded into the
    colour's alpha: position (L, 3), colour (L, 4), radius, ramp_length,
    cast, ao_radius, ao_opacity (L,), active (L,) ones; ramps {lane:
    (texture (RH, RW, 3), offset, rate)}."""
    f32 = np.float32
    colour = np.zeros((len(lights), 4), f32)
    for i, l in enumerate(lights):
        colour[i] = np.asarray(l["colour"], f32)
        colour[i, 3] *= l["opacity"]

    def t(v):
        return torch.as_tensor(np.asarray(v, f32), device=device)

    return dict(
        position=t([l["position"] for l in lights]), colour=t(colour),
        radius=t([l["radius"] for l in lights]),
        ramp_length=t([l["ramp_length"] for l in lights]),
        cast=t([1.0 if l["cast_shadows"] else 0.0 for l in lights]),
        ao_radius=t([l["ao_radius"] for l in lights]),
        ao_opacity=t([l["ao_opacity"] for l in lights]),
        active=t([1.0] * len(lights)),
        ramps={i: (t(l["ramp"][0][..., :3]), t(l["ramp"][1]),
                   t(l["ramp"][2]))
               for i, l in enumerate(lights) if l["ramp"] is not None})


def sample_wrapped(tex, u, v):
    """Bilinear sample of tex (TH, TW, 3) at u, v in [0, 1) with wrapped
    texel indices -> (..., 3)."""
    th, tw = tex.shape[0], tex.shape[1]
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), tw)
    x1i = torch.remainder((x0 + 1).to(torch.int64), tw)
    y0i = torch.remainder(y0.to(torch.int64), th)
    y1i = torch.remainder((y0 + 1).to(torch.int64), th)
    top = tex[y0i, x0i] + (tex[y0i, x1i] - tex[y0i, x0i]) * fx
    bot = tex[y1i, x0i] + (tex[y1i, x1i] - tex[y1i, x0i]) * fx
    return top + (bot - top) * fy


def sphere_lights(scene, gbuf, lights, shadowed: bool, with_ao: bool):
    """One blend group's sphere lights -> (H, W, 4): rgb, and the lights'
    summed opacity in alpha."""
    f32 = torch.float32
    h, w = gbuf["z"].shape
    dev = gbuf["z"].device
    ys = torch.arange(h, dtype=f32, device=dev) + 0.5
    xs = torch.arange(w, dtype=f32, device=dev) + 0.5
    wx = xs[None, None, :]
    wy = ys[None, :, None] + gbuf["relative_y"][None]
    wz = gbuf["z"][None]
    nx, ny, nz = (gbuf["normal"][None, ..., i] for i in range(3))

    def lp(v):
        return v[:, None, None]

    pos = lights["position"]
    active = lp(lights["active"])
    radius = lp(lights["radius"])
    ramp_length = torch.clamp(lp(lights["ramp_length"]), min=1e-6)
    d3x = wx - lp(pos[:, 0])
    d3y = wy - lp(pos[:, 1])
    d3z = wz - lp(pos[:, 2])
    distance = torch.sqrt(d3x * d3x + d3y * d3y + d3z * d3z + 1e-12)
    # Linear falloff, no light occlusion (the environment's is 0).
    distance_factor = 1.0 - _sat((distance - radius) / ramp_length)
    dot = -(d3x * nx + d3y * ny + d3z * nz) / distance
    normal_factor = _sat((dot + lighting.DOT_OFFSET)
                         / lighting.DOT_RAMP_RANGE) ** lighting.DOT_EXPONENT
    no_normal = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
    normal_factor = torch.where(no_normal, 1.0, normal_factor)
    pre_trace = _sat(normal_factor * distance_factor + _sat(radius - distance))
    visible = ((pre_trace > 0.0) & (wx > -9999.0)
               & (gbuf["fullbright"][None] < 0.5))
    if with_ao:
        ao_radius = lp(lights["ao_radius"]) * torch.clamp(nz, min=0.0)
        d = scene.distance(wx, wy, wz + nz * ao_radius)
        clamped = torch.minimum(torch.clamp(d, min=0.0), ao_radius)
        r = 1.0 - _sat(clamped / torch.clamp(ao_radius, min=1e-6))
        r = 1.0 - r * r
        ao_opacity = lp(lights["ao_opacity"])
        ao = (1.0 - ao_opacity) + r * ao_opacity
        pre_trace = pre_trace * torch.where((ao_radius >= 0.5) & visible, ao,
                                            1.0)
    cone = 1.0
    if shadowed:
        trace_enable = (visible
                        & (lp(lights["cast"]) * gbuf["enable_shadows"][None]
                           > 0.0)
                        & (pre_trace >= SHADOW_OPACITY_THRESHOLD)
                        & (active > 0.0))
        vis = lighting.shadow_visibility(scene, gbuf, dict(
            position=pos, active=lights["active"],
            properties=torch.stack([lights["radius"], lights["ramp_length"]],
                                   dim=-1)), QUALITY)
        cone = torch.where(trace_enable, vis, 1.0)
    opacity = torch.where(visible, pre_trace * cone, 0.0) * active
    colour = lights["colour"][:, :3] * lights["colour"][:, 3:4]
    if lights["ramps"]:
        angle = torch.atan2(wy - lp(pos[:, 1]), d3x)
        per_light = opacity[..., None].expand(*opacity.shape, 3).clone()
        light_cone = (cone * active).expand(opacity.shape)
        pre = _sat(pre_trace).expand(angle.shape)
        for i, (tex, offset, rate) in lights["ramps"].items():
            lit = sample_wrapped(tex, pre[i], torch.remainder(
                (angle[i] + offset) * rate, 1.0)) * light_cone[i][..., None]
            per_light[i] = torch.where(visible[i][..., None], lit, 0.0)
        rgb = torch.sum(colour[:, None, None, :] * per_light, dim=0)
    else:
        rgb = torch.einsum("lhw,lc->hwc", opacity, colour)
    return torch.cat([rgb, opacity.sum(dim=0)[..., None]], dim=-1)


def directional_light(gbuf, direction, colour):
    """One shadowless directional light -> (H, W, 4)."""
    f32 = torch.float32
    h, w = gbuf["z"].shape
    dev = gbuf["z"].device
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    dirn = torch.as_tensor(np.asarray([*d, 1.0], np.float32),
                           device=dev)[None, None, None, :]
    col = np.asarray(colour, np.float32).copy()
    col = torch.as_tensor(col, device=dev)[None, None, None, :]
    normal = gbuf["normal"][None]
    dot = torch.sum(-dirn[..., :3] * normal, dim=-1)
    factor = _sat((dot + DIRECTIONAL_DOT) / DIRECTIONAL_DOT) \
        ** lighting.DOT_EXPONENT
    factor = torch.where(torch.all(normal == 0.0, dim=-1), 1.0, factor)
    opacity = torch.where(dirn[..., 3] < 0.1, 1.0, factor)
    xs = torch.arange(w, dtype=f32, device=dev) + 0.5
    visible = (xs[None, None, :] > -9999.0) & (gbuf["fullbright"][None]
                                               < 0.5)
    opacity = torch.where(visible, opacity, 0.0) * 1.0
    rgb = col[..., :3] * col[..., 3:4] * opacity[..., None]
    return torch.cat([rgb.sum(dim=0), opacity.sum(dim=0)[..., None]], dim=-1)


def compose(base, subtractive, maxes):
    """The blend groups: the additive pass over the ambient (`base`), less
    the subtractive group's sum, then the per-channel maximum with each
    max light's pass, in order."""
    out = base - subtractive
    for m in maxes:
        out = torch.maximum(out, m)
    return out


def resolve_u8(lightmap, config: dict):
    """HDR mode 2 without an albedo at offset 0 and gamma 1, the sRGB
    output of the premultiplied result (alpha 1), the ordered dither, then
    uint8 (H, W, 4)."""
    result = torch.cat([lightmap[..., :3] * 1.0,
                        torch.ones_like(lightmap[..., 3:4])], dim=-1)
    pre = torch.clamp(result[..., :3] + 0.0, min=0.0) * config["exposure"]
    white = max(image.uncharted2(float(config["white_point"])), 1e-6)
    rgb = torch.clamp(image.uncharted2(pre) / white, min=0.0) ** 1.0
    alpha = result[..., 3:4]
    if config["srgb_output"]:
        straight = _sat(_sat(rgb) / torch.clamp(alpha, min=1e-6))
        low = straight * 12.92
        high = 1.055 * torch.clamp(straight, min=1e-8) ** (1.0 / 2.4) - 0.055
        rgb = torch.where(straight <= 0.0031308, low, high) * _sat(alpha)
    if config["dithering"]:
        h, w = rgb.shape[:2]
        bayer = torch.tensor(BAYER_4X4, dtype=torch.float32,
                             device=rgb.device) / 16.0 - 0.5
        offs = bayer[torch.arange(h, device=rgb.device)[:, None] % 4,
                     torch.arange(w, device=rgb.device)[None, :] % 4]
        rgb = rgb + offs[..., None] * (1.0 / 255.0)
    out = torch.cat([rgb, alpha], dim=-1)
    return torch.clamp(torch.round(out * 255.0), 0.0, 255.0).to(torch.uint8)


class Reference:
    def __init__(self, config: dict, device):
        if (config["shadow_mode"] != "scan" or config["hdr_mode"] != 2
                or not config["two_point_five_d"]):
            raise ValueError("this reference computes the renderer's 2.5D "
                             "frame under scan shadows and the Uncharted2 "
                             "resolve only")
        dev = self.device = torch.device(device)
        self.config = config
        self.lay = layout(config)
        f32 = np.float32

        def t(v):
            return torch.as_tensor(np.asarray(v, f32), device=dev)

        self.z_to_y = t(config["z_to_y_multiplier"])
        self.ambient = t(config["ambient"])
        self.volumes = [(t(poly), t(z0), t(z0 + height))
                        for poly, z0, height in self.lay["volumes"]]
        self.ring_base = self.lay["lights"][config["moving_light"]
                                            % config["ring_lights"]][
                                                "position"]

    def gbuffer(self, lowp: bool = False) -> dict:
        c = self.config
        g = gbuffer25d.ground(c["height"], c["width"], c["ground_z"],
                              self.device)
        g = gbuffer25d.height_volumes(g, self.volumes, self.z_to_y)
        bounds, texture, cylinder = self.lay["billboard"]
        g = gbuffer25d.mask_billboard(
            g, bounds, torch.as_tensor(texture, device=self.device),
            self.z_to_y, cylinder_factor=cylinder)
        return {k: _round(v, lowp) for k, v in g.items()}

    def scene(self, frame: int) -> sdf25d.Scene:
        """The obstructions and the volumes' prisms as frame `frame` puts
        the moving box."""
        dev, f32 = self.device, torch.float32
        prims = []
        for i, (type_id, centre, size, q) in enumerate(
                self.lay["obstructions"]):
            if i == self.config["moving_box"]:
                centre = moving_box(self.config, frame)
            prims.append(sdf25d.Turned(
                sdf.Primitive(type_id,
                              torch.tensor(centre, dtype=f32, device=dev),
                              torch.tensor(size, dtype=f32, device=dev)),
                None if q is None else torch.tensor(q, dtype=f32,
                                                    device=dev)))
        prisms = [sdf25d.Prism(*v) for v in self.volumes]
        return sdf25d.Scene(prims, prisms)

    def lights(self, frame: int) -> list:
        """The additive group, the ring (its moving light where frame
        `frame` puts it) then the replicas."""
        ring = [dict(l) for l in self.lay["lights"]]
        ring[self.config["moving_light"] % len(ring)]["position"] = \
            moving_light(self.config, self.ring_base, frame)
        return ring + self.lay["replicas"]

    def lightmap(self, gbuf: dict, frame: int):
        """The three passes composed -> (H, W, 4)."""
        h, w = gbuf["z"].shape
        scene = self.scene(frame)
        additive = self.lights(frame)
        lightmap = self.ambient.expand(h, w, 4) + sphere_lights(
            scene, gbuf, pack(additive, self.device),
            shadowed=any(l["cast_shadows"] for l in additive),
            with_ao=any(l["ao_radius"] > 0 for l in additive))
        subtractive = sphere_lights(
            scene, gbuf, pack([self.lay["subtractive"]], self.device),
            shadowed=False, with_ao=False)
        return compose(lightmap, subtractive,
                       [directional_light(gbuf, *self.lay["directional"])])

    def frame(self, inputs: dict, lowp: bool = False) -> dict:
        """inputs: frame (the phase the moving light and box take). -> the
        G-buffer's z, normal and relative_y, the lightmap and the image."""
        gbuf = self.gbuffer(lowp)
        lightmap = _round(self.lightmap(gbuf, inputs["frame"]), lowp)
        return dict(z=gbuf["z"], normal=gbuf["normal"],
                    relative_y=gbuf["relative_y"], lightmap=lightmap,
                    image=resolve_u8(lightmap, self.config))
