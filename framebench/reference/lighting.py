"""Sphere lights over a flat ground G-buffer with scan-propagated soft
shadows, in plain PyTorch.

A frozen copy of the computation the measured frame makes at the library's
default quality (shadow scale 0.5, nomination at half the shadow
resolution, one exact refine sample, the cone formula of the reference
engine's ConeTrace.fxh:122-189): the occlusion image at the trace height,
a column walk per axis and direction carrying the minimum distance along
each pixel's ray, its arg-distance and the blocker exit, the nominated
fields upsampled to the readout grid, the readout, and the sphere lights'
falloff and normal ramp (LightCommon.fxh:154-210). It keeps the program's
order of floating-point operations where that order decides results (the
fused multiply-add of the walk's lerp), so that two faithful computations
agree to rounding.
"""

from __future__ import annotations

import torch

BIG = 1e9
# ConeTrace.fxh's constants.
HACK_DISTANCE_OFFSET = 1.5
MIN_CONE_RADIUS = 0.33
FULLY_SHADOWED_THRESHOLD = 0.075
UNSHADOWED_THRESHOLD = 0.95
SELF_OCCLUSION_LIFT = 1.6
SHADOW_OPACITY_THRESHOLD = 0.75 / 255.0
DOT_OFFSET = 0.15
DOT_RAMP_RANGE = 0.15
DOT_EXPONENT = 0.85


def _sat(x):
    return torch.clamp(x, 0.0, 1.0)


def downsample2x(x, axis: int):
    """Exact 2x linear-antialiased downsample along `axis`: interior
    weights [1, 3, 3, 1] / 8, edges [3, 3, 1] / 7."""
    n = x.shape[axis]
    m = n // 2
    pairs = x.reshape(x.shape[:axis] + (m, 2) + x.shape[axis + 1:])
    e = pairs.select(axis + 1, 0)
    o = pairs.select(axis + 1, 1)

    def sl(v, a, b):
        return v.narrow(axis, a, b - a)

    om1 = torch.cat([sl(o, 0, 1), sl(o, 0, m - 1)], dim=axis)
    ep1 = torch.cat([sl(e, 1, m), sl(e, m - 1, m)], dim=axis)
    s = 0.125 * om1 + 0.375 * e + 0.375 * o + 0.125 * ep1
    first = (3.0 * sl(e, 0, 1) + 3.0 * sl(o, 0, 1) + sl(e, 1, 2)) / 7.0
    last = (sl(o, m - 2, m - 1) + 3.0 * sl(e, m - 1, m)
            + 3.0 * sl(o, m - 1, m)) / 7.0
    return torch.cat([first, sl(s, 1, m - 1), last], dim=axis)


def upsample2x(v):
    """Bilinear 2x upsample of the last two axes, edges clamped."""

    def axis_up(x, axis):
        n = x.shape[axis]
        lo = torch.cat([x.narrow(axis, 0, 1), x], dim=axis)
        hi = torch.cat([x, x.narrow(axis, n - 1, 1)], dim=axis)
        a = 0.75 * x + 0.25 * lo.narrow(axis, 0, n)
        b = 0.75 * x + 0.25 * hi.narrow(axis, 1, n)
        shape = list(x.shape)
        shape[axis] = 2 * n
        return torch.stack([a, b], dim=axis + 1).reshape(shape)

    return axis_up(axis_up(v, v.dim() - 2), v.dim() - 1)


def _walk(occ, light_x, light_y, light_radius, exit_band: float):
    """The column walk of one axis in both directions (the reverse
    direction on the x-flipped image as a second batch row). occ (H, W);
    light_x / y / radius (L,) in grid pixels. -> (east, west), each
    (min distance, its arg distance, blocker exit) of (L, H, W)."""
    H, W = occ.shape
    L = light_x.shape[0]
    dev = occ.device
    f32 = torch.float32
    ys = torch.arange(H, dtype=f32, device=dev)[None, None, :] + 0.5
    cols = torch.arange(W, dtype=f32, device=dev) + 0.5
    occ_t = occ.T
    occ_both = torch.stack([occ_t, occ_t.flip(0)], dim=1)  # (W, 2, H)
    lx = torch.stack([light_x, float(W) - light_x])[:, :, None]
    ly = light_y[None, :, None].expand(2, L, 1)
    lr = light_radius[None, :, None].expand(2, L, 1)
    dx_all = cols[:, None, None, None] - lx[None]
    in_front_all = dx_all >= 1.0
    valid_all = in_front_all & (dx_all > lr[None])
    f_all = torch.clamp((ys - ly)[None] / torch.clamp(dx_all, min=1.0),
                        -1.0, 1.0)
    af_all = torch.abs(f_all)
    near_all = 1.0 - af_all
    fpos_all = f_all >= 0.0
    fill = torch.tensor([BIG, 0.0, 0.0], dtype=f32,
                        device=dev)[:, None, None, None]
    carry = fill.expand(3, 2, L, H).clone()
    out = torch.empty((W, 3, 2, L, H), dtype=f32, device=dev)
    fill_row = fill.expand(3, 2, L, 1)
    for x in range(W):
        dx = dx_all[x]
        up = torch.cat([fill_row, carry[..., :-1]], dim=-1)
        dn = torch.cat([carry[..., 1:], fill_row], dim=-1)
        # carry * near + shifted * |f| with the second product rounded
        # and the first fused into the add (the order decides the arg-min
        # on plateaus of the occlusion image).
        res = torch.addcmul(torch.where(fpos_all[x], up, dn) * af_all[x],
                            carry, near_all[x])
        res = torch.where(in_front_all[x], res, fill)
        d_here = torch.where(valid_all[x], occ_both[x][:, None, :], BIG)
        new_d = torch.minimum(res[0], d_here)
        upd = d_here < res[0]
        out[x] = res
        carry = torch.stack([
            new_d, torch.where(upd, dx, res[1]),
            torch.where(d_here < torch.clamp(new_d + exit_band,
                                             min=exit_band), dx, res[2])])
    outs = out.permute(1, 2, 3, 4, 0)  # (3, 2, L, H, W)
    east = tuple(outs[i, 0] for i in range(3))
    west = tuple(outs[i, 1].flip(-1) for i in range(3))
    return east, west


def _upsample_nominated(min_d, k_frac, exit_frac):
    """One 2x upsample of the nominated fields: the no-blocker sentinel
    clamps to 8192 so that the bilinear min_d < 4096 is the 2 x 2 majority
    vote; the fractions upsample as mask-normalised complements."""
    nom = min_d < 4096.0
    min_d = torch.clamp(min_d, max=8192.0)
    k_c = upsample2x(torch.where(nom, 1.0 - k_frac, 0.0))
    e_c = upsample2x(torch.where(nom, 1.0 - exit_frac, 0.0))
    min_d = upsample2x(min_d)
    wgt = torch.clamp(upsample2x(nom.to(torch.float32)), min=1e-3)
    return (min_d, torch.clamp(1.0 - k_c / wgt, 0.0, 1.0),
            torch.clamp(1.0 - e_c / wgt, 0.0, 1.0), min_d < 4096.0)


def scan_visibility(scene, height, width, light_position, light_radius,
                    light_ramp, light_active, quality, render_scale,
                    pixel_z, pixel_offset_xy):
    """Visibility (L, height, width) of every light at the shadow
    resolution; nomination on a grid halved once (the default
    nomination scale)."""
    f32 = torch.float32
    dev = light_position.device
    lz = light_position[:, 2]
    aw = light_active.to(f32)
    trace_z = torch.sum(lz * aw) / torch.clamp(torch.sum(aw), min=1.0) * 0.4
    nh, nw, nscale = height // 2, width // 2, render_scale * 0.5
    lx = light_position[:, 0] * nscale
    ly = light_position[:, 1] * nscale
    ys = (torch.arange(nh, dtype=f32, device=dev) + 0.5) / nscale
    xs = (torch.arange(nw, dtype=f32, device=dev) + 0.5) / nscale
    occ = scene.distance(xs[None, :], ys[:, None], trace_z)
    lr_n = light_radius * nscale
    band = float(min(1.0, max(nscale, 0.25)))
    east, west = _walk(occ, lx, ly, lr_n, band)
    north, south = _walk(occ.T, ly, lx, lr_n, band)
    north = tuple(p.transpose(1, 2) for p in north)
    south = tuple(p.transpose(1, 2) for p in south)

    ys_n = torch.arange(nh, dtype=f32, device=dev)[None, :, None] + 0.5
    xs_n = torch.arange(nw, dtype=f32, device=dev)[None, None, :] + 0.5
    dx_n = xs_n - lx[:, None, None]
    dy_n = ys_n - ly[:, None, None]
    horiz = torch.abs(dx_n) >= torch.abs(dy_n)
    is_east = horiz & (dx_n >= 0.0)
    is_west = horiz & (dx_n < 0.0)
    is_north = (~horiz) & (dy_n >= 0.0)
    min_d, min_k, neg_k = (
        torch.where(is_east, e, torch.where(is_west, w, torch.where(
            is_north, n, s)))
        for e, w, n, s in zip(east, west, north, south))
    major_n = torch.clamp(torch.maximum(torch.abs(dx_n), torch.abs(dy_n)),
                          min=1e-3)
    k_frac = torch.clamp(min_k / major_n, 0.0, 1.0)
    exit_frac = torch.clamp(torch.maximum(neg_k, min_k) / major_n, 0.0, 1.0)
    min_d, k_frac, exit_frac, has_blocker = _upsample_nominated(
        min_d, k_frac, exit_frac)

    lx = light_position[:, 0] * render_scale
    ly = light_position[:, 1] * render_scale
    ys = torch.arange(height, dtype=f32, device=dev)[None, :, None] + 0.5
    xs = torch.arange(width, dtype=f32, device=dev)[None, None, :] + 0.5
    dx = xs - lx[:, None, None]
    dy = ys - ly[:, None, None]
    major = torch.clamp(torch.maximum(torch.abs(dx), torch.abs(dy)),
                        min=1e-3)
    pz = pixel_z[None]
    lz3 = lz[:, None, None]
    dz = pz - lz3
    inv_rs = 1.0 / max(render_scale, 1e-6)
    sec = torch.sqrt((dx * dx + dy * dy) * (inv_rs * inv_rs)
                     + dz * dz) / major
    max_radius = torch.clamp(light_radius[:, None, None], MIN_CONE_RADIUS,
                             quality["max_cone_radius"])
    ramp = torch.clamp(light_ramp[:, None, None], min=16.0)
    growth = max_radius / ramp * quality["cone_growth_factor"]
    px_x = xs * inv_rs + pixel_offset_xy[..., 0]
    px_y = ys * inv_rs + pixel_offset_xy[..., 1]
    lx_w = light_position[:, 0][:, None, None]
    ly_w = light_position[:, 1][:, None, None]

    fwd = torch.minimum((exit_frac - k_frac) * 0.5, 1.5 / (major * sec))
    t = torch.where(min_d < -1.0, k_frac + fwd, (k_frac + exit_frac) * 0.5)
    vis = torch.ones(min_d.shape, dtype=f32, device=dev)
    sz = lz3 + (pz - lz3) * t
    d_i = scene.distance(lx_w + (px_x - lx_w) * t, ly_w + (px_y - ly_w) * t,
                         sz)
    u_i = torch.clamp((1.0 - t) * major * sec, min=0.0)
    radius_i = torch.minimum(growth * u_i + MIN_CONE_RADIUS, max_radius)
    vis = torch.minimum(vis, torch.where(
        has_blocker, (d_i + HACK_DISTANCE_OFFSET) / radius_i, 1.0))
    # Where the 3D ray at the nominated blocker lies at or below the trace
    # plane, the flat block applies.
    ray_z_at_k = lz3 + (pz - lz3) * k_frac
    ray_z_at_exit = lz3 + (pz - lz3) * exit_frac
    low_ray = (ray_z_at_k <= trace_z + 0.5) | (
        (ray_z_at_exit <= trace_z + 0.5) & (min_d < -0.5))
    u0 = torch.clamp((1.0 - k_frac) * major * sec, min=0.0)
    radius0 = torch.minimum(growth * u0 + MIN_CONE_RADIUS, max_radius)
    flat_vis = torch.clamp((min_d + HACK_DISTANCE_OFFSET) / radius0, max=1.0)
    vis = torch.where(has_blocker & low_ray, torch.minimum(vis, flat_vis),
                      vis)
    final = torch.clamp(_sat(vis - FULLY_SHADOWED_THRESHOLD)
                        / (UNSHADOWED_THRESHOLD - FULLY_SHADOWED_THRESHOLD),
                        0.0, 1.0)
    return final ** quality["occlusion_to_opacity_power"]


def flat_ground(height, width, ground_z, device):
    """The ground-plane G-buffer: normal +z, z = ground_z, no y offset."""
    normal = torch.zeros((height, width, 3), dtype=torch.float32,
                         device=device)
    normal[..., 2] = 1.0
    return dict(normal=normal,
                relative_y=torch.zeros((height, width), dtype=torch.float32,
                                       device=device),
                z=torch.full((height, width), ground_z, dtype=torch.float32,
                             device=device))


def shadow_visibility(scene, gbuf, lights, quality):
    """The sphere lights' scan visibility at the G-buffer's resolution,
    from endpoints lifted 1.6 along the normal, at half resolution."""
    h, w = gbuf["z"].shape
    sh, sw = h // 2, w // 2
    lift = SELF_OCCLUSION_LIFT
    nrm = gbuf["normal"]

    def half(a):
        return downsample2x(downsample2x(a, 0), 1)

    pixel_z = half(gbuf["z"] + lift * nrm[..., 2])
    offset_xy = half(torch.stack([lift * nrm[..., 0],
                                  lift * nrm[..., 1] + gbuf["relative_y"]],
                                 dim=-1))
    vis = scan_visibility(scene, sh, sw, lights["position"],
                          lights["properties"][:, 0],
                          lights["properties"][:, 1], lights["active"],
                          quality, sh / h, pixel_z, offset_xy)
    return upsample2x(vis)


def sphere_lights(scene, gbuf, lights, light_occlusion, quality):
    """The sphere lights' sum (H, W, 3): falloff, normal ramp and scan
    shadows, no specular, no AO (the flagship's settings)."""
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

    pos, props = lights["position"], lights["properties"]
    active = lp(lights["active"])
    radius = lp(props[:, 0])
    ramp_length = torch.clamp(lp(props[:, 1]), min=1e-6)
    falloff_mode = lp(props[:, 2])
    y_factor = lp(lights["more"][:, 2])
    d3x = wx - lp(pos[:, 0])
    d3y = (wy - lp(pos[:, 1])) * y_factor
    d3z = wz - lp(pos[:, 2])
    distance = torch.sqrt(d3x * d3x + d3y * d3y + d3z * d3z + 1e-12)
    distance_factor = 1.0 - _sat((distance - radius) / ramp_length)
    lo = torch.clamp(light_occlusion, min=1e-6)
    occl = 1.0 - _sat(d3z / lo)
    distance_factor = distance_factor * torch.where(
        light_occlusion > 0.0, occl, torch.ones_like(occl))
    dot = -(d3x * nx + d3y * ny + d3z * nz) / distance
    normal_factor = _sat((dot + DOT_OFFSET) / DOT_RAMP_RANGE) ** DOT_EXPONENT
    no_normal = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
    normal_factor = torch.where(no_normal, 1.0, normal_factor)
    df_none = 1.0 - _sat(distance - radius)
    df_exp = distance_factor * distance_factor
    distance_factor = torch.where(
        falloff_mode >= 2.0, df_none,
        torch.where(falloff_mode >= 1.0, df_exp, distance_factor))
    normal_factor = torch.where(falloff_mode >= 2.0, 1.0, normal_factor)
    pre_trace = _sat(normal_factor * distance_factor + _sat(radius - distance))
    visible = (pre_trace > 0.0) & (wx > -9999.0)
    cast = lp(props[:, 3])
    trace_enable = (visible & (cast > 0.0)
                    & (pre_trace >= SHADOW_OPACITY_THRESHOLD) & (active > 0.0))
    vis = shadow_visibility(scene, gbuf, lights, quality)
    cone = torch.where(trace_enable, vis, 1.0)
    opacity = torch.where(visible, pre_trace * cone, 0.0) * active
    color = lights["color"][:, :3] * lights["color"][:, 3:4]
    return torch.einsum("lhw,lc->hwc", opacity, color)
