"""Scan-propagated soft shadows.

Counterpart of illuminant_tpu/lighting/scan_shadows.py (its docstring
explains the method): one occlusion image at the trace height, a column
walk per light and sector that carries the minimum distance along each
pixel's ray, its arg-distance and the blocker exit, then a per-pixel
readout applying the cone formula of ConeTrace.fxh:122-189 with a 3D
refine at 1 to 3 candidate points along the ray (or none: the flatland
mode, `scan_refine_samples=0`).
  * The exact refine (analytic scenes, voxel volumes, and
    `scan_refine_mode="exact"` on a ColumnField, which samples its
    volume) evaluates the field at each candidate's 3D point.
  * The carried refine (a ColumnField under "carried" / "carried_all",
    the library default for voxel fields, and an AnalyticScene under the
    opt-in "carried_all", from `analytic.scene_column_images`) has the
    walk also carry the nominated blocker column's interval (h_top,
    h_bot) and the running footprint minimum, and reconstructs the
    candidate distances elementwise.

The column walk (`scan_walk`) is one launch of the Hopper kernel K1 on
CUDA tensors (`scan_walk_kernel.scan_walk_cuda`) and, on CPU tensors, its
plain version `scan_walk_reference`: `_bidirectional_scan`, the JAX
`lax.scan` as a Python loop over columns in eager PyTorch.

Deviations from the JAX package:
  * carries and nominated fields stay float32. The JAX package stores the
    walk outputs and the nominated fields in float16 and upsamples the
    visibility in bfloat16 (scan_shadows.py:343-347, 876-890, 933); with
    float32 the f16 range offsets it needs (`k_off`) are dropped;
  * shadow scales other than 0.5 and 1 and visibility resizes other than
    1x and 2x take `utils.image.resize_linear`, the port's copy of
    jax.image.resize(..., "linear"), in float32.
"""

from __future__ import annotations

import torch

from ..core.config import QualitySettings
from ..core.trace import span
from ..sdf.analytic import (AnalyticScene, scene_column_images,
                            scene_sample_p)
from ..sdf.columns import (ColumnField, reconstruct_profile,
                           resample_map_to_grid)
from ..utils.image import resize_linear
from .cone_trace import (FULLY_SHADOWED_THRESHOLD, HACK_DISTANCE_OFFSET,
                         MIN_CONE_RADIUS, UNSHADOWED_THRESHOLD)

_BIG = 1e9
# The sphere lights' shading endpoint sits this far along the surface
# normal (SphereLightCore.fxh:151).
SELF_OCCLUSION_LIFT = 1.6
# Neutral interval for rays with no nominated blocker: a huge [b, t]
# reconstructs at the footprint term alone.
_TOP_FILL = 4096.0
_BOT_FILL = -4096.0


def occlusion_image(scene, height: int, width: int, trace_z,
                    render_scale: float = 1.0, world_offset=None):
    """Scene distance at every pixel center at height trace_z — a
    separable (1, W) x (H, 1) grid query: closed form on an analytic
    scene, the exact grid resample of a voxel volume. `world_offset`
    ((2,) [x, y], world units): the top-left corner of a windowed view
    (GBuffer.window)."""
    dev = trace_z.device
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) \
        / render_scale
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / render_scale
    if world_offset is not None:
        xs = xs + world_offset[0]
        ys = ys + world_offset[1]
    return scene_sample_p(scene, xs[None, :], ys[:, None], trace_z)


def _shifted(c, fill):
    """(c shifted one row down, one row up) along the last axis, with
    `fill` ((K, 1, 1, 1) per channel) entering at the edge: a ray leaving
    the image reads "nothing yet", not the opposite edge."""
    fill_row = fill.expand(*c.shape[:-1], 1)
    up = torch.cat([fill_row, c[..., :-1]], dim=-1)  # index y -> y - 1
    dn = torch.cat([c[..., 1:], fill_row], dim=-1)
    return up, dn


def _bidirectional_scan(occ, light_x, light_y, light_radius,
                        exit_band: float, extra=(), footprint=None):
    """Both half-plane walks of one axis, the reverse pass as a batch row
    on the x-flipped image. occ, footprint: (H, W); extra: () or the
    (h_top, h_bot) (H, W) images; light_x/y/radius (L,) in grid pixels.

    Returns (east, west), each (d, k, neg_k[, f_min][, h_top, h_bot]) of
    (L, H, W) pre-merge carries: the minimum scene distance along each
    pixel's ray excluding its own column, the horizontal distance from
    the light where it occurred, the blocker exit, and with a footprint
    the running footprint minimum, with extras the interval selected at
    the arg-min."""
    H, W = occ.shape
    L = light_x.shape[0]
    dev = occ.device
    f32 = torch.float32
    ys = torch.arange(H, dtype=f32, device=dev)[None, None, :] + 0.5
    cols = torch.arange(W, dtype=f32, device=dev) + 0.5

    def both(m):  # (H, W) -> (W, 2, H): east, then the x-flipped image
        mt = m.T
        return torch.stack([mt, mt.flip(0)], dim=1)

    occ_both = both(occ)
    fp_both = None if footprint is None else both(footprint)

    lx = torch.stack([light_x, float(W) - light_x])[:, :, None]  # (2, L, 1)
    ly = light_y[None, :, None].expand(2, L, 1)
    lr = light_radius[None, :, None].expand(2, L, 1)

    # Fan geometry of every column at once: the ray to (x, y) passes the
    # previous column at y - f, f = (y - ly) / dx in [-1, 1] in the wedge.
    dx_all = cols[:, None, None, None] - lx[None]           # (W, 2, L, 1)
    in_front_all = dx_all >= 1.0
    valid_all = in_front_all & (dx_all > lr[None])
    f_all = torch.clamp((ys - ly)[None] / torch.clamp(dx_all, min=1.0),
                        -1.0, 1.0)                          # (W, 2, L, H)
    af_all = torch.abs(f_all)
    near_all = 1.0 - af_all
    fpos_all = f_all >= 0.0

    # Associative carries (d, k, neg_k[, f_min]) lerp-resample along the
    # fan; the argmin payload (h_top, h_bot, row phase) moves by shifted
    # copy. Their fills, (_BIG, 0, 0[, _BIG]) and (_TOP_FILL, _BOT_FILL, 0),
    # are written on the device: no host copy, so a CUDA graph can capture
    # the loop.
    K = 3 if footprint is None else 4
    fill_c = torch.full((K, 1, 1, 1), _BIG, dtype=f32, device=dev)
    fill_c[1:3] = 0.0
    carry = fill_c.expand(K, 2, L, H).clone()
    out_c = torch.empty((W, K, 2, L, H), dtype=f32, device=dev)
    if extra:
        tb_both = torch.stack([both(extra[0]), both(extra[1])], dim=1)
        fill_p = torch.full((3, 1, 1, 1), _TOP_FILL, dtype=f32, device=dev)
        fill_p[1] = _BOT_FILL
        fill_p[2] = 0.0
        payload = fill_p.expand(3, 2, L, H).clone()
        out_p = torch.empty((W, 2, 2, L, H), dtype=f32, device=dev)

    for x in range(W):
        dx = dx_all[x]
        in_front = in_front_all[x]
        f = f_all[x]

        # carry * near + shifted * af as one fused multiply-add onto the
        # rounded second product (addcmul), the form XLA's CPU backend
        # contracts the JAX expression into, and the one torch.addcmul
        # takes on the card too (K1 repeats it). The rounding decides results:
        # on a plateau of the occlusion image (the flat interior of a prism
        # cut by the trace plane) both rows hold the same value, the lerp
        # lands within an ulp of it, and the strict arg-min update below
        # moves along the plateau or stays by that ulp. With two rounded
        # products the arg-min of a far light's ray (a directional
        # pseudo-center) sat many world units from the JAX package's, and
        # so did the refine's sample and a trace budget's cut.
        up, dn = _shifted(carry, fill_c)
        res = torch.addcmul(torch.where(fpos_all[x], up, dn) * af_all[x],
                            carry, near_all[x])
        res = torch.where(in_front, res, fill_c)
        res_d = res[0]

        valid = valid_all[x]
        d_here = torch.where(valid, occ_both[x][:, None, :], _BIG)
        new_d = torch.minimum(res_d, d_here)
        upd = d_here < res_d
        new = [new_d, torch.where(upd, dx, res[1]),
               torch.where(d_here < torch.clamp(new_d + exit_band,
                                                min=exit_band), dx, res[2])]
        if footprint is not None:
            f_here = torch.where(valid, fp_both[x][:, None, :], _BIG)
            new.append(torch.minimum(res[3], f_here))
        if extra:
            # Phase-corrected shifted copy (the JAX package's docstring at
            # scan_shadows.py:256-270): round (f + phase) each step; the
            # phase resets where the arg-min takes fresh column data.
            shift = torch.clamp(torch.round(f + payload[2]), -1.0, 1.0)
            up, dn = _shifted(payload, fill_p)
            res_p = torch.where(shift > 0.5, up,
                                torch.where(shift < -0.5, dn, payload))
            res_p[2] = res_p[2] + f - shift
            res_p = torch.where(in_front, res_p, fill_p)
            new_tb = torch.where(upd, tb_both[x][:, :, None, :], res_p[:2])
            new_ph = torch.where(upd, 0.0, res_p[2])
            out_p[x] = res_p[:2]
            payload = torch.cat([new_tb, new_ph[None]])
        out_c[x] = res
        carry = torch.stack(new)

    # (W, K, 2, L, H) -> (K, 2, L, H, W); undo the reverse pass's flip.
    outs = torch.cat([out_c, out_p], dim=1) if extra else out_c
    outs = outs.permute(1, 2, 3, 4, 0)
    east = tuple(outs[i, 0] for i in range(outs.shape[0]))
    west = tuple(outs[i, 1].flip(-1) for i in range(outs.shape[0]))
    return east, west


def scan_walk(occ, light_x, light_y, light_radius, exit_band: float,
              extra=(), footprint=None):
    """The column walks of every sector -> (4, C, L, H, W) float32: east,
    west, north, south, each contiguous in the readout's (H, W) layout,
    with channels (d, k, neg_k[, f_min][, h_top, h_bot]) as
    `_bidirectional_scan` returns them. occ, footprint, extra's (h_top,
    h_bot): (H, W); light_x / y / radius (L,) in grid pixels. CUDA tensors
    take one launch of K1 (`scan_walk_kernel.scan_walk_cuda`), CPU tensors
    the plain version, `scan_walk_reference`."""
    if occ.device.type == "cuda":
        from .scan_walk_kernel import scan_walk_cuda

        return scan_walk_cuda(occ, light_x, light_y, light_radius, exit_band,
                              extra, footprint)
    return scan_walk_reference(occ, light_x, light_y, light_radius,
                               exit_band, extra, footprint)


def scan_walk_reference(occ, light_x, light_y, light_radius,
                        exit_band: float, extra=(), footprint=None):
    """K1's plain version, on any device: `_bidirectional_scan` along each
    axis (the N/S walks on the transposed images), stacked into
    `scan_walk`'s (4, C, L, H, W) layout."""
    east, west = _bidirectional_scan(occ, light_x, light_y, light_radius,
                                     exit_band, extra, footprint)
    north, south = _bidirectional_scan(
        occ.T, light_y, light_x, light_radius, exit_band,
        tuple(e.T for e in extra), None if footprint is None else footprint.T)
    return torch.stack([torch.stack(east), torch.stack(west),
                        torch.stack(north).transpose(-1, -2),
                        torch.stack(south).transpose(-1, -2)])


@span("illuminant/scan_shadows")
def scan_visibility(scene, height: int, width: int, light_position,
                    light_radius, light_ramp_length,
                    quality: QualitySettings, trace_z=None,
                    render_scale: float = 1.0, pixel_z=None,
                    pixel_offset_xy=None, max_trace_distance=None,
                    world_offset=None, light_active=None):
    """Cone-trace-equivalent visibility of all lights -> (L, H, W).

    light_position (L, 3), light_radius / light_ramp_length (L,);
    `trace_z`: the occlusion image's height (default 0.4 of the mean
    active light height); `pixel_z` (H, W) or (L, H, W): shaded-surface
    heights, already lifted along the normal; `pixel_offset_xy` (H, W, 2)
    or (L, H, W, 2): the lift's world xy offset, read by the exact refine;
    `max_trace_distance` (L,) world units: blockers farther than this
    from the shaded pixel along the ray are ignored (the directional
    lights' ShadowTraceLength; None traces to the light); `world_offset`
    (2,) world units: the origin of a windowed view (GBuffer.window), which
    also keeps the exact per-candidate refine on a ColumnField;
    `light_active` (L,) 0/1 masks padded slots out of the default trace
    plane."""
    f32 = torch.float32
    dev = light_position.device
    windowed_eval = world_offset is not None
    off_x, off_y = world_offset if windowed_eval else (0.0, 0.0)
    lz = light_position[:, 2]
    if trace_z is not None:
        trace_z = torch.as_tensor(trace_z, dtype=f32, device=dev)
    elif light_active is not None:
        # The trace plane: 0.4 of the mean light height, over the active
        # lights only (padded slots sit at z = 0).
        aw = light_active.to(f32)
        trace_z = torch.sum(lz * aw) / torch.clamp(torch.sum(aw),
                                                   min=1.0) * 0.4
    else:
        trace_z = torch.mean(lz) * 0.4

    # --- NOMINATION on the coarser grid: power-of-two halvings while the
    # dims stay even.
    halvings = 0
    nh, nw, nscale = height, width, render_scale
    nm_left = quality.scan_nomination_scale
    while (nm_left <= 0.5 + 1e-6 and nh % 2 == 0 and nw % 2 == 0
           and min(nh, nw) >= 16):
        nh, nw, nscale = nh // 2, nw // 2, nscale * 0.5
        nm_left *= 2.0
        halvings += 1
    # Window-local pixel coordinates: the light shifts into the window's
    # frame, so the column walk's dx math is unchanged.
    lx = (light_position[:, 0] - off_x) * nscale
    ly = (light_position[:, 1] - off_y) * nscale
    occ = occlusion_image(scene, nh, nw, trace_z, nscale, world_offset)
    # The near-light skip compares dx in nomination-grid pixels.
    lr_n = light_radius * nscale
    # Windowed evaluations keep the exact per-candidate sampling: their
    # grids are small, and the carried maps' grid quantization made
    # windowed lights resolution-dependent (scan_shadows.py:477-489).
    want_carried = (quality.scan_refine_samples > 0
                    and quality.scan_refine_mode in ("carried",
                                                     "carried_all")
                    and not windowed_eval)
    use_cols = isinstance(scene, ColumnField) and want_carried
    if isinstance(scene, ColumnField) and \
            quality.scan_refine_mode == "exact":
        # The exact refine samples the underlying volume.
        scene = scene.volume
    ana_cols = None
    if (want_carried and isinstance(scene, AnalyticScene)
            and quality.scan_refine_mode == "carried_all"):
        # The analytic carried refine, an explicit opt-in: closed-form
        # column images on the nomination grid (None for rotated groups,
        # polygons or many primitives: those keep the exact refine).
        ana_cols = scene_column_images(scene, nh, nw, nscale)
        use_cols = ana_cols is not None
    if use_cols:
        if ana_cols is not None:
            t_img, b_img, f_img = ana_cols
        else:
            t_img = resample_map_to_grid(scene, scene.h_top, nh, nw, nscale)
            b_img = resample_map_to_grid(scene, scene.h_bot, nh, nw, nscale)
            f_img = resample_map_to_grid(scene, scene.flat_d, nh, nw,
                                         nscale)
        extra, fp = (t_img, b_img), f_img
    else:
        extra, fp = (), None
    band = float(min(1.0, max(nscale, 0.25)))
    walk = scan_walk(occ, lx, ly, lr_n, band, extra, fp)
    # The readout: everything after the column walk.
    with span("illuminant/scan_shadows/readout"):
        return scan_readout(
            scene, walk, lx, ly, light_position, light_radius,
            light_ramp_length, quality, trace_z, height, width,
            render_scale, halvings, use_cols, pixel_z=pixel_z,
            pixel_offset_xy=pixel_offset_xy,
            max_trace_distance=max_trace_distance, world_offset=world_offset)


def scan_readout(scene, walk, lx, ly, light_position, light_radius,
                 light_ramp_length, quality: QualitySettings, trace_z,
                 height: int, width: int, render_scale: float,
                 halvings: int, use_cols: bool, pixel_z=None,
                 pixel_offset_xy=None, max_trace_distance=None,
                 world_offset=None):
    """The readout after the column walk -> (L, height, width) visibility:
    the sector select over `walk` (K1's (4, C, L, nh, nw)), the nominated
    fields' upsample by `halvings` 2x steps, the ray geometry, the refine
    at 0 to 3 candidates (the carried reconstruction where `use_cols`,
    else `scene` sampled exactly), the compound-umbra guard, the
    thresholds and the opacity power. `lx`, `ly` (L,): the lights on the
    nomination grid, as the walk took them; `trace_z`: the 0-d trace
    height; the rest as `scan_visibility`'s. CUDA tensors take one launch
    of K2 (`scan_readout_kernel.scan_readout_cuda`), CPU tensors the plain
    version, `scan_readout_reference`."""
    args = (scene, walk, lx, ly, light_position, light_radius,
            light_ramp_length, quality, trace_z, height, width, render_scale,
            halvings, use_cols)
    kw = dict(pixel_z=pixel_z, pixel_offset_xy=pixel_offset_xy,
              max_trace_distance=max_trace_distance,
              world_offset=world_offset)
    dev = light_position.device
    if dev.type == "cuda":
        from .scan_readout_kernel import scan_readout_cuda

        for key in ("pixel_z", "pixel_offset_xy"):
            if kw[key] is not None:
                kw[key] = kw[key].contiguous()
        if world_offset is not None:
            kw["world_offset"] = torch.as_tensor(
                world_offset, dtype=torch.float32, device=dev).contiguous()
        return scan_readout_cuda(*args, **kw)
    return scan_readout_reference(*args, **kw)


def scan_readout_reference(scene, walk, lx, ly, light_position, light_radius,
                           light_ramp_length, quality: QualitySettings,
                           trace_z, height: int, width: int,
                           render_scale: float, halvings: int,
                           use_cols: bool, pixel_z=None,
                           pixel_offset_xy=None, max_trace_distance=None,
                           world_offset=None):
    """K2's plain version, on any device: the readout in eager PyTorch,
    the arguments as `scan_readout`'s."""
    f32 = torch.float32
    dev = light_position.device
    off_x, off_y = world_offset if world_offset is not None else (0.0, 0.0)
    lz = light_position[:, 2]
    east, west, north, south = walk
    nh, nw = east[0].shape[-2:]
    ys_n = torch.arange(nh, dtype=f32, device=dev)[None, :, None] + 0.5
    xs_n = torch.arange(nw, dtype=f32, device=dev)[None, None, :] + 0.5
    dx_n = xs_n - lx[:, None, None]
    dy_n = ys_n - ly[:, None, None]
    # Sector select: E/W own |dy| <= |dx|, N/S the rest.
    horiz = torch.abs(dx_n) >= torch.abs(dy_n)
    is_east = horiz & (dx_n >= 0.0)
    is_west = horiz & (dx_n < 0.0)
    is_north = (~horiz) & (dy_n >= 0.0)
    sel = [torch.where(is_east, e, torch.where(
        is_west, w, torch.where(is_north, n, s)))
        for e, w, n, s in zip(east, west, north, south)]
    # (min_d, k, neg_k) and, carried, (f_min, h_top, h_bot).
    min_d, min_k, neg_k, tb_star = sel[0], sel[1], sel[2], tuple(sel[3:])
    major_n = torch.clamp(torch.maximum(torch.abs(dx_n), torch.abs(dy_n)),
                          min=1e-3)
    k_frac = torch.clamp(min_k / major_n, 0.0, 1.0)  # 0 at light, 1 at px
    exit_frac = torch.clamp(torch.maximum(neg_k, min_k) / major_n, 0.0,
                            1.0)
    if halvings:
        min_d, k_frac, exit_frac, has_blocker, tb_star = \
            _upsample_nominated(min_d, k_frac, exit_frac, halvings,
                                extras=tb_star[1:],
                                fmin=tb_star[0] if use_cols else None)
    else:
        has_blocker = min_d < 1e8

    # --- READOUT at full shadow resolution (pixel centers at i + 0.5).
    lx = (light_position[:, 0] - off_x) * render_scale
    ly = (light_position[:, 1] - off_y) * render_scale
    ys = torch.arange(height, dtype=f32, device=dev)[None, :, None] + 0.5
    xs = torch.arange(width, dtype=f32, device=dev)[None, None, :] + 0.5
    dx = xs - lx[:, None, None]
    dy = ys - ly[:, None, None]
    # Major-axis extents -> along-ray world distances (u = frac * major
    # * sec): cone radii, HACK_DISTANCE_OFFSET and distances are world
    # units.
    major = torch.clamp(torch.maximum(torch.abs(dx), torch.abs(dy)),
                        min=1e-3)
    if pixel_z is None:
        pz = torch.zeros((1,) + tuple(min_d.shape[1:]), dtype=f32,
                         device=dev)
    else:
        pz = pixel_z if pixel_z.dim() == 3 else pixel_z[None]
    lz3 = lz[:, None, None]
    dz = pz - lz3
    inv_rs = 1.0 / max(render_scale, 1e-6)
    ray_len_w = torch.sqrt((dx * dx + dy * dy) * (inv_rs * inv_rs)
                           + dz * dz)
    sec = ray_len_w / major

    # createTraceConfig (ConeTrace.fxh:122-139) + coneTraceStep (:51-71).
    max_radius = torch.clamp(light_radius[:, None, None], MIN_CONE_RADIUS,
                             quality.max_cone_radius)
    ramp = torch.clamp(light_ramp_length[:, None, None], min=16.0)
    growth = max_radius / ramp * quality.cone_growth_factor

    # The exact refine's ray endpoints: light (world) -> the lifted
    # shaded surface.
    px_x = xs * inv_rs + off_x
    px_y = ys * inv_rs + off_y
    if pixel_offset_xy is not None:
        px_x = px_x + pixel_offset_xy[..., 0]
        px_y = px_y + pixel_offset_xy[..., 1]
    lx_w = light_position[:, 0][:, None, None]
    ly_w = light_position[:, 1][:, None, None]
    if max_trace_distance is not None:
        # The blocker's distance from the pixel along the ray, in world
        # units (major * sec is the world ray length).
        u_blocker = torch.clamp((1.0 - k_frac) * major * sec, min=0.0)
        has_blocker = has_blocker & (
            u_blocker <= max_trace_distance[:, None, None])

    if quality.scan_refine_samples <= 0:
        # Pure flatland: the scan's own 2D minimum.
        u0 = torch.clamp((1.0 - k_frac) * major * sec, min=0.0)
        radius0 = torch.minimum(growth * u0 + MIN_CONE_RADIUS, max_radius)
        vis = torch.clamp((min_d + HACK_DISTANCE_OFFSET) / radius0,
                          max=1.0)
        if max_trace_distance is not None:
            vis = torch.where(has_blocker, vis, 1.0)
        candidates = ()
    else:
        # Refine candidates along the blocker span (scan_shadows.py:
        # 729-764).
        fwd = torch.minimum((exit_frac - k_frac) * 0.5,
                            1.5 / (major * sec))
        t_star = torch.where(min_d < -1.0, k_frac + fwd,
                             (k_frac + exit_frac) * 0.5)
        if quality.scan_refine_samples == 1:
            candidates = (t_star,)
        elif quality.scan_refine_samples == 2:
            candidates = (t_star, exit_frac)
        else:
            t_entry = torch.where(min_d < -1.0, (k_frac + exit_frac) * 0.5,
                                  k_frac)
            candidates = (t_star, t_entry, exit_frac)
        vis = torch.ones(min_d.shape, dtype=f32, device=dev)
    for t in candidates:
        sz = lz3 + (pz - lz3) * t
        if use_cols:
            # Elementwise column reconstruction at the candidate's height.
            d_i = reconstruct_profile(tb_star[0], tb_star[1], tb_star[2],
                                      sz)
        else:
            d_i = scene_sample_p(scene, lx_w + (px_x - lx_w) * t,
                                 ly_w + (px_y - ly_w) * t, sz)
        u_i = torch.clamp((1.0 - t) * major * sec, min=0.0)
        radius_i = torch.minimum(growth * u_i + MIN_CONE_RADIUS,
                                 max_radius)
        vis_i = (d_i + HACK_DISTANCE_OFFSET) / radius_i
        vis = torch.minimum(vis, torch.where(has_blocker, vis_i, 1.0))
    if candidates:
        # Compound-umbra guard (scan_shadows.py:791-829): where the 3D ray
        # at the nominated blocker is at or below the trace plane, the
        # flatland block applies.
        ray_z_at_k = lz3 + (pz - lz3) * k_frac
        ray_z_at_exit = lz3 + (pz - lz3) * exit_frac
        low_ray = (ray_z_at_k <= trace_z + 0.5) | (
            (ray_z_at_exit <= trace_z + 0.5) & (min_d < -0.5))
        u0 = torch.clamp((1.0 - k_frac) * major * sec, min=0.0)
        radius0 = torch.minimum(growth * u0 + MIN_CONE_RADIUS, max_radius)
        flat_vis = torch.clamp((min_d + HACK_DISTANCE_OFFSET) / radius0,
                               max=1.0)
        vis = torch.where(has_blocker & low_ray,
                          torch.minimum(vis, flat_vis), vis)
    final = torch.clamp(
        torch.clamp(vis - FULLY_SHADOWED_THRESHOLD, 0.0, 1.0)
        / (UNSHADOWED_THRESHOLD - FULLY_SHADOWED_THRESHOLD), 0.0, 1.0)
    return final ** quality.occlusion_to_opacity_power


def _upsample_nominated(min_d, k_frac, exit_frac, halvings: int, extras=(),
                        fmin=None):
    """Upsample the nominated fields to the readout grid
    (scan_shadows.py:842-920): the no-blocker sentinel clamps to 8192 so
    "bilinear min_d < 4096" is the 2x2 majority vote on the blocker mask;
    the fractions upsample as a mask-normalized convolution of their
    complements; the carried interval heights `extras` edge-aware
    (bilinear where the coarse neighborhood agrees within 2 units, nearest
    across blocker boundaries); the carried footprint minimum `fmin`
    mask-normalized bilinear.

    Returns (min_d, k_frac, exit_frac, has_blocker, ([f_min,] *extras)) at
    2**halvings the input resolution."""
    nom_mask = min_d < 4096.0
    min_d = torch.clamp(min_d, max=8192.0)
    k_c = torch.where(nom_mask, 1.0 - k_frac, 0.0)
    e_c = torch.where(nom_mask, 1.0 - exit_frac, 0.0)
    wgt = nom_mask.to(torch.float32)
    ex_c = [torch.where(nom_mask, e, fill)
            for e, fill in zip(extras, (_TOP_FILL, _BOT_FILL))]
    fm_c = (None if fmin is None
            else torch.where(nom_mask, torch.clamp(fmin, max=4096.0), 0.0))
    for _ in range(halvings):
        k_c = upsample2x_bilinear(k_c)
        e_c = upsample2x_bilinear(e_c)
        min_d = upsample2x_bilinear(min_d)
        wgt = upsample2x_bilinear(wgt)
        ex_new = []
        for e in ex_c:
            nn = e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
            bi = upsample2x_bilinear(e)
            ex_new.append(torch.where(torch.abs(bi - nn) < 2.0, bi, nn))
        ex_c = ex_new
        if fm_c is not None:
            fm_c = upsample2x_bilinear(fm_c)
    has_blocker = min_d < 4096.0
    wgt = torch.clamp(wgt, min=1e-3)
    k_frac = torch.clamp(1.0 - k_c / wgt, 0.0, 1.0)
    exit_frac = torch.clamp(1.0 - e_c / wgt, 0.0, 1.0)
    ex_out = tuple(ex_c)
    if fm_c is not None:
        ex_out = (fm_c / wgt,) + ex_out
    return min_d, k_frac, exit_frac, has_blocker, ex_out


def resize_visibility(vis, target_hw):
    """Resize (L, h, w) visibility to (L, H, W): identity when the shapes
    match, the 2x bilinear upsample for an exact halving, otherwise
    `resize_linear` (jax.image.resize's linear method). The JAX package
    upsamples the 2x case in bfloat16; the port keeps float32."""
    th, tw = target_hw
    if tuple(vis.shape[1:]) == (th, tw):
        return vis
    if (vis.shape[1] * 2, vis.shape[2] * 2) == (th, tw):
        return upsample2x_bilinear(vis)
    return resize_linear(vis, (vis.shape[0], th, tw))


def downsample2x_linear(x, axis: int):
    """Exact-2x linear-antialiased downsample along `axis`: interior kernel
    [1/8, 3/8, 3/8, 1/8], edge kernels renormalized [3, 3, 1]/7 — the
    values of jax.image.resize(..., "linear") for even dims."""
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


def upsample2x_bilinear(v):
    """Bilinear 2x upsample over the last two axes (edge-clamped)."""

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


def scan_cone_visibility(scene, gbuffer, light_position, light_radius,
                         light_ramp_length, quality: QualitySettings,
                         max_trace_distance=None, trace_z=None,
                         self_occlusion_lift=SELF_OCCLUSION_LIFT,
                         upsample: bool = True, light_active=None):
    """Shadow-scale-aware scan visibility over a G-buffer -> (L, H, W):
    the shared dispatch of every light family on the scan path. It lifts
    the shading endpoints along the normal (with the 2.5D screen -> world
    y offset), runs the scan at quality.shadow_scale resolution from the
    G-buffer's window origin, and upsamples back.

    `self_occlusion_lift`: the family's constant (1.6 for sphere lights,
    SphereLightCore.fxh:151; 1.5 for directional and line lights,
    LineLightCore.fxh:10), or an (L,) tensor of per-light lifts for a
    fused multi-family call. `upsample=False` returns the scan-resolution
    (L, sh, sw) visibility; fused callers slice it per family and resize
    to each consumer's resolution."""
    h, w = gbuffer.shape
    ss = quality.shadow_scale
    world_off = (gbuffer.pixel_origin / gbuffer.render_scale
                 if gbuffer.pixel_origin is not None else None)
    if ss == 0.5 and h % 2 == 0 and w % 2 == 0:
        sh, sw = h // 2, w // 2
    elif ss != 1.0:
        sh, sw = max(int(h * ss), 8), max(int(w * ss), 8)
        if sh * w != sw * h:
            # Anisotropic rounding (odd dims, the min-8 clamp) would give
            # the two axes different scales; the scan's ray geometry
            # assumes square pixels, so the JAX package falls back to full
            # resolution.
            sh, sw = h, w
    else:
        sh, sw = h, w

    def resize(arr, axis):
        """The two spatial axes from `axis` to (sh, sw): the exact 2x
        downsample for a halving, `resize_linear` for other scales."""
        ah, aw = arr.shape[axis], arr.shape[axis + 1]
        if (ah, aw) == (sh, sw):
            return arr
        if (ah, aw) == (2 * sh, 2 * sw):
            return downsample2x_linear(downsample2x_linear(arr, axis),
                                       axis + 1)
        return resize_linear(arr, arr.shape[:axis] + (sh, sw)
                             + arr.shape[axis + 2:])

    # Lifting then resizing equals resizing then lifting (both linear). A
    # scalar lift goes first (3 planes through the resize); an array lift
    # resizes the 5 shared G-buffer planes once and lifts per light at scan
    # resolution, instead of materializing 3L full-resolution planes.
    if not torch.is_tensor(self_occlusion_lift) or \
            self_occlusion_lift.dim() == 0:
        lift = self_occlusion_lift
        pixel_z = resize(gbuffer.z + lift * gbuffer.normal[..., 2], 0)
        # The lift's world xy: the exact refine's ray endpoint.
        offset_xy = resize(torch.stack(
            [lift * gbuffer.normal[..., 0],
             lift * gbuffer.normal[..., 1] + gbuffer.relative_y], dim=-1), 0)
    else:
        z_s = resize(gbuffer.z, 0)
        n_s = resize(gbuffer.normal, 0)
        ry_s = resize(gbuffer.relative_y, 0)
        li = self_occlusion_lift[:, None, None]
        pixel_z = z_s[None] + li * n_s[None, ..., 2]
        offset_xy = torch.stack([li * n_s[None, ..., 0],
                                 li * n_s[None, ..., 1] + ry_s[None]], dim=-1)
    vis = scan_visibility(
        scene, sh, sw, light_position, light_radius, light_ramp_length,
        quality, trace_z=trace_z,
        render_scale=gbuffer.render_scale * (sh / h if sh != h else 1.0),
        pixel_z=pixel_z, pixel_offset_xy=offset_xy,
        max_trace_distance=max_trace_distance, world_offset=world_off,
        light_active=light_active)
    if not upsample:
        return vis
    return resize_visibility(vis, (h, w))
