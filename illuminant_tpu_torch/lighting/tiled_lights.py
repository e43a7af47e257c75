"""Tiled light culling: exact evaluation of many small lights.

Counterpart of illuminant_tpu/lighting/tiled_lights.py. The reference draws
one instanced quad per particle light (ParticleLight.fx; the rasteriser
culls each quad to the light's screen bounds); here the screen is cut
into square tiles, each light is binned into every tile its influence
region overlaps (the ramps reach exactly zero at radius + ramp_length),
and each tile is shaded against its binned lights only. Every live light
contributes up to the per-tile capacity; `dropped` counts the overflow.

The binning is plain PyTorch and reads nothing back to the host. The
shading is K10 (`tiled_lights_kernel.tiled_light_accumulate`): float32,
slots in order, written straight into the (H, W, 4) image, where the JAX
package contracts (T, 8, tile, tile) opacity chunks with the colours in
bfloat16 over a padded frame. The per-pixel fullbright x AO factor is the
plain epilogue; its AO sample goes through `scene_sample_p`, on a
ColumnField the fused column query.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.pytree import named_scope
from ..core.upload import upload
from ..sdf.analytic import scene_sample_p
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from .sphere import _saturate
from . import tiled_lights_kernel


def bin_lights_to_tiles(x, y, live, influence: float, tile: int, th: int,
                        tw: int, capacity: int,
                        influence_y: float | None = None,
                        tile_y_lo=None, tile_y_hi=None,
                        extra_y_window: float = 0.0):
    """Bin lights (screen px coords) into all tiles their influence region
    overlaps -> (idx (T, K) int32, mask (T, K) bool, dropped () int32).

    `influence` (px): the x support radius; `influence_y` the y support
    (default isotropic). The per-axis box test is slightly conservative.
    `tile_y_lo` / `tile_y_hi` ((T,) px): each tile's shaded-world y bounds
    (a 2.5D pixel's world y is its row plus relative_y); `extra_y_window`
    (px) widens the candidate window for them. Candidates are enumerated
    offset-major (oy outer, ox inner, then light index), stably sorted by
    tile id, and each tile keeps its first `capacity`, as in the JAX
    package."""
    n = x.shape[0]
    dev = x.device
    i32 = torch.int32
    n_tiles = th * tw
    inf_x = float(influence)
    inf_y = inf_x if influence_y is None else float(influence_y)
    reps_x = int(math.ceil(inf_x / tile))
    reps_y = int(math.ceil((inf_y + extra_y_window) / tile))
    base_tx = torch.floor(x / tile).to(i32)
    base_ty = torch.floor(y / tile).to(i32)
    ids_list = []
    for oy in range(-reps_y, reps_y + 1):
        for ox in range(-reps_x, reps_x + 1):
            tx = base_tx + ox
            ty = base_ty + oy
            in_bounds = (tx >= 0) & (tx < tw) & (ty >= 0) & (ty < th)
            tid = torch.where(in_bounds, ty * tw + tx, 0)
            # Closest point of the tile's world box to the light, per axis.
            x0 = (tx * tile).to(torch.float32)
            if tile_y_lo is None:
                y_lo = (ty * tile).to(torch.float32)
                y_hi = y_lo + tile
            else:
                y_lo = tile_y_lo[tid]
                y_hi = tile_y_hi[tid]
            dx = x - torch.minimum(torch.maximum(x, x0), x0 + tile)
            dy = y - torch.minimum(torch.maximum(y, y_lo), y_hi)
            ok = ((dx.abs() <= inf_x) & (dy.abs() <= inf_y) & live
                  & in_bounds)
            ids_list.append(torch.where(ok, tid, n_tiles))
    ids = torch.cat(ids_list)
    srcs = torch.arange(n, dtype=i32, device=dev).repeat(len(ids_list))
    # Stable: which lights a full tile keeps follows candidate order.
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    src_s = srcs[order]
    bounds = torch.searchsorted(
        ids_s, torch.arange(n_tiles + 1, dtype=i32, device=dev))
    starts, ends = bounds[:-1], bounds[1:]
    slot = starts[:, None] + torch.arange(capacity, device=dev)[None]
    mask = slot < ends[:, None]
    idx = src_s[torch.clamp(slot, max=ids.shape[0] - 1)]
    dropped = torch.clamp(ends - starts - capacity, min=0).sum().to(i32)
    return idx, mask, dropped


def _to_tiles(plane, th, tw, tile):
    """(Hp, Wp) -> (T, tile, tile)."""
    return plane.reshape(th, tile, tw, tile).permute(0, 2, 1, 3) \
        .reshape(th * tw, tile, tile)


@named_scope("illuminant/tiled_particle_lights")
def accumulate_sphere_lights_tiled(volume, gbuffer: GBuffer, position,
                                   color, active, template,
                                   env: EnvironmentUniforms, tile: int = 64,
                                   capacity: int = 32,
                                   with_alpha: bool = True,
                                   max_relative_y: float = 0.0,
                                   brightness_scale: float = 1.0):
    """Shade N template-uniform shadowless lights -> ((H, W, 4) HDR add,
    {"dropped": capacity overflow, "window_deficit_px": relief beyond the
    candidate window}), both device scalars.

    position (N, >=3) world; color (N, 4) un-premultiplied rgba a light;
    active (N,) bool; template the shared SphereLightSource (radius, ramp,
    falloff, AO). The shading is accumulate_sphere_lights' per light
    (computeSphereLightOpacity) restricted to each light's support tiles;
    no specular, ramp texture or shadows (LightSource.cs:466-505)."""
    h, w = gbuffer.shape
    rs = gbuffer.render_scale
    dev = gbuffer.z.device
    f32 = torch.float32
    th = -(-h // tile)
    tw = -(-w // tile)

    # Support radius in px (LightCommon.fxh:197-203) + a pixel-centre
    # guard; the y reach is longer by 1 / falloff_y_factor.
    r_world = template.radius + (
        template.ramp_length if template.ramp_mode < 2 else 1.0)
    influence = float(r_world) * rs + 0.5
    influence_y = float(r_world) / max(template.falloff_y_factor, 1e-3) \
        * rs + 0.5

    # Per-tile shaded-world y bounds over the padded frame (pads are 0,
    # as in the JAX package).
    rel_t = _to_tiles(F.pad(gbuffer.relative_y,
                            (0, tw * tile - w, 0, th * tile - h)),
                      th, tw, tile)
    t_idx = torch.arange(th * tw, dtype=torch.int32, device=dev)
    ty0 = ((t_idx // tw) * tile).to(f32)
    t_ylo = ty0 + rel_t.amin(dim=(1, 2)) * rs
    t_yhi = ty0 + tile + rel_t.amax(dim=(1, 2)) * rs

    extra_y = float(max_relative_y) * rs
    idx, mask, dropped = bin_lights_to_tiles(
        position[:, 0] * rs, position[:, 1] * rs, active, influence, tile,
        th, tw, capacity, influence_y=influence_y, tile_y_lo=t_ylo,
        tile_y_hi=t_yhi, extra_y_window=extra_y)
    # Relief beyond the candidate window cannot be binned: report it.
    window_deficit = torch.clamp(rel_t.abs().amax() * rs - extra_y, min=0.0)

    # Per-light records: x, y, z, on, weighted rgb, 1 (ParticleLight.fx:
    # 40-71; column 3 of the sum accumulates the raw opacity).
    col = color * upload(template.color, dev)
    col_w = col[:, :3] * (col[:, 3:4]
                          * (template.opacity * brightness_scale))
    records = torch.cat([position[:, :3].to(f32), active.to(f32)[:, None],
                         col_w, torch.ones_like(col_w[:, :1])], dim=1)

    # Per-pixel factors shared by every light of the template: fullbright
    # discard and AO (AOCommon.fxh:1-20, upward faces only).
    pix_f = (gbuffer.fullbright < 0.5).to(f32)
    if template.ambient_occlusion_radius > 0.0 and volume is not None:
        nz = gbuffer.normal[..., 2]
        ys = (torch.arange(h, dtype=f32, device=dev) + 0.5) / rs
        xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / rs
        ao_r = template.ambient_occlusion_radius * torch.clamp(nz, min=0.0)
        d = scene_sample_p(volume, xs[None, :].expand(h, w),
                           ys[:, None] + gbuffer.relative_y,
                           gbuffer.z + nz * ao_r)
        clamped = torch.minimum(torch.clamp(d, min=0.0), ao_r)
        r = 1.0 - _saturate(clamped / torch.clamp(ao_r, min=1e-6))
        r = 1.0 - r * r
        opa = template.ambient_occlusion_opacity
        ao = (1.0 - opa) + r * opa
        pix_f = pix_f * torch.where(ao_r >= 0.5, ao, 1.0)

    out = tiled_lights_kernel.tiled_light_accumulate(
        gbuffer.z.contiguous(), gbuffer.relative_y.contiguous(),
        gbuffer.normal.contiguous(), pix_f.contiguous(), idx.to(torch.int32),
        mask, records, env.light_occlusion.to(f32).contiguous(), tile,
        template.radius, max(template.ramp_length, 1e-6),
        max(template.falloff_y_factor, 1e-3), template.ramp_mode, rs,
        with_alpha)
    return out, dict(dropped=dropped, window_deficit_px=window_deficit)
