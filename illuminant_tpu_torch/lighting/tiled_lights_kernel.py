"""Tiled particle lights: the CUDA source `csrc/tiled_lights.cu` (K10), its
wrapper and the plain PyTorch versions of its parts.

K10 replaces the device work of `illuminant_tpu/lighting/tiled_lights.py:
accumulate_sphere_lights_tiled` (:123): the tile y bounds, the binning
(`bin_lights_to_tiles`, :43), the AO and fullbright factor (:284) and the
shading (:229-291, a bfloat16 einsum of (T, 8, tile, tile) opacity planes
with the lights' colours over a padded frame), in one launch a frame: one
block a screen tile culls and bins the lights for its tile, samples the
AO on a ColumnField, and shades its pixels, float32, slots in order,
straight into the (H, W, 4) image ((H, W, 3) without alpha). The
source's header says what bounds it and what the design does about it.

`tiled_lights_fused` is the wrapper. On CPU tensors it runs the plain
version, `tiled_lights_fused_reference`, built from the pieces the route
ran in PyTorch before the kernel took them: `tile_y_bounds`,
`bin_lights_to_tiles` (the JAX binning's parity reference), the AO /
fullbright epilogue (`pixel_factor`) and `tiled_light_accumulate_reference`
(the shading one slot at a time in slot order); a CUDA tensor launches
the kernel or raises. `cull_mirror` and `subtile_reaches` are the plain
forms of the kernel's per-tile cull and per-sub-tile skip rule. The
library is compiled from the repository's source at first use
(`core/cuda_build`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core import cuda_build
from ..core.upload import upload
from ..sdf import columns, columns_kernel
from ..sdf.analytic import scene_sample_p
from .sphere import _saturate

LIBRARY = cuda_build.Library("tiled_lights.cu", {
    "tiled_lights": [ctypes.c_void_p] * 17,
    "tiled_lights_plan": [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)]},
    ["k10_tiled_lights"])
# The kernel's limits: a tile's pixels are a loop of its block; its kept
# slots (36 B each), its candidate offsets' counters (12 B each) and two
# chunk lists of 256 ints are in shared memory, at most 198,656 B together
# at these limits (under the 227 KB a block may opt in to).
MAX_CAPACITY = 4096
MAX_TILE = 1024
MAX_OFFSETS = 4096
# Where the kernel's per-pixel factor comes from (the source's
# FactorMode): a pix_f plane, the fullbright plane alone, or fullbright x
# AO sampled in the kernel from a ColumnField.
FACTOR_MODES = {"pix_f": 0, "fullbright": 1, "column_ao": 2}
# The skip rule's relative margin on the support (see `Shading.cutoff`).
SKIP_MARGIN = 2.0 ** -12
DOT_OFFSET = 0.15  # LightCommon.fxh:1-10
DOT_RAMP_RANGE = 0.15
DOT_EXPONENT = 0.85


@dataclasses.dataclass(frozen=True)
class Shading:
    """The Python scalars of one tiled-lights call. `influence` /
    `influence_y` / `extra_y` (px) are the binning's support and extra y
    window; `radius`, `ramp_length` (clamped to >= 1e-6), `y_factor`
    (clamped to >= 1e-3) and `ramp_mode` the template's falloff (world
    units); `color` the template colour and `weight` its opacity x the
    brightness scale; `ao_radius`, `ao_opacity` its AO."""

    tile: int
    capacity: int
    render_scale: float
    influence: float
    influence_y: float
    extra_y: float
    radius: float
    ramp_length: float
    y_factor: float
    ramp_mode: int
    color: tuple
    weight: float
    ao_radius: float = 0.0
    ao_opacity: float = 0.0
    with_alpha: bool = True

    @property
    def reps_x(self) -> int:
        return int(math.ceil(self.influence / self.tile))

    @property
    def reps_y(self) -> int:
        return int(math.ceil((self.influence_y + self.extra_y) / self.tile))

    @property
    def offsets(self) -> int:
        """Candidate offsets a light has: (2 reps_x + 1)(2 reps_y + 1)."""
        return (2 * self.reps_x + 1) * (2 * self.reps_y + 1)

    @property
    def support(self) -> float:
        """Where every opacity is 0 (world units): radius + ramp_length
        for ramp modes 0 and 1, radius + 1 for mode 2."""
        return self.radius + (self.ramp_length if self.ramp_mode < 2
                              else 1.0)

    @property
    def cutoff(self) -> float:
        """The skip rule's distance: the support widened by 2^-12 of
        itself, beyond what the rounding of the distance and of
        (distance - radius) / ramp_length can cross."""
        return self.support * (1.0 + SKIP_MARGIN)


def check_sizes(sh: Shading):
    """Raise unless the kernel takes the tile, the capacity and the
    candidate window of `sh`."""
    if not (1 <= sh.tile <= MAX_TILE and 1 <= sh.capacity <= MAX_CAPACITY
            and sh.offsets <= MAX_OFFSETS):
        offsets = sh.offsets if sh.tile >= 1 else "-"
        raise ValueError(f"tiled_lights_fused: the kernel takes a tile of 1 "
                         f"to {MAX_TILE} pixels, 1 to {MAX_CAPACITY} slots a "
                         f"tile and up to {MAX_OFFSETS} candidate offsets; "
                         f"got tile {sh.tile}, capacity {sh.capacity}, "
                         f"{offsets} offsets")


def launch_plan(sh: Shading) -> dict:
    """The block a K10 launch takes for `sh` on the current card:
    threads, dynamic shared memory bytes, resident blocks an SM,
    registers and spilled bytes a thread."""
    check_sizes(sh)
    out = (ctypes.c_int * 5)()
    LIBRARY.call("tiled_lights_plan", sh.capacity, sh.offsets, out)
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                     "spill_bytes"), out))


def occluded(df, d3z, inv_lo, occl_on):
    """df scaled by the light-occlusion term where `occl_on` (the
    environment's light_occlusion > 0; the kernel skips the term when it
    is not), `inv_lo` 1 / the occlusion clamped to at least 1e-6."""
    return df * torch.where(occl_on,
                            1.0 - torch.clamp(d3z * inv_lo, 0.0, 1.0), 1.0)


def light_opacity(d3x, d3y, d3z, nx, ny, nz, no_normal, on, radius,
                  inv_ramp, ramp_mode, inv_lo, occl_on):
    """computeSphereLightOpacity (LightCommon.fxh:173-210) of a light at
    offsets d3x, (squashed) d3y, d3z from the pixels, in the kernel's
    operation order. It reorders the JAX package's arithmetic (the
    bf16 bound to it holds): no division, the distance d2 x rsqrt(d2)
    from the squared distance d2 and its reciprocal square root, which
    also divides the normal's dot product; the ramp and the 0.15 ramp as
    products with reciprocals; x ** 0.85 as exp2(0.85 log2 x), 0 at
    x = 0."""
    d2 = d3x * d3x + d3y * d3y + d3z * d3z + 1e-12
    inv = torch.rsqrt(d2)
    distance = d2 * inv
    df = 1.0 - torch.clamp((distance - radius) * inv_ramp, 0.0, 1.0)
    df = occluded(df, d3z, inv_lo, occl_on)
    dot = -(d3x * nx + d3y * ny + d3z * nz) * inv
    x = torch.clamp((dot + DOT_OFFSET) * (1.0 / DOT_RAMP_RANGE), 0.0, 1.0)
    nf = torch.exp2(DOT_EXPONENT * torch.log2(x))
    nf = torch.where(no_normal, 1.0, nf)
    if ramp_mode >= 2:
        df = 1.0 - torch.clamp(distance - radius, 0.0, 1.0)
        nf = torch.ones_like(nf)
    elif ramp_mode >= 1:
        df = df * df
    return torch.clamp(nf * df + torch.clamp(radius - distance, 0.0, 1.0),
                       0.0, 1.0) * on


def tiled_light_accumulate_reference(z, relative_y, normal, pix_f, idx,
                                     mask, records, light_occlusion,
                                     tile: int, radius: float,
                                     ramp_length: float, y_factor: float,
                                     ramp_mode: int, render_scale: float,
                                     with_alpha: bool = True,
                                     count_pairs: bool = False):
    """Plain version of K10's shading, in its operation order: for each
    slot k in order, every pixel of tile t shades light idx[t, k]
    (`light_opacity`) and adds opacity x (r, g, b, 1) of its record to its
    sum; the sum is then scaled by pix_f. records (N, 8): x, y, z, on,
    weighted r, g, b, 1; `ramp_length` and `y_factor` already clamped as
    the JAX package clamps them; `light_occlusion` a 0-d tensor. The
    kernel skips the slots `subtile_reaches` rules out; their terms here
    are exactly +0. With `count_pairs`, -> (image, the number of (slot,
    pixel) pairs whose opacity is nonzero)."""
    h, w = z.shape
    dev = z.device
    f32 = torch.float32
    tw = -(-w // tile)
    ys = (torch.arange(h, dtype=f32, device=dev) + 0.5) / render_scale
    xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / render_scale
    wx = xs[None, :]
    wy = ys[:, None] + relative_y
    nx, ny, nz = normal.unbind(-1)
    no_normal = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
    tid = ((torch.arange(h, device=dev) // tile)[:, None] * tw
           + (torch.arange(w, device=dev) // tile)[None, :])
    inv_lo = 1.0 / torch.clamp(light_occlusion, min=1e-6)
    occl_on = light_occlusion > 0.0
    inv_ramp = 1.0 / ramp_length
    acc = torch.zeros((h, w, 4), dtype=f32, device=dev)
    pairs = 0
    for k in range(idx.shape[1]):
        rec = records[idx[:, k].long()]
        rec = torch.cat([rec[:, :3], (rec[:, 3] * mask[:, k].to(f32))[:, None],
                         rec[:, 4:]], dim=1)[tid]  # (H, W, 8)
        op = light_opacity(wx - rec[..., 0], (wy - rec[..., 1]) * y_factor,
                           z - rec[..., 2], nx, ny, nz, no_normal,
                           rec[..., 3], radius, inv_ramp, ramp_mode, inv_lo,
                           occl_on)
        acc = acc + op[..., None] * rec[..., 4:]
        if count_pairs:
            pairs += int((op != 0.0).sum())
    out = acc * pix_f[..., None]
    out = out if with_alpha else out[..., :3].contiguous()
    return (out, pairs) if count_pairs else out


def cull_mirror(x, y, live, shading: Shading, height: int, width: int,
                t_ylo, t_yhi):
    """The kernel's cull, plain and tile by tile: for each tile, every
    light's one candidate offset (oy-major, then ox) inside the +-reps
    window and the binning's box test in its operation order; the
    survivors of each offset counted, a prefix over the offsets giving
    each its first slot, and each survivor filed at its offset's first
    slot plus its rank among that offset's survivors in light order.
    x, y (N,) px; t_ylo, t_yhi (T,) the tiles' y bounds -> (kept (T, K)
    int32, -1 past the count; count (T,) int32; dropped () int32)."""
    sh = shading
    tile = sh.tile
    th, tw = -(-height // tile), -(-width // tile)
    rx, ry = sh.reps_x, sh.reps_y
    n = x.shape[0]
    dev = x.device
    base_tx = torch.floor(x / tile).to(torch.int64)
    base_ty = torch.floor(y / tile).to(torch.int64)
    light = torch.arange(n, device=dev)
    kept = torch.full((th * tw, sh.capacity), -1, dtype=torch.int32,
                      device=dev)
    count = torch.zeros(th * tw, dtype=torch.int32, device=dev)
    dropped = 0
    for t in range(th * tw):
        ty, tx = divmod(t, tw)
        ox, oy = tx - base_tx, ty - base_ty
        x0 = torch.tensor(float(tx * tile), device=dev)
        dx = x - torch.minimum(torch.maximum(x, x0), x0 + tile)
        dy = y - torch.minimum(torch.maximum(y, t_ylo[t]), t_yhi[t])
        ok = ((ox.abs() <= rx) & (oy.abs() <= ry) & live
              & (dx.abs() <= sh.influence) & (dy.abs() <= sh.influence_y))
        o = (oy + ry) * (2 * rx + 1) + (ox + rx)
        cnt = torch.bincount(o[ok], minlength=sh.offsets)
        first = torch.cumsum(cnt, 0) - cnt
        # Rank among the same offset's survivors of lower light index.
        same = (o[ok][:, None] == o[ok][None, :]) & (
            light[ok][None, :] < light[ok][:, None])
        slot = first[o[ok]] + same.sum(dim=1)
        keep = slot < sh.capacity
        kept[t, slot[keep]] = light[ok][keep].to(torch.int32)
        total = int(ok.sum())
        count[t] = min(total, sh.capacity)
        dropped += max(total - sh.capacity, 0)
    return kept, count, torch.tensor(dropped, dtype=torch.int32)


def subtile_reaches(box, lights, y_factor: float, cutoff: float):
    """The kernel's skip rule, plain: box (..., 6) float32 world x0, x1,
    y0, y1, z0, z1 (the min / max over a sub-tile's pixels of x, y +
    relative_y and z, each computed as the shading computes it); lights
    (..., 3) world x, y, z -> bool, False where no pixel of the box can
    get a nonzero opacity from the light. The bound's squared distance
    rounds as the shading's does, each step monotone, so the shading's
    distance is at least the bound less a few ulps of the square root,
    far inside the 2^-12 margin of `cutoff`."""
    x0, x1, y0, y1, z0, z1 = box.unbind(-1)
    lx, ly, lz = lights.unbind(-1)
    ex = torch.clamp(torch.maximum(x0 - lx, lx - x1), min=0.0)
    ey = torch.clamp(torch.maximum(y0 - ly, ly - y1), min=0.0) * y_factor
    ez = torch.clamp(torch.maximum(z0 - lz, lz - z1), min=0.0)
    return ~(torch.sqrt(ex * ex + ey * ey + ez * ez) > cutoff)


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


def tile_y_bounds(relative_y, tile: int, render_scale: float):
    """Each tile's shaded-world y bounds over the frame padded with zeros
    to whole tiles (as in the JAX package, so a partial edge tile counts 0
    for its pad pixels) -> (y_lo (T,), y_hi (T,), max |relative_y|)."""
    h, w = relative_y.shape
    th, tw = -(-h // tile), -(-w // tile)
    rel_t = _to_tiles(F.pad(relative_y, (0, tw * tile - w, 0, th * tile - h)),
                      th, tw, tile)
    t_idx = torch.arange(th * tw, dtype=torch.int32,
                         device=relative_y.device)
    ty0 = ((t_idx // tw) * tile).to(torch.float32)
    t_ylo = ty0 + rel_t.amin(dim=(1, 2)) * render_scale
    t_yhi = ty0 + tile + rel_t.amax(dim=(1, 2)) * render_scale
    return t_ylo, t_yhi, rel_t.abs().amax()


def pixel_factor(volume, z, relative_y, normal, fullbright,
                 render_scale: float, ao_radius: float, ao_opacity: float):
    """The per-pixel factor shared by every light of the template:
    fullbright discard and AO (AOCommon.fxh:1-20, upward faces only), the
    AO's distance sample through `scene_sample_p` (on a ColumnField the
    column query) -> (H, W) float32."""
    h, w = z.shape
    f32 = torch.float32
    dev = z.device
    pix_f = (fullbright < 0.5).to(f32)
    if ao_radius > 0.0 and volume is not None:
        nz = normal[..., 2]
        ys = (torch.arange(h, dtype=f32, device=dev) + 0.5) / render_scale
        xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / render_scale
        ao_r = ao_radius * torch.clamp(nz, min=0.0)
        d = scene_sample_p(volume, xs[None, :].expand(h, w),
                           ys[:, None] + relative_y, z + nz * ao_r)
        clamped = torch.minimum(torch.clamp(d, min=0.0), ao_r)
        r = 1.0 - _saturate(clamped / torch.clamp(ao_r, min=1e-6))
        r = 1.0 - r * r
        ao = (1.0 - ao_opacity) + r * ao_opacity
        pix_f = pix_f * torch.where(ao_r >= 0.5, ao, 1.0)
    return pix_f


def fused_inputs(z, relative_y, normal, factor, position, color, active,
                 shading: Shading,
                 mode: str = "fullbright", column=None):
    """The plain pieces of K10 before its shading: the tile y bounds, the
    binning (`bin_lights_to_tiles`), the records and the per-pixel factor
    (the `factor` plane itself in mode "pix_f", fullbright alone in
    "fullbright", `pixel_factor` on `column` in "column_ao") -> (pix_f,
    idx, mask, records, dropped, window_deficit_px)."""
    sh = shading
    h, w = z.shape
    rs = sh.render_scale
    f32 = torch.float32
    tile = sh.tile
    th, tw = -(-h // tile), -(-w // tile)
    t_ylo, t_yhi, rel_max = tile_y_bounds(relative_y, tile, rs)
    idx, mask, dropped = bin_lights_to_tiles(
        position[:, 0] * rs, position[:, 1] * rs, active, sh.influence, tile,
        th, tw, sh.capacity, influence_y=sh.influence_y, tile_y_lo=t_ylo,
        tile_y_hi=t_yhi, extra_y_window=sh.extra_y)
    # Relief beyond the candidate window cannot be binned: report it.
    window_deficit = torch.clamp(rel_max * rs - sh.extra_y, min=0.0)

    # Per-light records: x, y, z, on, weighted rgb, 1 (ParticleLight.fx:
    # 40-71; column 3 of the sum accumulates the raw opacity).
    col = color * upload(sh.color, z.device)
    col_w = col[:, :3] * (col[:, 3:4] * sh.weight)
    records = torch.cat([position[:, :3].to(f32), active.to(f32)[:, None],
                         col_w, torch.ones_like(col_w[:, :1])], dim=1)
    if mode == "pix_f":
        pix_f = factor
    else:
        pix_f = pixel_factor(column, z, relative_y, normal, factor, rs,
                             sh.ao_radius if mode == "column_ao" else 0.0,
                             sh.ao_opacity)
    return pix_f, idx, mask, records, dropped, window_deficit


def tiled_lights_fused_reference(z, relative_y, normal, factor, position,
                                 color, active, light_occlusion,
                                 shading: Shading,
                                 mode: str = "fullbright", column=None,
                                 debug: bool = False):
    """Plain version of K10 (`tiled_lights_kernel.tiled_lights_fused`,
    the same arguments and results): `fused_inputs`, then the shading
    (`tiled_light_accumulate_reference`). The debug lists are
    `bin_lights_to_tiles`' (-1 past each tile's count)."""
    sh = shading
    pix_f, idx, mask, records, dropped, deficit = fused_inputs(
        z, relative_y, normal, factor, position, color, active, sh, mode,
        column)
    out = tiled_light_accumulate_reference(
        z, relative_y, normal, pix_f, idx, mask, records, light_occlusion,
        sh.tile, sh.radius, sh.ramp_length, sh.y_factor, sh.ramp_mode,
        sh.render_scale, sh.with_alpha)
    result = (out, dropped, deficit)
    if not debug:
        return result
    count = mask.sum(dim=1).to(torch.int32)
    return result + (torch.where(mask, idx, -1).to(torch.int32), count)


def _check(z, relative_y, normal, factor, position, color, active,
           light_occlusion):
    h, w = z.shape
    n = position.shape[0]
    planes = (("z", z, (h, w)), ("relative_y", relative_y, (h, w)),
              ("normal", normal, (h, w, 3)), ("factor", factor, (h, w)))
    for name, t, shape in planes:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"tiled_lights_fused: {name} must be float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if (position.dim() != 2 or position.shape[1] < 3
            or position.dtype != torch.float32
            or tuple(color.shape) != (n, 4) or color.dtype != torch.float32
            or tuple(active.shape) != (n,) or active.dtype != torch.bool):
        raise ValueError(f"tiled_lights_fused: position must be float32 "
                         f"(N, >=3), color float32 (N, 4), active bool (N,); "
                         f"got {position.dtype} {tuple(position.shape)}, "
                         f"{color.dtype} {tuple(color.shape)}, "
                         f"{active.dtype} {tuple(active.shape)}")
    if light_occlusion.numel() != 1 or light_occlusion.dtype != torch.float32:
        raise ValueError("tiled_lights_fused: light_occlusion must be one "
                         "float32 value")


def tiled_lights_fused(z, relative_y, normal, factor, position, color,
                       active, light_occlusion, shading: Shading,
                       mode: str = "fullbright", column=None,
                       debug: bool = False):
    """The tiled particle lights of one frame -> (image, dropped,
    window_deficit_px), or with `debug` also (kept (T, K) int32, count
    (T,) int32): each tile's kept light indices (entries past its count
    are -1) and their count.

    z, relative_y (H, W), normal (H, W, 3): the G-buffer; `factor` (H, W):
    the fullbright plane (modes "fullbright" and "column_ao") or the
    per-pixel factor pix_f ("pix_f"); position (N, >=3) world, color (N, 4)
    un-premultiplied, active (N,) bool: the lights; light_occlusion the
    environment's, 0-d; `column` the ColumnField whose distance query
    gives the AO ("column_ao"). `dropped` (int32) and `window_deficit_px`
    (float32) are device scalars.

    A CPU tensor runs the plain version (`tiled_lights_fused_reference`);
    a CUDA tensor launches
    K10 on the current stream (after the ColumnField's map pack and the
    zeroing of the two diagnostics), or raises."""
    _check(z, relative_y, normal, factor, position, color, active,
           light_occlusion)
    if mode not in FACTOR_MODES or (mode == "column_ao") != (
            column is not None):
        raise ValueError(f"tiled_lights_fused: mode {mode!r} with "
                         f"column {type(column).__name__}")
    if z.device.type == "cpu":
        return tiled_lights_fused_reference(
            z, relative_y, normal, factor, position, color, active,
            light_occlusion, shading, mode, column, debug)
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"tiled_lights_fused: no kernel for device {dev}")
    tensors = (z, relative_y, normal, factor, position, color, active,
               light_occlusion)
    for t in tensors:
        if t.device != dev:
            raise ValueError("tiled_lights_fused: the tensors must share a "
                             "device")
    for t in (z, relative_y, normal, factor, color, active):
        if not t.is_contiguous():
            raise ValueError("tiled_lights_fused: the planes, color and "
                             "active must be contiguous")
    if position.stride(1) != 1:
        raise ValueError("tiled_lights_fused: position's rows must be "
                         "contiguous")
    check_sizes(shading)
    h, w = z.shape
    n = position.shape[0]
    pack, geometry, hc, wc = None, None, 0, 0
    if column is not None:
        if column.maps_c.device != dev or column.maps_c.shape[0] != 5:
            raise ValueError("tiled_lights_fused: the ColumnField must hold "
                             "its 5 maps on the planes' device")
        pack = columns_kernel.pack_maps(column.maps_c.contiguous())
        hc, wc = pack.shape[:2]
        geometry = (ctypes.c_float * len(columns_kernel.QUERY_GEOMETRY))(
            *map(float, columns.query_geometry(column)))
    sh = shading
    ints = (ctypes.c_int * 13)(
        h, w, sh.tile, n, position.stride(0), sh.capacity, sh.reps_x,
        sh.reps_y, int(sh.ramp_mode), int(bool(sh.with_alpha)),
        FACTOR_MODES[mode], hc, wc)
    floats = (ctypes.c_float * 16)(
        sh.render_scale, sh.influence, sh.influence_y, sh.extra_y,
        sh.radius, 1.0 / sh.ramp_length, sh.y_factor, sh.cutoff,
        *map(float, sh.color), sh.weight, sh.ao_radius, sh.ao_opacity,
        1.0 - sh.ao_opacity)
    out = torch.empty((h, w, 4 if sh.with_alpha else 3),
                      dtype=torch.float32, device=dev)
    diag = torch.zeros(2, dtype=torch.int32, device=dev)
    n_tiles = -(-h // sh.tile) * -(-w // sh.tile)
    kept = count = None
    if debug:
        kept = torch.full((n_tiles, sh.capacity), -1, dtype=torch.int32,
                          device=dev)
        count = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    LIBRARY.launch(
        "k10_tiled_lights", "tiled_lights", dev,
        z.data_ptr(), relative_y.data_ptr(), normal.data_ptr(),
        factor.data_ptr(), position.data_ptr(), color.data_ptr(),
        active.data_ptr(), light_occlusion.data_ptr(),
        None if pack is None else pack.data_ptr(), out.data_ptr(),
        diag.data_ptr(), None if kept is None else kept.data_ptr(),
        None if count is None else count.data_ptr(),
        ctypes.cast(ints, ctypes.c_void_p),
        ctypes.cast(floats, ctypes.c_void_p),
        None if geometry is None else ctypes.cast(geometry, ctypes.c_void_p))
    result = (out, diag[0], diag[1:].view(torch.float32)[0])
    return result + (kept, count) if debug else result
