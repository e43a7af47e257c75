"""The additive particle raster over a row-banded mesh (counterpart of
illuminant_tpu/parallel/raster.py).

Each rank holds a capacity shard of the particles and owns a band of
whole tile rows of the frame (`mesh.band_layout`: band_tiles = ceil(gy /
D)). A particle binned at tile row ty splats a window that touches tile
rows ty - 1, ty and ty + 1 (0 < apron < tile), so it is sent to each
distinct owner of those rows, through ONE `all_to_all_single` of (D, B, 8)
float32 lanes a rank: x, y, size, valid, and four colour channels. Every
rank then rasterizes what it received on its band with a ghost tile row
above and below and keeps its band. The work splits into two pure
functions around the collective, `route` and `raster_band`, which a
single process can also chain for every rank (the exchange is then a
transpose of the stacked send buffers).

Budget semantics are the JAX package's: B = min(max(ceil(n_loc f /
owners_used), 64), 3 n_loc) slots for each (source, owner) pair, where
owners_used counts the ranks that own any tile row. What does not fit is
counted in `send_dropped`, never silent; `send_peak_fill` and
`suggested_send_budget_factor` give the factor that would have routed it.
B depends on static sizes only, so the route reads nothing back.

The local raster is `rasterize_tiled`: on the card one K5 splat a band.
Its ghost rows exist only where a neighbouring band does: a band's grid
starts at the frame's row 0 or one tile above the band and ends one tile
below it or at the frame's last row. So the local grid clips a particle
above the frame into tile row 0 and one below it into the last tile row
exactly as the whole frame's grid does, and each band equals the whole
frame's raster of its rows (the JAX grid, a ghost row on both sides of
every band, shifts such a particle into the ghost row and cuts its
footprint at the ghost tile's window).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.coords import stipple_keep
from ..raster.tiled import TiledRasterConfig, rasterize_tiled
from .mesh import band_layout, band_rows, mesh_group

LANES = 8


def owners_used(cfg: TiledRasterConfig, n_devices: int) -> int:
    """The ranks that own at least one tile row (fewer than D when the
    frame has fewer tile rows than D has bands)."""
    gy = cfg.grid[0]
    band_tiles, _ = band_layout(cfg.height, cfg.tile, n_devices)
    return max(-(-gy // band_tiles), 1)


def send_budget(cfg: TiledRasterConfig, n_devices: int, n_loc: int,
                send_budget_factor: float = 3.0) -> int:
    """B, the slots each rank sends each owner: n_loc f / owners_used
    rounded up, at least 64 and at most 3 n_loc (parallel/raster.py:
    101-103)."""
    budget = max(int(math.ceil(n_loc * send_budget_factor
                               / owners_used(cfg, n_devices))), 64)
    return min(budget, 3 * n_loc)


def route(cfg: TiledRasterConfig, d: int, x, y, color, size, live,
          budget: int):
    """One rank's send buffers: x, y, color (n_loc, 4), size, live of its
    shard -> (lanes (D, B, 8) float32, counts (D,) int32 of the particles
    each owner should get, send_drops () int32 past the budget). Owner o's
    lanes hold its first min(count, B) particles in slot order, then
    zeros. A particle above or below the frame routes by its tile row
    clipped into the frame."""
    gy = cfg.grid[0]
    band_tiles, _ = band_layout(cfg.height, cfg.tile, d)
    n_loc = x.shape[0]
    a = cfg.apron + 1.0
    ok = live & (x > -a) & (x < cfg.width + a) & (y > -a) \
        & (y < cfg.height + a)
    ty = torch.clamp((y / cfg.tile).to(torch.int32), 0, gy - 1)
    o_mid = ty // band_tiles
    o_up = torch.clamp(ty - 1, min=0) // band_tiles
    o_dn = torch.clamp(ty + 1, max=gy - 1) // band_tiles
    none = torch.full_like(o_mid, d)  # sorts after every owner
    cands = torch.stack([
        torch.where(ok, o_mid, none),
        torch.where(ok & (o_up != o_mid), o_up, none),
        torch.where(ok & (o_dn != o_mid) & (o_dn != o_up), o_dn, none),
    ]).reshape(-1)
    keys, order = torch.sort(cands, stable=True)
    src = order % n_loc
    starts = torch.searchsorted(
        keys, torch.arange(d + 1, dtype=torch.int32, device=x.device))
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    send_drops = torch.clamp(counts - budget, min=0).sum().to(torch.int32)
    j = torch.arange(budget, device=x.device)
    valid = j[None, :] < counts[:, None]
    pick = src[torch.clamp(starts[:-1, None] + j[None, :], max=3 * n_loc - 1)]
    lanes = torch.cat([x[pick][..., None], y[pick][..., None],
                       size[pick][..., None],
                       torch.ones_like(x[pick])[..., None],
                       color[pick, :4]], dim=-1)
    lanes = torch.where(valid[..., None], lanes, 0.0)
    return lanes, counts, send_drops


def band_grid(cfg: TiledRasterConfig, d: int, rank: int):
    """(row_lo, local config) of rank's local grid: its band with a ghost
    tile row above and below where the frame has one, in whole tiles from
    row_lo."""
    band_tiles, _ = band_layout(cfg.height, cfg.tile, d)
    t_lo = max(rank * band_tiles - 1, 0)
    row_lo = t_lo * cfg.tile
    row_hi = min(((rank + 1) * band_tiles + 1) * cfg.tile, cfg.height)
    return row_lo, dataclasses.replace(cfg, height=max(row_hi - row_lo, 0))


def raster_band(cfg: TiledRasterConfig, d: int, rank: int, recv):
    """The band image (row1 - row0, W, C) of rank's rows (`band_rows`)
    from the (D B, 8) lanes it received: the local raster on its ghost-
    extended grid, cropped to the band. An empty band launches nothing."""
    row0, row1 = band_rows(cfg, d, rank)
    if row1 == row0:
        return torch.zeros((0, cfg.width, cfg.channels), dtype=torch.float32,
                           device=recv.device)
    row_lo, local = band_grid(cfg, d, rank)
    img, _ = rasterize_tiled(local, recv[:, 0], recv[:, 1] - float(row_lo),
                             recv[:, 4:8], recv[:, 2], recv[:, 3] > 0.5)
    return img[row0 - row_lo:row1 - row_lo]


def rasterize_tiled_sharded(mesh, cfg: TiledRasterConfig, x, y, color, size,
                            live, stipple_factor: float = 1.0,
                            send_budget_factor: float = 3.0):
    """`rasterize_tiled` over the mesh. x, y, color, size, live: the
    calling rank's capacity shard (N / D slots of a capacity N). Returns
    (its band (row1 - row0, W, C) of `mesh.row_band`'s rows, diagnostics)
    with the diagnostics of the JAX function as device tensors: "dropped"
    (bin drops, always 0 in the port's splat, plus the send drops, summed
    over the mesh), "send_dropped", "send_budget", "send_peak_fill" (the
    largest (source, owner) demand over B) and
    "suggested_send_budget_factor". On a mesh of one rank: the whole
    frame from `rasterize_tiled`, as in the JAX package."""
    import torch.distributed as dist

    d, rank = mesh.size(), mesh.get_local_rank()
    n_loc = x.shape[0]
    if not (isinstance(stipple_factor, (int, float)) and stipple_factor >= 1.0):
        # The stipple keys off the global slot index.
        live = live & stipple_keep(
            torch.arange(rank * n_loc, (rank + 1) * n_loc, device=x.device),
            stipple_factor, cfg.stipple_offset)
    if d == 1:
        return rasterize_tiled(cfg, x, y, color, size, live)
    budget = send_budget(cfg, d, n_loc, send_budget_factor)
    lanes, counts, send_drops = route(cfg, d, x, y, color, size, live, budget)
    group = mesh_group(mesh)
    recv = torch.empty_like(lanes).reshape(d * budget, LANES)
    dist.all_to_all_single(recv, lanes.reshape(d * budget, LANES),
                           group=group)
    img = raster_band(cfg, d, rank, recv)
    drops = send_drops.reshape(1).repeat(2)
    dist.all_reduce(drops, group=group)
    peak = counts.max().reshape(1)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    return img, diagnostics(cfg, d, n_loc, budget, drops[0], peak[0])


def diagnostics(cfg: TiledRasterConfig, d: int, n_loc: int, budget: int,
                send_dropped, peak) -> dict:
    """The JAX diagnostics from the mesh's summed send drops and its
    largest (source, owner) count."""
    peak_f = peak.to(torch.float32)
    return dict(
        dropped=send_dropped, send_dropped=send_dropped,
        send_budget=torch.tensor(budget, dtype=torch.int32,
                                 device=peak.device),
        send_peak_fill=peak_f / float(budget),
        # The factor that makes B equal this frame's peak, one slot of
        # slack for the rounding up.
        suggested_send_budget_factor=(peak_f + 1.0)
        * float(owners_used(cfg, d)) / float(n_loc))


def measure_send_budget_factor(mesh, cfg: TiledRasterConfig, x, y, live,
                               slack: float = 1.25) -> float:
    """The send_budget_factor that routes one representative frame's
    particles with `slack` headroom: the route alone (no raster, no
    exchange), its peak demand reduced over the mesh, read back as a
    Python float for the next build."""
    import torch.distributed as dist

    d, n_loc = mesh.size(), x.shape[0]
    zeros = torch.zeros((n_loc, 4), dtype=torch.float32, device=x.device)
    _, counts, _ = route(cfg, d, x, y, zeros, torch.ones_like(x), live,
                         send_budget(cfg, d, n_loc, float(d)))
    peak = counts.max().reshape(1)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=mesh_group(mesh))
    suggested = (peak.to(torch.float32) + 1.0) \
        * float(owners_used(cfg, d)) / float(n_loc)
    return float(suggested[0]) * slack
