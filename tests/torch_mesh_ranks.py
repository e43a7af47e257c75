"""Rank bodies of the port's multi-device tests, run by
`parallel.mesh.spawn_ranks` in processes of their own. This module imports
torch and the port only: the spawned ranks never load jax."""

import torch

from illuminant_tpu_torch.parallel import mesh as pmesh
from illuminant_tpu_torch.parallel.raster import (measure_send_budget_factor,
                                                  rasterize_tiled_sharded)
from illuminant_tpu_torch.scenes import build_flagship


def sharded_raster(mesh, cases):
    """rasterize_tiled_sharded of each case (cfg, x, y, color, size, live,
    kwargs) on this rank's shard -> [(band, diagnostics, rows, measured
    factor, the gathered frame)]."""
    torch.set_num_threads(1)
    out = []
    for cfg, x, y, color, size, live, kw in cases:
        shard = [pmesh.shard_particles(a, mesh)
                 for a in (x, y, color, size, live)]
        band, diag = rasterize_tiled_sharded(mesh, cfg, *shard, **kw)
        factor = measure_send_budget_factor(mesh, cfg, shard[0], shard[1],
                                            shard[4])
        whole = pmesh.gather_rows(mesh, band, cfg.height, cfg.tile)
        out.append((band, {k: v.clone() for k, v in diag.items()},
                    pmesh.row_band(mesh, cfg), factor, whole))
    return out


def mesh_frames(mesh, runs):
    """Each run (build_flagship kwargs, frames, spawn count, seed, first
    cursor): the mesh frame from the capacity shard of the empty state
    with its ring cursor there, the spawn draws from a generator seeded
    alike on every rank -> [(bands, the shard's final position, avg_lum
    per frame, dropped per frame, rows, the G-buffer's band: its z plane
    and pixel origin)]."""
    torch.set_num_threads(1)
    out = []
    for kw, frames, count, seed, cursor in runs:
        scene = build_flagship(mesh=mesh, device="cpu", **kw)
        state = pmesh.shard_particles(scene.system.state, mesh)
        state = state.replace(write_cursor=torch.tensor(cursor,
                                                        dtype=torch.int32))
        gen = torch.Generator().manual_seed(seed)
        avg = torch.tensor(0.5)
        env_u = scene.environment.uniforms(device="cpu")
        bands, avgs, drops = [], [], []
        for i in range(frames):
            band, state, avg, dropped = scene.frame(
                state, avg, gen, scene.volume, scene.gbuffer,
                scene.sphere_lights, env_u, count, frame_index=i)
            bands.append(band)
            avgs.append(float(avg))
            drops.append(int(dropped))
        gb = pmesh.shard_gbuffer(scene.gbuffer, mesh, scene.raster_config)
        out.append((bands, state.position.clone(), avgs, drops,
                    pmesh.row_band(mesh, scene.raster_config),
                    (gb.world_position(), gb.pixel_origin)))
    return out
