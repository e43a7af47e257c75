"""Entry points of the port (counterpart of __graft_entry__.py).

entry() -> (fn, example_args): the small flagship frame (multi-light SDF
lighting and a particle step, 128 x 256, 4,096 slots) as a function of the
particle state and a generator, on one device.

dryrun_multichip(n_devices) spawns n_devices ranks, builds the full-family
flagship on a mesh of them with one spawn sub-ring a rank, and runs one
frame of each rank's band at 16 n_devices x 128.
"""

from __future__ import annotations

import torch

from .parallel import mesh as pmesh
from .scenes import build_flagship


def _build(height, width, capacity, spawn_sub_rings=1, full_family=False,
           mesh=None, device="cuda"):
    return build_flagship(
        height=height, width=width, capacity=capacity, spawn_max=256,
        n_lights=4, spawn_sub_rings=spawn_sub_rings, full_family=full_family,
        bin_capacity=128, mesh=mesh, device=device)


def entry(device="cuda"):
    """(fn, (state, generator)): fn(state, generator) runs one frame of the
    small flagship on `device` (the card unless the caller asks for
    another) and returns (image, state, avg_lum, dropped)."""
    scene = _build(128, 256, 4096, device=device)
    env_u = scene.environment.uniforms(device=scene.device)

    def fn(state, generator):
        return scene.frame(state, 0.5, generator, scene.volume,
                           scene.gbuffer, scene.sphere_lights, env_u, 128)

    generator = torch.Generator(device=scene.device).manual_seed(0)
    return fn, (scene.system.state, generator)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One full-family mesh frame on `n_devices` new processes, one a
    device (gloo on "cpu"), each checked to return its row band of the
    16 n x 128 frame and the gathered frame."""
    bands = pmesh.spawn_ranks(_dryrun_rank, n_devices, device=device)
    assert [tuple(b.shape) for b in bands] == [(16 * n_devices, 128, 3)] \
        * n_devices, [b.shape for b in bands]
    assert all(torch.equal(b, bands[0]) for b in bands)


def _dryrun_rank(mesh):
    n = mesh.size()
    scene = _build(16 * n, 128, 128 * n, spawn_sub_rings=n,
                   full_family=True, mesh=mesh, device=mesh.device_type)
    state = pmesh.shard_particles(scene.system.state, mesh)
    gen = torch.Generator(device=scene.device).manual_seed(0)
    band, state, avg, dropped = scene.frame(
        state, 0.5, gen, scene.volume, scene.gbuffer, scene.sphere_lights,
        scene.environment.uniforms(device=scene.device), 64)
    row0, row1 = pmesh.row_band(mesh, scene.raster_config)
    assert band.shape == (row1 - row0, 128, 3), band.shape
    assert state.capacity == 128 and torch.isfinite(avg)
    return pmesh.gather_rows(mesh, band, 16 * n).cpu()
