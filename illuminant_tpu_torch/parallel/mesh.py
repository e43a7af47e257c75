"""The 1-D device mesh and the placement of a frame's inputs on it
(counterpart of illuminant_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` of one dimension,
named PIXEL_AXIS, over the default process group: one rank a device. JAX
places whole arrays with shardings; here every rank holds its own part,
so the helpers below return the calling rank's part:
  * `row_band`: the rank's rows of the frame, whole raster tiles
    (`band_layout`: ceil(tile rows / D) a rank, the last band shorter, a
    rank past the frame's last tile row owning none);
  * `shard_gbuffer`: those rows of every G-buffer plane;
  * `shard_particles`: the rank's slots [r N / D, (r + 1) N / D), the ring
    cursor and the spawn total replicated;
  * `replicate`: the whole value on the rank's device.
`gather_rows` and `gather_slots` assemble the whole frame or the whole
particle set on every rank; `reduce_histogram` sums a histogram's counts
over the mesh.
"""

from __future__ import annotations

import dataclasses
import os

import torch

PIXEL_AXIS = "px"
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices=None, device="cuda"):
    """The 1-D DeviceMesh over the default process group, one rank a
    device, on the card unless the caller asks for the CPU.

    If the default group is not yet initialized, a launcher's environment
    (`torchrun`: RANK, WORLD_SIZE, MASTER_ADDR, ...) initializes it; a
    single process without one gets a group of one over a local store.
    Under `mp.spawn` the caller initializes the group first and this uses
    it. On "cuda" the backend is NCCL and each rank's device is
    cuda:<local rank> (LOCAL_RANK, else the rank modulo the visible
    cards); a group of another backend is refused, never replaced. On
    "cpu" the backend is gloo. `n_devices` defaults to the world size and
    must equal it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', not {device!r}")
    backend = _BACKENDS[kind]
    if kind == "cuda":
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    elif backend not in dist.get_backend():
        raise RuntimeError(
            f"a {kind} mesh needs the {backend} backend; the default process "
            f"group runs {dist.get_backend()!r}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"the mesh spans the default process group: "
                         f"n_devices={n}, world size {world}")
    return DeviceMesh(kind, list(range(n)), mesh_dim_names=(PIXEL_AXIS,))


def check_mesh(mesh):
    """`mesh` as a 1-D DeviceMesh named (PIXEL_AXIS,), or a TypeError."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1 \
            or mesh.mesh_dim_names != (PIXEL_AXIS,):
        raise TypeError(f"expected a 1-D DeviceMesh named ({PIXEL_AXIS!r},) "
                        f"(make_mesh), got {mesh!r}")
    return mesh


def mesh_device(mesh) -> torch.device:
    """The calling rank's device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_group(mesh):
    return mesh.get_group(PIXEL_AXIS)


def band_layout(height: int, tile: int, n_devices: int):
    """(band_tiles, band_h): each rank's whole tile rows of a frame of
    `height` rows in tiles of `tile`, and their pixel rows."""
    gy = -(-height // tile)
    band_tiles = -(-gy // n_devices)
    return band_tiles, band_tiles * tile


def band_rows(cfg, n_devices: int, rank: int):
    """(row0, row1): rank's rows of the frame of raster config `cfg`,
    [r band_h, (r + 1) band_h) clamped to the frame (empty past its last
    tile row)."""
    _, band_h = band_layout(cfg.height, cfg.tile, n_devices)
    row0 = min(rank * band_h, cfg.height)
    return row0, min(row0 + band_h, cfg.height)


def row_band(mesh, cfg):
    """The calling rank's rows of the frame: (row0, row1)."""
    return band_rows(cfg, mesh.size(), mesh.get_local_rank())


def shard_gbuffer(gbuffer, mesh, cfg):
    """The rank's rows of every G-buffer plane, a window whose
    `pixel_origin` places it in the frame."""
    row0, row1 = row_band(mesh, cfg)
    g = replicate(gbuffer, mesh)
    return g.window(row0, 0, row1 - row0, g.shape[1])


def _map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def replicate(tree, mesh):
    """Every tensor of `tree` (a tensor, a tensor dataclass, nested tuples,
    lists and dicts) whole on the rank's device."""
    device = mesh_device(mesh)
    return _map(lambda t: t.to(device), tree)


def shard_particles(state, mesh):
    """The rank's slots of every (N, ...) plane of a particle state (or of
    one (N, ...) tensor); the 0-d cursor and total replicated. N must
    divide by the mesh size."""
    d, r = mesh.size(), mesh.get_local_rank()
    n = state.shape[0] if torch.is_tensor(state) else state.capacity
    if n % d:
        raise ValueError(f"capacity {n} does not divide by the mesh size {d}")
    lo, hi = r * (n // d), (r + 1) * (n // d)
    device = mesh_device(mesh)
    return _map(lambda t: (t[lo:hi] if t.ndim >= 1 else t).to(device),
                state)


def gather_slots(mesh, x):
    """The (N, ...) tensor of every rank's equal (N / D, ...) shard, in
    rank (global slot) order, on every rank: one all_gather."""
    import torch.distributed as dist

    x = x.contiguous()
    out = x.new_empty((mesh.size() * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh_group(mesh))
    return out


def gather_rows(mesh, band, height: int, tile: int = 32):
    """The whole (height, ...) image on every rank from each rank's row
    band (`row_band`'s rows of a frame of `height` rows in tiles of
    `tile`), each padded to a whole band for one all_gather and the
    result cropped to the frame."""
    _, band_h = band_layout(height, tile, mesh.size())
    pad = band.new_zeros((band_h - band.shape[0],) + tuple(band.shape[1:]))
    return gather_slots(mesh, torch.cat([band, pad]))[:height]


def reduce_histogram(result, mesh):
    """A histogram of the rank's pixels made the histogram of the whole
    frame on every rank: counts and sample counts summed, min and max
    reduced, the mean weighted by the sample counts."""
    import torch.distributed as dist

    group = mesh_group(mesh)
    ints = torch.cat([result.counts, result.sample_count.reshape(1)])
    dist.all_reduce(ints, group=group)
    ext = torch.stack([result.max, -result.min])
    dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=group)
    total = (result.mean * result.sample_count).reshape(1)
    dist.all_reduce(total, group=group)
    n = ints[-1]
    return result.replace(counts=ints[:-1], sample_count=n, max=ext[0],
                          min=-ext[1],
                          mean=total[0] / torch.clamp(n, min=1))


def spawn_ranks(fn, n_ranks: int, *args, device="cuda"):
    """Run fn(mesh, *args) in `n_ranks` new processes, one a rank (rank r
    on cuda:r on the card), over a process group that meets through a
    FileStore in a temporary directory: the single-host launcher of the
    dry run and the tests. `fn` must be importable by name (a module's
    function). -> the ranks' return values in rank order."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(n_ranks, tmp, fn, args, device),
                           nprocs=n_ranks, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]


def _rank_main(rank, n_ranks, tmp, fn, args, device):
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    dist.init_process_group(
        _BACKENDS[kind], store=dist.FileStore(os.path.join(tmp, "store"),
                                              n_ranks),
        rank=rank, world_size=n_ranks)
    try:
        out = fn(make_mesh(n_ranks, device), *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
