"""The 3D signed distance field volume.

Counterpart of illuminant_tpu/sdf/volume.py: a dense (S, H, W) float32
array of raw signed distances, slice-major. Slice s holds world
z = s * virtual_depth / slice_count + z_offset; texel (y, x) holds world
xy = ((x + 0.5) / scale_x, (y + 0.5) / scale_y)
(DistanceFieldCommon.fxh:303-353). The static/dynamic split of
DynamicDistanceField (DistanceField.cs:248-321) is two volumes combined by
an elementwise min. Incremental regeneration writes a budgeted number of
slices a frame (MaximumFieldUpdatesPerFrame, LightingRenderer.
Configuration.cs:87-91): `update_slices` with host-tracked validity (the
renderer's path) or `regenerate_invalid_budgeted` with a device-side mask.
Both return a new volume and leave the one they were given untouched, so
a caller's handle to an earlier field stays what it was. `save`/`load` use
the JAX package's .npz layout, so a field saved by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.pytree import tensor_dataclass
from ..ops import sdf_primitives

DISTANCE_ZERO = 192.0 / 255.0  # DistanceFieldCommon.fxh:8


@tensor_dataclass
class SdfObstructions:
    """SoA obstruction set (LightObstruction.cs:10-36), padded to N.

    types (N,) int32 (TYPE_NONE = inactive pad); centers, sizes (N, 3);
    rotations (N, 4) quaternions (x, y, z, w)."""

    types: torch.Tensor
    centers: torch.Tensor
    sizes: torch.Tensor
    rotations: torch.Tensor

    @staticmethod
    def empty(capacity: int, device="cuda") -> "SdfObstructions":
        """`capacity` inactive pads."""
        return SdfObstructions.from_lists([], [], [], capacity=capacity,
                                          device=device)

    @staticmethod
    def from_lists(types, centers, sizes, rotations=None, capacity=None,
                   device=None) -> "SdfObstructions":
        n = len(types)
        cap = capacity or max(n, 1)
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} obstructions")
        t = np.zeros((cap,), np.int32)
        c = np.zeros((cap, 3), np.float32)
        s = np.ones((cap, 3), np.float32)
        r = np.zeros((cap, 4), np.float32)
        r[:, 3] = 1.0
        if n:
            t[:n] = np.asarray(types, np.int32)
            c[:n] = np.asarray(centers, np.float32)
            s[:n] = np.asarray(sizes, np.float32)
            if rotations is not None:
                r[:n] = np.asarray(rotations, np.float32)
        return SdfObstructions(
            types=torch.as_tensor(t, device=device),
            centers=torch.as_tensor(c, device=device),
            sizes=torch.as_tensor(s, device=device),
            rotations=torch.as_tensor(r, device=device),
        )


@dataclasses.dataclass(frozen=True)
class SdfVolumeConfig:
    """Static field geometry (DistanceField.cs:38-109 minus atlas
    packing)."""

    virtual_width: int = 256
    virtual_height: int = 256
    virtual_depth: float = 128
    slice_count: int = 16
    resolution_scale: float = 0.25
    max_encoded_distance: float = 128.0
    z_offset: float = 0.0

    @property
    def slice_width(self) -> int:
        return max(1, int(round(self.virtual_width * self.resolution_scale)))

    @property
    def slice_height(self) -> int:
        return max(1, int(round(self.virtual_height
                                * self.resolution_scale)))

    @property
    def shape(self):
        return (self.slice_count, self.slice_height, self.slice_width)

    @property
    def scale_x(self) -> float:
        """Texels per world unit in x."""
        return self.slice_width / self.virtual_width

    @property
    def scale_y(self) -> float:
        return self.slice_height / self.virtual_height

    @property
    def slice_z_size(self) -> float:
        """World-z distance between slices."""
        return self.virtual_depth / self.slice_count


@tensor_dataclass
class SdfVolume:
    """data (S, H, W) float32 raw distances; max_valid_z () float32 —
    world z of the last generated slice, which sampling clamps to."""

    data: torch.Tensor
    max_valid_z: torch.Tensor
    config: SdfVolumeConfig = dataclasses.field(
        default_factory=SdfVolumeConfig)

    @staticmethod
    def empty(config: SdfVolumeConfig, device="cuda") -> "SdfVolume":
        """No slice generated yet: every distance at
        `max_encoded_distance`, max_valid_z 0."""
        return SdfVolume(
            data=torch.full(config.shape, config.max_encoded_distance,
                            dtype=torch.float32, device=device),
            max_valid_z=torch.tensor(0.0, dtype=torch.float32,
                                     device=device),
            config=config)


def _slices_at(config: SdfVolumeConfig, obstructions: SdfObstructions,
               slice_index: torch.Tensor) -> torch.Tensor:
    """The slices at `slice_index` ((s,) float32 slice numbers on the
    obstructions' device): every voxel evaluates every obstruction,
    min-reduced, then clamped to the band the reference's encoded Rgba64
    texture can represent, [-(63/255) m, (192/255) m]
    (DistanceFieldCommon.fxh:264-270) — deliberately asymmetric."""
    f32 = torch.float32
    device = obstructions.centers.device
    xs = (torch.arange(config.slice_width, dtype=f32, device=device)
          + 0.5) / config.scale_x
    ys = (torch.arange(config.slice_height, dtype=f32, device=device)
          + 0.5) / config.scale_y
    zs = slice_index * config.slice_z_size + config.z_offset
    z, y, x = torch.meshgrid(zs, ys, xs, indexing="ij")
    d = sdf_primitives.scene_distance(
        torch.stack([x, y, z], dim=-1), obstructions.types,
        obstructions.centers, obstructions.sizes, obstructions.rotations)
    m = config.max_encoded_distance
    return torch.clamp(d, -(63.0 / 255.0) * m, (192.0 / 255.0) * m)


def generate_slab(config: SdfVolumeConfig, obstructions: SdfObstructions,
                  slice_start: int, slice_count: int) -> torch.Tensor:
    """`slice_count` slices from `slice_start` -> (slice_count, H, W)."""
    return _slices_at(config, obstructions, torch.arange(
        slice_start, slice_start + slice_count, dtype=torch.float32,
        device=obstructions.centers.device))


def generate_volume(config: SdfVolumeConfig,
                    obstructions: SdfObstructions) -> SdfVolume:
    """The full field in one pass (all slices valid)."""
    data = generate_slab(config, obstructions, 0, config.slice_count)
    return SdfVolume(
        data=data,
        max_valid_z=torch.tensor(config.slice_count * config.slice_z_size,
                                 dtype=torch.float32, device=data.device),
        config=config,
    )


def update_slices(volume: SdfVolume, slice_start: int,
                  slab: torch.Tensor) -> SdfVolume:
    """A copy of `volume` with the regenerated `slab` (s, H, W) written at
    slice `slice_start`. The slab must fit: any start outside
    [0, S - s] raises (the JAX package's dynamic_update_slice clamps a
    traced start, which writes every slice a plane off). A tensor start is
    read to the host for that check."""
    start = int(slice_start)
    stop = start + slab.shape[0]
    if start < 0 or stop > volume.data.shape[0]:
        raise ValueError(f"slab [{start}, {stop}) out of range for "
                         f"{volume.data.shape[0]} slices")
    data = volume.data.clone()
    data[start:stop] = slab
    return volume.replace(data=data)


def _generate_slices_at(config: SdfVolumeConfig,
                        obstructions: SdfObstructions,
                        slice_index: torch.Tensor) -> torch.Tensor:
    """One slice (1, H, W) at a 0-d tensor index that stays on the device:
    the building block of the budgeted regeneration."""
    return _slices_at(config, obstructions,
                      slice_index.to(torch.float32).reshape(1))


def invalid_slices_for_bounds(config: SdfVolumeConfig,
                              obstructions: SdfObstructions,
                              band: float = 0.0) -> torch.Tensor:
    """Device-side slice invalidation (DistanceField.InvalidSlices,
    DistanceField.cs:13-16; marked by obstruction bounds in
    LightingRenderer.DistanceField.cs:415-462) -> (S,) bool.

    A slice is invalid when its world-z plane lies within an active
    obstruction's conservative radius (|size| covers every primitive under
    rotation) grown by `band`: how far out a moved surface must stay
    accurate. Pass the largest distance the frame consumes (a cone radius,
    a collision band), not max_encoded_distance. OR the masks of several
    frames to accumulate pending invalidations."""
    zs = (torch.arange(config.slice_count, dtype=torch.float32,
                       device=obstructions.centers.device)
          * config.slice_z_size + config.z_offset)
    active = obstructions.types != sdf_primitives.TYPE_NONE
    half = torch.sqrt(torch.sum(obstructions.sizes ** 2, dim=-1)) + band
    lo = obstructions.centers[:, 2] - half
    hi = obstructions.centers[:, 2] + half
    hit = ((zs[:, None] >= lo[None, :]) & (zs[:, None] <= hi[None, :])
           & active[None, :])
    return torch.any(hit, dim=1)


def regenerate_invalid_budgeted(volume: SdfVolume,
                                obstructions: SdfObstructions,
                                invalid: torch.Tensor, budget: int):
    """MaximumFieldUpdatesPerFrame (LightingRenderer.Configuration.cs:
    87-91; the slice queue of LightingRenderer.DistanceField.cs:415-462):
    regenerate up to `budget` invalid slices, lowest index first; the rest
    stay stale until a later call. -> (volume', invalid') with the
    regenerated slices cleared from the (S,) bool mask.

    The cost is budget * H * W * N evaluations whatever the mask holds, and
    no step reads the mask back to the host: the slice to write is a
    tensor index, and with nothing pending the slice at index 0 is
    rewritten with its own values."""
    lanes = torch.arange(volume.config.slice_count, device=invalid.device)
    data = volume.data.clone()
    for _ in range(budget):
        idx = torch.argmax(invalid.to(torch.int32))  # first pending, else 0
        present = torch.any(invalid)
        at = idx.reshape(1)
        slab = _generate_slices_at(volume.config, obstructions, idx)
        data.index_copy_(0, at, torch.where(present, slab,
                                            data.index_select(0, at)))
        invalid = invalid & (lanes != idx)
    return volume.replace(data=data), invalid


def combine_static_dynamic(static_volume: SdfVolume,
                           dynamic_volume: SdfVolume) -> SdfVolume:
    """DynamicDistanceField composition (DistanceField.cs:248-321): the
    closer surface of the static and dynamic obstruction sets."""
    return dynamic_volume.replace(
        data=torch.minimum(static_volume.data, dynamic_volume.data),
        max_valid_z=torch.minimum(static_volume.max_valid_z,
                                  dynamic_volume.max_valid_z),
    )


def encode_distance(d, max_encoded_distance):
    """DistanceFieldCommon.fxh:264-266."""
    return DISTANCE_ZERO - (d / max_encoded_distance)


def decode_distance(e, max_encoded_distance):
    """DistanceFieldCommon.fxh:268-270."""
    return (DISTANCE_ZERO - e) * max_encoded_distance


def save(volume: SdfVolume, path: str) -> None:
    """Save as .npz: raw float32 distances plus geometry, the JAX
    package's layout (geometry and params as float64)."""
    c = volume.config
    np.savez_compressed(
        path,
        data=volume.data.detach().cpu().numpy(),
        max_valid_z=volume.max_valid_z.detach().cpu().numpy(),
        geometry=np.asarray([c.virtual_width, c.virtual_height,
                             c.virtual_depth, c.slice_count], np.float64),
        params=np.asarray([c.resolution_scale, c.max_encoded_distance,
                           c.z_offset], np.float64),
    )


def load(path: str, device=None) -> SdfVolume:
    """Load a field written by `save` here or in the JAX package."""
    # np.savez_compressed appends '.npz' to a path without it.
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as f:
        geo = f["geometry"]
        par = f["params"]
        depth = float(geo[2])
        config = SdfVolumeConfig(
            virtual_width=int(geo[0]),
            virtual_height=int(geo[1]),
            virtual_depth=int(depth) if depth == int(depth) else depth,
            slice_count=int(geo[3]),
            resolution_scale=float(par[0]),
            max_encoded_distance=float(par[1]),
            z_offset=float(par[2]),
        )
        data = f["data"]
        if tuple(data.shape) != config.shape:
            raise ValueError(
                f"field data shape {tuple(data.shape)} does not match the "
                f"geometry-derived {config.shape}")
        return SdfVolume(
            data=torch.as_tensor(data, dtype=torch.float32, device=device),
            max_valid_z=torch.as_tensor(f["max_valid_z"],
                                        dtype=torch.float32, device=device),
            config=config,
        )
