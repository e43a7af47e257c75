"""Analytic SDF scene data and the field query dispatch.

Counterpart of illuminant_tpu/sdf/analytic.py, as far as the voxel frame
uses it:
  * `pack_scene` / `AnalyticScene` as data: obstructions grouped by type in
    sorted type order. The voxel frame reads `group_types` to key each
    dynamic occluder's orbit frequency. Evaluating the analytic field
    (`distance_p`, normals) comes with the analytic frame (ROADMAP M1).
  * The uniform query interface over `ColumnField` and `SdfVolume`:
    `scene_sample`, `scene_sample_p`, `scene_sample_grad_p`,
    `scene_normal_p`. Separable grid queries (the occlusion image) go to
    the exact `sampling.sample_grid`, never to the column kernel;
    scattered queries on a ColumnField go to the kernel.
The TPU dispatch gates `set_interp_dispatch` / `_use_interp` are not
ported: the port has no MXU interpolation path to gate.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.pytree import tensor_dataclass
from ..ops import sdf_primitives as sp
from . import sampling
from .columns import ColumnField, sample_columns, sample_columns_grad
from .volume import SdfVolume

_FAR = 1e9


@tensor_dataclass
class AnalyticScene:
    """Type-grouped obstruction SoA: per group (n, 3) centers and sizes and
    (n, 4) rotations, with static (type, rotated, live count) per group."""

    centers: Tuple[torch.Tensor, ...]
    sizes: Tuple[torch.Tensor, ...]
    rotations: Tuple[torch.Tensor, ...]
    group_types: Tuple[int, ...] = ()
    group_rotated: Tuple[bool, ...] = ()
    maximum_distance: float = 128.0
    group_counts: Tuple[int, ...] = ()


def _is_identity_rotation(q) -> bool:
    return abs(q[0]) < 1e-9 and abs(q[1]) < 1e-9 and abs(q[2]) < 1e-9


def pack_scene(obstructions: List, maximum_distance: float = 128.0,
               group_capacity_round: int = 2, device=None) -> AnalyticScene:
    """Group host obstructions (.type/.center/.size/.rotation) by type,
    each group padded to a multiple of `group_capacity_round` with far
    unit boxes (illuminant_tpu/sdf/analytic.py:pack_scene)."""
    by_type: Dict[int, list] = {}
    for o in obstructions:
        if o.type == sp.TYPE_NONE:
            continue
        tid = abs(o.type)
        if tid not in sp.KNOWN_TYPES:
            raise ValueError(f"unknown obstruction type {o.type!r} (known: "
                             f"{sorted(sp.KNOWN_TYPES)})")
        by_type.setdefault(tid, []).append(o)

    centers, sizes, rotations = [], [], []
    group_types, group_rotated, group_counts = [], [], []
    for type_id in sorted(by_type):
        group = by_type[type_id]
        n = len(group)
        cap = -(-n // group_capacity_round) * group_capacity_round
        c = np.full((cap, 3), _FAR, np.float32)
        s = np.ones((cap, 3), np.float32)
        r = np.zeros((cap, 4), np.float32)
        r[:, 3] = 1.0
        rotated = False
        for i, o in enumerate(group):
            c[i] = o.center
            s[i] = np.maximum(np.asarray(o.size, np.float32), 1e-6)
            r[i] = o.rotation
            rotated = rotated or not _is_identity_rotation(o.rotation)
        group_types.append(type_id)
        group_rotated.append(rotated)
        group_counts.append(n)
        centers.append(torch.as_tensor(c, device=device))
        sizes.append(torch.as_tensor(s, device=device))
        rotations.append(torch.as_tensor(r, device=device))
    return AnalyticScene(
        centers=tuple(centers), sizes=tuple(sizes),
        rotations=tuple(rotations), group_types=tuple(group_types),
        group_rotated=tuple(group_rotated),
        maximum_distance=maximum_distance, group_counts=tuple(group_counts))


def _unported(field):
    if isinstance(field, AnalyticScene):
        return NotImplementedError(
            "analytic field evaluation is not ported yet (ROADMAP M1)")
    return TypeError(f"unsupported field {type(field).__name__}")


def _stack_p(x, y, z):
    """Broadcast planar components (x a tensor; y, z tensors or
    scalars) into (..., 3) positions."""
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device)

    return torch.stack(torch.broadcast_tensors(x, f32(y), f32(z)), dim=-1)


def scene_sample(field, position):
    """Distance at world positions (..., 3): ColumnField -> column
    reconstruction (the kernel); SdfVolume -> exact trilinear; None ->
    128 (no field)."""
    if field is None:
        return torch.full(position.shape[:-1], 128.0, dtype=torch.float32,
                          device=position.device)
    if isinstance(field, ColumnField):
        return sample_columns(field, position)
    if isinstance(field, SdfVolume):
        return sampling.sample(field, position)
    raise _unported(field)


def _separable_grid(x, y) -> bool:
    """By shape: x varies only along the last axis and y only along the
    second-to-last — the occlusion image's planar grid query."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    if len(ys) < 2:
        return False
    x_ok = len(xs) >= 1 and all(d == 1 for d in xs[:-1])
    y_ok = ys[-1] == 1 and all(d == 1 for d in ys[:-2])
    return x_ok and y_ok


def scene_sample_p(field, x, y, z):
    """Planar query: component arrays in, distance of their broadcast
    shape out. Separable grids on a voxel field take the exact grid
    resample of the volume — also through a ColumnField."""
    vol_field = field.volume if isinstance(field, ColumnField) else field
    if isinstance(vol_field, SdfVolume) and _separable_grid(x, y):
        return sampling.sample_grid(vol_field, x.reshape(-1), y.reshape(-1),
                                    z)
    return scene_sample(field, _stack_p(x, y, z))


def scene_sample_grad_p(field, x, y, z):
    """Distance and normalized gradient at the same points for a
    ColumnField (one kernel launch with the gradient rows), or None for
    fields without a fused path."""
    if not isinstance(field, ColumnField):
        return None
    d, g = sample_columns_grad(field, _stack_p(x, y, z))
    gx, gy, gz = _normalized(g)
    return d, gx, gy, gz


def _normalized(g):
    norm = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
    g = torch.where(norm > 1e-9, g / torch.clamp(norm, min=1e-9),
                    torch.zeros_like(g))
    return g[..., 0], g[..., 1], g[..., 2]


def scene_normal_p(field, x, y, z, fast: bool = False):
    """Planar normal query -> (nx, ny, nz). On a ColumnField `fast` takes
    the column reconstruction's own gradient (the collision normal);
    otherwise the tetrahedral estimate of the exact volume."""
    pos = _stack_p(x, y, z)
    if isinstance(field, ColumnField):
        if fast:
            _, g = sample_columns_grad(field, pos)
            return _normalized(g)
        field = field.volume
    if isinstance(field, SdfVolume):
        n = sampling.estimate_normal(field, pos)
        return n[..., 0], n[..., 1], n[..., 2]
    raise _unported(field)
