"""Analytic SDF scene and the field query dispatch.

Counterpart of illuminant_tpu/sdf/analytic.py:
  * `pack_scene` / `AnalyticScene`: obstructions grouped by type in sorted
    type order, each group's live count a static Python int. The field is
    evaluated in closed form at every query point: `distance_p` unrolls
    over the live primitives (pad slots, which sit at 1e9, are never
    evaluated) and switches to one batched evaluation per group above
    `_UNROLL_LIMIT` primitives. Obstruction-flagged height volumes ride
    along as `polygons` and join the min as extruded polygon distances.
    `normal_p` is the autograd gradient, `normal_fast_p` the closed-form
    normal of the nearest primitive (the autograd one when the scene has
    polygons).
  * The uniform query interface over `AnalyticScene`, `ColumnField` and
    `SdfVolume`: `scene_sample`, `scene_normal`, `scene_sample_p`,
    `scene_sample_grad_p`, `scene_normal_p`. Separable grid queries (the
    occlusion image) on a voxel field go to the exact
    `sampling.sample_grid`, never to the column kernel; scattered queries
    on a ColumnField go to the fused column query (`columns.query`), one
    launch each on the card.
  * `scene_column_images`: closed-form column-interval images of the
    scene on a pixel-center grid, which the opt-in `carried_all` scan
    refine carries (lighting/scan_shadows.py).
Not ported: the TPU dispatch gates `set_interp_dispatch` / `_use_interp`
(the port has no MXU interpolation path to gate).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.pytree import tensor_dataclass
from ..ops import sdf_primitives as sp
from . import sampling
from .columns import ColumnField, query as column_query, sample_columns
from .height_volume import (HeightVolumes, extruded_polygon_distance_p,
                            pack_height_volumes)
from .volume import SdfVolume

_FAR = 1e9


@tensor_dataclass
class AnalyticScene:
    """Type-grouped obstruction SoA: per group (n, 3) centers and sizes and
    (n, 4) rotations, with static (type, rotated, live count) per group;
    `polygons`: the packed obstruction-flagged height volumes, or None."""

    centers: Tuple[torch.Tensor, ...]
    sizes: Tuple[torch.Tensor, ...]
    rotations: Tuple[torch.Tensor, ...]
    polygons: Optional[HeightVolumes] = None
    group_types: Tuple[int, ...] = ()
    group_rotated: Tuple[bool, ...] = ()
    maximum_distance: float = 128.0
    # Live obstructions per group, pad slots excluded; empty means all.
    group_counts: Tuple[int, ...] = ()

    # Above this many live primitives the per-primitive unroll gives way to
    # one batched evaluation per group.
    _UNROLL_LIMIT = 64

    def _counts(self):
        if self.group_counts:
            return self.group_counts
        return tuple(int(c.shape[0]) for c in self.centers)

    def _primitives(self, x, y, z):
        """Yield (group type, local px, py, pz, sx, sy, sz, quaternion or
        None) for every live primitive, the query shifted to its center
        and rotated into its frame."""
        counts = self._counts()
        for gi, type_id in enumerate(self.group_types):
            c, s, q = self.centers[gi], self.sizes[gi], self.rotations[gi]
            for i in range(counts[gi]):
                px, py, pz = x - c[i, 0], y - c[i, 1], z - c[i, 2]
                qi = None
                if self.group_rotated[gi]:
                    qi = (q[i, 0], q[i, 1], q[i, 2], q[i, 3])
                    px, py, pz = sp.rotate_by_quaternion_p(px, py, pz, *qi)
                yield type_id, px, py, pz, s[i, 0], s[i, 1], s[i, 2], qi

    def distance(self, position):
        """Scene distance at (..., 3) points -> (...,)."""
        return self.distance_p(position[..., 0], position[..., 1],
                               position[..., 2])

    def distance_p(self, x, y, z):
        """Planar scene distance: x, y, z broadcastable tensors -> the
        distance of their broadcast shape, the min over all live
        primitives, the extruded polygons and `maximum_distance` (the
        reference's MAX blend over encoded distances, fxh:264-270)."""
        if sum(self._counts()) > self._UNROLL_LIMIT:
            return self._distance_vectorized(x, y, z)
        d = torch.full(_broadcast_shape(x, y, z), self.maximum_distance,
                       dtype=torch.float32, device=x.device)
        for type_id, px, py, pz, sx, sy, sz, _ in self._primitives(x, y, z):
            d = torch.minimum(
                d, sp.PLANAR_EVALUATORS[type_id](px, py, pz, sx, sy, sz))
        return self._with_polygons(d, x, y, z)

    def _with_polygons(self, d, x, y, z):
        if self.polygons is None:
            return d

        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=d.device)

        return torch.minimum(d, extruded_polygon_distance_p(
            f32(x), f32(y), f32(z), self.polygons))

    def _distance_vectorized(self, x, y, z):
        """One (..., n) evaluation per group, every slot of the group
        (the JAX package's many-primitive path evaluates pad slots too)."""
        position = _stack_p(x, y, z)
        d = torch.full(position.shape[:-1], self.maximum_distance,
                       dtype=torch.float32, device=x.device)
        for gi, type_id in enumerate(self.group_types):
            p = position[..., None, :] - self.centers[gi]
            if self.group_rotated[gi]:
                p = sp.rotate_by_quaternion(p, self.rotations[gi])
            dg = _EVALUATORS[type_id](p, self.sizes[gi])
            d = torch.minimum(d, torch.amin(dg, dim=-1))
        return self._with_polygons(d, x, y, z)

    def normal_p(self, x, y, z):
        """Planar field gradient by autograd -> unit (nx, ny, nz), zero
        where the gradient vanishes. Runs under grad mode whatever the
        caller's mode and returns detached tensors."""
        with torch.inference_mode(False), torch.enable_grad():
            xg, yg, zg = (v.detach().clone().requires_grad_(True)
                          for v in (x, y, z))
            d = self.distance_p(xg, yg, zg)
            gx, gy, gz = torch.autograd.grad(d, (xg, yg, zg),
                                             torch.ones_like(d),
                                             allow_unused=True)
        gx, gy, gz = (torch.zeros_like(v) if g is None else g.detach()
                      for g, v in ((gx, x), (gy, y), (gz, z)))
        gx, gy, gz = torch.broadcast_tensors(gx, gy, gz)
        norm = torch.sqrt(gx * gx + gy * gy + gz * gz)
        ok = norm > 1e-9
        safe = torch.clamp(norm, min=1e-9)
        return (torch.where(ok, gx / safe, 0.0),
                torch.where(ok, gy / safe, 0.0),
                torch.where(ok, gz / safe, 0.0))

    def normal_fast_p(self, x, y, z):
        """Closed-form normal of the nearest primitive (strictly nearer
        than `maximum_distance` and than every earlier primitive; (0, 0, 0)
        beyond it). Above `_UNROLL_LIMIT` primitives: central differences
        of the batched distance, step 0.05. A scene with polygons has no
        closed form and takes the autograd gradient."""
        if self.polygons is not None:
            return self.normal_p(x, y, z)
        if sum(self._counts()) > self._UNROLL_LIMIT:
            eps = 0.05
            dist = self._distance_vectorized
            gx = dist(x + eps, y, z) - dist(x - eps, y, z)
            gy = dist(x, y + eps, z) - dist(x, y - eps, z)
            gz = dist(x, y, z + eps) - dist(x, y, z - eps)
            inv = 1.0 / torch.sqrt(gx * gx + gy * gy + gz * gz + 1e-12)
            return gx * inv, gy * inv, gz * inv
        shape = _broadcast_shape(x, y, z)
        best = torch.full(shape, self.maximum_distance, dtype=torch.float32,
                          device=x.device)
        nx = torch.zeros(shape, dtype=torch.float32, device=x.device)
        ny = torch.zeros_like(nx)
        nz = torch.zeros_like(nx)
        for type_id, px, py, pz, sx, sy, sz, q in self._primitives(x, y, z):
            d = sp.PLANAR_EVALUATORS[type_id](px, py, pz, sx, sy, sz)
            inx, iny, inz = sp.PLANAR_NORMALS[type_id](px, py, pz, sx, sy,
                                                       sz)
            if q is not None:
                inx, iny, inz = sp.rotate_by_quaternion_inverse_p(
                    inx, iny, inz, *q)
            closer = d < best
            nx = torch.where(closer, inx, nx)
            ny = torch.where(closer, iny, ny)
            nz = torch.where(closer, inz, nz)
            best = torch.minimum(best, d)
        return nx, ny, nz

    def estimate_normal(self, position):
        """The autograd field gradient at (..., 3) points -> (..., 3)."""
        return torch.stack(self.normal_p(position[..., 0], position[..., 1],
                                         position[..., 2]), dim=-1)


_EVALUATORS = {
    sp.TYPE_ELLIPSOID: sp.sd_ellipsoid,
    sp.TYPE_BOX: sp.sd_box,
    sp.TYPE_CYLINDER: sp.sd_cylinder,
    sp.TYPE_SPHEROID: sp.sd_spheroid,
    sp.TYPE_OCTAGON: sp.sd_octagon,
}


def _broadcast_shape(x, y, z):
    return torch.broadcast_shapes(x.shape, torch.as_tensor(y).shape,
                                  torch.as_tensor(z).shape)


def _is_identity_rotation(q) -> bool:
    return abs(q[0]) < 1e-9 and abs(q[1]) < 1e-9 and abs(q[2]) < 1e-9


def pack_scene(obstructions: List, maximum_distance: float = 128.0,
               group_capacity_round: int = 2,
               height_volumes: Optional[List] = None,
               device="cuda") -> AnalyticScene:
    """Group host obstructions (.type/.center/.size/.rotation) by type,
    each group padded to a multiple of `group_capacity_round` with far
    unit boxes (illuminant_tpu/sdf/analytic.py:pack_scene).
    `height_volumes`: a list of sdf.height_volume.HeightVolume; those
    flagged `is_obstruction` join the field as extruded polygons."""
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
    obstructing = [v for v in height_volumes or () if v.is_obstruction]
    polygons = (pack_height_volumes(obstructing, device=device)
                if obstructing else None)
    return AnalyticScene(
        centers=tuple(centers), sizes=tuple(sizes),
        rotations=tuple(rotations), polygons=polygons,
        group_types=tuple(group_types),
        group_rotated=tuple(group_rotated),
        maximum_distance=maximum_distance, group_counts=tuple(group_counts))


def _unsupported(field):
    return TypeError(f"unsupported field {type(field).__name__}")


def _stack_p(x, y, z):
    """Broadcast planar components (x a tensor; y, z tensors or
    scalars) into (..., 3) positions."""
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device)

    return torch.stack(torch.broadcast_tensors(x, f32(y), f32(z)), dim=-1)


def scene_sample(field, position):
    """Distance at world positions (..., 3): AnalyticScene -> closed form;
    ColumnField -> column reconstruction (the kernel); SdfVolume -> exact
    trilinear; None -> 128 (no field)."""
    if field is None:
        return torch.full(position.shape[:-1], 128.0, dtype=torch.float32,
                          device=position.device)
    if isinstance(field, AnalyticScene):
        return field.distance(position)
    if isinstance(field, ColumnField):
        return sample_columns(field, position)
    if isinstance(field, SdfVolume):
        return sampling.sample(field, position)
    raise _unsupported(field)


def scene_normal(field, position):
    """Unit normal at world positions (..., 3) -> (..., 3): the autograd
    gradient of an AnalyticScene; the tetrahedral estimate of the exact
    volume for a voxel field (through a ColumnField too); +z with no
    field."""
    if field is None:
        return torch.tensor([0.0, 0.0, 1.0], device=position.device).expand(
            position.shape)
    if isinstance(field, AnalyticScene):
        return field.estimate_normal(position)
    if isinstance(field, ColumnField):
        field = field.volume
    if isinstance(field, SdfVolume):
        return sampling.estimate_normal(field, position)
    raise _unsupported(field)


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
    shape out. An AnalyticScene evaluates the components directly;
    separable grids on a voxel field take the exact grid resample of the
    volume — also through a ColumnField."""
    if isinstance(field, AnalyticScene):
        return field.distance_p(x, y, z)
    vol_field = field.volume if isinstance(field, ColumnField) else field
    if isinstance(vol_field, SdfVolume) and _separable_grid(x, y):
        return sampling.sample_grid(vol_field, x.reshape(-1), y.reshape(-1),
                                    z)
    if isinstance(field, ColumnField):
        return column_query(field, x, y, z)
    return scene_sample(field, _stack_p(x, y, z))


def scene_sample_grad_p(field, x, y, z):
    """Distance and normalized gradient at the same points for a
    ColumnField (one launch of the fused query), or None for fields
    without a fused path (an AnalyticScene keeps its closed-form
    normals)."""
    if not isinstance(field, ColumnField):
        return None
    return column_query(field, x, y, z, want_grad=True, normalize=True)


def scene_column_images(field: AnalyticScene, nh: int, nw: int, nscale):
    """Closed-form column-interval images (h_top, h_bot, footprint) of an
    analytic scene on an (nh, nw) pixel-center grid (centers at
    (i + 0.5) / nscale world units, the convention of
    `columns.resample_map_to_grid`), or None when the scene has content
    without a column form: rotated groups, polygons, no primitive, or
    more than the unroll limit (illuminant_tpu/sdf/analytic.py:461-600).

    Boxes, cylinders and octagon prisms are z-extruded ([cz - sz,
    cz + sz]); ellipsoids and spheroids take per-column caps from their
    cross-section. Overlapping columns merge into one interval (min
    bottom, max top); an empty column carries the footprint-nearest
    primitive's interval. The footprint image is the min over the
    primitives of their centre-plane cross-section distance. The JAX
    package's `world_offset` is left out: a windowed scan keeps the exact
    refine and never asks for column images (lighting/scan_shadows.py)."""
    counts = field._counts()
    if sum(counts) == 0 or sum(counts) > field._UNROLL_LIMIT:
        return None
    if field.polygons is not None or any(field.group_rotated):
        return None
    if any(t not in sp.KNOWN_TYPES for t in field.group_types):
        return None
    f32 = torch.float32
    dev = field.centers[0].device
    xs = (torch.arange(nw, dtype=f32, device=dev) + 0.5) / nscale
    ys = (torch.arange(nh, dtype=f32, device=dev) + 0.5) / nscale
    xg = xs[None, :]
    yg = ys[:, None]

    big_h = 4096.0  # the neutral fill of scan_shadows._upsample_nominated
    t_occ = torch.full((nh, nw), -big_h, dtype=f32, device=dev)
    b_occ = torch.full((nh, nw), big_h, dtype=f32, device=dev)
    best_f = torch.full((nh, nw), _FAR, dtype=f32, device=dev)
    best_t = torch.full((nh, nw), big_h, dtype=f32, device=dev)
    best_b = torch.full((nh, nw), -big_h, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    for gi, type_id in enumerate(field.group_types):
        centers, sizes = field.centers[gi], field.sizes[gi]
        fn = sp.PLANAR_EVALUATORS[type_id]
        for i in range(counts[gi]):
            px = xg - centers[i, 0]
            py = yg - centers[i, 1]
            sx, sy, sz = sizes[i, 0], sizes[i, 1], sizes[i, 2]
            # The footprint: the cross-section at the centre plane.
            f2 = fn(px, py, zero, sx, sy, sz)
            cz = centers[i, 2]
            if type_id in (sp.TYPE_BOX, sp.TYPE_CYLINDER, sp.TYPE_OCTAGON):
                half = sz.expand(f2.shape)
            elif type_id == sp.TYPE_ELLIPSOID:
                sxs = torch.clamp(sx, min=1e-6)
                sys_ = torch.clamp(sy, min=1e-6)
                rr = (px / sxs) ** 2 + (py / sys_) ** 2
                half = sz * torch.sqrt(torch.clamp(1.0 - rr, min=0.0))
            else:  # spheroid: a rounded box's cross-section along z
                ms = torch.minimum(sx, torch.minimum(sy, sz))
                ax = torch.clamp(torch.abs(px) - (sx - ms), min=0.0)
                ay = torch.clamp(torch.abs(py) - (sy - ms), min=0.0)
                half = (sz - ms) + torch.sqrt(
                    torch.clamp(ms * ms - (ax * ax + ay * ay), min=0.0))
            occupied = f2 < 0.0
            ti = cz + half
            bi = cz - half
            t_occ = torch.where(occupied, torch.maximum(t_occ, ti), t_occ)
            b_occ = torch.where(occupied, torch.minimum(b_occ, bi), b_occ)
            nearer = f2 < best_f
            best_t = torch.where(nearer, ti, best_t)
            best_b = torch.where(nearer, bi, best_b)
            best_f = torch.minimum(best_f, f2)
    any_occ = t_occ > -big_h
    return (torch.where(any_occ, t_occ, best_t),
            torch.where(any_occ, b_occ, best_b), best_f)


def scene_normal_p(field, x, y, z, fast: bool = False):
    """Planar normal query -> (nx, ny, nz). `fast` selects the collision
    normal: the nearest primitive's closed form on an AnalyticScene, the
    column reconstruction's own gradient on a ColumnField. Otherwise
    `scene_normal`."""
    if isinstance(field, AnalyticScene):
        return field.normal_fast_p(x, y, z) if fast else \
            field.normal_p(x, y, z)
    if fast and isinstance(field, ColumnField):
        return column_query(field, x, y, z, want_grad=True,
                            normalize=True)[1:]
    n = scene_normal(field, _stack_p(x, y, z))
    return n[..., 0], n[..., 1], n[..., 2]
