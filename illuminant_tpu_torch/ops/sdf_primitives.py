"""Signed-distance primitives (the obstruction shape library).

Counterpart of illuminant_tpu/ops/sdf_primitives.py (vector forms):
iq's distance formulas from DistanceFunctionCommon.fxh — box, ellipsoid
improved-V2, capped cylinder, spheroid via elongation, octagon prism — with
the quaternion local rotation. `evaluate_by_type` computes every shape and
selects by type id; TYPE_NONE slots return 1e9 so padding is the identity
of the min that composes a scene. The planar (component-wise) forms, which
the analytic field evaluates, come with that field (ROADMAP M1).
"""

from __future__ import annotations

import torch

TYPE_NONE = 0
TYPE_ELLIPSOID = 1
TYPE_BOX = 2
TYPE_CYLINDER = 3
TYPE_SPHEROID = 4
TYPE_OCTAGON = 5

KNOWN_TYPES = (TYPE_ELLIPSOID, TYPE_BOX, TYPE_CYLINDER, TYPE_SPHEROID,
               TYPE_OCTAGON)

_NONE_DISTANCE = 1e9


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def rotate_by_quaternion(p, q):
    """Rotate vectors p (..., 3) by quaternions q (..., 4) (x, y, z, w):
    p + w * t + cross(q.xyz, t), t = 2 * cross(q.xyz, p)
    (DistanceFunctionCommon.fxh:23-26)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(qv, p)
    return p + w * t + _cross(qv, t)


def _length(v):
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-12)


def _op_elongate(p, h):
    """iq opElongate (fxh:43-46) -> (q (..., 3), w (...,))."""
    q = torch.abs(p) - h
    w = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return torch.sign(p) * torch.clamp(q, min=0.0), w


def sd_box(p, size):
    """Axis-aligned box of half-extents `size` (fxh:48-63)."""
    d = torch.abs(p) - size
    outside = _length(torch.clamp(d, min=0.0))
    inside = torch.clamp(torch.amax(d, dim=-1), max=0.0)
    return inside + outside


def sd_ellipsoid(p, r):
    """iq improved-V2 ellipsoid (fxh:92-99)."""
    k0 = _length(p / r)
    k1 = _length(p / (r * r))
    near = (k0 - 1.0) * torch.amin(r, dim=-1)
    far = k0 * (k0 - 1.0) / torch.clamp(k1, min=1e-12)
    return torch.where(k0 < 1.0, near, far)


def sd_spheroid(p, size):
    """Sphere of radius min(size) elongated to size (fxh:65-75)."""
    min_size = torch.amin(size, dim=-1, keepdim=True)
    q, w = _op_elongate(p, size - min_size)
    return w + (_length(q) - min_size[..., 0])


def sd_cylinder(p, size):
    """Capped cylinder: radius |size.xy|, half-height size.z
    (fxh:110-121)."""
    r = _length(size[..., :2])
    h = size[..., 2]
    d_xy = _length(p[..., :2]) - r
    d_z = torch.abs(p[..., 2]) - h
    d = torch.stack(torch.broadcast_tensors(d_xy, d_z), dim=-1)
    return (torch.clamp(torch.amax(d, dim=-1), max=0.0)
            + _length(torch.clamp(d, min=0.0)))


def _sd_octagon_prism(p, r, h):
    """iq octagon prism (fxh:139-152)."""
    kx = -0.9238795325
    ky = 0.3826834323
    kz = 0.4142135623
    p = torch.abs(p)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]

    m1 = 2.0 * torch.clamp(kx * px + ky * py, max=0.0)
    px = px - m1 * kx
    py = py - m1 * ky

    m2 = 2.0 * torch.clamp(-kx * px + ky * py, max=0.0)
    px = px - m2 * -kx
    py = py - m2 * ky

    px = px - torch.minimum(torch.maximum(px, -kz * r), kz * r)
    py = py - r
    dx = torch.sqrt(px * px + py * py) * torch.sign(py)
    dz = pz - h
    d = torch.stack(torch.broadcast_tensors(dx, dz), dim=-1)
    return (torch.clamp(torch.amax(d, dim=-1), max=0.0)
            + _length(torch.clamp(d, min=0.0)))


def sd_octagon(p, size):
    """Octagon prism elongated over xy (fxh:154-164)."""
    min_size = torch.minimum(size[..., 0], size[..., 1])
    elongation = torch.stack(
        [size[..., 0] - min_size, size[..., 1] - min_size,
         torch.zeros_like(min_size)], dim=-1)
    q, w = _op_elongate(p, elongation)
    return w + _sd_octagon_prism(q, min_size, size[..., 2])


def evaluate_by_type(type_id, world_position, center, size, rotation):
    """Branchless evaluateByTypeId (fxh:167-186).

    type_id (...,) int; world_position/center/size (..., 3); rotation
    (..., 4) quaternion (x, y, z, w). Broadcasts freely; TYPE_NONE slots
    return 1e9."""
    p = rotate_by_quaternion(world_position - center, rotation)

    d_ellipsoid = sd_ellipsoid(p, torch.clamp(size, min=1e-6))
    d_box = sd_box(p, size)
    d_cylinder = sd_cylinder(p, size)
    d_spheroid = sd_spheroid(p, size)
    d_octagon = sd_octagon(p, size)

    t = torch.abs(type_id)
    shape = torch.broadcast_shapes(t.shape, d_box.shape)
    result = torch.full(shape, _NONE_DISTANCE, dtype=torch.float32,
                        device=d_box.device)
    result = torch.where(t == TYPE_ELLIPSOID, d_ellipsoid, result)
    result = torch.where(t == TYPE_BOX, d_box, result)
    result = torch.where(t == TYPE_CYLINDER, d_cylinder, result)
    result = torch.where(t == TYPE_SPHEROID, d_spheroid, result)
    result = torch.where(t == TYPE_OCTAGON, d_octagon, result)
    return result


def scene_distance(world_position, types, centers, sizes, rotations):
    """Distance from points (..., 3) to the nearest of N obstructions:
    types (N,), centers/sizes (N, 3), rotations (N, 4). The min over
    obstructions is the reference's MAX blend over encoded distances
    (LightingRenderer.DistanceField.cs:361-372)."""
    d = evaluate_by_type(types, world_position[..., None, :], centers,
                         sizes, rotations)
    return torch.amin(d, dim=-1)
