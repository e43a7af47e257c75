"""Signed-distance primitives (the obstruction shape library).

Counterpart of illuminant_tpu/ops/sdf_primitives.py: iq's distance
formulas from DistanceFunctionCommon.fxh — box, ellipsoid improved-V2,
capped cylinder, spheroid via elongation, octagon prism — with the
quaternion local rotation.
  * Vector forms take (..., 3) points. `evaluate_by_type` computes every
    shape and selects by type id; TYPE_NONE slots return 1e9 so padding is
    the identity of the min that composes a scene.
  * Planar forms (`*_p`) take x, y, z as separate broadcastable tensors
    and the extents as tensors that broadcast with them (0-d for one
    primitive): the analytic field evaluates them one primitive at a
    time. `nrm_*_p` are their closed-form field gradients (the collision
    normals).
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


# --- Planar (component-wise) forms: the same math as the vector forms. ----


def rotate_by_quaternion_p(px, py, pz, qx, qy, qz, qw):
    """Planar rotateLocalPosition (DistanceFunctionCommon.fxh:23-26)."""
    tx = 2.0 * (qy * pz - qz * py)
    ty = 2.0 * (qz * px - qx * pz)
    tz = 2.0 * (qx * py - qy * px)
    ox = px + qw * tx + (qy * tz - qz * ty)
    oy = py + qw * ty + (qz * tx - qx * tz)
    oz = pz + qw * tz + (qx * ty - qy * tx)
    return ox, oy, oz


def rotate_by_quaternion_inverse_p(px, py, pz, qx, qy, qz, qw):
    """Rotate planar vectors by the conjugate quaternion (local -> world)."""
    return rotate_by_quaternion_p(px, py, pz, -qx, -qy, -qz, qw)


def _len3_p(x, y, z):
    return torch.sqrt(x * x + y * y + z * z + 1e-12)


def _len2_p(x, y):
    return torch.sqrt(x * x + y * y + 1e-12)


def sd_box_p(px, py, pz, sx, sy, sz):
    """Planar sd_box (fxh:48-63)."""
    dx = torch.abs(px) - sx
    dy = torch.abs(py) - sy
    dz = torch.abs(pz) - sz
    inside = torch.clamp(torch.maximum(dx, torch.maximum(dy, dz)), max=0.0)
    outside = _len3_p(torch.clamp(dx, min=0.0), torch.clamp(dy, min=0.0),
                      torch.clamp(dz, min=0.0))
    return inside + outside


def sd_ellipsoid_p(px, py, pz, sx, sy, sz):
    """Planar iq improved-V2 ellipsoid (fxh:92-99)."""
    sx = torch.clamp(sx, min=1e-6)
    sy = torch.clamp(sy, min=1e-6)
    sz = torch.clamp(sz, min=1e-6)
    k0 = _len3_p(px / sx, py / sy, pz / sz)
    k1 = _len3_p(px / (sx * sx), py / (sy * sy), pz / (sz * sz))
    rmin = torch.minimum(sx, torch.minimum(sy, sz))
    near = (k0 - 1.0) * rmin
    far = k0 * (k0 - 1.0) / torch.clamp(k1, min=1e-12)
    return torch.where(k0 < 1.0, near, far)


def _elongate_p(px, py, pz, hx, hy, hz):
    """Planar opElongate (fxh:43-46) -> (qx, qy, qz, w)."""
    ax = torch.abs(px) - hx
    ay = torch.abs(py) - hy
    az = torch.abs(pz) - hz
    w = torch.clamp(torch.maximum(ax, torch.maximum(ay, az)), max=0.0)
    qx = torch.sign(px) * torch.clamp(ax, min=0.0)
    qy = torch.sign(py) * torch.clamp(ay, min=0.0)
    qz = torch.sign(pz) * torch.clamp(az, min=0.0)
    return qx, qy, qz, w


def sd_spheroid_p(px, py, pz, sx, sy, sz):
    """Planar spheroid (fxh:65-75)."""
    ms = torch.minimum(sx, torch.minimum(sy, sz))
    qx, qy, qz, w = _elongate_p(px, py, pz, sx - ms, sy - ms, sz - ms)
    return w + (_len3_p(qx, qy, qz) - ms)


def sd_cylinder_p(px, py, pz, sx, sy, sz):
    """Planar capped cylinder (fxh:110-121)."""
    r = _len2_p(sx, sy)
    d_xy = _len2_p(px, py) - r
    d_z = torch.abs(pz) - sz
    inside = torch.clamp(torch.maximum(d_xy, d_z), max=0.0)
    outside = _len2_p(torch.clamp(d_xy, min=0.0), torch.clamp(d_z, min=0.0))
    return inside + outside


def sd_octagon_p(px, py, pz, sx, sy, sz):
    """Planar octagon prism elongated over xy (fxh:139-164)."""
    ms = torch.minimum(sx, sy)
    qx, qy, qz, w = _elongate_p(px, py, pz, sx - ms, sy - ms,
                                torch.zeros_like(ms))
    kx = -0.9238795325
    ky = 0.3826834323
    kz = 0.4142135623
    ax = torch.abs(qx)
    ay = torch.abs(qy)
    az = torch.abs(qz)
    m1 = 2.0 * torch.clamp(kx * ax + ky * ay, max=0.0)
    ax = ax - m1 * kx
    ay = ay - m1 * ky
    m2 = 2.0 * torch.clamp(-kx * ax + ky * ay, max=0.0)
    ax = ax - m2 * -kx
    ay = ay - m2 * ky
    ax = ax - torch.minimum(torch.maximum(ax, -kz * ms), kz * ms)
    ay = ay - ms
    dxo = torch.sqrt(ax * ax + ay * ay + 1e-12) * torch.sign(ay)
    dzo = az - sz
    inside = torch.clamp(torch.maximum(dxo, dzo), max=0.0)
    outside = _len2_p(torch.clamp(dxo, min=0.0), torch.clamp(dzo, min=0.0))
    return w + inside + outside


PLANAR_EVALUATORS = {
    TYPE_ELLIPSOID: sd_ellipsoid_p,
    TYPE_BOX: sd_box_p,
    TYPE_CYLINDER: sd_cylinder_p,
    TYPE_SPHEROID: sd_spheroid_p,
    TYPE_OCTAGON: sd_octagon_p,
}


# Closed-form field gradients per primitive: normals for particle bounce /
# redirect (UpdateParticleSystemWithDistanceField.fx estimateNormal4);
# callers renormalize, so orientation is what matters.


def _nrm_safe(px, py, pz, fallback_z=1.0):
    l = torch.sqrt(px * px + py * py + pz * pz)
    ok = l > 1e-9
    inv = 1.0 / torch.where(ok, l, 1.0)
    return (torch.where(ok, px * inv, 0.0),
            torch.where(ok, py * inv, 0.0),
            torch.where(ok, pz * inv, fallback_z))


def nrm_box_p(px, py, pz, bx, by, bz):
    qx = torch.abs(px) - bx
    qy = torch.abs(py) - by
    qz = torch.abs(pz) - bz
    outside = (qx > 0.0) | (qy > 0.0) | (qz > 0.0)
    ox = torch.sign(px) * torch.clamp(qx, min=0.0)
    oy = torch.sign(py) * torch.clamp(qy, min=0.0)
    oz = torch.sign(pz) * torch.clamp(qz, min=0.0)
    # Inside: the face of the least interior penetration (max q).
    mx = (qx >= qy) & (qx >= qz)
    my = (~mx) & (qy >= qz)
    ix = torch.where(mx, torch.sign(px), 0.0)
    iy = torch.where(my, torch.sign(py), 0.0)
    iz = torch.where(~(mx | my), torch.sign(pz), 0.0)
    return _nrm_safe(torch.where(outside, ox, ix),
                     torch.where(outside, oy, iy),
                     torch.where(outside, oz, iz))


def nrm_ellipsoid_p(px, py, pz, rx, ry, rz):
    # Clamped like sd_ellipsoid_p: a zero extent would give NaN normals.
    rx = torch.clamp(rx, min=1e-6)
    ry = torch.clamp(ry, min=1e-6)
    rz = torch.clamp(rz, min=1e-6)
    return _nrm_safe(px / (rx * rx), py / (ry * ry), pz / (rz * rz))


def nrm_cylinder_p(px, py, pz, sx, sy, sz):
    r = torch.sqrt(sx * sx + sy * sy)
    lxy = torch.sqrt(px * px + py * py + 1e-12)
    d_xy = lxy - r
    d_z = torch.abs(pz) - sz
    both_out = (d_xy > 0.0) & (d_z > 0.0)
    radial = d_xy >= d_z
    ox = px / lxy * torch.clamp(d_xy, min=0.0)
    oy = py / lxy * torch.clamp(d_xy, min=0.0)
    oz = torch.sign(pz) * torch.clamp(d_z, min=0.0)
    nx = torch.where(both_out, ox, torch.where(radial, px / lxy, 0.0))
    ny = torch.where(both_out, oy, torch.where(radial, py / lxy, 0.0))
    nz = torch.where(both_out, oz, torch.where(radial, 0.0, torch.sign(pz)))
    return _nrm_safe(nx, ny, nz)


def nrm_spheroid_p(px, py, pz, sx, sy, sz):
    # Away from the inner core box (the elongation region); deep inside
    # the core, +z.
    m = torch.minimum(sx, torch.minimum(sy, sz))
    ex, ey, ez = sx - m, sy - m, sz - m
    dx = px - torch.minimum(torch.maximum(px, -ex), ex)
    dy = py - torch.minimum(torch.maximum(py, -ey), ey)
    dz = pz - torch.minimum(torch.maximum(pz, -ez), ez)
    return _nrm_safe(dx, dy, dz)


def nrm_octagon_p(px, py, pz, sx, sy, sz):
    """Tetrahedral finite difference (the reference's estimateNormal4
    form, VisualizeCommon.fxh)."""
    h = 0.5
    d1 = sd_octagon_p(px + h, py - h, pz - h, sx, sy, sz)
    d2 = sd_octagon_p(px - h, py - h, pz + h, sx, sy, sz)
    d3 = sd_octagon_p(px - h, py + h, pz - h, sx, sy, sz)
    d4 = sd_octagon_p(px + h, py + h, pz + h, sx, sy, sz)
    return _nrm_safe(d1 - d2 - d3 + d4, -d1 - d2 + d3 + d4,
                     -d1 + d2 - d3 + d4)


PLANAR_NORMALS = {
    TYPE_ELLIPSOID: nrm_ellipsoid_p,
    TYPE_BOX: nrm_box_p,
    TYPE_CYLINDER: nrm_cylinder_p,
    TYPE_SPHEROID: nrm_spheroid_p,
    TYPE_OCTAGON: nrm_octagon_p,
}
