"""The particle tick of the measured frames, in plain PyTorch.

A frozen copy of the arithmetic of the reference engine's particle path:
clamped beziers (Bezier.fxh), the spawn formulas and the ring write
(SpawnerCommon.fxh:34-190), gravity attractors (Gravity.fx:12-61), the
SDF collision integrate (UpdateParticleSystemWithDistanceField.fx:29-147)
and the render data (UpdateCommon.fxh). The benchmark also fills its
steady populations with these formulas, so the program and this reference
start from the same rows.
"""

from __future__ import annotations

import math

import torch

# UpdateParticleSystemWithDistanceField.fx:12-25.
BOUNCE_DELAY = 3.0
NO_NORMAL_THRESHOLD = 0.33
INITIAL_ESCAPE_SPEED = 0.33
ESCAPE_SPEED_ACCELERATION = 1.1


# -- clamped beziers -------------------------------------------------------

def bezier(points, min_value=0.0, max_value=1.0, device=None):
    """(header (4,), points (4, C)): up to four control points."""
    pts = torch.atleast_2d(torch.as_tensor(points, dtype=torch.float32,
                                           device=device))
    count = pts.shape[0]
    pad = torch.zeros((4 - count, pts.shape[1]), dtype=torch.float32,
                      device=pts.device)
    divisor = max_value - min_value
    inv = 1.0 if divisor == 0.0 else 1.0 / divisor
    header = torch.tensor([min_value, inv, float(count), 0.0],
                          dtype=torch.float32, device=pts.device)
    return header, torch.cat([pts, pad], dim=0)


def bezier_t(header, value):
    """Clamped linear time (no loop, bounce or easing: mode 0)."""
    t = (value - header[0]) * torch.abs(header[1])
    t = torch.clamp(t, 0.0, 1.0)
    return header[2], torch.where(header[1] < 0, 1.0 - t, t)


def at_t(points, count, t):
    a, b, c, d = points[0], points[1], points[2], points[3]
    tt = t[..., None]
    ab = a + (b - a) * tt
    bc = b + (c - b) * tt
    cd = c + (d - c) * tt
    abbc = ab + (bc - ab) * tt
    bccd = bc + (cd - bc) * tt
    cubic = abbc + (bccd - abbc) * tt
    shelf = torch.where(tt <= 0.0, a, torch.where(tt >= 1.0, c, b))
    result = torch.where(count <= 1.5, a, torch.where(
        count <= 2.5, ab, torch.where(count <= 3.5, shelf, cubic)))
    return torch.broadcast_to(result, tuple(t.shape) + (points.shape[-1],))


def evaluate(bez, value):
    header, points = bez
    value = torch.as_tensor(value, dtype=torch.float32, device=points.device)
    count, t = bezier_t(header, value)
    return at_t(points, count, t)


def rotation_matrix_bezier(angles, scale, min_value, max_value, value):
    """The (4, 4) row-vector matrix of a bezier over rotation angles in
    degrees at one scale (DynamicMatrix controls, Bezier.cs:379-424)."""
    dev = value.device
    header, _ = bezier([[0.0]] * len(angles), min_value, max_value, dev)
    controls = list(angles) + [angles[-1]] * (4 - len(angles))
    count, t = bezier_t(header, value)
    ang_scale = torch.tensor([[a, scale] for a in controls],
                             dtype=torch.float32, device=dev)
    p = at_t(ang_scale, count, t)
    trans = torch.tensor([[0.0, 0.0, 0.0, 1.0]] * 4, dtype=torch.float32,
                         device=dev)
    tr = at_t(trans, count, t)
    rad = p[..., 0] * (math.pi / 180.0)
    c = torch.cos(rad) * p[..., 1]
    s = torch.sin(rad) * p[..., 1]
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, s, z, z], dim=-1),
        torch.stack([-s, c, z, z], dim=-1),
        torch.stack([z, z, p[..., 1] * one, z], dim=-1),
        torch.stack([tr[..., 0], tr[..., 1], tr[..., 2], one], dim=-1),
    ], dim=-2)


# -- spawning --------------------------------------------------------------

def random_normal3(r, axis_mask):
    phi = r[..., 0] * (2.0 * math.pi)
    cos_theta = (r[..., 1] - 0.5) * 2.0
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    n = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                     cos_theta], dim=-1)
    n = n * axis_mask
    norm = torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                  min=1e-12))
    return n / norm


def spherical(constant, scale, offset, r, axis_mask):
    """The spherical formula: xyz on a shell, w linear."""
    rn = random_normal3(r[..., :2], axis_mask)
    circular = rn * r[..., 2:3] * scale[..., :3]
    xyz = constant[..., :3] + circular + rn * offset[..., :3]
    w = (constant + (r + offset) * scale)[..., 3:4]
    return torch.cat([xyz, w], dim=-1)


def linear(constant, scale, offset, r):
    return constant + (r + offset) * scale


def mul_point_rows(v4, m):
    out = (v4[:, 0:1] * m[0, :3] + v4[:, 1:2] * m[1, :3]
           + v4[:, 2:3] * m[2, :3] + m[3, :3])
    return torch.cat([out, v4[:, 3:4]], dim=-1)


def spawn_rows(sp, position_constant, velocity_matrix, draws):
    """New (position + life, velocity, colour) rows from three (n, 4)
    uniform draws. `sp`: the spawner's formulas as tensors ("position",
    "velocity", "color": (constant, scale, offset) each (4,); "life"
    rides in position.w; "axis_mask" (3,); "align": the velocity's
    direction drawn as the position's)."""
    r1, r2, r3 = draws
    if sp["align"]:
        # AlignVelocityAndPosition: the velocity's direction draws are the
        # position's.
        r2 = torch.cat([r1[:, :2], r2[:, 2:]], dim=-1)
    am = sp["axis_mask"]
    _, pscale, poffset = sp["position"]
    temp_position = spherical(position_constant, pscale, poffset, r1, am)
    new_position = mul_point_rows(
        temp_position, torch.eye(4, dtype=torch.float32,
                                 device=r1.device))
    vconst, vscale, voffset = sp["velocity"]
    # A single emission point: no velocity along a polygon path.
    temp_velocity = spherical(torch.broadcast_to(vconst, temp_position.shape),
                              vscale, voffset, r2, am)
    new_velocity = mul_point_rows(temp_velocity, velocity_matrix)
    cconst, cscale, coffset = sp["color"]
    new_color = linear(torch.broadcast_to(cconst, temp_position.shape),
                       cscale, coffset, r3)
    return new_position, new_velocity, new_color


def spawn(state, sp, position_constant, velocity_matrix, draws, count):
    """Write `count` (<= the draws' rows) new particles at the ring
    cursor, in place, and advance the cursor and the total."""
    n = state["position"].shape[0]
    rows = draws[0].shape[0]
    rel = torch.arange(rows, dtype=torch.int64, device=draws[0].device)
    idx = torch.remainder(state["write_cursor"].long() + rel, n)
    new = spawn_rows(sp, position_constant.expand(rows, 4), velocity_matrix,
                     draws)
    keep = ((rel < count) & (new[2][:, 3] >= sp["discard"]))[:, None]
    for name, rows_new in zip(("position", "velocity", "color"), new):
        arr = state[name]
        arr[idx] = torch.where(keep, rows_new, arr[idx])
    state["write_cursor"] = torch.remainder(
        state["write_cursor"] + count, n).to(torch.int32)
    state["total_spawned"] = (state["total_spawned"] + count).to(torch.int32)
    return state


# -- forces ----------------------------------------------------------------

def gravity(position, velocity, g, su):
    """Attractors (Gravity.fx:12-61): g holds positions (A, 3), radiuses,
    strengths, falloff_types, active (A,), maximum_acceleration ()."""
    to_center = g["positions"][None, :, :] - position[:, None, :3]
    dist_sq = torch.sum(to_center * to_center, dim=-1)
    dist = torch.sqrt(torch.clamp(dist_sq, min=1e-12))
    att_linear = 1.0 - torch.clamp(dist / torch.clamp(g["radiuses"],
                                                      min=1e-6), 0.0, 1.0)
    att_exp = att_linear * att_linear
    att_ramped = torch.where(g["falloff_types"] >= 1.5, att_exp, att_linear)
    att_ramped = att_ramped * su["dt"]
    att_physical = 1.0 / torch.clamp(dist_sq - g["radiuses"], min=0.001)
    attraction = torch.where(g["falloff_types"] >= 0.5, att_ramped,
                             att_physical)
    accel = (to_center / dist[..., None]
             * (attraction * g["strengths"] * g["active"])[..., None])
    accel = torch.sum(accel, dim=1)
    max_accel = g["maximum_acceleration"] * su["dt"]
    alen = torch.sqrt(torch.clamp(torch.sum(accel * accel, dim=-1),
                                  min=1e-12))
    accel = accel * torch.clamp(max_accel / alen, max=1.0)[:, None]
    live = (position[:, 3] > 0.0)[:, None]
    new_v = torch.minimum(velocity[:, :3] + accel, su["maximum_velocity"])
    return torch.where(live, torch.cat([new_v, velocity[:, 3:4]], dim=-1),
                       velocity)


def _unit3(velocity):
    return velocity[:, :3] / torch.sqrt(torch.clamp(
        torch.sum(velocity[:, :3] ** 2, dim=-1, keepdim=True), min=1e-12))


def steer(velocity, delta, w, t, replace):
    """Replace v by lerp(v, delta, w), or add delta * t; then add
    |delta.w| along v (the velocity update of Noise and VectorField)."""
    v = velocity[:, :3]
    if replace:
        new_v = v + (delta[:, :3] - v) * w[:, None]
    else:
        new_v = v + delta[:, :3] * t[:, None]
    new_v = new_v + _unit3(velocity) * delta[:, 3:4]
    return torch.cat([new_v, velocity[:, 3:4]], dim=-1)


def bilinear_wrap(data, xy, offset, rate):
    """Bilinear sample of an (H, W, 4) table with wrap, texel centres at
    i + 0.5 (smoothRandomCustom, RandomCommon.fxh:36-39)."""
    h, w = data.shape[:2]
    coord = xy * rate + offset
    tx = coord[..., 0] - 0.5
    ty = coord[..., 1] - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    wx = (tx - x0)[..., None]
    wy = (ty - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    y1i = torch.remainder(y0i + 1, h)
    v00 = data[y0i, x0i]
    v01 = data[y0i, x1i]
    v10 = data[y1i, x0i]
    v11 = data[y1i, x1i]
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy


def point_wrap(data, xy, offset):
    """Point sample of an (H, W, 4) table with wrap (randomCustom,
    RandomCommon.fxh:27-30)."""
    h, w = data.shape[:2]
    coord = xy * 1.0 + offset
    xi = torch.remainder(torch.floor(coord[..., 0]).to(torch.int64), w)
    yi = torch.remainder(torch.floor(coord[..., 1]).to(torch.int64), h)
    return data[yi, xi]


def vector_field(position, velocity, vf, su):
    """A texture force field sampled at the particles' xy
    (VectorField.cs:10-51): its weight everywhere 1, its time weight
    dt x cycles per second, added to the velocity of the live."""
    w = torch.ones_like(position[:, 0])
    t = w * su["dt"] * vf["cycles_per_second"]
    sample = bilinear_wrap(vf["field"], position[:, :2], vf["offset"],
                           vf["scale"])
    new_vel = steer(velocity, sample * vf["velocity_scale"], w, t, False)
    live = (position[:, 3] > 0.0)[:, None]
    return torch.where(live, new_vel, velocity)


def noise(position, velocity, nz, su, random_field, slot_xy):
    """Temporal noise (Noise.fx:28-72): per-slot randomness lerped between
    the random field at two offsets, replacing the velocity; no position
    term (its scale is 0). nz: offset_a, offset_b (2,), lerp (),
    velocity_offset, velocity_minimum, velocity_scale (4,),
    cycles_per_second ()."""
    w = torch.ones_like(position[:, 0])
    t = w * su["dt"] * nz["cycles_per_second"]
    shifted = torch.stack([slot_xy[..., 0] + 2.0, slot_xy[..., 1] + 1.0],
                          dim=-1)
    a = point_wrap(random_field, shifted, nz["offset_a"])
    b = point_wrap(random_field, shifted, nz["offset_b"])
    vd = a + (b - a) * nz["lerp"] + nz["velocity_offset"]
    vd = torch.sign(vd) * torch.maximum(torch.abs(vd), nz["velocity_minimum"])
    vd = vd * nz["velocity_scale"]
    return steer(velocity, vd, w, t, True)


# -- integration -----------------------------------------------------------

def _len3(x, y, z, eps=1e-12):
    return torch.sqrt(x * x + y * y + z * z + eps)


def _friction_max(vx, vy, vz, su, v_len):
    max_v = su["maximum_velocity"]
    clamped = torch.minimum(v_len, max_v)
    new_l = torch.minimum(torch.clamp(
        clamped - clamped * su["friction"] * su["dt"], min=0.0), max_v)
    small = v_len <= 0.001
    m = torch.where(small, 0.0, new_l / v_len)
    return vx * m, vy * m, vz * m, torch.where(small, 0.0, new_l)


def _slot_direction(n, device):
    """The integer Weyl hash of the slot index as a unit 2D direction."""
    mask = 0xFFFFFFFF
    slot = torch.arange(n, dtype=torch.int64, device=device)
    h1 = (slot * 2654435761) & mask
    h2 = (((slot + 0x9E3779B9) & mask) * 2246822519) & mask
    fbx = (h1 >> 16).to(torch.float32) / 32768.0 - 1.0
    fby = (h2 >> 16).to(torch.float32) / 32768.0 - 1.0
    fb_len = _len3(fbx, fby, torch.zeros_like(fbx), 1e-6)
    return fbx / fb_len, fby / fb_len


def integrate(state, su, field, substeps, maximum_z=1e9):
    """The collision integrate: friction and maximum velocity, life decay,
    up to `substeps` sphere-trace steps with backtracking, the collision
    normal of the field, and the bounce / escape / redirect outcomes.
    `field`: distance(x, y, z) and normal(x, y, z) of planar tensors.
    -> new (position, velocity)."""
    pos, vel = state["position"], state["velocity"]
    dt = su["dt"]
    escape_velocity, bounce_mult, collision_distance, life_penalty = (
        su["collision"][i] for i in range(4))
    ox, oy, oz = pos[:, 0], pos[:, 1], pos[:, 2]
    new_life = pos[:, 3] - su["life_decay"] * dt
    was_alive = pos[:, 3] > 0.0
    alive = (new_life > 0.0) & was_alive
    v0x, v0y, v0z, v0w = vel[:, 0], vel[:, 1], vel[:, 2], vel[:, 3]
    v0len = _len3(v0x, v0y, v0z)
    ux, uy, uz = v0x / v0len, v0y / v0len, v0z / v0len
    vx, vy, vz, v_new_len = _friction_max(v0x, v0y, v0z, su, v0len)
    scaled_len = v_new_len * dt
    above_field = oz > maximum_z
    initial_distance = torch.where(above_field, 1e9,
                                   field.distance(ox, oy, oz))
    was_colliding = initial_distance < collision_distance
    travel = torch.clamp(torch.minimum(initial_distance, scaled_len),
                         min=0.0)
    zero = torch.zeros_like(ox)
    collided = torch.zeros_like(was_colliding)
    escaping = torch.zeros_like(was_colliding)
    cpx, cpy, cpz = zero, zero, zero
    steps_left = torch.where(was_colliding, 1, torch.where(
        travel <= 0.001, 0, substeps))
    for _ in range(substeps):
        active = steps_left > 0
        tx = ox + travel * ux
        ty = oy + travel * uy
        tz = oz + travel * uz
        step_distance = torch.where(above_field, 1e9,
                                    field.distance(tx, ty, tz))
        hit = step_distance < collision_distance
        newly = active & hit
        collided = collided | newly
        escaping = torch.where(active, step_distance > initial_distance,
                               escaping)
        backtrack = active & collided & ~escaping
        at_step = newly | backtrack
        cpx = torch.where(at_step, tx, cpx)
        cpy = torch.where(at_step, ty, cpy)
        cpz = torch.where(at_step, tz, cpz)
        offset = torch.clamp(step_distance + collision_distance, 0.05, 16.0)
        travel = torch.where(backtrack, torch.clamp(travel - offset, min=0.0),
                             travel)
        steps_left = torch.where(active & backtrack & (travel > 0.001),
                                 steps_left - 1, 0)
    bounce = v0w <= 0.0
    redirect = was_colliding & ~escaping
    needs_normal = collided & (bounce | redirect)
    nnx, nny, nnz = field.normal(cpx, cpy, cpz)
    nx = torch.where(needs_normal, nnx, zero)
    ny = torch.where(needs_normal, nny, zero)
    nz = torch.where(needs_normal, nnz, zero)
    escape_speed = torch.minimum(su["maximum_velocity"], escape_velocity)
    r_len = _len3(nx, ny, zero)
    fbx, fby = _slot_direction(pos.shape[0], pos.device)
    no_norm = r_len < NO_NORMAL_THRESHOLD
    rdx = torch.where(no_norm, fbx, nx)
    rdy = torch.where(no_norm, fby, ny)
    rd_len = torch.where(no_norm, 1.0, torch.clamp(r_len, min=1e-6))
    r_speed = escape_speed * INITIAL_ESCAPE_SPEED
    r_vx = rdx / rd_len * r_speed
    r_vy = rdy / rd_len * r_speed
    r_vz = zero
    r_px = ox + r_vx * dt
    r_py = oy + r_vy * dt
    r_pz = oz + r_vz * dt
    ndotu = nx * ux + ny * uy + nz * uz
    bvx = -(2.0 * ndotu * (nx - ux))
    bvy = -(2.0 * ndotu * (ny - uy))
    bvz = -(2.0 * ndotu * (nz - uz))
    b_len = _len3(bvx, bvy, bvz)
    short = b_len < NO_NORMAL_THRESHOLD
    bdx = torch.where(short, -ux, bvx / b_len)
    bdy = torch.where(short, -uy, bvy / b_len)
    bdz = torch.where(short, -uz, bvz / b_len)
    b_speed = torch.minimum(su["maximum_velocity"], v_new_len * bounce_mult)
    b_vx, b_vy, b_vz = bdx * b_speed, bdy * b_speed, bdz * b_speed
    e_speed = torch.maximum(v0len * ESCAPE_SPEED_ACCELERATION, escape_speed)
    e_vx, e_vy, e_vz = ux * e_speed, uy * e_speed, uz * e_speed
    n_px = ox + travel * ux
    n_py = oy + travel * uy
    n_pz = oz + travel * uz
    n_w = torch.clamp(v0w - 1.0, min=0.0)
    sel_redirect = collided & redirect
    sel_bounce = collided & ~redirect & bounce
    sel_escape = collided & ~redirect & ~bounce

    def pick(r, b, e, n):
        return torch.where(sel_redirect, r, torch.where(
            sel_bounce, b, torch.where(sel_escape, e, n)))

    out_v = (pick(r_vx, b_vx, e_vx, vx), pick(r_vy, b_vy, e_vy, vy),
             pick(r_vz, b_vz, e_vz, vz))
    out_p = (pick(r_px, cpx, n_px, n_px), pick(r_py, cpy, n_py, n_py),
             pick(r_pz, cpz, n_pz, n_pz))
    out_w = torch.where(collided & (redirect | bounce), BOUNCE_DELAY,
                        torch.where(collided, v0w, n_w))
    new_life = torch.where(collided & ~redirect & bounce,
                           new_life - life_penalty, new_life)
    keep = alive & (new_life > 0.0)

    def sel(new, old):
        return torch.where(keep, new, torch.where(was_alive, 0.0, old))

    new_pos = torch.stack([sel(out_p[0], pos[:, 0]), sel(out_p[1], pos[:, 1]),
                           sel(out_p[2], pos[:, 2]),
                           sel(new_life, pos[:, 3])], dim=-1)
    new_vel = torch.stack([sel(out_v[0], vel[:, 0]), sel(out_v[1], vel[:, 1]),
                           sel(out_v[2], vel[:, 2]), sel(out_w, vel[:, 3])],
                          dim=-1)
    return new_pos, new_vel


def _curve(v, x, channels):
    """A bezier (header, points) at x, or a constant (channels,) tensor
    broadcast to x's shape."""
    if isinstance(v, tuple):
        return evaluate(v, x)
    return torch.broadcast_to(v, tuple(x.shape) + (channels,))


def render_data(position, velocity, attributes, rd):
    """(render_color, render_data (size, rotation, |v|, v.w)), zero where
    dead. rd: "color_from_life", "color_from_velocity" (4 channels),
    "size_from_life", "size_from_velocity" (1), each a bezier or a
    constant; no rotation."""
    life = position[..., 3]
    vel_len = torch.clamp(
        torch.sqrt(torch.sum(velocity[..., :3] ** 2, dim=-1)), min=1e-4)
    color = (_curve(rd["color_from_life"], life, 4)
             * _curve(rd["color_from_velocity"], vel_len, 4))
    render_color = attributes * color
    a = torch.clamp(render_color[..., 3:4], 0.0, 1.0)
    render_color = torch.cat([render_color[..., :3] * a, a], dim=-1)
    size = (_curve(rd["size_from_life"], life, 1)[..., 0]
            * _curve(rd["size_from_velocity"], vel_len, 1)[..., 0])
    index = torch.arange(life.shape[0], dtype=torch.int32,
                         device=life.device)
    rotation = life * 0.0 + index.to(torch.float32) * 0.0
    out = torch.stack([size, rotation, vel_len, velocity[..., 3]], dim=-1)
    dead = (life <= 0.0)[..., None]
    return (torch.where(dead, 0.0, render_color),
            torch.where(dead, 0.0, out))
