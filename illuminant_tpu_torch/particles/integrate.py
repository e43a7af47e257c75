"""Particle integrators: plain Euler and SDF collision.

Counterpart of illuminant_tpu/particles/integrate.py. `integrate` is the
plain Euler step (UpdateParticleSystem.fx PS_Update :9-38), the route of a
system without a field. `integrate_with_distance_field`
(UpdateParticleSystemWithDistanceField.fx:29-147) runs against any
field: friction and maximum velocity, life decay, the initial distance
sample, up to `substeps` sphere-trace steps with backtracking, the
collision normal, and the bounce / escape / redirect outcomes, all
branchless per particle over planar (N,) components.
  * One substep on a ColumnField: the step sample returns the unit
    gradient too, in one launch of the fused column query (two launches
    per call with the initial distance; at three substeps five: the
    initial distance, one a substep, the normal).
  * Otherwise each substep samples the field (`scene_sample_p`) and the
    normal is the field's fast normal at the collision point
    (`scene_normal_p(fast=True)`: closed form on an analytic scene).
On the card, an AnalyticScene or a ColumnField takes the whole call,
render data included, as one launch of K4 (`integrate_kernel`,
`csrc/collide_integrate.cu`); the eager body,
`integrate_with_distance_field_reference`, is its plain version, and runs
on the CPU and for a bare SdfVolume.
"""

from __future__ import annotations

import torch

from ..core.trace import span
from ..sdf.analytic import (scene_normal_p, scene_sample_grad_p,
                            scene_sample_p)
from . import integrate_kernel
from .render_data import RenderDataUniforms, compute_render_data
from .state import (ParticleState, SystemUniforms,
                    friction_and_maximum_length)

# UpdateParticleSystemWithDistanceField.fx:12-25.
MAX_STEP_COUNT = 3
BOUNCE_DELAY = 3.0
NO_NORMAL_THRESHOLD = 0.33
INITIAL_ESCAPE_SPEED = 0.33
ESCAPE_SPEED_ACCELERATION = 1.1


def _len3(x, y, z, eps=1e-12):
    return torch.sqrt(x * x + y * y + z * z + eps)


def _friction_max_p(vx, vy, vz, su: SystemUniforms, v_len=None):
    """applyFrictionAndMaximum (UpdateCommon.fxh:20-35), planar, with the
    speed arithmetic of state.apply_friction_and_maximum; returns the
    scaled velocity and its new length. Without `v_len` the length is
    computed as the JAX package's plain integrate does (eps 1e-20)."""
    l = _len3(vx, vy, vz, 1e-20) if v_len is None else v_len
    new_l = friction_and_maximum_length(l, su)
    small = l <= 0.001
    m = torch.where(small, 0.0, new_l / l)
    return vx * m, vy * m, vz * m, torch.where(small, 0.0, new_l)


def _slot_hash_direction(n: int, device, first_slot: int = 0):
    """The JAX package's integer Weyl hash of the slot index -> a unit 2D
    direction (the redirect fallback), in uint32 arithmetic, for slots
    first_slot .. first_slot + n - 1."""
    mask = 0xFFFFFFFF
    slot = torch.arange(first_slot, first_slot + n, dtype=torch.int64,
                        device=device)
    h1 = (slot * 2654435761) & mask
    h2 = (((slot + 0x9E3779B9) & mask) * 2246822519) & mask
    fbx = (h1 >> 16).to(torch.float32) / 32768.0 - 1.0
    fby = (h2 >> 16).to(torch.float32) / 32768.0 - 1.0
    fb_len = _len3(fbx, fby, torch.zeros_like(fbx), 1e-6)
    return fbx / fb_len, fby / fb_len


def _render(state, new_pos, new_vel, rd, first_slot: int = 0):
    index = torch.arange(first_slot, first_slot + state.capacity,
                         dtype=torch.int32, device=new_pos.device)
    render_color, render_data = compute_render_data(
        new_pos, new_vel, state.color, index, rd)
    return state.replace(position=new_pos, velocity=new_vel,
                         render_color=render_color, render_data=render_data)


@span("illuminant/particle_integrate")
def integrate(state: ParticleState, su: SystemUniforms,
              rd: RenderDataUniforms) -> ParticleState:
    """Plain Euler (UpdateParticleSystem.fx PS_Update): friction and
    maximum velocity, life decay, position += v dt; a particle that dies
    this step is zeroed. Returns a new state."""
    pos = state.position
    vel = state.velocity
    dt = su.dt
    vx, vy, vz, _ = _friction_max_p(vel[:, 0], vel[:, 1], vel[:, 2], su)
    new_life = pos[:, 3] - su.life_decay * dt
    was_alive = pos[:, 3] > 0.0
    keep = (new_life > 0.0) & was_alive

    def sel(new, old):
        return torch.where(keep, new, torch.where(was_alive, 0.0, old))

    new_pos = torch.stack([sel(pos[:, 0] + vx * dt, pos[:, 0]),
                           sel(pos[:, 1] + vy * dt, pos[:, 1]),
                           sel(pos[:, 2] + vz * dt, pos[:, 2]),
                           sel(new_life, pos[:, 3])], dim=-1)
    new_vel = torch.stack([sel(vx, vel[:, 0]), sel(vy, vel[:, 1]),
                           sel(vz, vel[:, 2]), sel(vel[:, 3], vel[:, 3])],
                          dim=-1)
    return _render(state, new_pos, new_vel, rd)


@span("illuminant/particle_integrate")
def integrate_with_distance_field(state: ParticleState, su: SystemUniforms,
                                  rd: RenderDataUniforms, volume,
                                  maximum_z: float = 1e9,
                                  substeps: int = MAX_STEP_COUNT,
                                  first_slot: int = 0) -> ParticleState:
    """SDF collision integrate (UpdateParticleSystemWithDistanceField.fx)
    with up to `substeps` sphere-trace steps; particles above `maximum_z`
    ignore the field. `first_slot`: the ring slot of the state's row 0
    (a mesh rank's capacity shard), which the slot-keyed terms read (the
    redirect fallback's hash, the render data's index). Returns a new
    state."""
    if integrate_kernel.takes(state.position.device, volume):
        return integrate_kernel.integrate_cuda(
            state, su, rd, volume, maximum_z, substeps, first_slot)
    return integrate_with_distance_field_reference(
        state, su, rd, volume, maximum_z, substeps, first_slot)


def integrate_with_distance_field_reference(
        state: ParticleState, su: SystemUniforms, rd: RenderDataUniforms,
        volume, maximum_z: float = 1e9, substeps: int = MAX_STEP_COUNT,
        first_slot: int = 0) -> ParticleState:
    """The eager body of `integrate_with_distance_field` on any device and
    field: the plain version of K4, and the path of the CPU and of a bare
    SdfVolume."""
    pos = state.position
    vel = state.velocity
    dt = su.dt
    escape_velocity = su.collision_settings[0]
    bounce_mult = su.collision_settings[1]
    collision_distance = su.collision_settings[2]
    life_penalty = su.collision_settings[3]

    ox, oy, oz = pos[:, 0], pos[:, 1], pos[:, 2]
    new_life = pos[:, 3] - su.life_decay * dt
    was_alive = pos[:, 3] > 0.0
    alive = (new_life > 0.0) & was_alive

    v0x, v0y, v0z, v0w = vel[:, 0], vel[:, 1], vel[:, 2], vel[:, 3]
    v0len = _len3(v0x, v0y, v0z)
    ux, uy, uz = v0x / v0len, v0y / v0len, v0z / v0len
    vx, vy, vz, v_new_len = _friction_max_p(v0x, v0y, v0z, su, v0len)
    scaled_len = v_new_len * dt

    # fx:63-70.
    above_field = oz > maximum_z
    initial_distance = torch.where(above_field, 1e9,
                                   scene_sample_p(volume, ox, oy, oz))
    was_colliding = initial_distance < collision_distance
    travel = torch.clamp(torch.minimum(initial_distance, scaled_len),
                         min=0.0)

    zero = torch.zeros_like(ox)
    collided = torch.zeros_like(was_colliding)
    escaping = torch.zeros_like(was_colliding)
    cpx, cpy, cpz = zero, zero, zero
    # Active substeps (fx:66-71): a colliding particle takes one step,
    # zero travel none.
    steps_left = torch.where(was_colliding, 1, torch.where(
        travel <= 0.001, 0, substeps))

    # At one substep the collision point is this step's position, so a
    # field with a fused path (a ColumnField) returns the normal with the
    # step sample.
    fused_normal = None
    for _ in range(substeps):  # fx:72-90
        active = steps_left > 0
        tx = ox + travel * ux
        ty = oy + travel * uy
        tz = oz + travel * uz
        fused = (scene_sample_grad_p(volume, tx, ty, tz)
                 if substeps == 1 else None)
        if fused is not None:
            step_distance, *fused_normal = fused
        else:
            step_distance = scene_sample_p(volume, tx, ty, tz)
        step_distance = torch.where(above_field, 1e9, step_distance)
        hit = step_distance < collision_distance

        newly = active & hit
        collided = collided | newly
        escaping = torch.where(active, step_distance > initial_distance,
                               escaping)
        # A new hit or a backtrack records this step's position.
        backtrack = active & collided & ~escaping
        at_step = newly | backtrack
        cpx = torch.where(at_step, tx, cpx)
        cpy = torch.where(at_step, ty, cpy)
        cpz = torch.where(at_step, tz, cpz)
        offset = torch.clamp(step_distance + collision_distance, 0.05, 16.0)
        travel = torch.where(backtrack, torch.clamp(travel - offset, min=0.0),
                             travel)
        # stepCount = 0 when not backtracking or travel exhausted (fx:85-89).
        steps_left = torch.where(active & backtrack & (travel > 0.001),
                                 steps_left - 1, 0)

    # fx:92-139: resolve collision outcomes.
    bounce = v0w <= 0.0
    redirect = was_colliding & ~escaping
    needs_normal = collided & (bounce | redirect)
    if fused_normal is not None:
        nnx, nny, nnz = fused_normal
    else:
        nnx, nny, nnz = scene_normal_p(volume, cpx, cpy, cpz, fast=True)
    nx = torch.where(needs_normal, nnx, zero)
    ny = torch.where(needs_normal, nny, zero)
    nz = torch.where(needs_normal, nnz, zero)
    escape_speed = torch.minimum(su.maximum_velocity, escape_velocity)

    # Redirect: flee along the xy-masked normal (fx:103-116), or along the
    # slot-hash direction where the normal is too short (fx:105-110).
    r_len = _len3(nx, ny, zero)
    fbx, fby = _slot_hash_direction(pos.shape[0], pos.device, first_slot)
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

    # Bounce: reflect (fx:117-128).
    ndotu = nx * ux + ny * uy + nz * uz
    bvx = -(2.0 * ndotu * (nx - ux))
    bvy = -(2.0 * ndotu * (ny - uy))
    bvz = -(2.0 * ndotu * (nz - uz))
    b_len = _len3(bvx, bvy, bvz)
    short = b_len < NO_NORMAL_THRESHOLD
    bdx = torch.where(short, -ux, bvx / b_len)
    bdy = torch.where(short, -uy, bvy / b_len)
    bdz = torch.where(short, -uz, bvz / b_len)
    b_speed = torch.minimum(su.maximum_velocity, v_new_len * bounce_mult)
    b_vx, b_vy, b_vz = bdx * b_speed, bdy * b_speed, bdz * b_speed

    # Escaping while colliding: accelerate out (fx:129-135).
    e_speed = torch.maximum(v0len * ESCAPE_SPEED_ACCELERATION, escape_speed)
    e_vx, e_vy, e_vz = ux * e_speed, uy * e_speed, uz * e_speed

    # No collision (fx:136-139).
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

    out_vx = pick(r_vx, b_vx, e_vx, vx)
    out_vy = pick(r_vy, b_vy, e_vy, vy)
    out_vz = pick(r_vz, b_vz, e_vz, vz)
    out_px = pick(r_px, cpx, n_px, n_px)
    out_py = pick(r_py, cpy, n_py, n_py)
    out_pz = pick(r_pz, cpz, n_pz, n_pz)
    out_w = torch.where(collided & (redirect | bounce), BOUNCE_DELAY,
                        torch.where(collided, v0w, n_w))
    new_life = torch.where(collided & ~redirect & bounce,
                           new_life - life_penalty, new_life)

    keep = alive & (new_life > 0.0)

    def sel(new, old):
        return torch.where(keep, new, torch.where(was_alive, 0.0, old))

    new_pos = torch.stack([sel(out_px, pos[:, 0]), sel(out_py, pos[:, 1]),
                           sel(out_pz, pos[:, 2]), sel(new_life, pos[:, 3])],
                          dim=-1)
    new_vel = torch.stack([sel(out_vx, vel[:, 0]), sel(out_vy, vel[:, 1]),
                           sel(out_vz, vel[:, 2]), sel(out_w, vel[:, 3])],
                          dim=-1)
    return _render(state, new_pos, new_vel, rd, first_slot)
