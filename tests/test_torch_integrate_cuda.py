"""The particles' collision integrate (K4, csrc/collide_integrate.cu) on
the card against its plain version, the eager body
`integrate.integrate_with_distance_field_reference`, run on the same
inputs on the CPU and on the card.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_integrate_cuda.py

Here, without a card, the `cuda` cases skip and the CPU cases check that
the inputs reach what the card cases are about.

Tolerance: on a staged scene and a ColumnField, against the eager body on
the card, none: every row of every slot bit for bit (K4 keeps its
operation order, the card's order of torch.sum over a 3-wide axis
included, and its roots and quotients are IEEE as torch's are on the
card). Against the eager body on the CPU, which divides by a 0-d tensor
as a product with its reciprocal and adds a 3-wide sum in another order,
every element within CPU_TOLERANCE x (1 + |value|) but in at most
FAR_SHARE of the slots (a slot within the rounding of a collision
threshold resolves the other way). On a scene read from device memory
(above the unroll limit, or with polygons) the slots beyond
CPU_TOLERANCE are counted against both eager bodies and bounded: by
BATCHED_SHARE above the unroll limit, where the batched distance adds its
3-wide lengths in another order than the card's torch.sum (0.43-0.47% of
the slots against the card's eager body, 0.08-0.10% against the CPU's, on
an H100; the two eager bodies differ in 0.52% between them), and by
FAR_SHARE with polygons within the limit, where only the autograd
normal's sums round in another order than the backward pass (at most 1
slot in 65,537).
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.lighting.environment import LightObstruction
from illuminant_tpu_torch.ops.bezier import (MODE_BOUNCE_BIT, MODE_EXP,
                                             MODE_LOOP_BIT, MODE_SINE,
                                             constant_bezier, pack_bezier)
from illuminant_tpu_torch.particles import integrate as integ
from illuminant_tpu_torch.particles import integrate_kernel as k4
from illuminant_tpu_torch.particles.render_data import (
    RenderDataUniforms, pack_life_ramp_settings)
from illuminant_tpu_torch.particles.state import ParticleState
from illuminant_tpu_torch.sdf import analytic

WIDTH, HEIGHT = 1920, 1080
# The flagship's occluders (scenes.build_flagship at 1080p): centre and
# half size of the two boxes, the ellipsoid and the cylinder.
_CX, _CY, _RING = WIDTH * 0.5, HEIGHT * 0.5, min(WIDTH, HEIGHT) * 0.38
OCCLUDERS = (
    ("box", (_CX, _CY, 24.0), (22.0, 22.0, 24.0)),
    ("ellipsoid", (_CX - _RING * 0.5, _CY, 20.0), (28.0, 16.0, 20.0)),
    ("cylinder", (_CX, _CY - _RING * 0.5, 26.0), (12.0, 12.0, 26.0)),
    ("box", (_CX + _RING * 0.45, _CY + _RING * 0.3, 16.0),
     (30.0, 10.0, 16.0)))
FULL = 1 << 20
# Slot counts: the cells' ring and counts that leave a block partly
# full.
COUNTS = (FULL, 1000003, 257, 1)
# Against the eager body on the CPU: an element's difference as a share
# of 1 + its magnitude, and the share of slots allowed beyond it.
CPU_TOLERANCE = 1e-5
FAR_SHARE = 1e-3
# A scene above the unroll limit: the share of slots allowed beyond
# CPU_TOLERANCE, against either eager body.
BATCHED_SHARE = 1e-2
# The polygons of `polygon_scene`: two extruded height volumes on the
# frame's free ground, (x, y) corners.
POLYGONS = (((260.0, 180.0), (520.0, 200.0), (380.0, 430.0)),
            ((1400.0, 760.0), (1640.0, 720.0), (1700.0, 930.0),
             (1520.0, 1000.0), (1380.0, 900.0)))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


def flagship_scene(device):
    """The flagship's AnalyticScene at rest (its occluders un-orbited)."""
    obs = [getattr(LightObstruction, kind)(c, s) for kind, c, s in OCCLUDERS]
    return analytic.pack_scene(obs, group_capacity_round=1, device=device)


def mixed_scene(count, device, seed=0):
    """The flagship's occluders and count - 4 more of all five types,
    half of them rotated, over the frame."""
    return analytic.pack_scene(_mixed_obstructions(count, seed),
                               group_capacity_round=2, device=device)


def _mixed_obstructions(count, seed=0):
    from illuminant_tpu_torch.ops import sdf_primitives as sp

    rng = np.random.default_rng(seed)
    obs = [getattr(LightObstruction, kind)(c, s) for kind, c, s in OCCLUDERS]
    for i in range(count - len(OCCLUDERS)):
        q = rng.normal(size=4) if i % 2 else np.array([0.0, 0.0, 0.0, 1.0])
        obs.append(LightObstruction(
            type=sorted(sp.KNOWN_TYPES)[i % len(sp.KNOWN_TYPES)],
            center=tuple(rng.uniform((0.0, 0.0, 5.0),
                                     (WIDTH, HEIGHT, 40.0))),
            size=tuple(rng.uniform(4.0, 30.0, 3)),
            rotation=tuple(q / np.linalg.norm(q))))
    return obs


def polygon_scene(device, count=len(OCCLUDERS)):
    """`mixed_scene`'s primitives (the flagship's occluders alone at the
    default count) with the two extruded POLYGONS, 40 high."""
    from illuminant_tpu_torch.sdf.height_volume import HeightVolume

    return analytic.pack_scene(
        _mixed_obstructions(count), group_capacity_round=2,
        height_volumes=[HeightVolume(polygon=p, height=40.0)
                        for p in POLYGONS], device=device)


def polygon_rows(n, seed=0):
    """`state_rows` with a third of the slots over the POLYGONS' bounding
    boxes (a margin of 30 around them), below and above their top."""
    pos, vel, color = state_rows(n, seed)
    rng = np.random.default_rng(seed + 1)
    boxes = np.array([[min(x for x, _ in p), min(y for _, y in p),
                       max(x for x, _ in p), max(y for _, y in p)]
                      for p in POLYGONS], np.float32)
    k = rng.integers(0, len(POLYGONS), n)
    over = rng.random(n) < 1.0 / 3.0
    lo, hi = boxes[k, :2] - 30.0, boxes[k, 2:] + 30.0
    pos[over, 0] = rng.uniform(lo[:, 0], hi[:, 0])[over]
    pos[over, 1] = rng.uniform(lo[:, 1], hi[:, 1])[over]
    pos[over, 2] = rng.uniform(0.0, 46.0, n)[over]
    return pos, vel, color


def state_rows(n, seed=0, maximum_z=50.0):
    """(position, velocity, color) (n, 4) float32 numpy rows that reach
    every branch: dead slots (life 0 or below), slots that die this step,
    slots near and inside each occluder and on a box's top face (whose
    normal has no xy part: the redirect's hash fallback), slots above
    `maximum_z`, zero and near-zero velocities, each bounce-delay state."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    centers = np.array([c for _, c, _ in OCCLUDERS], f32)
    halves = np.array([s for _, _, s in OCCLUDERS], f32)
    pos = np.empty((n, 4), f32)
    pos[:, 0] = rng.uniform(-20.0, WIDTH + 20.0, n)
    pos[:, 1] = rng.uniform(-20.0, HEIGHT + 20.0, n)
    pos[:, 2] = rng.uniform(0.0, maximum_z + 10.0, n)
    k = rng.integers(0, len(OCCLUDERS), n)
    near = rng.random(n) < 0.4
    pos[near, :3] = (centers[k] + rng.uniform(-1.4, 1.4, (n, 3))
                     * halves[k])[near]
    top = (rng.random(n) < 0.06) & (k % 3 == 0)  # the boxes
    pos[top, :2] = (centers[k, :2] + rng.uniform(-0.6, 0.6, (n, 2))
                    * halves[k, :2])[top]
    pos[top, 2] = (centers[k, 2] + halves[k, 2]
                   + rng.uniform(0.05, 0.9, n))[top]
    pos[:, 3] = rng.uniform(0.01, 3.0, n)
    dying = rng.random(n) < 0.05
    pos[dying, 3] = rng.uniform(1e-5, 3e-3, n)[dying]
    dead = rng.random(n) < 0.2
    pos[dead, 3] = rng.choice(np.array([0.0, -0.5, -1.0], f32), n)[dead]
    vel = np.zeros((n, 4), f32)
    vel[:, :2] = rng.uniform(-300.0, 300.0, (n, 2))
    vel[:, 2] = rng.uniform(-30.0, 30.0, n)
    down = top & (rng.random(n) < 0.5)
    vel[down, :3] = np.array([0.0, 0.0, -40.0], f32)
    still = rng.random(n) < 0.03
    vel[still, :3] = 0.0
    slow = rng.random(n) < 0.02
    vel[slow, :3] = rng.uniform(-5e-4, 5e-4, (n, 3))[slow]
    vel[:, 3] = rng.choice(np.array([0.0, -1.0, 0.5, 2.0, 3.0], f32), n)
    color = rng.random((n, 4), dtype=f32)
    return pos, vel, color


def as_state(rows, device):
    pos, vel, color = (torch.as_tensor(r, device=device) for r in rows)
    zeros = torch.zeros_like(pos)
    return ParticleState(
        position=pos, velocity=vel, color=color, render_color=zeros,
        render_data=zeros.clone(),
        write_cursor=torch.zeros((), dtype=torch.int32, device=device),
        total_spawned=torch.zeros((), dtype=torch.int32, device=device))


def flagship_uniforms(device):
    """The flagship's system and render-data uniforms (scenes.py)."""
    from illuminant_tpu_torch.particles.system import (ParticleSystem,
                                                       ParticleSystemConfig)
    from illuminant_tpu_torch.scenes import DT

    cfg = ParticleSystemConfig(
        capacity=16, updates_per_second=0.0, life_decay_per_second=0.2,
        friction=0.05, maximum_velocity=600.0, collision_distance=1.0,
        bounce_velocity_multiplier=0.7)
    rd = RenderDataUniforms(
        color_from_life=pack_bezier(
            [(0.3, 0.3, 0.6, 0.0), (1.0, 1.0, 1.0, 1.0),
             (1.0, 1.0, 1.0, 1.0)], min_value=0.0, max_value=4.0,
            device=device),
        color_from_velocity=constant_bezier([1.0, 1.0, 1.0, 1.0],
                                            device=device),
        size_from_life=pack_bezier([[1.0], [2.5], [3.0]], min_value=0.0,
                                   max_value=4.0, device=device),
        size_from_velocity=constant_bezier([1.0], device=device),
        rotation_from_life_and_index=torch.zeros(
            (2,), dtype=torch.float32, device=device))
    system = ParticleSystem(cfg, [], render_data=rd, device=device)
    return system.system_uniforms(DT), system.render_data


def every_render_option(device):
    """Render data with every option: beziers of each time mode (sine,
    exp, loop, bounce, reversed) and count, a 1-channel colour bezier, a
    life-ramp texture and the velocity rotation."""
    rh, rw = 3, 8
    ramp = torch.as_tensor(np.random.default_rng(3).random(
        (rh, rw, 4), dtype=np.float32), device=device)
    return RenderDataUniforms(
        color_from_life=pack_bezier(
            [(0.2, 0.4, 0.6, 0.1), (1.0, 0.5, 0.2, 1.0), (0.3, 0.9, 1.0, 0.7),
             (0.0, 0.1, 0.2, 0.3)], min_value=0.0, max_value=2.5,
            mode=MODE_SINE | MODE_BOUNCE_BIT, device=device),
        color_from_velocity=pack_bezier(
            [[0.5], [1.5]], min_value=400.0, max_value=0.0,
            mode=MODE_EXP, device=device),
        size_from_life=pack_bezier([[1.0], [2.5], [3.0], [0.5]],
                                   min_value=0.5, max_value=1.5,
                                   mode=MODE_LOOP_BIT, device=device),
        size_from_velocity=pack_bezier([[2.0], [0.5], [1.0]], 0.0, 300.0,
                                       device=device),
        rotation_from_life_and_index=torch.tensor(
            [0.7, 0.001], dtype=torch.float32, device=device),
        velocity_rotation=torch.tensor(0.5, dtype=torch.float32,
                                       device=device),
        life_ramp=ramp,
        life_ramp_settings=pack_life_ramp_settings(
            strength=-0.8, minimum=0.1, maximum=2.9, texture_height=5,
            device=device),
        use_velocity_rotation=True)


def _rows_of(state):
    return [state.position, state.velocity, state.render_color,
            state.render_data]


def differing_slots(got, ref):
    """Slots (n,) bool where any of the four output rows of `got` differs
    from `ref`'s bit for bit."""
    out = None
    for a, b in zip(_rows_of(got), _rows_of(ref)):
        d = (a.cpu().contiguous().view(torch.int32)
             != b.cpu().contiguous().view(torch.int32)).any(dim=1)
        out = d if out is None else out | d
    return out


def far_share(got, ref):
    """The share of slots with an element of the four output rows beyond
    CPU_TOLERANCE x (1 + |ref|)."""
    far = None
    for a, b in zip(_rows_of(got), _rows_of(ref)):
        a, b = a.cpu(), b.cpu()
        d = ((a - b).abs() > CPU_TOLERANCE * (1.0 + b.abs())).any(1)
        far = d if far is None else far | d
    return float(far.float().mean())


def assert_bounded(got, card, cpu, share):
    """`got` within CPU_TOLERANCE of both eager bodies in all but `share`
    of the slots."""
    shares = far_share(got, card), far_share(got, cpu)
    assert max(shares) <= share, shares


def assert_matches(got, card, cpu):
    """`got` equals `card` bit for bit, and `cpu` within CPU_TOLERANCE in
    all but FAR_SHARE of the slots."""
    differ = differing_slots(got, card)
    assert int(differ.sum()) == 0, (
        f"{int(differ.sum())} slots differ from the eager body on the card, "
        f"first {torch.nonzero(differ)[:4].flatten().tolist()}")
    assert far_share(got, cpu) <= FAR_SHARE


def test_inputs_reach_the_cases():
    """On the CPU, the eager body over the test rows on the flagship's
    scene at 1 substep: slots die, keep their rows dead, collide (bounce,
    redirect, escape), some redirect along the slot hash (the normal has
    no xy part), some stay above maximum_z; the launch plan takes it."""
    n, maximum_z, first_slot = 20011, 50.0, 123457
    rows = state_rows(n)
    su, rd = flagship_uniforms("cpu")
    scene = flagship_scene("cpu")
    out = integ.integrate_with_distance_field_reference(
        as_state(rows, "cpu"), su, rd, scene, maximum_z, 1, first_slot)
    pos0, vel0 = rows[0], rows[1]
    pos, vel = out.position.numpy(), out.velocity.numpy()
    was_dead = pos0[:, 3] <= 0.0
    assert was_dead.sum() > 100
    np.testing.assert_array_equal(pos[was_dead], pos0[was_dead])
    died = ~was_dead & (pos[:, 3] == 0.0)
    assert died.sum() > 100
    collided = ~was_dead & ~died & (vel[:, 3] == integ.BOUNCE_DELAY)
    assert collided.sum() > 100
    redirected = collided & (vel[:, 2] == 0.0)
    fbx, fby = integ._slot_hash_direction(n, "cpu", first_slot)
    speed = np.hypot(vel[:, 0], vel[:, 1])
    along = (np.abs(vel[:, 0] - fbx.numpy() * speed) < 1e-3) & \
        (np.abs(vel[:, 1] - fby.numpy() * speed) < 1e-3)
    assert (redirected & along & (speed > 0)).sum() > 10
    assert (~was_dead & (pos0[:, 2] > maximum_z)).sum() > 100
    plan = k4.launch_plan(n, scene, 1, maximum_z, first_slot)
    assert plan["blocks"] * plan["threads"] >= n
    assert plan["kind"] == k4.FIELD_KINDS["analytic"]


def test_inputs_reach_the_polygons():
    """On the CPU, the eager body over `polygon_rows` on `polygon_scene`
    at 1 substep: slots over the POLYGONS collide, some of them with a
    normal from a polygon's side (a redirect along its xy part), and the
    launch plan reads the scene from device memory."""
    n = 20011
    rows = polygon_rows(n)
    su, rd = flagship_uniforms("cpu")
    scene = polygon_scene("cpu")
    out = integ.integrate_with_distance_field_reference(
        as_state(rows, "cpu"), su, rd, scene, 50.0, 1, 0)
    pos0 = torch.as_tensor(rows[0])
    poly = torch.as_tensor(np.array([
        [min(x for x, _ in p), min(y for _, y in p), max(x for x, _ in p),
         max(y for _, y in p)] for p in POLYGONS], np.float32))
    over = torch.zeros(n, dtype=torch.bool)
    for x0, y0, x1, y1 in poly.tolist():
        over |= ((pos0[:, 0] >= x0 - 5) & (pos0[:, 0] <= x1 + 5)
                 & (pos0[:, 1] >= y0 - 5) & (pos0[:, 1] <= y1 + 5))
    collided = out.velocity[:, 3] == integ.BOUNCE_DELAY
    assert int((collided & over).sum()) > 200
    side = collided & over & (out.velocity[:, 2] == 0.0) & (
        out.velocity[:, :2].abs().sum(1) > 0)
    assert int(side.sum()) > 20
    plan = k4.launch_plan(n, scene, 1)
    assert plan["kind"] == k4.FIELD_KINDS["analytic_global"]
    assert plan["ints"][2:] == [len(POLYGONS), 5]


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [0, 1, 2, 3])
@pytest.mark.parametrize("n", COUNTS)
def test_cuda_flagship_scene_equals_eager(n, substeps):
    """The flagship's AnalyticScene and uniforms, one launch: K4 equals
    the eager body on the card (`assert_matches`)."""
    _needs_card()
    rows = state_rows(n, seed=n + substeps)
    su, rd = flagship_uniforms("cuda")
    su_c, rd_c = flagship_uniforms("cpu")
    scene, st = flagship_scene("cuda"), as_state(rows, "cuda")
    first_slot = 0 if n == FULL else 77777
    cuda_build.reset_launches()
    got = integ.integrate_with_distance_field(st, su, rd, scene, 50.0,
                                              substeps, first_slot)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k4_integrate"] == 1
    card = integ.integrate_with_distance_field_reference(
        st, su, rd, scene, 50.0, substeps, first_slot)
    cpu = integ.integrate_with_distance_field_reference(
        as_state(rows, "cpu"), su_c, rd_c, flagship_scene("cpu"), 50.0,
        substeps, first_slot)
    assert_matches(got, card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [12, 64])
def test_cuda_mixed_scene_equals_eager(count):
    """Scenes of all five primitive types, half rotated, within the
    unroll limit: one K4 launch that equals the eager body on the card
    (`assert_matches`)."""
    _needs_card()
    n, substeps = 65537, 2
    rows = state_rows(n, seed=count)
    su, rd = flagship_uniforms("cuda")
    su_c, rd_c = flagship_uniforms("cpu")
    scene, st = mixed_scene(count, "cuda"), as_state(rows, "cuda")
    cuda_build.reset_launches()
    got = integ.integrate_with_distance_field(st, su, rd, scene, 50.0,
                                              substeps, 3)
    card = integ.integrate_with_distance_field_reference(
        st, su, rd, scene, 50.0, substeps, 3)
    assert cuda_build.launches()["k4_integrate"] == 1
    cpu = integ.integrate_with_distance_field_reference(
        as_state(rows, "cpu"), su_c, rd_c, mixed_scene(count, "cpu"), 50.0,
        substeps, 3)
    assert_matches(got, card, cpu)


GLOBAL_SCENES = {
    # name: (scene builder, rows builder)
    "batched": (lambda dev: mixed_scene(70, dev), state_rows),
    "polygons": (polygon_scene, polygon_rows),
    "polygons_batched": (lambda dev: polygon_scene(dev, 70), polygon_rows),
}


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("name", sorted(GLOBAL_SCENES))
def test_cuda_scene_in_device_memory_is_bounded(name, substeps):
    """Scenes K4 reads from device memory: 70 primitives of all five
    types (the batched forms, the central-difference normal), the
    flagship's occluders with two polygons (the autograd normal), and
    both. One K4 launch a call, within CPU_TOLERANCE of the eager body on
    the card and on the CPU in all but BATCHED_SHARE of the slots above
    the unroll limit, FAR_SHARE within it (`assert_bounded`); the polygons
    take part in the collisions."""
    _needs_card()
    build, rows_of = GLOBAL_SCENES[name]
    n = 65537
    rows = rows_of(n, seed=substeps)
    su, rd = flagship_uniforms("cuda")
    su_c, rd_c = flagship_uniforms("cpu")
    scene, st = build("cuda"), as_state(rows, "cuda")
    assert k4.launch_plan(n, scene, substeps)["kind"] == \
        k4.FIELD_KINDS["analytic_global"]
    cuda_build.reset_launches()
    got = integ.integrate_with_distance_field(st, su, rd, scene, 50.0,
                                              substeps, 3)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k4_integrate"] == 1
    card = integ.integrate_with_distance_field_reference(
        st, su, rd, scene, 50.0, substeps, 3)
    cpu = integ.integrate_with_distance_field_reference(
        as_state(rows, "cpu"), su_c, rd_c, build("cpu"), 50.0, substeps, 3)
    batched = sum(scene._counts()) > scene._UNROLL_LIMIT
    assert_bounded(got, card, cpu, BATCHED_SHARE if batched else FAR_SHARE)
    collided = got.velocity[:, 3] == integ.BOUNCE_DELAY
    assert int(collided.sum()) > n // 50
    if scene.polygons is not None:
        x, y = got.position[:, 0], got.position[:, 1]
        over = torch.zeros_like(collided)
        for p in POLYGONS:
            xs, ys = [v for v, _ in p], [v for _, v in p]
            over |= ((x >= min(xs)) & (x <= max(xs)) & (y >= min(ys))
                     & (y <= max(ys)))
        assert int((collided & over).sum()) > n // 200


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [4, 6])
def test_cuda_runtime_substeps_equal_eager(column_cell, substeps):
    """Above three substeps the run-time instance, on the flagship's
    scene and the particle cell's ColumnField: one launch, equal to the
    eager body on the card (`assert_matches`)."""
    field, su_col, rd_col = column_cell
    su, rd = flagship_uniforms("cuda")
    su_c, rd_c = flagship_uniforms("cpu")
    n = 65537
    rows = state_rows(n, seed=substeps)
    for volume, s_u, r_d, s_u_c, r_d_c, vol_c in (
            (flagship_scene("cuda"), su, rd, su_c, rd_c,
             flagship_scene("cpu")),
            (field, su_col, rd_col, _to_cpu(su_col), _to_cpu(rd_col),
             _to_cpu(field))):
        st = as_state(rows, "cuda")
        cuda_build.reset_launches()
        got = integ.integrate_with_distance_field(st, s_u, r_d, volume,
                                                  50.0, substeps, 21)
        torch.cuda.synchronize()
        assert cuda_build.launches()["k4_integrate"] == 1
        card = integ.integrate_with_distance_field_reference(
            st, s_u, r_d, volume, 50.0, substeps, 21)
        cpu = integ.integrate_with_distance_field_reference(
            as_state(rows, "cpu"), s_u_c, r_d_c, vol_c, 50.0, substeps, 21)
        assert_matches(got, card, cpu)


def particle_cell(device):
    """The particle cell's ColumnField (the voxel flagship's static field,
    (5, 135, 240) maps) and its config-4 system's uniforms."""
    import chip_smoke as cs

    _, field = cs._slice_field(device)
    system, _ = cs.config4_system(cs.particle_api(device), field,
                                  **cs.PARTICLE_FULL)
    return field, system


@pytest.fixture(scope="module")
def column_cell():
    _needs_card()
    field, system = particle_cell(torch.device("cuda"))
    return field, system.system_uniforms(1.0 / 60.0), system.render_data


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [0, 1, 2, 3])
@pytest.mark.parametrize("n", COUNTS)
def test_cuda_column_field_equals_eager(column_cell, n, substeps):
    """The particle cell's ColumnField and uniforms: one K4 launch and no
    column query (the field's pack is kept from the first call); K4
    equals the eager body on the card (`assert_matches`)."""
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    field, su, rd = column_cell
    rows = state_rows(n, seed=2 * n + substeps)
    st = as_state(rows, "cuda")
    ck.packed(field)
    cuda_build.reset_launches()
    got = integ.integrate_with_distance_field(st, su, rd, field, 50.0,
                                              substeps, 5)
    torch.cuda.synchronize()
    counts = cuda_build.launches()
    assert (counts["k4_integrate"], counts["k7_column_query"],
            counts["k7_column_pack"]) == (1, 0, 0)
    card = integ.integrate_with_distance_field_reference(
        st, su, rd, field, 50.0, substeps, 5)
    cpu = integ.integrate_with_distance_field_reference(
        as_state(rows, "cpu"), _to_cpu(su), _to_cpu(rd), _to_cpu(field),
        50.0, substeps, 5)
    assert_matches(got, card, cpu)


def _to_cpu(obj):
    import chip_smoke as cs

    return cs._to_device(obj, "cpu")


@pytest.mark.cuda
def test_cuda_every_render_option(column_cell):
    """Every render-data option (time modes, a 1-channel colour bezier,
    the life ramp, the velocity rotation) on the ColumnField at 3
    substeps: K4 equals the eager body on the card (`assert_matches`)."""
    field, su, _ = column_cell
    n = 65537
    rows = state_rows(n, seed=11)
    rd = every_render_option("cuda")
    st = as_state(rows, "cuda")
    got = integ.integrate_with_distance_field(st, su, rd, field, 50.0, 3, 9)
    assert float(got.render_data[:, 1].abs().max()) > 0.0
    card = integ.integrate_with_distance_field_reference(
        st, su, rd, field, 50.0, 3, 9)
    cpu = integ.integrate_with_distance_field_reference(
        as_state(rows, "cpu"), _to_cpu(su), _to_cpu(rd), _to_cpu(field),
        50.0, 3, 9)
    assert_matches(got, card, cpu)


@pytest.mark.cuda
def test_cuda_tick_launches_k4_and_no_column_query(column_cell):
    """The config-4 system's ticks on the ColumnField: one K4 launch a
    tick, no column query, the field's pack built once."""
    import chip_smoke as cs

    _, system = particle_cell(torch.device("cuda"))
    cuda_build.reset_launches()
    ticks = sum(system.update(cs.DT) for _ in range(3))
    torch.cuda.synchronize()
    assert ticks == 3
    counts = cuda_build.launches()
    assert (counts["k4_integrate"], counts["k7_column_query"],
            counts["k7_column_pack"]) == (3, 0, 1)


def _profile(fn):
    """fn() once, then once under torch.profiler -> (device us of each
    `illuminant/` span, the device operations (name, start, end), the
    names of the host operations)."""
    from test_torch_trace_cuda import held_us
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, ops, cpu_ops = {}, [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("illuminant/"):
                ops.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name.startswith("illuminant/"):
            spans[e.name] = spans.get(e.name, 0.0) + held_us(e)
        else:
            cpu_ops.append(e.name)
    return spans, ops, cpu_ops


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic", "column"])
def test_cuda_k4_span_holds_the_kernel(column_cell, kind):
    """One call at 1,048,576 slots in a torch.profiler trace:
    `illuminant/kernel/k4_integrate` holds `collide_integrate_kernel`'s
    device time within 1%, inside `illuminant/particle_integrate`; the
    call reads nothing on the host (no aten::_local_scalar_dense) and
    launches nothing else."""
    import re

    if kind == "analytic":
        su, rd = flagship_uniforms("cuda")
        field, substeps = flagship_scene("cuda"), 1
    else:
        field, su, rd = column_cell
        substeps = 3
    st = as_state(state_rows(FULL, seed=5), "cuda")
    spans, ops, cpu_ops = _profile(
        lambda: integ.integrate_with_distance_field(st, su, rd, field, 50.0,
                                                    substeps))
    own = [op for op in ops if re.search(r"\bcollide_integrate_kernel\b",
                                         op[0])]
    assert len(own) == 1 and len(ops) == 1, [op[0] for op in ops]
    us = own[0][2] - own[0][1]
    got = spans["illuminant/kernel/k4_integrate"]
    assert abs(got - us) <= 0.01 * us, (got, us)
    assert spans["illuminant/particle_integrate"] >= got
    assert "aten::_local_scalar_dense" not in cpu_ops


@pytest.mark.cuda
def test_cuda_plan_reports_each_instance(column_cell):
    """Every instance (each field kind, 0-3 substeps and the run-time
    count) loads on the card, four blocks of 256 threads an SM (its
    registers fit 64 a thread)."""
    _needs_card()
    field, _, _ = column_cell
    for volume in (flagship_scene("cuda"), field, polygon_scene("cuda")):
        for substeps in range(k4.RUNTIME_SUBSTEPS + 1):
            plan = k4.block_plan(volume, substeps)
            assert plan["registers"] <= 64, plan
            assert plan["blocks_per_sm"] >= 4, plan
