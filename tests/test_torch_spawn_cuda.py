"""The particles' spawn (K4b, csrc/spawn.cu) on the card against its plain
version, the eager body `spawner.spawn_reference` (the animated uniforms
evaluated by `spawner.animated`), run on the same CUDA tensors.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_spawn_cuda.py

Here, without a card, the `cuda` cases skip and the CPU cases check that
the inputs reach what the card cases are about.

Tolerance: none. Every written row, every slot the window leaves alone,
the cursor and the total equal the eager body's on the card bit for bit
(K4b keeps its operation order, the card's order of torch.sum over a
3-wide axis included, its roots and quotients are IEEE and its sines and
cosines CUDA's precise forms, as torch's are on the card).
"""

import functools

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.ops.bezier import (DynamicMatrix, MODE_LOOP_BIT,
                                             MODE_SINE, pack_bezier_matrix)
from illuminant_tpu_torch.particles import spawn_kernel as k4b
from illuminant_tpu_torch.particles import spawner
from illuminant_tpu_torch.particles.formula import (FORMULA_LINEAR,
                                                    FORMULA_RECTANGULAR,
                                                    FORMULA_SPHERICAL,
                                                    FORMULA_TOWARDS,
                                                    Formula1, Formula3,
                                                    Formula4)
from illuminant_tpu_torch.particles.state import ParticleState

WIDTH, HEIGHT = 1920, 1080
SPAWN_MAX = 4096
CAPACITY = 1 << 16
DT = 1.0 / 60.0
# Frames across the flagship's 4 s (240-frame) and 6 s (360-frame) wraps.
FRAMES = (0, 1, 239, 240, 241, 359, 360, 361, 719, 720, 1234)
ROWS = ("position", "velocity", "color")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


def ring(capacity, cursor, total, device, seed=0):
    """A ring of random rows (the slots a spawn leaves must stay as they
    are) with its cursor and total."""
    g = torch.Generator().manual_seed(seed)
    rows = [torch.rand((capacity, 4), generator=g) * 100.0 - 20.0
            for _ in range(3)]
    return ParticleState(
        *(r.to(device) for r in rows),
        render_color=torch.zeros((capacity, 4), device=device),
        render_data=torch.zeros((capacity, 4), device=device),
        write_cursor=torch.tensor(cursor, dtype=torch.int32, device=device),
        total_spawned=torch.tensor(total, dtype=torch.int32, device=device))


def copy(state):
    return state.replace(**{n: getattr(state, n).clone() for n in ROWS})


def draws(spawn_max, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((spawn_max, 4), generator=g).to(device)
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def flagship_spawn(device, spawn_max=SPAWN_MAX):
    """The 1080p flagship's spawner and the uniforms its particle stage
    hands the spawn (scenes._FlagshipFrame: the emission path wrapped at
    6 s, the velocity post-matrix at 4 s)."""
    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(height=96, width=160, n_lights=2,
                           capacity=spawn_max, spawn_max=spawn_max,
                           device=device)
    frame = scene.frame.__self__
    return frame.spawner, frame.spawn_u


def config4_spawner(device):
    """The particle cell's spawner (framebench's config-4 system at 1080p)
    and its uniforms."""
    from framebench.lib.loader import module

    system = module("scenes", "particles-config4-1080p").config4_system(
        None, HEIGHT, WIDTH, 1 << 12, SPAWN_MAX, device)
    sp = system.spawners[0]
    return sp, sp.uniforms(0.0, device)


def pattern_spawner(device):
    """A PatternSpawner of 15 x 12 pixels with colours, every other one
    under the alpha threshold: P = 90 position constants."""
    img = np.zeros((15, 12, 4), np.float32)
    img[..., 0] = np.linspace(0.1, 1.0, 12)[None, :]
    img[..., 1] = np.linspace(1.0, 0.2, 15)[:, None]
    img[..., 2] = 0.5
    img[..., 3] = np.where(np.indices((15, 12)).sum(0) % 2, 1.0, 0.01)
    sp = spawner.PatternSpawner(
        image=img, pixel_scale=4.0, min_rate=1e4, max_rate=1e4,
        position=Formula3(constant=(300.0, 200.0, 5.0),
                          random_scale=(1.0, 1.0, 0.5)),
        color=Formula4(constant=(1.0, 0.8, 0.6, 1.0),
                       random_scale=(0.2, 0.2, 0.2, 0.0)),
        spawn_max=SPAWN_MAX)
    assert sp.pattern_size == 90
    return sp, sp.uniforms(0.0, device)


def polygon_spawner(device, loop):
    """A polygon walk over 5 points at 3.5 particles a point, with a
    velocity along the path; looped or clamped."""
    sp = spawner.Spawner(
        min_rate=1e4, max_rate=1e4,
        position=Formula3(constant=(100.0, 100.0, 10.0),
                          random_scale=(2.0, 2.0, 1.0),
                          type=FORMULA_RECTANGULAR, offset=(3.0, 0.0, 1.0)),
        additional_positions=[(400.0, 120.0, 10.0), (380.0, 500.0, 12.0),
                              (90.0, 460.0, 8.0), (100.0, 100.0, 10.0)],
        velocity=Formula3(constant=(1.0, 2.0, 0.0),
                          random_scale=(10.0, 10.0, 1.0),
                          offset=(5.0, 5.0, 0.0), type=FORMULA_TOWARDS),
        polygon_rate=3.5, polygon_loop=loop,
        velocity_along_polygon=Formula1(constant=20.0, random_scale=5.0,
                                        offset=0.25),
        spawn_max=SPAWN_MAX)
    return sp, sp.uniforms(0.0, device)


def animated_spawner(device):
    """Both post-matrices animated (one fully dynamic, one mixed, in sine
    and looping time), linear formulas, a discard threshold above 0."""
    dyn = [DynamicMatrix.from_components(angle=a, scale=s, translation=t,
                                         device=device)
           for a, s, t in ((10.0, 1.0, (0.0, 0.0, 0.0)),
                           (50.0, 1.3, (5.0, -3.0, 1.0)),
                           (-20.0, 0.8, (2.0, 2.0, 0.0)))]
    explicit = DynamicMatrix.from_matrix(
        np.arange(16, dtype=np.float32).reshape(4, 4) * 0.05 + np.eye(4),
        device=device)
    sp = spawner.Spawner(
        min_rate=1e4, max_rate=1e4,
        life=Formula1(constant=1.0, random_scale=2.0),
        position=Formula3(constant=(50.0, 60.0, 5.0),
                          random_scale=(20.0, 20.0, 2.0),
                          type=FORMULA_LINEAR),
        velocity=Formula3(random_scale=(8.0, 8.0, 1.0),
                          type=FORMULA_SPHERICAL),
        color=Formula4(constant=(0.5, 0.5, 0.5, 0.2),
                       random_scale=(0.5, 0.5, 0.5, 0.8)),
        axis_mask=(1.0, 1.0, 0.0), alpha_discard_threshold=100.0,
        position_post_matrix=pack_bezier_matrix(
            dyn, 0.0, 3.0, mode=MODE_SINE, device=device),
        velocity_post_matrix=pack_bezier_matrix(
            [dyn[0], explicit, dyn[2], explicit], 0.0, 2.0,
            mode=MODE_LOOP_BIT, device=device),
        spawn_max=SPAWN_MAX)
    return sp, sp.uniforms(0.0, device)


SPAWNERS = {"config4": config4_spawner, "pattern": pattern_spawner,
            "polygon_loop": lambda d: polygon_spawner(d, True),
            "polygon_clamp": lambda d: polygon_spawner(d, False),
            "animated": animated_spawner}


def run_both(state, u, count, spawn_max, time, sub_rings=1, shard=None,
             seed=1):
    """K4b and the eager body on copies of `state` on the card -> (the
    kernel's state, the eager one's); the kernel launched once."""
    dev = state.position.device
    d = draws(spawn_max, dev, seed)
    cuda_build.reset_launches()
    got = spawner.spawn(copy(state), u, count, spawn_max, uniforms=d,
                        sub_rings=sub_rings, shard=shard, time=time)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k4b_spawn"] == 1
    ref = spawner.spawn_reference(copy(state), u, count, spawn_max,
                                  uniforms=d, sub_rings=sub_rings,
                                  shard=shard, time=time)
    return got, ref


def assert_equal(got, ref, before):
    """Every row bit for bit, the cursor and total equal; slots left
    as they were."""
    for name in ROWS:
        a, b = getattr(got, name), getattr(ref, name)
        differ = (a.view(torch.int32) != b.view(torch.int32)).any(dim=1)
        assert int(differ.sum()) == 0, (
            f"{name}: {int(differ.sum())} slots differ from the eager body "
            f"on the card, first {torch.nonzero(differ)[:4].flatten()}")
    assert int(got.write_cursor) == int(ref.write_cursor)
    assert int(got.total_spawned) == int(ref.total_spawned)
    assert got.write_cursor.dtype == torch.int32
    changed = (ref.position != before.position).any(dim=1)
    assert int(changed.sum()) < before.capacity


def test_inputs_reach_the_cases():
    """On the CPU, the eager body on each case's uniforms: the flagship's
    emission path moves across the 6 s wrap and its matrix across the
    4 s wrap; the pattern spawner reads its 90 constants and colours; the
    polygon walk reaches every point, clamped it stops at the last; the
    animated spawner discards part of its rows."""
    sp, u = flagship_spawn("cpu", spawn_max=256)
    at = [spawner.animated(u, torch.tensor(i * DT)) for i in (359, 360)]
    assert not torch.equal(at[0].position_constants,
                           at[1].position_constants)
    at = [spawner.animated(u, torch.tensor(i * DT)) for i in (239, 240)]
    assert not torch.equal(at[0].velocity_matrix, at[1].velocity_matrix)
    _, pu = pattern_spawner("cpu")
    assert pu.position_constants.shape == (90, 4)
    assert pu.position_colors is not None
    for loop in (True, False):
        _, gu = polygon_spawner("cpu", loop)
        st = spawner.spawn_reference(ring(CAPACITY, 0, 0, "cpu"), gu, 64,
                                     SPAWN_MAX, uniforms=draws(SPAWN_MAX,
                                                               "cpu"))
        x = st.position[:64, 0]
        assert float(x.max()) > 350.0 and float(x.min()) < 120.0
    for name, case in SPAWNERS.items():
        _, cu = case("cpu")
        st = spawner.spawn_reference(ring(CAPACITY, 0, 0, "cpu"), cu, 3,
                                     SPAWN_MAX, uniforms=draws(SPAWN_MAX,
                                                               "cpu"),
                                     time=0.5)
        assert int(st.total_spawned) == 3, name
    _, au = animated_spawner("cpu")
    before = ring(CAPACITY, 0, 0, "cpu")
    st = spawner.spawn_reference(copy(before), au, SPAWN_MAX, SPAWN_MAX,
                                 uniforms=draws(SPAWN_MAX, "cpu"), time=0.7)
    kept = int((st.position[:SPAWN_MAX] != before.position[:SPAWN_MAX])
               .any(dim=1).sum())
    assert 0 < kept < SPAWN_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("frame", FRAMES)
def test_cuda_flagship_spawn_equals_eager(frame):
    """The flagship's spawn at frame i (time i / 60 s on the device, the
    path wrapped at 6 s, the matrix at 4 s), across the wraps, into a ring
    whose window runs over its end at some frames."""
    _needs_card()
    dev = torch.device("cuda")
    _, u = flagship_spawn(dev)
    t = torch.tensor(float(frame), device=dev) * DT
    cursor = (frame * SPAWN_MAX) % CAPACITY + (frame % 3) * 1000
    state = ring(CAPACITY, cursor % CAPACITY, frame * SPAWN_MAX, dev,
                 seed=frame)
    got, ref = run_both(state, u, SPAWN_MAX, SPAWN_MAX, t, seed=frame)
    assert_equal(got, ref, state)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [SPAWN_MAX, 2500, 1])
@pytest.mark.parametrize("name", sorted(SPAWNERS))
def test_cuda_spawner_equals_eager(name, count):
    """The config-4 spawner, a PatternSpawner (P = 90, colours), the
    polygon walk looped and clamped, both post-matrices animated with a
    discard threshold; a full window and counts below spawn_max, at the
    ring's end and in the middle."""
    _needs_card()
    dev = torch.device("cuda")
    _, u = SPAWNERS[name](dev)
    cursor = CAPACITY - 1500 if count > 1 else 77
    state = ring(CAPACITY, cursor, 123456 + count, dev, seed=count)
    got, ref = run_both(state, u, count, SPAWN_MAX, 0.85 + count * 1e-3)
    assert_equal(got, ref, state)


@pytest.mark.cuda
@pytest.mark.parametrize("sub_rings, shard", [
    (2, None), (4, None), (1, (0, 2)), (1, (1, 2)), (2, (0, 2)),
    (2, (1, 2)), (4, (1, 2))])
def test_cuda_partitioned_ring_equals_eager(sub_rings, shard):
    """Sub-rings 2 and 4 and a mesh rank's shard of 2: the flagship's
    spawn into a ring whose window straddles the shards, a count that
    rounds down and a count on the device."""
    _needs_card()
    dev = torch.device("cuda")
    _, u = flagship_spawn(dev)
    capacity = CAPACITY // (1 if shard is None else shard[1])
    cursor = CAPACITY // 2 - 1000
    state = ring(capacity, cursor, 99, dev, seed=sub_rings)
    t = torch.tensor(500.0, device=dev) * DT
    for count in (SPAWN_MAX - 3, torch.tensor(3001, device=dev)):
        got, ref = run_both(state, u, count, SPAWN_MAX, t, sub_rings,
                            shard)
        for name in ROWS:
            assert torch.equal(getattr(got, name).view(torch.int32),
                               getattr(ref, name).view(torch.int32)), name
        assert int(got.write_cursor) == int(ref.write_cursor)
        assert int(got.total_spawned) == int(ref.total_spawned)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity, count, sub_rings, shard", [
    (1000, SPAWN_MAX, 1, None), (1000, 2500, 1, None), (1000, 700, 1, None),
    (2048, SPAWN_MAX - 5, 4, None), (1000, 3001, 1, (1, 2)),
    (512, SPAWN_MAX, 4, (1, 2))])
@pytest.mark.parametrize("name", ["flagship", "animated"])
def test_cuda_overlapping_window_equals_eager(name, capacity, count,
                                              sub_rings, shard):
    """A window longer than its ring (or a sub-ring's segment longer than
    its block): one launch, each slot the newest row that the count and
    the discard keep (the animated spawner discards part of its rows), as
    the eager body's ordered write keeps it; a shard of such a ring."""
    _needs_card()
    dev = torch.device("cuda")
    u = flagship_spawn(dev)[1] if name == "flagship" \
        else animated_spawner(dev)[1]
    ranks = 1 if shard is None else shard[1]
    assert SPAWN_MAX // sub_rings > capacity * ranks // sub_rings
    state = ring(capacity, 333 % (capacity * ranks), 4242, dev, seed=count)
    t = torch.tensor(1.7, device=dev)
    got, ref = run_both(state, u, count, SPAWN_MAX, t, sub_rings, shard)
    for row in ROWS:
        assert torch.equal(getattr(got, row).view(torch.int32),
                           getattr(ref, row).view(torch.int32)), row
    assert int(got.write_cursor) == int(ref.write_cursor)
    assert int(got.total_spawned) == int(ref.total_spawned)
    changed = (ref.position != state.position).any(dim=1)
    assert int(changed.sum()) > 0


@pytest.mark.cuda
def test_cuda_flagship_frame_launches_k4b_once():
    """A small flagship frame on the card spawns through one K4b launch;
    a tick of the particle cell's system too."""
    _needs_card()
    from illuminant_tpu_torch.scenes import build_flagship

    dev = torch.device("cuda")
    scene = build_flagship(height=96, width=160, n_lights=2,
                           capacity=1 << 12, spawn_max=256, device=dev)
    env_u = scene.environment.uniforms(device=dev)
    state = scene.system.state
    avg = torch.tensor(0.5, device=dev)
    for i in range(3):
        cuda_build.reset_launches()
        _, state, avg, _ = scene.frame(
            state, avg, None, scene.volume, scene.gbuffer,
            scene.sphere_lights, env_u, 256, frame_index=i,
            spawn_uniforms=draws(256, dev, seed=i))
        torch.cuda.synchronize()
        assert cuda_build.launches()["k4b_spawn"] == 1
    from framebench.lib.loader import module

    system = module("scenes", "particles-config4-1080p").config4_system(
        None, HEIGHT, WIDTH, 1 << 13, SPAWN_MAX, dev)
    for i in range(3):
        cuda_build.reset_launches()
        system.tick(DT, spawn_uniforms=[draws(SPAWN_MAX, dev, seed=i)])
        torch.cuda.synchronize()
        assert cuda_build.launches()["k4b_spawn"] == 1
    assert int(system.state.total_spawned) == 3 * SPAWN_MAX


@pytest.mark.cuda
def test_cuda_k4b_span_holds_the_kernel():
    """One flagship spawn in a torch.profiler trace:
    `illuminant/kernel/k4b_spawn` holds `spawn_kernel`'s device time,
    inside `illuminant/particle_spawn`; the call reads nothing on the host
    and launches nothing else."""
    import re

    from test_torch_integrate_cuda import _profile

    _needs_card()
    dev = torch.device("cuda")
    _, u = flagship_spawn(dev)
    state = ring(CAPACITY, 5, 5, dev)
    d = draws(SPAWN_MAX, dev)
    t = torch.tensor(7.0, device=dev)
    spans, ops, cpu_ops = _profile(lambda: spawner.spawn(
        state, u, SPAWN_MAX, SPAWN_MAX, uniforms=d, time=t))
    own = [op for op in ops if re.search(r"\bspawn_kernel\b", op[0])]
    assert len(own) == 1 and len(ops) == 1, [op[0] for op in ops]
    us = own[0][2] - own[0][1]
    got = spans["illuminant/kernel/k4b_spawn"]
    assert abs(got - us) <= max(0.01 * us, 0.5), (got, us)
    assert spans["illuminant/particle_spawn"] >= got
    assert "aten::_local_scalar_dense" not in cpu_ops


@pytest.mark.cuda
def test_cuda_plan_reports_the_block():
    """The kernel loads on the card: 256 threads, the uniform table in
    static shared memory, a small stack frame (thread 0's animation
    arrays; ptxas reports no spills), at least two blocks an SM (a
    4,096-row window is 16 blocks over the card's 132 SMs)."""
    _needs_card()
    plan = k4b.block_plan()
    assert plan["threads"] == k4b.THREADS
    assert plan["smem_bytes"] >= 4 * k4b.UNIFORM_FLOATS, plan
    assert plan["local_bytes"] <= 64 and plan["registers"] <= 96, plan
    assert plan["blocks_per_sm"] >= 2, plan
