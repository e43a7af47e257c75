"""The particle tick's modifier chain (K4c, csrc/modifiers.cu) on the card
against its plain version, the eager chain of `transforms.apply_*`, run on
the same CUDA tensors.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_modifier_cuda.py

Here, without a card, the `cuda` cases skip and the CPU cases check that
the inputs reach what the card cases are about.

Tolerance: none. At 1,048,576 slots (dead ones among them) every element
of the position and velocity rows equals the eager chain's on the card bit
for bit: the slots that differ are counted and the count is held to
DIFFER_MAX = 0 (K4c keeps the eager operation order, the card's orders of
torch.sum over a 3-wide axis and over the attractors included, and its
roots and quotients are IEEE).
"""

import functools

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.ops.noise import RandomField
from illuminant_tpu_torch.particles import modifier_kernel as k4c
from illuminant_tpu_torch.particles import transforms as tx
from illuminant_tpu_torch.particles.state import SystemUniforms

WIDTH, HEIGHT = 1920, 1080
SLOTS = 1 << 20
DT = 1.0 / 60.0
NOW = 1.37  # a Noise's frequency_lerp between 0 and 1
# Slots allowed to differ from the eager chain on the card in any case.
DIFFER_MAX = 0
AREA_TYPES = (0, 1, 2, 3, 4, 5)
# A filter that keeps categories 1 and 2 of 0-3.
CUT = (0.5, 2.5)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


def rows(n, device, seed=0):
    """(position, velocity) of `n` slots over the 1080p frame: a quarter
    dead (life <= 0), categories 0-3, speeds up to ~80."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 4), generator=g)
    pos[:, 0] *= WIDTH
    pos[:, 1] *= HEIGHT
    pos[:, 2] *= 64.0
    pos[:, 3] = pos[:, 3] * 4.0 - 1.0
    vel = (torch.rand((n, 4), generator=g) - 0.5) * 160.0
    vel[:, 3] = torch.randint(0, 4, (n,), generator=g).float()
    return pos.to(device), vel.to(device)


def system_uniforms(device, maximum_velocity=220.0 * HEIGHT / 512.0):
    return SystemUniforms.make(dt=DT, friction=0.1,
                               maximum_velocity=maximum_velocity,
                               device=device)


def area(type_id):
    """An area of `type_id` around the frame's centre, rotated: it holds
    part of the slots and leaves the rest (falloff 40)."""
    return tx.TransformArea(type=type_id, center=(WIDTH * 0.5, HEIGHT * 0.5,
                                                  20.0),
                            size=(300.0, 180.0, 30.0), falloff=40.0,
                            rotation_z=0.6)


def swirl(n=64):
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    field = np.zeros((n, n, 4), np.float32)
    norm = np.sqrt((xx - n / 2) ** 2 + (yy - n / 2) ** 2) + 1e-3
    field[..., 0], field[..., 1] = -(yy - n / 2) / norm, (xx - n / 2) / norm
    field[..., 2] = 0.25
    field[..., 3] = np.linspace(-1.0, 1.0, n * n).reshape(n, n)
    return field


def transform(kind, type_id=0, cut=False, variant=0):
    """A transform of `kind` over an area of `type_id`, its filter cutting
    the population where `cut`; `variant` 1 takes the kind's other branch
    (replace instead of add, no time scaling, a GeometricTransform)."""
    kw = dict(area=area(type_id), category_filter=CUT if cut else
              (-1e9, 1e9))
    cps = None if variant else 4.0
    if kind == "fma":
        return tx.FMA(position_add=(3.0, -2.0, 0.5),
                      position_multiply=(0.99, 1.01, 0.9),
                      velocity_add=(5.0, 1.0, -2.0),
                      velocity_multiply=(0.8, 1.1, 1.0),
                      cycles_per_second=cps, strength=0.7, **kw)
    if kind == "matrix_multiply":
        if variant:
            return tx.GeometricTransform(
                position_pre_translate=(-960.0, -540.0, 0.0),
                position_rotation=(0.0, 0.0, 0.3),
                position_post_translate=(960.0, 540.0, 0.0),
                position_post_scale=1.02, velocity_rotation=(0.1, 0.2, 0.4),
                velocity_scale=0.9, cycles_per_second=None, **kw)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] += np.arange(9, dtype=np.float32).reshape(3, 3) * 0.01
        m[3, :3] = (4.0, -3.0, 1.0)
        return tx.MatrixMultiply(position_matrix=m, velocity_matrix=m.T.copy(),
                                 cycles_per_second=cps, strength=0.8, **kw)
    if kind == "vector_field":
        return tx.VectorField(field=swirl(), field_scale=(64.0 / HEIGHT,) * 2,
                              field_offset=(3.5, -7.25),
                              velocity_scale=(160.0, 160.0, 20.0, 3.0),
                              replace_old_velocity=bool(variant),
                              cycles_per_second=3.0, **kw)
    noise = tx.Noise(position_offset=(-0.5, -0.5, -0.5, 0.0),
                     position_minimum=(0.1, 0.2, 0.0, 0.0),
                     position_scale=(2.0, 2.0, 0.5, 0.1),
                     velocity_minimum=(0.05, 0.0, 0.1, 0.0),
                     velocity_scale=(18.0, 18.0, 3.0, 1.5),
                     replace_old_velocity=bool(variant),
                     cycles_per_second=cps, space_scale=(7.0, 5.0),
                     spatial=kind == "spatial_noise",
                     _rng=np.random.default_rng(3), **kw)
    return noise


def gravity(attractors, cut=False, maximum_acceleration=40.0):
    """`attractors` attractors over the frame, their falloffs cycling
    through physical, linear and exponential, one a repulsor."""
    at = [tx.Attractor(position=(WIDTH * (0.2 + 0.6 * ((i * 7) % 11) / 10),
                                 HEIGHT * (0.2 + 0.6 * ((i * 3) % 7) / 6),
                                 5.0 + 3.0 * i),
                       radius=300.0 + 40.0 * i,
                       strength=(60.0 if i % 4 else -90.0) + i,
                       falloff_type=i % 3)
          for i in range(attractors)]
    return tx.Gravity(attractors=at,
                      maximum_acceleration=maximum_acceleration,
                      category_filter=CUT if cut else (-1e9, 1e9))


def steps_of(transforms, device, now=NOW):
    return [(k4c_eager(t), t.uniforms(now, device)) for t in transforms]


def k4c_eager(t):
    """The eager function of transform `t` (as ParticleSystem._build_step
    picks it)."""
    if isinstance(t, tx.Noise):
        return tx.apply_spatial_noise if t.spatial else tx.apply_noise
    for cls, f in ((tx.FMA, tx.apply_fma), (tx.Gravity, tx.apply_gravity),
                   (tx.VectorField, tx.apply_vector_field),
                   (tx.MatrixMultiply, tx.apply_matrix_multiply)):
        if isinstance(t, cls):
            return f
    raise TypeError(type(t).__name__)


@functools.lru_cache(maxsize=None)
def random_field(device):
    return RandomField.create(torch.Generator(device).manual_seed(11),
                              device=device)


def run_both(transforms, n=SLOTS, seed=0, su=None):
    """K4c through `apply_modifiers` and the eager chain on the card ->
    the slots that differ (position or velocity, bit for bit); the kernel
    launched once and its inputs left as they were."""
    dev = torch.device("cuda")
    pos, vel = rows(n, dev, seed)
    before = (pos.clone(), vel.clone())
    su = su or system_uniforms(dev)
    field = random_field(dev)
    steps = steps_of(transforms, dev)
    cuda_build.reset_launches()
    got = tx.apply_modifiers(pos, vel, steps, su, field)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k4c_modifiers"] == 1
    ref = tx.apply_modifiers_reference(pos, vel, steps, su, field)
    assert torch.equal(pos, before[0]) and torch.equal(vel, before[1])
    differ = torch.zeros(n, dtype=torch.bool, device=dev)
    for a, b in zip(got, ref):
        differ |= (a.view(torch.int32) != b.view(torch.int32)).any(dim=1)
    changed = ((ref[0] != pos) | (ref[1] != vel)).any(dim=1)
    return int(differ.sum()), int(changed.sum())


def assert_equal(transforms, **kw):
    differ, changed = run_both(transforms, **kw)
    assert differ <= DIFFER_MAX, (
        f"{differ} slots differ from the eager chain on the card")
    assert changed > 0


def test_inputs_reach_the_cases():
    """On the CPU at a small size: each area type holds some slots and
    leaves others, the cut filter and the dead slots leave some alone,
    Gravity's maximum acceleration clamps some, and each kind changes the
    rows."""
    n = 1 << 14
    pos, vel = rows(n, "cpu")
    su = system_uniforms("cpu")
    for type_id in AREA_TYPES[1:]:
        w = tx.area_weight(pos[:, :3], area(type_id).uniforms(1.0))
        assert 0 < int((w > 0).sum()) < n, type_id
        assert int(((w > 0) & (w < 1)).sum()) > 0, type_id
    assert 0 < int((pos[:, 3] <= 0).sum()) < n
    field = RandomField.create(torch.Generator().manual_seed(11),
                               device="cpu")
    kinds = ("fma", "matrix_multiply", "vector_field", "noise",
             "spatial_noise")
    for kind in kinds:
        for variant in (0, 1):
            steps = steps_of([transform(kind, cut=True, variant=variant)],
                             "cpu")
            p, v = tx.apply_modifiers_reference(pos, vel, steps, su, field)
            moved = ((p != pos) | (v != vel)).any(dim=1)
            assert 0 < int(moved.sum()) < n, (kind, variant)
    g = gravity(5)
    u = g.uniforms(0.0)
    assert u.radiuses.shape == (6,)
    _, v = tx.apply_gravity(pos, vel, u, su)
    dv = (v - vel)[:, :3].norm(dim=1)
    assert float(dv.max()) <= 40.0 * DT * 1.001
    assert int((dv > 40.0 * DT * 0.999).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("type_id", AREA_TYPES)
@pytest.mark.parametrize("kind", ["fma", "matrix_multiply", "vector_field",
                                  "noise", "spatial_noise"])
def test_cuda_kind_equals_eager(kind, type_id, cut, variant):
    """Each kind with an area alone, over every area type, with and
    without a filter that cuts the population, in both branches (time
    scaling or none, replace or add, a GeometricTransform)."""
    _needs_card()
    assert_equal([transform(kind, type_id, cut, variant)], seed=type_id)


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("attractors", [1, 2, 3, 5, 6, 8, 11, 16])
def test_cuda_gravity_equals_eager(attractors, cut):
    """Gravity with 1-16 attractors (padded to 2-16), the three falloffs, a
    repulsor, the acceleration clamp and the maximum velocity."""
    _needs_card()
    assert_equal([gravity(attractors, cut)], seed=attractors,
                 su=system_uniforms(torch.device("cuda"),
                                    maximum_velocity=30.0))


@functools.lru_cache(maxsize=None)
def cell_system(device):
    """The particle cell's system (framebench's config-4 system at 1080p,
    1,048,576 slots, no field: the modifiers do not read it)."""
    from framebench.lib.loader import module

    return module("scenes", "particles-config4-1080p").config4_system(
        None, HEIGHT, WIDTH, SLOTS, 4096, device)


def flagship_frame(device):
    """The 1080p flagship's particle stage (scenes._FlagshipFrame): its
    two attractors and its SystemUniforms."""
    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(height=HEIGHT, width=WIDTH, n_lights=2,
                           capacity=4096, spawn_max=256, device=device)
    return scene.frame.__self__


def test_cell_lists_are_what_the_cases_name():
    """On the CPU: the particle cell's tick runs VectorField, Gravity (one
    attractor, padded to 2) and temporal Noise over the 'everywhere' area;
    the flagship's stage runs Gravity with 2 attractors."""
    from framebench.lib.loader import module

    system = module("scenes", "particles-config4-1080p").config4_system(
        None, HEIGHT, WIDTH, 1 << 12, 4096, "cpu")
    steps = [(f, t.uniforms(0.0, "cpu")) for t, f in system._step]
    assert k4c.program(steps) == (("vector_field", 0), ("gravity", 2),
                                  ("noise", 0))
    assert all(int(u.area.type) == 0 for f, u in steps
               if f is not tx.apply_gravity)
    frame = flagship_frame("cpu")
    assert k4c.program([(tx.apply_gravity, frame.grav_u)]) == (
        ("gravity", 2),)


@pytest.mark.cuda
@pytest.mark.parametrize("now", [0.0, NOW, 2.9])
def test_cuda_cell_list_equals_eager(now):
    """The particle cell's step list (its system's transforms and its
    SystemUniforms at the tick's dt) at three times: the Noise's offsets
    cycle and its frequency_lerp moves."""
    _needs_card()
    dev = torch.device("cuda")
    system = cell_system(dev)
    su = system.system_uniforms(DT)
    pos, vel = rows(SLOTS, dev, seed=5)
    steps = [(f, t.uniforms(now, dev)) for t, f in system._step]
    cuda_build.reset_launches()
    got = tx.apply_modifiers(pos, vel, steps, su, system.random_field)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k4c_modifiers"] == 1
    ref = tx.apply_modifiers_reference(pos, vel, steps, su, system.random_field)
    differ = sum(int((a.view(torch.int32) != b.view(torch.int32)).any(dim=1)
                     .sum()) for a, b in zip(got, ref))
    assert differ <= DIFFER_MAX, differ


@pytest.mark.cuda
def test_cuda_flagship_list_equals_eager():
    """The flagship's gravity list on its own SystemUniforms."""
    _needs_card()
    dev = torch.device("cuda")
    frame = flagship_frame(dev)
    pos, vel = rows(SLOTS, dev, seed=9)
    steps = [(tx.apply_gravity, frame.grav_u)]
    cuda_build.reset_launches()
    got = tx.apply_modifiers(pos, vel, steps, frame.su)
    torch.cuda.synchronize()
    assert cuda_build.launches()["k4c_modifiers"] == 1
    ref = tx.apply_modifiers_reference(pos, vel, steps, frame.su, None)
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_cuda_every_kind_in_one_list_equals_eager():
    """Every kind in one list, over mixed areas and filters, so that each
    step reads the rows the previous one left; and a list longer than one
    launch's limits (18 steps) as two launches."""
    _needs_card()
    chain = [transform("fma", 2, True), gravity(3),
             transform("vector_field", 4, False, 1),
             transform("matrix_multiply", 5, True, 1),
             transform("noise", 1, True), transform("spatial_noise", 3),
             gravity(16, True), transform("matrix_multiply", 0)]
    assert_equal(chain)
    long = chain + chain + [transform("noise", 0), gravity(2)]
    plan = k4c.launch_plan(k4c.program(steps_of(long, "cpu")), SLOTS)
    assert len(plan["chunks"]) == 2
    dev = torch.device("cuda")
    pos, vel = rows(SLOTS, dev, seed=2)
    su = system_uniforms(dev)
    steps = steps_of(long, dev)
    cuda_build.reset_launches()
    got = tx.apply_modifiers(pos, vel, steps, su, random_field(dev))
    torch.cuda.synchronize()
    assert cuda_build.launches()["k4c_modifiers"] == 2
    ref = tx.apply_modifiers_reference(pos, vel, steps, su, random_field(dev))
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_cuda_ticks_launch_k4c_once_and_rewrite_changed_pointers():
    """The particle cell's system ticks on the card: one K4c launch a
    tick, none of the eager chain's kernels; its launch arrays are kept
    across ticks and only the Noise's moving uniforms are rewritten. A
    small flagship frame launches K4c once too."""
    _needs_card()
    dev = torch.device("cuda")
    from framebench.lib.loader import module

    system = module("scenes", "particles-config4-1080p").config4_system(
        None, HEIGHT, WIDTH, 1 << 13, 4096, dev)
    draws = [[torch.rand((4096, 4), device=dev) for _ in range(3)]]
    system.tick(DT, spawn_uniforms=draws)
    kept = system.system_uniforms(DT)._k4c_launch[1]
    sources = list(kept[0].sources)
    for _ in range(3):
        cuda_build.reset_launches()
        system.tick(DT, spawn_uniforms=draws)
        torch.cuda.synchronize()
        assert cuda_build.launches()["k4c_modifiers"] == 1
    assert system.system_uniforms(DT)._k4c_launch[1] is kept
    now = kept[0].sources
    moved = [j for j, (a, b) in enumerate(zip(sources, now)) if a is not b]
    names = ["field"] * 3 + ["global_settings"] + [
        name for kind in kept[0].kinds
        for name, _ in k4c.SEGMENTS[kind]]
    assert {names[j] for j in moved} <= {"frequency_lerp",
                                         "randomness_offset",
                                         "next_randomness_offset"}
    assert "frequency_lerp" in {names[j] for j in moved}
    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(height=96, width=160, n_lights=2,
                           capacity=1 << 12, spawn_max=256, device=dev)
    env_u = scene.environment.uniforms(device=dev)
    state, avg = scene.system.state, torch.tensor(0.5, device=dev)
    for i in range(2):
        cuda_build.reset_launches()
        _, state, avg, _ = scene.frame(
            state, avg, None, scene.volume, scene.gbuffer,
            scene.sphere_lights, env_u, 256, frame_index=i,
            spawn_uniforms=[torch.rand((256, 4), device=dev)
                            for _ in range(3)])
        torch.cuda.synchronize()
        assert cuda_build.launches()["k4c_modifiers"] == 1


@pytest.mark.cuda
def test_cuda_k4c_span_holds_the_kernel():
    """One tick's modifier chain of the particle cell at 1,048,576 slots
    in a torch.profiler trace: `illuminant/kernel/k4c_modifiers` holds
    `modifiers_kernel`'s device time, inside
    `illuminant/particles/transforms`; the call reads nothing on the host
    and puts nothing else on the device (no copies, no fills)."""
    import re

    from illuminant_tpu_torch.core.trace import span
    from test_torch_integrate_cuda import _profile

    _needs_card()
    dev = torch.device("cuda")
    system = cell_system(dev)
    su = system.system_uniforms(DT)
    pos, vel = rows(SLOTS, dev, seed=4)
    steps = [(f, t.uniforms(NOW, dev)) for t, f in system._step]

    def call():
        with span("illuminant/particles/transforms"):
            return tx.apply_modifiers(pos, vel, steps, su,
                                      system.random_field)

    spans, ops, cpu_ops = _profile(call)
    own = [op for op in ops if re.search(r"\bmodifiers_kernel\b", op[0])]
    assert len(own) == 1 and len(ops) == 1, [op[0] for op in ops]
    us = own[0][2] - own[0][1]
    got = spans["illuminant/kernel/k4c_modifiers"]
    assert abs(got - us) <= max(0.01 * us, 0.5), (got, us)
    assert spans["illuminant/particles/transforms"] >= got
    assert "aten::_local_scalar_dense" not in cpu_ops


@pytest.mark.cuda
def test_cuda_plan_reports_the_block():
    """The kernel loads on the card: 256 threads, the program's copy in
    static shared memory, no stack frame to speak of (ptxas reports no
    spills), several blocks an SM."""
    _needs_card()
    plan = k4c.block_plan()
    assert plan["threads"] == k4c.THREADS
    assert plan["smem_bytes"] >= 4 * k4c.MAX_WORDS, plan
    assert plan["local_bytes"] <= 64 and plan["registers"] <= 128, plan
    assert plan["blocks_per_sm"] >= 2, plan


@pytest.mark.cuda
@pytest.mark.parametrize("attractors", [2, 3, 4, 5, 6, 8, 10, 16])
def test_cuda_attractor_sum_order_is_the_kernels(attractors):
    """torch.sum over dim 1 of an (N, A, 3) tensor on the card adds in the
    order `attractor_sum` mirrors (attractor a into accumulator a % 4,
    then the four in order): written here with single float32 additions,
    it equals torch.sum bit for bit. And torch.sum over a 3-wide axis is
    (x + z) + y, of an (N, 3) and of an (N, A, 3) tensor."""
    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(attractors)
    x = (torch.rand((1 << 16, attractors, 3), generator=g) - 0.5)
    x = (x * torch.exp2(torch.randint(-20, 20, x.shape, generator=g)
                        .float())).to(dev)
    assert torch.equal(torch.sum(x, dim=1), mirror_attractor_sum(x))
    for y in (x[:, 0, :] * x[:, 0, :], x * x):
        assert torch.equal(torch.sum(y, dim=-1),
                           (y[..., 0] + y[..., 2]) + y[..., 1])


def mirror_attractor_sum(x):
    """modifiers.cu:attractor_sum over dim 1 of x (N, A, 3), one float32
    addition at a time."""
    n = x.shape[1]
    acc = [torch.zeros_like(x[:, 0])] * 4
    a = 0
    while a + 3 < n:
        for k in range(4):
            acc[k] = acc[k] + x[:, a + k]
        a += 4
    for k in range(4):
        if a + k < n:
            acc[k] = acc[k] + x[:, a + k]
    return ((acc[0] + acc[1]) + acc[2]) + acc[3]
