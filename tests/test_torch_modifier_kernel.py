"""K4c's host side on the CPU: the dispatch of `transforms.apply_modifiers`
between the kernel and the eager chain of `apply_*`, the step program and
the uniform tables of each kind and of the particle cell's and the
flagship's lists, `launch_plan` (its chunks and its refusals), the launch's
argument arrays and the entry point's arguments read against the source
(`csrc/modifiers.cu`). The kernel itself runs only on the card
(tests/test_torch_modifier_cuda.py).
"""

import re

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.ops.noise import RandomField
from illuminant_tpu_torch.particles import modifier_kernel as k4c
from illuminant_tpu_torch.particles import transforms as tx
from illuminant_tpu_torch.particles.state import SystemUniforms
from illuminant_tpu_torch.particles.system import (ParticleSystem,
                                                   ParticleSystemConfig)

SOURCE = k4c.LIBRARY.source
CPU = torch.device("cpu")


def su():
    return SystemUniforms.make(dt=1.0 / 60.0, friction=0.1,
                               maximum_velocity=90.0)


def rows(n=4096, seed=0):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 4), generator=g) * torch.tensor(
        [320.0, 200.0, 40.0, 4.0]) - torch.tensor([0.0, 0.0, 0.0, 1.0])
    vel = (torch.rand((n, 4), generator=g) - 0.5) * 80.0
    vel[:, 3] = torch.randint(0, 4, (n,), generator=g).float()
    return pos, vel


def area(type_id):
    return tx.TransformArea(type=type_id, center=(160.0, 100.0, 10.0),
                            size=(60.0, 40.0, 20.0), falloff=12.0,
                            rotation_z=0.4)


def every_kind(type_id=2):
    """One transform of each kind (and a GeometricTransform), with their
    eager functions."""
    return [
        (tx.FMA(position_add=(1.0, 2.0, 0.0), velocity_multiply=(0.9,) * 3,
                area=area(type_id), category_filter=(0.5, 2.5)),
         tx.apply_fma),
        (tx.MatrixMultiply(position_matrix=np.eye(4, dtype=np.float32) * 1.01,
                           area=area(type_id)), tx.apply_matrix_multiply),
        (tx.GeometricTransform(position_rotation=(0.0, 0.0, 0.2),
                               area=area(type_id)),
         tx.apply_matrix_multiply),
        (tx.Gravity(attractors=[tx.Attractor(position=(100.0, 80.0, 5.0),
                                             radius=90.0, strength=20.0,
                                             falloff_type=f)
                                for f in range(3)],
                    maximum_acceleration=50.0), tx.apply_gravity),
        (tx.VectorField(field=np.random.default_rng(0).random(
            (16, 24, 4), dtype=np.float32) - 0.5,
            field_scale=(0.1, 0.1), velocity_scale=(40.0, 40.0, 1.0, 2.0),
            area=area(type_id)), tx.apply_vector_field),
        (tx.Noise(velocity_scale=(9.0, 9.0, 2.0, 1.0),
                  position_scale=(1.0, 1.0, 0.0, 0.0), area=area(type_id),
                  _rng=np.random.default_rng(1)), tx.apply_noise),
        (tx.spatial_noise(velocity_scale=(5.0, 5.0, 0.0, 0.0),
                          space_scale=(8.0, 8.0),
                          _rng=np.random.default_rng(2)),
         tx.apply_spatial_noise),
    ]


def steps_of(pairs, now=0.7):
    return [(f, t.uniforms(now, CPU)) for t, f in pairs]


def field():
    return RandomField.create(torch.Generator().manual_seed(3),
                              height=64, width=96, device="cpu")


# -- dispatch ------------------------------------------------------------------


def test_cpu_rows_run_the_eager_chain_bit_for_bit():
    """On CPU tensors `apply_modifiers` is the chain of `apply_*`, bit for
    bit, the noise steps at the slot grid of the rows."""
    pos, vel = rows()
    f = field()
    steps = steps_of(every_kind())
    assert not k4c.takes(pos.device)
    got = tx.apply_modifiers(pos, vel, steps, su(), f)
    p, v = pos, vel
    grid = tx.slot_xy(pos.shape[0])
    for apply, u in steps:
        if apply in (tx.apply_noise, tx.apply_spatial_noise):
            p, v = apply(p, v, u, su(), f, grid)
        else:
            p, v = apply(p, v, u, su())
    assert torch.equal(got[0], p) and torch.equal(got[1], v)
    assert not torch.equal(p, pos) and not torch.equal(v, vel)
    again = tx.apply_modifiers_reference(pos, vel, steps, su(), f)
    assert torch.equal(again[0], p) and torch.equal(again[1], v)


def test_empty_list_returns_the_rows():
    pos, vel = rows(16)
    got = tx.apply_modifiers(pos, vel, [], su())
    assert got[0] is pos and got[1] is vel


def test_takes_cuda_rows_of_known_steps_only():
    """The kernel takes every call on rows on a CUDA device, whatever its
    steps; a step that is not one of EAGER's functions raises there
    instead of running the eager chain."""
    assert not k4c.takes(torch.device("cpu"))
    assert not k4c.takes(torch.device("meta"))
    assert k4c.takes(torch.device("cuda"))
    assert k4c.takes("cuda:1")
    known = steps_of(every_kind())
    assert len(k4c.program(known)) == len(known)
    with pytest.raises(ValueError, match="no kernel step"):
        k4c.program(known + [(lambda *a: a, None)])
    assert set(k4c.EAGER.values()) == set(k4c.KINDS)


def test_slot_xy_is_the_texel_grid():
    grid = tx.slot_xy(600)
    assert grid.dtype == torch.float32 and grid.shape == (600, 2)
    assert grid[0].tolist() == [0.0, 0.0]
    assert grid[257].tolist() == [1.0, 1.0]
    assert grid[599].tolist() == [599 % 256, 599 // 256]


def test_system_builds_the_steps_apply_modifiers_runs():
    """ParticleSystem._build_step keeps its (transform, eager function)
    form, the noise steps as their eager functions; a CPU tick runs the
    eager chain."""
    pairs = every_kind()
    system = ParticleSystem(ParticleSystemConfig(capacity=512),
                            [t for t, _ in pairs] + [tx.Sensor()],
                            device="cpu")
    assert len(system._step) == len(pairs)
    assert all(a is t and g is f
               for (a, g), (t, f) in zip(system._step, pairs))
    system.tick(1.0 / 60.0)


# -- the program and its tables -------------------------------------------------


def test_program_of_every_kind():
    steps = steps_of(every_kind())
    assert k4c.program(steps) == (
        ("fma", 0), ("matrix_multiply", 0), ("matrix_multiply", 0),
        ("gravity", 4), ("vector_field", 0), ("noise", 0),
        ("spatial_noise", 0))
    with pytest.raises(ValueError, match="no kernel step"):
        k4c.program([(lambda *a: a, None)])


@pytest.mark.parametrize("index", range(7))
def test_uniform_table_of_each_kind(index):
    """A step's table: one tensor a segment in SEGMENTS order, the
    uniforms' own (no copy), of the words the segment holds (Gravity's
    first five that many a attractor), int32 for the area's type."""
    t, f = every_kind()[index]
    u = t.uniforms(0.7, CPU)
    kind, attractors = k4c.program([(f, u)])[0]
    table = k4c.uniform_table(kind, u)
    words = k4c.segment_words(kind, attractors)
    assert len(table) == len(words) == len(k4c.SEGMENTS[kind])
    for (name, _), tensor, w in zip(k4c.SEGMENTS[kind], table, words):
        assert tensor.numel() == w, name
        assert tensor.dtype == (torch.int32 if name == "area.type"
                                else torch.float32), name
        assert tensor.is_contiguous()
    if kind == "gravity":
        assert table[0] is u.positions and words[0] == 3 * attractors
    else:
        assert table[0] is u.area.type


def _cell_system(capacity=1 << 12):
    from framebench.lib.loader import module

    return module("scenes", "particles-config4-1080p").config4_system(
        None, 1080, 1920, capacity, 4096, "cpu")


def test_particle_cell_and_flagship_programs():
    """The particle cell's tick: VectorField, Gravity (one attractor,
    padded to 2) and temporal Noise in one launch of 3 steps and 38
    uniform segments besides the system's; the flagship's stage: Gravity
    with 2 attractors."""
    system = _cell_system()
    steps = [(f, t.uniforms(0.0, CPU)) for t, f in system._step]
    prog = k4c.program(steps)
    assert prog == (("vector_field", 0), ("gravity", 2), ("noise", 0))
    plan = k4c.launch_plan(prog, 1 << 20)
    assert plan["blocks"] == 4096 and plan["threads"] == 256
    (chunk,) = plan["chunks"]
    assert (chunk["start"], chunk["stop"]) == (0, 3)
    assert chunk["firsts"] == [1, 13, 20]
    assert len(chunk["offsets"]) - 1 == 1 + 12 + 7 + 19
    assert chunk["offsets"][-1] == 4 + 25 + (2 * 7 + 3) + 48
    from illuminant_tpu_torch.scenes import build_flagship

    frame = build_flagship(height=48, width=80, n_lights=1, capacity=256,
                           spawn_max=64, device="cpu").frame.__self__
    assert k4c.program([(tx.apply_gravity, frame.grav_u)]) == (
        ("gravity", 2),)
    assert k4c.bytes_moved((("gravity", 2),), 1 << 20) == (
        64 * (1 << 20) + 4 * (4 + 17))


def test_launch_plan_refuses_and_splits():
    """More than 16 attractors (or none) and a ring beyond int32 are
    refused; a list beyond one launch's steps, segments or words runs as
    consecutive launches, each within the source's limits."""
    with pytest.raises(ValueError, match="at most 16"):
        k4c.launch_plan((("gravity", 18),), 64)
    with pytest.raises(ValueError, match="attractors"):
        k4c.launch_plan((("gravity", 0),), 64)
    with pytest.raises(ValueError, match="int32"):
        k4c.launch_plan((("fma", 0),), 2 ** 31)
    with pytest.raises(ValueError, match="kind"):
        k4c.launch_plan((("sensor", 0),), 64)
    assert k4c.launch_plan((), 10)["chunks"] == []
    for prog in ((("fma", 0),) * 40, (("noise", 0),) * 12,
                 (("gravity", 16),) * 30):
        chunks = k4c.launch_plan(prog, 1000)["chunks"]
        assert len(chunks) > 1
        assert chunks[0]["start"] == 0 and chunks[-1]["stop"] == len(prog)
        for a, b in zip(chunks, chunks[1:]):
            assert a["stop"] == b["start"]
        for c in chunks:
            assert c["stop"] - c["start"] <= k4c.MAX_STEPS
            assert len(c["offsets"]) - 1 <= k4c.MAX_SEGMENTS
            assert c["offsets"][-1] <= k4c.MAX_WORDS
            assert c["offsets"][:2] == [0, k4c.SYSTEM_WORDS]
    assert len(k4c.launch_plan((("noise", 0),) * 10, 1)["chunks"]) == 1


def test_segments_are_the_sources():
    """SEGMENTS follows the source's segment enums, KINDS its Kind enum,
    the limits its constants, Gravity's attractors Gravity.fx's."""
    text = SOURCE.read_text()

    def enum(name):
        body = re.search(rf"enum {name} \{{(.*?)\}};", text, re.S).group(1)
        return re.findall(r"\bk(\w+)", re.sub(r"= *k\w+", "", body))

    assert enum("Kind") == ["FMA", "MatrixMultiply", "Gravity",
                            "VectorField", "Noise", "SpatialNoise", "Kinds"]
    camel = {"fma": "FMA", "matrix_multiply": "MatrixMultiply",
             "gravity": "Gravity", "vector_field": "VectorField",
             "noise": "Noise", "spatial_noise": "SpatialNoise"}
    assert [camel[k] for k in k4c.KINDS] == enum("Kind")[:-1]
    area = enum("AreaSegment")
    assert [n.split(".")[1] for n, _ in k4c.SEGMENTS["fma"][:6]] == [
        "type", "center", "size", "falloff", "rotation", "strength"]
    assert area[:-1] == ["AreaType", "AreaCenter", "AreaSize", "AreaFalloff",
                         "AreaRotation", "AreaStrength"]
    for kind, name, prefix in (("fma", "FMASegment", "FMA"),
                               ("matrix_multiply", "MatrixSegment", "Matrix"),
                               ("gravity", "GravitySegment", "Gravity"),
                               ("vector_field", "FieldSegment", "Field"),
                               ("noise", "NoiseSegment", "Noise")):
        own = enum(name)
        assert own[-1] == prefix + "Segments"
        base = 0 if kind == "gravity" else 6
        assert len(own) - 1 == len(k4c.SEGMENTS[kind]) - base, kind
    assert enum("GravitySegment")[:5] == [
        "GravityPositions", "GravityRadiuses", "GravityStrengths",
        "GravityFalloffs", "GravityActive"]
    assert [n for n, _ in k4c.SEGMENTS["gravity"][:5]] == list(
        k4c.PER_ATTRACTOR)
    assert k4c.SEGMENTS["spatial_noise"] == k4c.SEGMENTS["noise"]
    for const, value in (("kThreads", k4c.THREADS),
                         ("kMaxSteps", k4c.MAX_STEPS),
                         ("kMaxSegments", k4c.MAX_SEGMENTS),
                         ("kMaxWords", k4c.MAX_WORDS),
                         ("kMaxAttractors", tx.MAX_ATTRACTORS)):
        assert f"{const} = {value};" in text, const


def test_arguments_are_the_sources():
    """The entry point reads its pointers and ints at the places POINTERS
    and STEP_INTS give them, each step's field and the segments after the
    rows, each step's ints after the counts and the offsets after them."""
    text = SOURCE.read_text()
    entry = text[text.index('extern "C" int k4c_modifiers('):]
    for i, name in enumerate(k4c.POINTERS):
        assert re.search(rf"L\.{name} = \([^)]*\)ptrs\[{i}\];", entry), name
    assert "st.field = (const float4*)ptrs[4 + s];" in entry
    assert "P.ptr[s] = (const unsigned*)ptrs[4 + P.steps + s];" in entry
    assert "L.n = ints[0];" in entry
    assert "P.steps = (int)ints[1];" in entry
    assert "P.segments = (int)ints[2];" in entry
    assert "const long long* step_ints = ints + 3;" in entry
    assert len(k4c.STEP_INTS) == 5
    for i, name in enumerate(k4c.STEP_INTS):
        at = "5 * s" + (f" + {i}" if i else "")
        assert f"st.{name} = (int)step_ints[{at}];" in entry, name
    assert "const long long* offsets = step_ints + 5 * P.steps;" in entry
    assert 'extern "C" int k4c_modifiers_plan(int* out)' in text


# -- the launch's argument arrays -------------------------------------------------


def test_launch_arrays_are_kept_and_rewritten_where_a_uniform_changed():
    """A program's arrays are made once a ring and kept on the
    SystemUniforms: the step ints and offsets as launch_plan lays them
    out, each segment's pointer its tensor's, each field's its data with
    its height and width; a later call rewrites only what changed (the
    Noise's frequency_lerp as time runs) and another ring makes new
    arrays."""
    pairs = every_kind()
    system_u = su()
    f = field()
    steps = steps_of(pairs, now=0.25)
    prog = k4c.program(steps)
    launch = k4c._launch(system_u, prog, 4096, CPU)
    assert k4c._launch(system_u, prog, 4096, CPU) is launch
    (chunk,) = launch
    chunk.bind(steps, system_u, f, CPU)
    plan = k4c.launch_plan(prog, 4096)["chunks"][0]
    n_steps = len(prog)
    ints = list(chunk.ints)
    assert ints[:3] == [4096, n_steps, len(plan["offsets"]) - 1]
    step_ints = ints[3:3 + 5 * n_steps]
    assert step_ints[0::5] == [k4c.KINDS.index(k) for k, _ in prog]
    assert step_ints[1::5] == plan["firsts"]
    assert step_ints[2::5] == [a for _, a in prog]
    heights = dict(vector_field=16, noise=64, spatial_noise=64)
    widths = dict(vector_field=24, noise=96, spatial_noise=96)
    assert step_ints[3::5] == [heights.get(k, 0) for k, _ in prog]
    assert step_ints[4::5] == [widths.get(k, 0) for k, _ in prog]
    assert ints[3 + 5 * n_steps:] == plan["offsets"]
    base = len(k4c.POINTERS)
    fields = [chunk.ptrs[base + s] for s in range(n_steps)]
    assert fields[-1] == fields[-2] == f.data.data_ptr()
    assert fields[0] is None
    tensors = [system_u.global_settings] + [
        t for (kind, _), (_, u) in zip(prog, steps)
        for t in k4c.uniform_table(kind, u)]
    assert [chunk.ptrs[base + n_steps + j] for j in range(len(tensors))] == \
        [t.data_ptr() for t in tensors]
    before = list(chunk.sources)
    later = steps_of(pairs, now=0.5)
    chunk.bind(later, system_u, f, CPU)
    moved = [j for j, (a, b) in enumerate(zip(before, chunk.sources))
             if a is not b]
    names = ["field"] * n_steps + ["global_settings"] + [
        name for kind, _ in prog for name, _ in k4c.SEGMENTS[kind]]
    assert {names[j] for j in moved} == {"frequency_lerp"}
    other = k4c._launch(system_u, prog, 2048, CPU)
    assert other is not launch and other[0].ints[0] == 2048


def test_launch_arrays_refuse_what_the_kernel_cannot_read():
    system_u = su()
    g = tx.Gravity(attractors=[tx.Attractor()])
    u = g.uniforms(0.0, CPU)
    steps = [(tx.apply_gravity, u.replace(positions=torch.zeros(5)))]
    launch = k4c._launch(system_u, k4c.program(steps), 64, CPU)
    with pytest.raises(ValueError, match="uniform of 5 values"):
        launch[0].bind(steps, system_u, None, CPU)
    noise = tx.Noise(_rng=np.random.default_rng(0))
    steps = [(tx.apply_noise, noise.uniforms(0.0, CPU))]
    launch = k4c._launch(system_u, k4c.program(steps), 64, CPU)
    with pytest.raises(ValueError, match="RandomField"):
        launch[0].bind(steps, system_u, None, CPU)
    with pytest.raises(ValueError, match=r"not \(H, W, 4\)"):
        launch[0].bind(steps, system_u,
                              RandomField(data=torch.zeros(8, 8, 3)), CPU)
    with pytest.raises(ValueError, match="contiguous"):
        k4c.modifiers_cuda(torch.zeros(8, 3), torch.zeros(8, 4), steps,
                           system_u)
