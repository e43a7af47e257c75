"""K4's host side on the CPU: the launch plan of the collision integrate
(`particles/integrate_kernel.py`) for the fields it takes at any count of
substeps, its uniform table and the records it stages, and the dispatch
of `integrate_with_distance_field` between K4 and the eager body. The
kernel itself runs only on the card (tests/test_torch_integrate_cuda.py).
`staged_records` and `staged_uniforms` below are PyTorch mirrors of what
a block builds in shared memory (the source's stage_groups and
stage_uniforms).
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.lighting.cone_trace_kernel import analytic_records
from illuminant_tpu_torch.lighting.environment import (LightingEnvironment,
                                                       LightObstruction)
from illuminant_tpu_torch.ops.bezier import constant_bezier, pack_bezier
from illuminant_tpu_torch.particles import integrate as integ
from illuminant_tpu_torch.particles import integrate_kernel as k4
from illuminant_tpu_torch.particles.render_data import (
    RenderDataUniforms, pack_life_ramp_settings)
from illuminant_tpu_torch.particles.state import ParticleState, SystemUniforms
from illuminant_tpu_torch.sdf import analytic, columns
from illuminant_tpu_torch.sdf.height_volume import HeightVolume
from illuminant_tpu_torch.sdf.volume import SdfVolumeConfig, generate_volume

CUDA = torch.device("cuda")


def _scene(n_boxes=2, rotated=False, round_to=1, polygons=False):
    obs = [LightObstruction.box((20.0 + 9.0 * i, 30.0, 6.0), (4.0, 3.0, 6.0))
           for i in range(n_boxes)]
    obs.append(LightObstruction.ellipsoid((60.0, 20.0, 5.0),
                                          (6.0, 4.0, 5.0)))
    if rotated:
        obs[0].rotation = (0.0, 0.0, 0.38268343, 0.9238795)
    volumes = ([HeightVolume(polygon=[(5.0, 5.0), (15.0, 5.0), (10.0, 14.0)])]
               if polygons else None)
    return analytic.pack_scene(obs, group_capacity_round=round_to,
                               height_volumes=volumes, device="cpu")


def _column_field():
    env = LightingEnvironment()
    env.obstructions.append(LightObstruction.box((40.0, 30.0, 6.0),
                                                 (10.0, 8.0, 6.0)))
    cfg = SdfVolumeConfig(virtual_width=96, virtual_height=64,
                          virtual_depth=32, slice_count=8,
                          resolution_scale=0.5)
    return columns.build_column_maps(generate_volume(
        cfg, env.pack_obstructions(device="cpu")))


def staged_records(scene):
    """The primitive records a launch on a staged scene builds in shared
    memory from its groups, (count, PRIMITIVE_RECORD) float32."""
    f32 = torch.float32
    parts = [torch.cat([torch.tensor([float(type_id), float(rotated)],
                                     dtype=f32).expand(k, 2),
                        c[:k].to(f32), s[:k].to(f32), q[:k].to(f32)], dim=1)
             for type_id, rotated, k, c, s, q in k4._analytic_groups(scene)]
    if not parts:
        return torch.zeros((0, k4.PRIMITIVE_RECORD), dtype=f32)
    return torch.cat(parts, dim=0)


def staged_uniforms(su, rd):
    """The block's copy of the uniform table, (UNIFORM_FLOATS,) float32:
    each segment at its offset, zero beyond its tensor."""
    out = torch.zeros(k4.UNIFORM_FLOATS, dtype=torch.float32)
    for t, off in zip(k4.uniform_table(su, rd), k4.SEGMENT_OFFSETS.values()):
        if t is not None:
            out[off:off + t.numel()] = t
    return out


def _uniforms(**rd_changes):
    su = SystemUniforms.make(friction=0.05, maximum_velocity=600.0,
                             collision_distance=1.0, device="cpu")
    rd = RenderDataUniforms.defaults(size=2.0, device="cpu").replace(
        color_from_life=pack_bezier([(0.3, 0.3, 0.6, 0.0),
                                     (1.0, 1.0, 1.0, 1.0)], 0.0, 4.0))
    return su, rd.replace(**rd_changes)


@pytest.mark.parametrize("substeps", [0, 1, 2, 3])
def test_plan_on_an_analytic_scene(substeps):
    """The staged instance of the substeps, its records in shared memory,
    each group's live count, type and rotation, the scene's maximum
    distance; a block of 256 slots."""
    scene = _scene(rotated=True)
    plan = k4.launch_plan(1000, scene, substeps, 40.0, 7)
    assert plan["kind"] == k4.FIELD_KINDS["analytic"]
    assert plan["instance"] == plan["kind"] * k4.VARIANTS + substeps
    assert (plan["blocks"], plan["threads"]) == (4, 256)
    assert plan["smem_bytes"] == 3 * k4.PRIMITIVE_RECORD * 4
    # count, groups, then (count, type, rotated) a group.
    assert plan["ints"][:8] == [3, 2, 1, 1, 0, 2, 2, 1]
    assert plan["ints"][8:] == [0, 0, 0] * (k4.MAX_GROUPS - 2)
    assert plan["floats"] == [scene.maximum_distance]
    assert len(plan["field_tensors"]) == 3 * 2
    assert (plan["maximum_z"], plan["first_slot"]) == (40.0, 7)


@pytest.mark.parametrize("substeps", [0, 1, 2, 3])
def test_plan_on_a_column_field(substeps):
    """The column instance of the substeps, the coarse maps' size and the
    query's 12 constants; the pack is the launch's to find."""
    field = _column_field()
    plan = k4.launch_plan(257, field, substeps)
    assert plan["kind"] == k4.FIELD_KINDS["column"]
    assert plan["instance"] == k4.VARIANTS + substeps
    assert plan["blocks"] == 2 and plan["smem_bytes"] == 0
    assert plan["ints"] == list(field.maps_c.shape[1:])
    assert plan["floats"] == [float(v) for v in
                              columns.query_geometry(field)]
    assert plan["field_tensors"] == [None]


def test_plan_up_to_the_unroll_limit():
    """A scene of the unroll limit's 64 live primitives is staged (pad
    slots left out); one more primitive and the scene is read from
    device memory as K12's records, the pad slots included, in the
    batched forms the plain version evaluates above the limit."""
    at_limit = _scene(n_boxes=63, round_to=4)
    plan = k4.launch_plan(10, at_limit, 1)
    assert plan["kind"] == k4.FIELD_KINDS["analytic"]
    assert plan["ints"][:2] == [64, 2]
    assert plan["smem_bytes"] == 64 * k4.PRIMITIVE_RECORD * 4
    above = _scene(n_boxes=64, round_to=4)
    plan = k4.launch_plan(10, above, 1)
    records, batched = analytic_records(above)
    assert batched and records.shape[0] == 64 + 4  # pads: 0 and 3
    assert plan["kind"] == k4.FIELD_KINDS["analytic_global"]
    assert plan["instance"] == 2 * k4.VARIANTS + 1
    assert plan["ints"] == [68, 1, 0, 0] and plan["smem_bytes"] == 0
    assert torch.equal(plan["field_tensors"][0], records)
    assert plan["field_tensors"][1:] == [None] * 4
    assert k4.takes(CUDA, above) and k4.takes(CUDA, at_limit)


@pytest.mark.parametrize("n_boxes", [2, 64])
def test_plan_on_a_scene_with_polygons(n_boxes):
    """A scene with polygons is read from device memory: K12's records
    (batched above the unroll limit), then the polygons' vertices, next
    vertices, z range and active flags; their count and edges."""
    scene = _scene(n_boxes=n_boxes, polygons=True)
    plan = k4.launch_plan(300, scene, 3)
    records, batched = analytic_records(scene)
    poly = scene.polygons
    assert plan["kind"] == k4.FIELD_KINDS["analytic_global"]
    assert plan["ints"] == [records.shape[0], int(batched), 1, 3]
    assert batched == (n_boxes > 63)
    assert torch.equal(plan["field_tensors"][0], records)
    for got, name in zip(plan["field_tensors"][1:], k4.POLYGON_TENSORS):
        assert got is getattr(poly, name)
    assert plan["floats"] == [scene.maximum_distance]


@pytest.mark.parametrize("substeps", [4, 5, 9])
def test_plan_above_three_substeps(substeps):
    """Above MAX_SUBSTEPS the run-time instance of the field's kind takes
    the count as an argument."""
    for volume in (_scene(), _column_field(), _scene(polygons=True)):
        plan = k4.launch_plan(10, volume, substeps)
        assert plan["instance"] == (plan["kind"] * k4.VARIANTS
                                    + k4.RUNTIME_SUBSTEPS)
        assert plan["substeps"] == substeps


@pytest.mark.parametrize("round_to, n_boxes, rotated",
                         [(1, 2, False), (2, 3, True), (4, 63, True)])
def test_staged_records_are_the_march_records(round_to, n_boxes, rotated):
    """The records a launch stages from the groups are K12's records, in
    its order, the pad slots left out."""
    scene = _scene(n_boxes=n_boxes, rotated=rotated, round_to=round_to)
    records, batched = analytic_records(scene)
    assert not batched
    assert torch.equal(staged_records(scene), records)
    assert k4.launch_plan(1, scene, 1)["ints"][0] == records.shape[0]


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="substeps"):
        k4.launch_plan(10, _scene(), -1)
    with pytest.raises(TypeError):
        k4.launch_plan(10, _column_field().volume, 1)
    with pytest.raises(ValueError, match="int32"):
        k4.launch_plan(10, _scene(), 1, first_slot=2 ** 31 - 5)


def test_uniform_table_order_and_sizes():
    """One tensor a segment, in UNIFORM_SEGMENTS order, no larger than its
    slot; the absent ones None."""
    su, rd = _uniforms()
    table = k4.uniform_table(su, rd)
    assert len(table) == len(k4.UNIFORM_SEGMENTS)
    sizes = [None if t is None else t.numel() for t in table]
    assert sizes == [4, 4, 4, 16, 4, 16, 4, 4, 4, 4, 2, 1, None]
    assert table[0].data_ptr() == su.global_settings.data_ptr()
    assert sum(size for _, size in k4.UNIFORM_SEGMENTS) <= k4.UNIFORM_FLOATS


def test_staged_uniforms_layout():
    """The block's copy: each segment at its offset, zeros after a
    segment's tensor and for an absent one."""
    su, rd = _uniforms(velocity_rotation=None)
    u = staged_uniforms(su, rd)
    off = k4.SEGMENT_OFFSETS
    assert u.shape == (k4.UNIFORM_FLOATS,)
    assert torch.equal(u[0:4], su.global_settings)
    assert torch.equal(u[4:8], su.collision_settings)
    p = off["color_from_life.points"]
    assert torch.equal(u[p:p + 16], rd.color_from_life.points.reshape(-1))
    s = off["size_from_life.points"]
    assert torch.equal(u[s:s + 4], rd.size_from_life.points.reshape(-1))
    assert not u[s + 4:s + 16].any()
    assert u[off["velocity_rotation"]] == 0.0
    assert not u[off["life_ramp_settings"]:].any()


def test_staged_uniforms_with_a_ramp_and_a_one_channel_colour():
    ramp = torch.rand(2, 5, 4)
    settings = pack_life_ramp_settings(strength=-0.5, texture_height=2)
    su, rd = _uniforms(color_from_velocity=constant_bezier([0.5]),
                       life_ramp=ramp, life_ramp_settings=settings)
    u = staged_uniforms(su, rd)
    off = k4.SEGMENT_OFFSETS
    v = off["color_from_velocity.points"]
    assert u[v] == 0.5 and not u[v + 1:v + 16].any()
    r = off["life_ramp_settings"]
    assert torch.equal(u[r:r + 4], settings)
    assert k4._render_ints(rd) == [4, 1, 1, 1, 0, 1, 1, 1, 0, 2, 5]


def test_uniform_table_refuses_a_three_channel_colour():
    su, rd = _uniforms(color_from_life=pack_bezier([(1.0, 1.0, 1.0)]))
    with pytest.raises(ValueError, match="color_from_life"):
        k4.uniform_table(su, rd)


@pytest.mark.parametrize("case, expected", [
    ("cpu_scene", False), ("cuda_scene", True), ("cuda_column", True),
    ("cuda_volume", False), ("cuda_polygons", True),
    ("cuda_batched", True), ("cuda_four_substeps", True),
    ("cuda_no_substep", True)])
def test_dispatch(case, expected):
    """K4 takes CUDA tensors on any AnalyticScene (above the unroll limit
    and with polygons too) or ColumnField at any count of substeps; the
    CPU and a bare SdfVolume take the eager body."""
    field = {"cpu_scene": _scene, "cuda_scene": _scene,
             "cuda_column": _column_field,
             "cuda_volume": lambda: _column_field().volume,
             "cuda_polygons": lambda: _scene(polygons=True),
             "cuda_batched": lambda: _scene(n_boxes=70),
             "cuda_four_substeps": _scene, "cuda_no_substep": _scene}[case]()
    device = "cpu" if case.startswith("cpu") else CUDA
    substeps = {"cuda_four_substeps": 4, "cuda_no_substep": 0}.get(case, 1)
    assert k4.takes(device, field) is expected
    if expected:
        assert k4.launch_plan(7, field, substeps)["blocks"] == 1


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(0.0, 96.0, n)
    pos[:, 1] = rng.uniform(0.0, 64.0, n)
    pos[:, 2] = rng.uniform(0.0, 20.0, n)
    pos[:, 3] = rng.uniform(-0.5, 2.0, n)
    vel = np.zeros((n, 4), np.float32)
    vel[:, :3] = rng.uniform(-60.0, 60.0, (n, 3))
    t = torch.as_tensor
    zeros = torch.zeros((n, 4))
    return ParticleState(
        position=t(pos), velocity=t(vel), color=torch.ones((n, 4)),
        render_color=zeros, render_data=zeros.clone(),
        write_cursor=torch.zeros((), dtype=torch.int32),
        total_spawned=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("field", ["scene", "column", "volume", "polygons"])
def test_cpu_call_runs_the_eager_body(monkeypatch, field):
    """On the CPU, integrate_with_distance_field never reaches the kernel
    wrapper and returns what the eager body returns, on every field (a
    bare SdfVolume included)."""
    def no_kernel(*a, **kw):
        raise AssertionError("the CPU reached the kernel wrapper")

    monkeypatch.setattr(k4, "integrate_cuda", no_kernel)
    volume = {"scene": _scene, "column": _column_field,
              "volume": lambda: _column_field().volume,
              "polygons": lambda: _scene(polygons=True)}[field]()
    su, rd = _uniforms()
    state = _state(333)
    got = integ.integrate_with_distance_field(state, su, rd, volume, 15.0,
                                              2, 11)
    ref = integ.integrate_with_distance_field_reference(state, su, rd,
                                                        volume, 15.0, 2, 11)
    for name in ("position", "velocity", "render_color", "render_data"):
        assert torch.equal(getattr(got, name), getattr(ref, name))
    assert not torch.equal(got.position, state.position)


def test_uniform_table_is_the_sources():
    """The segments' sizes and offsets here are the source's
    kSegmentCapacity and kSegmentOffset, and its block copy's length
    kUniformFloats."""
    import re

    src = k4.LIBRARY.source.read_text()

    def ints(name):
        body = re.search(name + r"\[kSegments\] = \{([^}]*)\}", src).group(1)
        return [int(v) for v in body.replace("\n", " ").split(",")]

    assert ints("kSegmentCapacity") == [n for _, n in k4.UNIFORM_SEGMENTS]
    assert ints("kSegmentOffset") == list(k4.SEGMENT_OFFSETS.values())
    assert f"kUniformFloats = {k4.UNIFORM_FLOATS};" in src
    assert f"kMaxGroups = {k4.MAX_GROUPS};" in src
    assert f"kMaxPrimitives = {k4.MAX_PRIMITIVES};" in src
    assert f"kRuntimeSubsteps = {k4.RUNTIME_SUBSTEPS};" in src
    assert f"kVariants = {k4.VARIANTS};" in src
    kinds = re.search(r"enum Kind \{(.*?)\};", src, re.S).group(1)
    assert [int(v) for v in re.findall(r"= (\d+),", kinds)] == list(
        k4.FIELD_KINDS.values())
