"""K4b's host side on the CPU: the dispatch of `spawner.spawn` between the
kernel and the eager body, the launch's argument and uniform tables read
against the source (`csrc/spawn.cu`), and PyTorch mirrors of what the
kernel computes that the CPU can check: its index and mask plan against
the eager spawn's writes (`kernel_rows`), and its evaluation of the
animated uniforms against ops/bezier.py (`bezier_t`, `bezier_channel`,
`bezier_matrix`, written branch for branch as the source's device
functions). The kernel itself runs only on the card
(tests/test_torch_spawn_cuda.py).
"""

import math
import re

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.ops.bezier import (MODE_BOUNCE_BIT, MODE_EXP,
                                             MODE_LOOP_BIT, MODE_SINE,
                                             DynamicMatrix, constant_bezier,
                                             evaluate_bezier,
                                             evaluate_bezier_matrix,
                                             pack_bezier, pack_bezier_matrix)
from illuminant_tpu_torch.particles import spawn_kernel as k4b
from illuminant_tpu_torch.particles import spawner
from illuminant_tpu_torch.particles.formula import (FORMULA_SPHERICAL,
                                                    Formula1, Formula3,
                                                    Formula4)
from illuminant_tpu_torch.particles.state import ParticleState

CUDA = torch.device("cuda")
F32 = torch.float32
SOURCE = k4b.LIBRARY.source


def f32(v):
    return torch.tensor(v, dtype=F32)


# -- mirrors of the source's device functions --------------------------------


def bezier_t(head, value):
    """bezier.cuh:bezier_t -> (count, t), float32 scalars."""
    min_value, inv_divisor, count, mode_f = head
    mode = int(abs(float(mode_f)))
    reverse = bool(inv_divisor < 0)
    t = (value - min_value) * torch.abs(inv_divisor)
    if mode > 511:
        m2 = torch.fmod(t * 2.0, f32(2.0))
        tb = 2.0 - m2 if reverse else m2
        t = 2.0 - tb if tb > 1.0 else tb
    elif mode > 255:
        m1 = torch.fmod(t, f32(1.0))
        t = 1.0 - m1 if reverse else m1
    else:
        tc = torch.clamp(t, 0.0, 1.0)
        t = 1.0 - tc if reverse else tc
    if mode % 256 == MODE_SINE:
        t = torch.sin(t * f32(1.57079637))
    if mode % 256 == MODE_EXP:
        t = t * t
    return count, t


def bezier_channel(points, count, t, c):
    """bezier.cuh:bezier_channel of column c of (4, C) points."""
    a, b, cc, d = (points[i, c] for i in range(4))
    if count <= 1.5:
        return a
    ab = a + (b - a) * t
    if count <= 2.5:
        return ab
    if count <= 3.5:
        return a if t <= 0.0 else (cc if t >= 1.0 else b)
    bc = b + (cc - b) * t
    cd = cc + (d - cc) * t
    abbc = ab + (bc - ab) * t
    bccd = bc + (cd - bc) * t
    return abbc + (bccd - abbc) * t


def path_value(bezier, value):
    """The kernel's emission path at `value`: 3 channels."""
    if bezier.is_constant:
        return bezier.points[0]
    count, t = bezier_t(bezier.range_and_count, value)
    return torch.stack([bezier_channel(bezier.points, count, t, c)
                        for c in range(3)])


def regenerate(angle, scale, tx, ty, tz):
    """spawn.cu:regenerate -> (4, 4)."""
    rad = angle * f32(math.pi / 180.0)
    c = torch.cos(rad) * scale
    s = torch.sin(rad) * scale
    z, one = f32(0.0), f32(1.0)
    return torch.stack([c, s, z, z, -s, c, z, z, z, z, scale, z,
                        tx, ty, tz, one]).reshape(4, 4)


def bezier_matrix(bm, value):
    """spawn.cu:bezier_matrix -> (4, 4)."""
    count, t = bezier_t(bm.range_and_count, value)
    ctrl = (bm.a, bm.b, bm.c, bm.d)
    if all(bool(m.is_dynamic > 0.5) for m in ctrl):
        pts = torch.stack([torch.stack([m.angle, m.scale, *m.translation])
                           for m in ctrl])
        angle, scale, tx, ty, tz = (bezier_channel(pts, count, t, c)
                                    for c in range(5))
        return regenerate(angle, scale, tx, ty, tz)
    rows = torch.stack([
        regenerate(m.angle, m.scale, *m.translation)
        if bool(m.is_dynamic > 0.5) else m.matrix for m in ctrl])
    flat = rows.reshape(4, 16)
    return torch.stack([bezier_channel(flat, count, t, e)
                        for e in range(16)]).reshape(4, 4)


def kernel_rows(capacity, spawn_max, count, cursor, sub_rings=1,
                shard=None, kept=None):
    """The kernel's index and mask plan (spawn.cu:spawn_kernel) in Python
    ints -> {window row: (ring slot of the state, spawn ordinal)} of the
    rows it writes: each thread's slot, its rows walked from the newest
    down to the first that the count and `kept` (the rows the discard
    keeps; every row where None) keep."""
    plan = k4b.launch_plan(capacity, spawn_max, sub_rings, shard)
    n, rank, lanes = plan["ring"], plan["rank"], plan["lanes"]
    seg, block = spawn_max // sub_rings, n // sub_rings
    per = count // sub_rings
    assert plan["blocks"] * plan["threads"] >= plan["segments"] * lanes
    rows = {}
    for g in range(plan["segments"] * lanes):
        q = plan["first_segment"] + g // lanes
        newest = seg - lanes + g % lanes
        idx = (q * block + ((cursor // sub_rings) % block + newest) % block
               - rank * capacity)
        if not 0 <= idx < capacity:
            continue
        for r in range(newest, -1, -block):
            j = q * seg + r
            if r < per and (kept is None or j in kept):
                assert j not in rows
                rows[j] = (idx, q * per + r)
                break
    return rows


def kernel_advance(capacity, count, cursor, total, sub_rings=1,
                   shard=None):
    """The cursor and total the kernel's thread 0 writes."""
    ring = capacity * (1 if shard is None else shard[1])
    count = count // sub_rings * sub_rings
    return (cursor + count) % ring, total + count


# -- the dispatch -------------------------------------------------------------


@pytest.mark.parametrize("device, capacity, spawn_max, shard, expected", [
    ("cpu", 64, 16, None, False), (CUDA, 64, 16, None, True),
    (CUDA, 16, 16, None, True), (CUDA, 8, 16, None, True),
    (CUDA, 32, 64, (1, 2), True), (CUDA, 16, 64, (0, 2), True)])
def test_takes(device, capacity, spawn_max, shard, expected):
    """K4b takes every state on the card, a window longer than the whole
    ring (a shard's ring is its capacity times the ranks) too: a launch
    has a thread for each slot the window writes, its rows or the ring's
    slots, whichever are fewer. The CPU keeps the eager body."""
    assert k4b.takes(device) is expected
    plan = k4b.launch_plan(capacity, spawn_max, shard=shard)
    ring = capacity * (1 if shard is None else shard[1])
    assert (plan["first_segment"], plan["segments"]) == (0, 1)
    assert plan["lanes"] == min(spawn_max, ring)
    assert plan["blocks"] == -(-plan["lanes"] // k4b.THREADS)


def _spawner(**kw):
    args = dict(
        min_rate=60.0, max_rate=60.0,
        life=Formula1(constant=2.5, random_scale=1.0, offset=-0.5),
        position=Formula3(constant=(40.0, 30.0, 10.0),
                          offset=(8.0, 6.0, 2.0),
                          random_scale=(4.0, 3.0, 1.0),
                          type=FORMULA_SPHERICAL),
        velocity=Formula3(offset=(20.0, 20.0, 0.0),
                          random_scale=(5.0, 5.0, 2.0),
                          type=FORMULA_SPHERICAL),
        color=Formula4(constant=(0.4, 0.5, 0.9, 0.5),
                       random_scale=(0.4, 0.3, 0.1, 0.3)),
        align_velocity_and_position=True, spawn_max=32)
    args.update(kw)
    return spawner.Spawner(**args)


def _rot(device="cpu"):
    return pack_bezier_matrix(
        [DynamicMatrix.from_components(angle=84.0, device=device),
         DynamicMatrix.from_components(angle=96.0, device=device),
         DynamicMatrix.from_components(angle=84.0, device=device)],
        min_value=0.0, max_value=4.0, device=device)


def _state(n, cursor=0, total=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return ParticleState(
        position=torch.rand((n, 4), generator=g),
        velocity=torch.rand((n, 4), generator=g),
        color=torch.rand((n, 4), generator=g),
        render_color=torch.zeros((n, 4)), render_data=torch.zeros((n, 4)),
        write_cursor=torch.tensor(cursor, dtype=torch.int32),
        total_spawned=torch.tensor(total, dtype=torch.int32))


def _draws(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((n, 4), generator=g) for _ in range(3)]


def test_a_distinct_window_on_the_card_goes_to_k4b(monkeypatch):
    """With `takes` true, `spawn` hands the kernel wrapper the state, the
    uniforms, the count, the draws, the ring's partition and the time,
    and returns what it returns; nothing eager runs."""
    calls = []

    def kernel(*args):
        calls.append(args)
        return "k4b"

    monkeypatch.setattr(k4b, "takes", lambda device: True)
    monkeypatch.setattr(k4b, "spawn_cuda", kernel)
    monkeypatch.setattr(spawner, "spawn_reference", None)
    u, st, draws = _spawner().uniforms(0.0), _state(64), _draws(32)
    t = f32(1.25)
    out = spawner.spawn(st, u, 20, 32, uniforms=draws, sub_rings=2,
                        shard=None, time=t)
    assert out == "k4b" and len(calls) == 1
    got = calls[0]
    assert got[0] is st and got[1] is u and got[2] == 20 and got[3] == 32
    assert all(torch.equal(a, b) for a, b in zip(got[4], draws))
    assert got[5:] == (2, None, t)


@pytest.mark.parametrize("case", ["cpu", "overlapping", "feedback"])
def test_the_eager_body_runs_without_the_kernel(monkeypatch, case):
    """The CPU, a window longer than the ring there included, and
    spawn_feedback never reach the kernel wrapper."""
    def no_kernel(*a, **kw):
        raise AssertionError("reached the kernel wrapper")

    monkeypatch.setattr(k4b, "spawn_cuda", no_kernel)
    sp = _spawner(velocity_post_matrix=_rot())
    if case == "feedback":
        fb = spawner.FeedbackSpawner(source=None, spawn_max=32)
        u = fb.feedback_uniforms(0.5)
        out = spawner.spawn_feedback(_state(64), _state(64, seed=3), u, 20,
                                     32, uniforms=_draws(32), time=0.5)
        assert int(out.total_spawned) == 20
        return
    capacity = 64 if case == "cpu" else 16
    assert not k4b.takes("cpu")
    st = _state(capacity, cursor=5, total=70)
    got = spawner.spawn(st, sp.uniforms(0.0), 20, 32, uniforms=_draws(32),
                        time=1.5)
    ref = spawner.spawn_reference(_state(capacity, cursor=5, total=70),
                                  sp.uniforms(0.0), 20, 32,
                                  uniforms=_draws(32), time=1.5)
    for name in ("position", "velocity", "color", "write_cursor",
                 "total_spawned"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


# -- the tables against the source ---------------------------------------------


def test_uniform_table_is_the_sources():
    """UNIFORM_SEGMENTS follows the source's Segment enum (its animations'
    fields the ControlField enum) and SEGMENT_OFFSETS lays its sizes end
    to end within the block's copy: the sizes live in Python alone, and a
    launch passes the offsets."""
    text = SOURCE.read_text()
    enum = re.search(r"enum Segment \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"^\s*(k\w+)", enum, re.M)
    assert names[:names.index("kAnimations")] == [
        "kConfig", "kFormulaTypes", "kPositionMatrix", "kVelocityMatrix",
        "kAxisMask", "kAlign", "kDiscard", "kPolygonRate", "kPolygonLoop",
        "kConstantCount", "kPathHead", "kPathPoints"]
    assert names.index("kAnimations") == 12
    fields = re.search(r"enum ControlField \{(.*?)\};", text, re.S).group(1)
    assert re.findall(r"k(\w+)", fields) == [
        "Matrix", "Angle", "Scale", "Translation", "IsDynamic",
        "ControlFields"]
    assert [f for f, _ in k4b.CONTROL_FIELDS] == [
        "matrix", "angle", "scale", "translation", "is_dynamic"]
    assert "kAnimationSegments = 1 + 4 * kControlFields;" in text
    assert len(k4b.UNIFORM_SEGMENTS) == 12 + 2 * (1 + 4 * 5)
    sizes = [n for _, n in k4b.UNIFORM_SEGMENTS]
    assert k4b.SEGMENT_OFFSETS[0] == 0
    assert list(np.diff(k4b.SEGMENT_OFFSETS)) == sizes
    most = int(re.search(r"kMaxUniformFloats = (\d+);", text).group(1))
    assert k4b.UNIFORM_FLOATS == k4b.SEGMENT_OFFSETS[-1] <= most
    assert "kSegmentCapacity" not in text
    assert f"kThreads = {k4b.THREADS};" in text


def test_arguments_are_the_sources():
    """The entry point reads its pointers, ints and floats at the places
    POINTERS, INTS and FLOATS give them, the uniform table after them."""
    text = SOURCE.read_text()
    entry = text[text.index('extern "C" int k4b_spawn('):]
    fields = {"position": "position", "velocity": "velocity",
              "color": "color", "write_cursor": "write_cursor",
              "total_spawned": "total_spawned", "out_cursor": "out_cursor",
              "out_total": "out_total", "count": "count_ptr",
              "time": "time_ptr", "position_constants": "constants",
              "position_colors": "colors"}
    for name, field in fields.items():
        i = k4b.POINTERS.index(name)
        assert re.search(rf"L\.{field} = \([^)]*\)ptrs\[{i}\];", entry), name
    assert "L.draws[i] = (const float4*)ptrs[7 + i];" in entry
    assert k4b.POINTERS[7:10] == ("random1", "random2", "random3")
    assert f"T.ptr[s] = (const float*)ptrs[{len(k4b.POINTERS)} + s];" \
        in entry
    ints = {"count": "count_value", "spawn_max": "spawn_max",
            "capacity": "n_local", "ranks": "n_ranks", "rank": "rank",
            "sub_rings": "sub_rings", "first_segment": "first_segment",
            "segments": "segments", "position_constants": "n_constants",
            "path_constant": "path_constant"}
    for name, field in ints.items():
        i = k4b.INTS.index(name)
        assert re.search(rf"L\.{field} = (\(int\))?ints\[{i}\];", entry), \
            name
    assert f"const long long len = ints[{len(k4b.INTS)} + s];" in entry
    # The offsets after the segments' floats: kSegments + 1 of them.
    assert f"T.offset[0] = (int)ints[{len(k4b.INTS)} + kSegments];" in entry
    assert (f"T.offset[s + 1] = (int)ints[{len(k4b.INTS) + 1} + kSegments "
            "+ s];") in entry
    assert "L.time_value = floats[0];" in entry
    assert "L.period[i] = floats[1 + i];" in entry
    assert k4b.FLOATS[1:] == ("path_period", "position_period",
                              "velocity_period")


def _flagship_uniforms():
    """The flagship's spawn uniforms (scenes._FlagshipFrame) at a small
    size: the emission path and the animated velocity post-matrix."""
    sp = _spawner(velocity_post_matrix=_rot())
    path = pack_bezier([(20.0, 30.0, 30.0), (40.0, 10.0, 34.0),
                        (60.0, 30.0, 30.0), (40.0, 50.0, 26.0)],
                       min_value=0.0, max_value=6.0)
    return sp, sp.uniforms(0.0).replace(
        position_path=path, animation_periods=(6.0, 0.0, 4.0))


def test_uniform_table_order_and_sizes():
    """One tensor a segment in UNIFORM_SEGMENTS order, no larger than its
    slot, the uniforms' own storage; None for what the uniforms lack: the
    static velocity matrix an animation replaces, the absent position
    animation."""
    sp, u = _flagship_uniforms()
    table = k4b.uniform_table(u)
    names = [name for name, _ in k4b.UNIFORM_SEGMENTS]
    got = dict(zip(names, table))
    assert len(table) == len(names)
    assert got["config"].data_ptr() == u.config.data_ptr()
    assert got["velocity_matrix"] is None
    assert torch.equal(got["position_matrix"], torch.eye(4).reshape(-1))
    assert torch.equal(got["position_path.points"], u.position_path.points
                       .reshape(-1))
    assert all(got[n] is None for n in names
               if n.startswith("position_animation"))
    rot = sp.velocity_post_matrix
    assert torch.equal(got["velocity_animation.head"], rot.range_and_count)
    assert torch.equal(got["velocity_animation.c.angle"], rot.c.angle[None])
    assert torch.equal(got["velocity_animation.d.matrix"],
                       rot.d.matrix.reshape(-1))
    for t, (name, size) in zip(table, k4b.UNIFORM_SEGMENTS):
        assert t is None or t.numel() <= size, name


def test_uniform_table_refuses_what_the_kernel_cannot_read():
    _, u = _flagship_uniforms()
    with pytest.raises(ValueError, match="position_path.points"):
        k4b.uniform_table(u.replace(position_path=pack_bezier(
            [(1.0, 2.0, 3.0, 4.0)])))
    with pytest.raises(ValueError, match="velocity post-matrix"):
        k4b.uniform_table(u.replace(velocity_animation=None))


def test_launch_arrays_are_kept_per_uniforms_and_ring():
    """A uniforms object's launch arrays are made once a ring: the
    uniforms' pointers after the per-call slots, the ring's ints, the
    periods; another ring makes new ones."""
    _, u = _flagship_uniforms()
    dev = torch.device("cpu")
    first = k4b._launch(u, 64, 32, 1, None, dev)
    assert k4b._launch(u, 64, 32, 1, None, dev) is first
    slot = len(k4b.POINTERS)
    table = k4b.uniform_table(u)
    assert first.ptrs[k4b.POINTERS.index("position_constants")] == \
        u.position_constants.data_ptr()
    assert first.ptrs[k4b.POINTERS.index("position_colors")] is None
    for i, t in enumerate(table):
        assert first.ptrs[slot + i] == (None if t is None else t.data_ptr())
    assert list(first.ints[1:len(k4b.INTS)]) == [32, 64, 1, 0, 1, 0, 1, 1,
                                                  0]
    assert list(first.ints[len(k4b.INTS) + len(table):]) == list(
        k4b.SEGMENT_OFFSETS)
    assert list(first.floats[1:]) == [6.0, 0.0, 4.0]
    sharded = k4b._launch(u, 32, 32, 4, (1, 2), dev)
    assert sharded is not first
    assert list(sharded.ints[1:8]) == [32, 32, 2, 1, 4, 2, 2]


# -- the plan against the eager spawn ---------------------------------------


def _marker_uniforms(n_constants):
    """Uniforms under which a spawned row writes its window row into x
    (the draw's x), its spawn ordinal plus the total's offset into y (the
    position constant's index), life 1 into w; nothing is discarded."""
    config = torch.zeros((9, 4))
    config[0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    constants = torch.zeros((n_constants, 4))
    constants[:, 1] = torch.arange(n_constants, dtype=F32)
    constants[:, 3] = 1.0
    return spawner.SpawnUniforms(
        position_constants=constants,
        position_constant_count=f32(float(n_constants)), config=config,
        formula_types=torch.zeros(4), position_matrix=torch.eye(4),
        velocity_matrix=torch.eye(4), axis_mask=torch.ones(3),
        align_velocity_and_position=f32(0.0),
        attribute_discard_threshold=f32(0.0), polygon_rate=f32(0.0),
        polygon_loop=f32(0.0))


PLAN_CASES = [
    # capacity, spawn_max, count, cursor, sub_rings, shard
    (64, 16, 16, 0, 1, None),
    (64, 16, 10, 60, 1, None),          # wraps the ring's end, count < max
    (16, 16, 16, 7, 1, None),           # the window is the ring
    (64, 16, 13, 9, 2, None),           # count rounds down to 12
    (64, 16, 16, 62, 4, None),
    (32, 16, 14, 25, 1, (0, 2)),           # split across the shards
    (32, 16, 14, 25, 1, (1, 2)),
    (32, 16, 10, 31, 2, (0, 2)),
    (32, 16, 10, 31, 2, (1, 2)),
    (16, 16, 16, 60, 4, (3, 4)),
    # Windows longer than their ring: each slot keeps its newest row.
    (16, 48, 40, 5, 1, None),           # the window laps the ring twice
    (16, 32, 7, 14, 1, None),           # ... but the count does not
    (16, 48, 45, 3, 4, None),           # a segment of 12 in blocks of 4
    (16, 48, 48, 9, 1, (1, 2)),         # a 32-slot ring in two shards
    (8, 48, 48, 13, 4, (1, 2)),         # a rank's own sub-rings
]


@pytest.mark.parametrize("tensor_count", [False, True])
@pytest.mark.parametrize("capacity, spawn_max, count, cursor, sub_rings, "
                         "shard", PLAN_CASES)
def test_kernel_plan_is_the_eager_spawns(capacity, spawn_max, count, cursor,
                                         sub_rings, shard, tensor_count):
    """`kernel_rows` (the source's plan) writes the same window rows into
    the same slots with the same spawn ordinals as the eager body, and
    advances the cursor and the total as it does: sub-rings 2 and 4,
    shards of 2 and 4 ranks, a window over the ring's end, count below
    spawn_max, a count on the device."""
    total = 5
    n_constants = 64
    st = _state(capacity, cursor=cursor, total=total)
    st.position.zero_()
    draws = _draws(spawn_max)
    draws[0][:, 0] = torch.arange(spawn_max, dtype=F32) + 0.25
    out = spawner.spawn_reference(
        st, _marker_uniforms(n_constants),
        torch.tensor(count) if tensor_count else count, spawn_max,
        uniforms=draws, sub_rings=sub_rings, shard=shard)
    pos = out.position
    written = {int(pos[s, 0]): (s, int(pos[s, 1]) - total)
               for s in range(capacity) if pos[s, 3] == 1.0}
    assert written == kernel_rows(capacity, spawn_max, count, cursor,
                                  sub_rings, shard)
    assert written
    assert (int(out.write_cursor), int(out.total_spawned)) == \
        kernel_advance(capacity, count, cursor, total, sub_rings, shard)


@pytest.mark.parametrize("capacity, spawn_max, count, cursor, sub_rings, "
                         "shard", PLAN_CASES)
def test_kernel_plan_keeps_the_newest_kept_row(capacity, spawn_max, count,
                                               cursor, sub_rings, shard):
    """With a discard (the colour's w is the third draw's, kept at 0.5 and
    above), each slot the kernel's plan writes takes the same row as in
    the eager body: where a window longer than the ring aims several rows
    at it, the newest that the count and the discard keep."""
    st = _state(capacity, cursor=cursor, total=5)
    st.position.zero_()
    draws = _draws(spawn_max, seed=4)
    draws[0][:, 0] = torch.arange(spawn_max, dtype=F32) + 0.25
    config = torch.zeros((9, 4))
    config[0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    config[6, 3] = 1.0
    u = _marker_uniforms(64).replace(
        config=config, attribute_discard_threshold=f32(0.5))
    out = spawner.spawn_reference(st, u, count, spawn_max, uniforms=draws,
                                  sub_rings=sub_rings, shard=shard)
    pos = out.position
    written = {int(pos[s, 0]): (s, int(pos[s, 1]) - 5)
               for s in range(capacity) if pos[s, 3] == 1.0}
    kept = {j for j in range(spawn_max) if draws[2][j, 3] >= 0.5}
    assert written == kernel_rows(capacity, spawn_max, count, cursor,
                                  sub_rings, shard, kept)


# -- the animated uniforms against ops/bezier.py -------------------------------


MODES = {"linear": 0, "sine": MODE_SINE, "exp": MODE_EXP,
         "loop": MODE_LOOP_BIT, "bounce": MODE_BOUNCE_BIT,
         "sine_loop": MODE_SINE | MODE_LOOP_BIT}
TIMES = (-0.7, 0.0, 0.3, 1.999, 2.5, 4.0, 5.2, 7.75, 13.1)
POINTS = ((3.0, -1.0, 2.0), (7.5, 4.0, -3.0), (-2.0, 9.0, 1.5),
          (1.0, 0.5, 8.0))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_path_mirror_is_evaluate_bezier(count, mode, reverse):
    """The kernel's path evaluation equals evaluate_bezier bit for bit at
    counts 1-4, each time mode, looping and bouncing, reversed."""
    lo, hi = (5.0, 1.0) if reverse else (1.0, 5.0)
    b = pack_bezier(POINTS[:count], min_value=lo, max_value=hi,
                    mode=MODES[mode])
    for value in TIMES:
        want = evaluate_bezier(b, f32(value))
        assert torch.equal(path_value(b, f32(value)), want), value


def test_constant_path_mirror():
    b = constant_bezier([4.0, 5.0, 6.0])
    assert torch.equal(path_value(b, f32(3.0)), evaluate_bezier(b, 3.0))


def _controls(kind):
    dyn = [DynamicMatrix.from_components(angle=a, scale=s, translation=t)
           for a, s, t in ((84.0, 1.0, (0.0, 0.0, 0.0)),
                           (96.0, 1.5, (3.0, -2.0, 1.0)),
                           (-30.0, 0.75, (1.0, 4.0, -1.0)),
                           (200.0, 2.0, (0.5, 0.5, 0.5)))]
    explicit = [DynamicMatrix.from_matrix(np.arange(16, dtype=np.float32)
                                          .reshape(4, 4) * (i + 1) * 0.1)
                for i in range(4)]
    return {"dynamic": dyn, "explicit": explicit,
            "mixed": [dyn[0], explicit[1], dyn[2], explicit[3]]}[kind]


@pytest.mark.parametrize("mode", ["linear", "sine", "exp", "loop",
                                  "bounce"])
@pytest.mark.parametrize("kind", ["dynamic", "explicit", "mixed"])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_matrix_mirror_is_evaluate_bezier_matrix(count, kind, mode):
    """The kernel's BezierM evaluation equals evaluate_bezier_matrix bit
    for bit: fully dynamic controls (angle, scale and translation
    interpolated, then regenerated), explicit and mixed ones (each
    control regenerated, then interpolated element by element)."""
    bm = pack_bezier_matrix(_controls(kind)[:count], min_value=0.0,
                            max_value=4.0, mode=MODES[mode])
    for value in TIMES:
        want = evaluate_bezier_matrix(bm, f32(value))
        assert torch.equal(bezier_matrix(bm, f32(value)), want), value


@pytest.mark.parametrize("frame", [0, 239, 240, 359, 360, 361, 719, 1234])
def test_the_flagship_wraps_are_torch_remainder(frame):
    """The flagship's animations at frame i / 60 s across the 4 s and 6 s
    wraps: the kernel's wrapped times (fmod, then the divisor's sign) are
    torch.remainder's, and the path and the velocity matrix evaluated at
    them are the eager frame's."""
    sp, u = _flagship_uniforms()
    t = f32(float(frame)) * f32(1.0 / 60.0)
    for period in (6.0, 4.0):
        m = torch.fmod(t, f32(period))
        wrapped = m + period if (m != 0 and m < 0) else m
        assert torch.equal(wrapped, torch.remainder(t, period))
    resolved = spawner.animated(u, t)
    assert torch.equal(resolved.position_constants[0, :3],
                       path_value(u.position_path, torch.remainder(t, 6.0)))
    assert torch.equal(resolved.velocity_matrix, bezier_matrix(
        sp.velocity_post_matrix, torch.remainder(t, 4.0)))


# -- the eager body ------------------------------------------------------------


def test_animated_is_what_the_frame_evaluated():
    """`animated` gives the uniforms the flagship's particle stage built
    before the animations moved into the spawn (the path replaces every
    position constant's xyz, the matrix is evaluated at remainder(t,
    4)), and the spawn from them is the same bit for bit."""
    sp, u = _flagship_uniforms()
    t = f32(5.9)
    pc = u.position_constants.clone()
    pc[:, :3] = evaluate_bezier(u.position_path,
                                torch.remainder(t, 6.0))[None, :]
    before = u.replace(position_constants=pc, position_path=None,
                       velocity_animation=None,
                       velocity_matrix=evaluate_bezier_matrix(
                           sp.velocity_post_matrix, torch.remainder(t, 4.0)))
    draws = _draws(32)
    got = spawner.spawn(_state(128, 100, 9), u, 25, 32, uniforms=draws,
                        time=t)
    ref = spawner.spawn_reference(_state(128, 100, 9), before, 25, 32,
                                  uniforms=draws)
    for name in ("position", "velocity", "color", "write_cursor",
                 "total_spawned"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_spawner_hands_its_animation_to_the_spawn():
    """A Spawner with a BezierM post-matrix hands it over (no static
    matrix), and the spawn at `now` equals the eager evaluation there;
    its uniforms are one object while nothing changes."""
    sp = _spawner(velocity_post_matrix=_rot())
    u = sp.uniforms(1.3)
    assert u.velocity_matrix is None
    assert u.velocity_animation is sp.velocity_post_matrix
    assert sp.uniforms(2.0) is u
    resolved = spawner.animated(u, 1.3)
    assert torch.equal(resolved.velocity_matrix, evaluate_bezier_matrix(
        sp.velocity_post_matrix, 1.3))
    sp.alpha_discard_threshold = 3.0
    assert sp.uniforms(2.0) is not u


@pytest.mark.parametrize("route", ["cpu", "card"])
def test_animated_uniforms_need_the_time(monkeypatch, route):
    """Uniforms with an animation have no time of their own: a spawn of
    them without `time` raises on either route, before the kernel; static
    uniforms need none."""
    def no_kernel(*a, **kw):
        raise AssertionError("reached the kernel wrapper")

    if route == "card":
        monkeypatch.setattr(k4b, "takes", lambda device: True)
        monkeypatch.setattr(k4b, "spawn_cuda", no_kernel)
    _, u = _flagship_uniforms()
    for animated in (u, u.replace(position_path=None),
                     u.replace(velocity_animation=None,
                               velocity_matrix=torch.eye(4))):
        with pytest.raises(ValueError, match="time"):
            spawner.spawn(_state(64), animated, 20, 32, uniforms=_draws(32))
    if route == "cpu":
        out = spawner.spawn(_state(64), _spawner().uniforms(0.0), 20, 32,
                            uniforms=_draws(32))
        assert int(out.total_spawned) == 20


def test_a_spawner_keeps_one_animation_a_device():
    """A BezierM post-matrix is moved to the uniforms' device once (kept
    as it is where it already lies there) and handed over as one object
    from call to call; a new BezierM replaces it."""
    sp = _spawner(velocity_post_matrix=_rot())
    first = sp.uniforms(0.0, "cpu").velocity_animation
    assert first is sp.velocity_post_matrix
    assert sp.uniforms(3.0, "cpu").velocity_animation is first
    sp.velocity_post_matrix = _rot()
    assert sp.uniforms(3.0, "cpu").velocity_animation is \
        sp.velocity_post_matrix
    moved = spawner._moved(first, torch.device("cpu"))
    assert moved is first
    doubled = first.replace(a=first.a.replace(angle=first.a.angle.double()))
    assert spawner._moved(doubled, torch.device("cpu")) is doubled


def test_bytes_moved_counts_what_a_launch_reads_and_writes():
    """The table's present floats, each constant once, the draws of the
    computed rows and the three rows of each written one."""
    _, u = _flagship_uniforms()
    table = sum(t.numel() for t in k4b.uniform_table(u) if t is not None)
    assert k4b.bytes_moved(u, 4096, 4000) == (
        4 * (table + 4) + 48 * 4096 + 48 * 4000 + 16)
    colored = u.replace(position_colors=torch.ones((1, 4)))
    assert k4b.bytes_moved(colored, 10, 0) - k4b.bytes_moved(u, 10, 0) == 16
