"""The benchmark's renderer cell (`renderer-march-1080p`: `LightingRenderer`
at 1080p, 8 sphere lights under the exact cone march through a budgeted
static / dynamic voxel field) on the CPU at a small size: the cell agrees
with its plain reference and the control does not, a timed path that
ignores the budget is not correct, the replayed slice queue's and the
field's hand cases, K12's work on the volume and the cell's four readers.

On the CPU the port samples the volume and marches with its plain loop
(`sdf/sampling.py:sample`, `lighting/cone_trace.py:cone_trace_reference`),
which take the reference's operations in the reference's order, so every
compared number reads 0 here; on the card K12 takes another root (PERF.md,
section 6).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from framebench.lib import bench, loader  # noqa: E402
from framebench.lib.trace import Trace  # noqa: E402
from framebench.metrics import _k12_volume_work  # noqa: E402
from framebench.reference import march, sdf  # noqa: E402
from framebench.reference.voxel import Geometry  # noqa: E402
from illuminant_tpu_torch.lighting import renderer as trend  # noqa: E402

CELL = "renderer-march-1080p"
CONFIG = "renderer-voxel-march-1080p"
# 8 lights as in the configuration (with 4 the bfloat16 control moves the
# image by a level at most, as little as rounding may); 16 slices, so that
# a budget of 2 slabs leaves 10 slices of the dynamic partition stale.
SMALL = dict(height=96, width=160, n_lights=8)
SEED = 2 ** 31 + 101
NEW_METRICS = {"field_regen_device_ms", "update_fields_host_ms",
               "render_lighting_device_ms", "k12_volume_roofline"}
# The host times of frames run with the program's recorder on.
RECORDED_METRICS = {"frame_host_ms", "host_syncs_per_frame",
                    "launch_host_us", "sphere_lights_host_ms",
                    "field_slab_host_ms"}
SLAB = "illuminant/renderer/field_slab"

ref_mod = loader.module("reference", CONFIG)


@pytest.fixture(scope="module")
def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_base(tmp_path_factory):
    """A copy of framebench/ with the renderer configuration cut to SMALL;
    -> the copy's path."""
    base = tmp_path_factory.mktemp("renderer") / "framebench"
    shutil.copytree(os.path.join(ROOT, "framebench"), base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = base / "configs" / f"{CONFIG}.json"
    config = json.loads(path.read_text())
    config.update(SMALL)
    path.write_text(json.dumps(config))
    return str(base)


def _small_config(small_base):
    with open(os.path.join(small_base, "configs", f"{CONFIG}.json")) as f:
        return json.load(f)


def _run(bench_json, base, seconds=1.0, trace=False, **kw):
    return bench.run(CELL, SEED, seconds, trace, "cpu", time.perf_counter(),
                     bench=bench_json, base=base, **kw)


@pytest.fixture(scope="module")
def controlled(bench_json, small_base):
    return _run(bench_json, small_base, control=True)


def test_the_cell_is_in_the_benchmark(bench_json):
    spec = loader.cell(bench_json, CELL)
    assert spec["entry"]["chips"] == 1
    assert spec["entry"]["traffic"] == "renderer_moving"
    assert spec["config_entry"]["reduced"] == []
    assert spec["config_entry"]["source"] == spec["config"]["source"]
    assert (spec["config"]["width"], spec["config"]["height"]) == (1920, 1080)
    assert spec["params"]["budget"] == 2
    assert {m["name"] for m in spec["per_layer"]} == \
        NEW_METRICS | RECORDED_METRICS
    assert hasattr(loader.module("scenes", CONFIG), "build")
    assert hasattr(ref_mod, "Reference")
    for name in NEW_METRICS | RECORDED_METRICS:
        assert callable(loader.module("metrics", name).read)


def test_the_reference_loads_neither_package():
    code = ("import json, sys\n"
            "from framebench.lib import loader\n"
            f"loader.module('reference', '{CONFIG}')\n"
            "import framebench.metrics._k12_volume_work\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & set(bench.BANNED + ("illuminant_tpu_torch",))


def test_the_cell_equals_its_reference_on_the_cpu(controlled):
    """Every number reads 0: on the CPU the port's slabs, trilinear sample
    and plain march follow the reference's operations in order."""
    assert controlled["correct"] and controlled["failed"] == 0
    assert controlled["attempted"] > 0
    assert all(c["value"] == 0.0 for c in controlled["checks"].values()), \
        controlled["checks"]


def test_the_control_fails_every_number(controlled):
    failing = {name for name, value in controlled["control"].items()
               if value > controlled["checks"][name]["limit"]}
    assert failing == set(controlled["checks"]), controlled["control"]


SETUP_BUDGET = 10 ** 6


def _every_slice(orig):
    """Each frame regenerates every invalid slice, whatever the budget."""
    def regenerate(self, budget):
        return orig(self, SETUP_BUDGET)
    return regenerate


def _no_slice(orig):
    """The set-up writes every slice; no frame writes any."""
    def regenerate(self, budget):
        if budget >= SETUP_BUDGET:
            return orig(self, budget)
        return None
    return regenerate


@pytest.mark.parametrize("fault", [_every_slice, _no_slice])
def test_a_path_that_ignores_the_budget_is_not_correct(
        bench_json, small_base, monkeypatch, fault):
    monkeypatch.setattr(trend.LightingRenderer, "_regenerate",
                        fault(trend.LightingRenderer._regenerate))
    r = _run(bench_json, small_base, seconds=0.3)
    assert not r["correct"], r["checks"]
    assert r["checks"]["field"]["value"] > r["checks"]["field"]["limit"]


def test_the_scene_is_chip_smokes_renderer_march_scene(small_base):
    """The cell's frozen scene, built on the CPU, holds the lights,
    obstructions, field geometry and motion of `chip_smoke.
    renderer_march_scene` at the same size."""
    import chip_smoke

    config = _small_config(small_base)
    params = loader.json_file("workloads", CELL)
    cell = loader.module("scenes", CONFIG, small_base).build(
        config, params, SEED, torch.device("cpu"))
    smoke, hdr, move = chip_smoke.renderer_march_scene(
        chip_smoke.port_api(), SMALL["width"], SMALL["height"],
        n_lights=SMALL["n_lights"], device="cpu")
    ours = cell.renderer
    assert ours.config == smoke.config and hdr == cell.hdr
    assert ours.sdf_config == smoke.sdf_config
    assert ours.sdf_config.shape == (16, 24, 40)
    a, b = ours.environment, smoke.environment
    assert (a.ground_z, a.maximum_z, a.ambient) == (b.ground_z, b.maximum_z,
                                                    b.ambient)
    assert [(l.position, l.radius, l.ramp_length, l.color, l.cast_shadows)
            for l in a.lights] == [
        (l.position, l.radius, l.ramp_length, l.color, l.cast_shadows)
        for l in b.lights]

    def obstructions(env):
        return [(o.type, tuple(o.center), tuple(o.size), o.is_dynamic)
                for o in env.obstructions]

    assert obstructions(a) == obstructions(b)
    i = cell.k0 + 5
    move(i)
    assert [tuple(o.center) for o in b.obstructions if o.is_dynamic] == \
        [tuple(c) for c in ref_mod.dynamic_centers(config, i)]


def test_exactly_two_slabs_a_moving_frame(small_base):
    """Under a profiler each frame opens one `field_slab` span a slab
    written: 2 while the boxes move (the dynamic partition's slices 0-5),
    none for the static partition; the port's queue agrees with the
    replayed one."""
    from torch.profiler import ProfilerActivity, profile

    config = _small_config(small_base)
    params = loader.json_file("workloads", CELL)
    cell = loader.module("scenes", CONFIG, small_base).build(
        config, params, SEED, torch.device("cpu"))
    cell.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cell.step()
    slabs = [e for e in prof.events() if e.name == SLAB]
    assert len(slabs) == 2
    for e in slabs:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(
                "illuminant/"):
            parent = parent.cpu_parent
        assert parent.name == "illuminant/renderer/field_regen"
    assert cell.traced == dict(frame=cell.k0 + 1, frames_run=2, budget=2)
    static, dynamic = ref_mod.replay(16, cell.k0, 2, 2)
    assert cell.renderer._invalid_dynamic == dynamic.invalid
    assert cell.renderer._invalid_static == static.invalid == []


# -- the reference's hand cases ---------------------------------------------

def test_the_replayed_queue_while_the_boxes_move():
    """After the set-up and three frames of moving boxes under a budget of
    2 slabs: the dynamic partition's slices 0-5 are the last frame's, 6-15
    the set-up's, and it is valid up to z = 6 x 64 / 16 = 24; the static
    partition is the set-up's throughout."""
    static, dynamic = ref_mod.replay(16, 100, 3, 2)
    assert dynamic.source == [102] * 6 + [ref_mod.SETUP] * 10
    assert dynamic.invalid == list(range(6, 16))
    assert dynamic.valid_slices == 6
    assert static.source == [ref_mod.SETUP] * 16
    assert static.invalid == [] and static.valid_slices == 16
    # A last slab shorter than 3 slices: 16 = 5 x 3 + 1.
    q = ref_mod.Queue(16)
    q.update(6, "a")
    assert q.source == ["a"] * 16 and q.valid_slices == 16


def test_the_reference_field_of_moving_boxes(small_base):
    """The combined field's max_valid_z is 24 while the boxes move; its
    slices 6-15 are the set-up's boxes, 0-5 the frame's."""
    config = _small_config(small_base)
    ref = ref_mod.Reference(config, "cpu")
    inputs = dict(frame=100, frames_run=3, budget=2)
    field = ref.field(inputs)
    assert float(field.max_valid_z) == 24.0
    g = ref.g
    now = ref.static + ref._dynamic(100)
    then = ref.static + ref._dynamic(ref_mod.SETUP)
    assert torch.equal(field.data[:6], ref_mod.slices(g, now, range(6)))
    assert torch.equal(field.data[6:],
                       ref_mod.slices(g, then, range(6, 16)))
    assert not torch.equal(field.data[:6], ref_mod.slices(g, then, range(6)))


def _f(v):
    return torch.tensor(v, dtype=torch.float32)


def test_one_voxel_by_hand():
    """Voxel (s, y, x) lies at world ((x + 0.5) / 0.25, (y + 0.5) / 0.25,
    4 s). A box at (42, 42, 20) of half size (10, 10, 20): at its centre
    (voxel (5, 10, 10)) -10 + 1e-6 (the 1e-12 under the root), 6 units
    past its face (voxel (5, 10, 14), x = 58) 6, far off (x = 398) the
    band's top (192 / 255) x 128; inside a box of half size (100, 100, 32)
    at its centre the band's bottom -(63 / 255) x 128."""
    g = Geometry(width=400, height=400, depth=64, slices=16, scale=0.25)
    box = sdf.Primitive(sdf.TYPE_BOX, _f([42.0, 42.0, 20.0]),
                        _f([10.0, 10.0, 20.0]))
    d = ref_mod.slices(g, [box], [5])[0]
    assert float(d[10, 10]) == pytest.approx(-10.0 + 1e-6, abs=1e-6)
    assert float(d[10, 14]) == 6.0
    assert float(d[10, 99]) == pytest.approx(192.0 / 255.0 * 128.0,
                                             rel=1e-7)
    big = sdf.Primitive(sdf.TYPE_BOX, _f([198.0, 198.0, 32.0]),
                        _f([100.0, 100.0, 32.0]))
    d = ref_mod.slices(g, [big], [8])[0]
    assert float(d[49, 49]) == pytest.approx(-63.0 / 255.0 * 128.0,
                                             rel=1e-7)


def test_the_trilinear_sample_by_hand():
    """A volume whose voxel value is its world x + 10 z: the sample is
    that plane at points inside (trilinear is exact on it), clamped at
    max_valid_z in z. Past the box's edge x = 0 the point is clamped to
    x = 0, whose texel coordinate -0.5 takes its weight 0.5 from the
    unclipped floor -1 and its taps from the clipped indices 0 and 1
    (world x 2 and 6): 4 + 80, plus the distance 3 to the box."""
    g = Geometry(width=40, height=24, depth=64, slices=16, scale=0.25)
    s, h, w = g.shape
    x = (torch.arange(w, dtype=torch.float32) + 0.5) / 0.25
    z = torch.arange(s, dtype=torch.float32) * 4.0
    data = (x[None, None, :] + 10.0 * z[:, None, None]).expand(s, h, w)
    field = ref_mod.VolumeField(g, data.contiguous(), _f(24.0))
    d = field.distance(_f([10.0, 10.0, 10.0, -3.0]), _f([5.0, 5.0, 5.0, 5.0]),
                       _f([8.0, 30.0, 2.0, 8.0]))
    assert d.tolist() == pytest.approx([90.0, 250.0, 30.0, 84.0 + 3.0])


def _box_field():
    g = Geometry(width=160, height=96, depth=64, slices=16, scale=0.25)
    box = sdf.Primitive(sdf.TYPE_BOX, _f([50.0, 50.0, 10.0]),
                        _f([10.0, 10.0, 10.0]))
    return ref_mod.VolumeField(g, ref_mod.slices(g, [box], range(16)),
                               _f(64.0))


def test_k12_volume_work_equals_a_hand_count():
    """One light, one box in a (16, 24, 40) volume, four points: two
    inside the box (shadowed on their first step), one a unit from the
    light (past its end on its first step), one disabled: 3 steps in all.
    Bytes: the light's centre, radius and ramp (5 floats), 4 origins (12
    floats), 4 enable bytes, the packed volume (16 B a texel), 4
    visibilities. Operations a ray with no step, and on the light, as for
    the analytic field (23 and 4: `test_framebench_march.py`). A step:
    the march's own 29 (the steps' decrement and select, the sample
    point, the cone, the visibility, the step, the two selects, the
    liveness and its update) and the trilinear sample's 67 (3 clamps
    into the box; 5 a axis for the distance past it and 6 for its root;
    the slice position 2, its floor and weight 2, its two indices 3; the
    texel coordinates 4, their floors and weights 4, their four indices
    6; two bilinear slices of 9; the z lerp and the distance 4), less the
    4 of the masking."""
    field = _box_field()
    origin = [[50.0, 50.0, 5.0], [52.0, 49.0, 6.0], [150.0, 90.0, 1.6],
              [10.0, 10.0, 1.6]]
    quality = dict(ref_mod.QUALITY)
    rays = dict(center=_f([[151.0, 91.0, 2.0]]), radius=_f([0.5]),
                ramp=_f([100.0]), origin=_f(origin),
                enable=torch.tensor([[True, True, True, False]]))
    _, steps = march.march(field, quality=quality, **rays)
    assert steps.tolist() == [[63.0, 63.0, 63.0, 64.0]]
    n_bytes, n_ops = _k12_volume_work.march_work(field, quality=quality,
                                                 **rays)
    assert n_bytes == 4.0 * 5 + 4.0 * 12 + 4 + 16.0 * 16 * 24 * 40 + 4.0 * 4
    assert n_ops == 4 * (15 + 8) + 4 + 3 * (29 + 67 - 4)


# -- the readers -------------------------------------------------------------

class _Cell:
    def __init__(self, traced):
        self._traced = traced

    def traced_march(self):
        return self._traced


def _trace(ranges, cell=None, peaks=None, ops=True):
    return Trace(frames=2, device_ops=[("k", 0.0, 1.0)] if ops else [],
                 ranges=ranges, host_counts={}, start_us=0.0, end_us=10.0,
                 cell=cell, peaks=peaks)


@pytest.mark.parametrize("name,span,host", [
    ("field_regen_device_ms", "illuminant/renderer/field_regen", False),
    ("update_fields_host_ms", "illuminant/renderer/update_fields", True),
    ("render_lighting_device_ms", "illuminant/renderer/render_lighting",
     False)])
def test_a_span_reader_reads_its_span(name, span, host):
    """Two frames: the span's host time (end - start, us) or its device
    time summed and halved; another span is not read."""
    m = loader.module("metrics", name)
    ranges = [(span, 0.0, 3000.0, 1000.0), (span, 5000.0, 6000.0, 3000.0),
              ("illuminant/renderer/resolve", 0.0, 9000.0, 9000.0)]
    assert m.read(_trace(ranges)) == pytest.approx(2.0)
    if host:
        assert m.read(_trace(ranges, ops=False)) == pytest.approx(2.0)
    else:
        assert m.read(_trace(ranges, ops=False)) is None
    assert m.read(_trace(ranges[2:])) is None


def test_k12_volume_roofline_reads_the_last_traced_span():
    from framebench.lib.peaks import bound_ms

    m = loader.module("metrics", "k12_volume_roofline")
    field = _box_field()
    rays = dict(center=_f([[80.0, 50.0, 20.0]]), radius=_f([4.0]),
                ramp=_f([300.0]), origin=_f([[x, 20.0, 1.6]
                                             for x in range(0, 100, 10)]),
                enable=torch.ones(1, 10, dtype=torch.bool),
                quality=dict(ref_mod.QUALITY))
    peaks = dict(bytes_per_s=3.35e12, f32_ops_per_s=67e12)
    cell = _Cell((field, rays))
    ranges = [(m.SPAN, 5.0, 6.0, 40.0), (m.SPAN, 1.0, 2.0, 10.0),
              ("illuminant/renderer/render_lighting", 0.0, 7.0, 60.0)]
    got = m.read(_trace(ranges, cell, peaks))
    want = 100.0 * bound_ms(peaks, *_k12_volume_work.march_work(
        field, **rays)) / 40e-3
    assert got == pytest.approx(want, rel=1e-12)
    # Off the card, without the span or a traced frame: nothing.
    assert m.read(_trace(ranges, cell, None)) is None
    assert m.read(_trace(ranges, cell, peaks, ops=False)) is None
    assert m.read(_trace(ranges[2:], cell, peaks)) is None
    assert m.read(_trace(ranges, _Cell(None), peaks)) is None
    assert m.read(_trace(ranges, object(), peaks)) is None


def test_the_traced_march_is_the_frame_the_port_marched(small_base):
    """The rays and field `_k12_volume_work` counts (the reference's, from
    the traced frame's inputs) are those the port's frame passes to its
    march, and the field samples alike."""
    from illuminant_tpu_torch.lighting import sphere
    from illuminant_tpu_torch.sdf import sampling

    config = _small_config(small_base)
    params = loader.json_file("workloads", CELL)
    cell = loader.module("scenes", CONFIG, small_base).build(
        config, params, SEED, torch.device("cpu"))
    seen = []
    orig = sphere.cone_trace

    def spy(volume, center, radius, ramp, origin, enable, quality, *a):
        seen.append((volume, center, radius, ramp, origin, enable))
        return orig(volume, center, radius, ramp, origin, enable, quality,
                    *a)

    sphere.cone_trace = spy
    try:
        cell.step()
        from torch.profiler import profile

        with profile():
            cell.step()
    finally:
        sphere.cone_trace = orig
    volume, center, radius, ramp, origin, enable = seen[-1]
    field, rays = cell.traced_march()
    assert torch.equal(center.reshape(-1, 3), rays["center"])
    assert torch.equal(radius.reshape(-1), rays["radius"])
    assert torch.equal(ramp.reshape(-1), rays["ramp"])
    assert torch.equal(origin[0], rays["origin"])
    assert torch.equal(enable, rays["enable"])
    assert torch.equal(volume.data, field.data)
    assert torch.equal(volume.max_valid_z, field.max_valid_z)
    p = rays["origin"] + torch.tensor([3.0, -2.0, 17.0])
    assert torch.equal(sampling.sample(volume, p),
                       field.distance(p[..., 0], p[..., 1], p[..., 2]))
